"""The port's mesh (``parallel.mesh``) without processes: the rows of each
rank against the JAX package's ``rows_from_slices`` / ``process_local_rows``
on its 8-device virtual meshes, the rows under gradient accumulation, and
the mesh's errors. Two processes over the mesh are
tests/test_torch_parallel.py.
"""

import warnings

import numpy as np
import pytest

from tests.test_torch_parallel import TRAINER
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.data.pipeline import (
    process_local_rows, rows_from_slices)
from unsupervised_pose_estimation_tpu_torch.parallel.mesh import (Mesh,
                                                                   make_mesh)
from unsupervised_pose_estimation_tpu_torch.train.loop import Trainer


@pytest.mark.parametrize("data,fsdp,dcn", [(8, 1, 1), (4, 2, 1), (2, 2, 2),
                                           (-1, 2, 1)])
def test_rows_match_the_jax_meshes(data, fsdp, dcn):
    """Rank r holds the rows that the JAX device at r's mesh coordinates
    holds under ``batch_sharding``; the ranks together hold the batch, as
    JAX's one process does."""
    import jax

    from unsupervised_pose_estimation_tpu.data import pipeline as jp
    from unsupervised_pose_estimation_tpu.parallel import mesh as jm

    gb = 16
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # dcn on virtual devices
        jmesh = jm.make_mesh(data, fsdp, dcn=dcn)
        port = [make_mesh(data, fsdp, dcn, world=8, rank=r)
                for r in range(8)]
    assert [jmesh.shape[a] for a in jm.AXES] == [
        port[0].dcn, port[0].data, port[0].fsdp]
    index = jm.batch_sharding(jmesh).devices_indices_map((gb,))
    for r, m in enumerate(port):
        device = jmesh.devices[m.coords]
        assert device.id == jax.devices()[r].id
        want = jp.rows_from_slices([index[device]], gb)
        np.testing.assert_array_equal(process_local_rows(m, gb), want)
        np.testing.assert_array_equal(
            rows_from_slices([index[device]], gb), want)
    every = np.sort(np.concatenate([process_local_rows(m, gb)
                                    for m in port]))
    np.testing.assert_array_equal(
        every, jp.process_local_rows(jm.batch_sharding(jmesh), gb))


def test_rows_under_grad_accum_are_each_ranks_share_of_each_microbatch():
    gb, accum = 16, 2
    port = [Mesh(1, 4, 1, rank=r) for r in range(4)]
    rows = [process_local_rows(m, gb, accum) for m in port]
    for i in range(accum):
        micro = np.sort(np.concatenate([r[i * 2:(i + 1) * 2] for r in rows]))
        np.testing.assert_array_equal(micro, np.arange(i * 8, (i + 1) * 8))


def test_mesh_errors(tmp_path):
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        make_mesh(2)
    with pytest.raises(ValueError, match="mesh 1x1x2 needs more than 1"):
        make_mesh(fsdp=2)
    with pytest.raises(ValueError, match="uses 2 of the 4 processes"):
        make_mesh(2, world=4, rank=0)
    with pytest.warns(UserWarning, match="dcn=2 but"):
        make_mesh(2, dcn=2, world=4, rank=0, local_world=4)
    with pytest.raises(ValueError, match="does not split"):
        Mesh(1, 2, 1).batch_slices(6, accum=2)
    with pytest.raises(ValueError, match="mesh 1x1x2 needs more than 1"):
        Trainer(Options(**TRAINER, mesh_fsdp=2, log_dir=str(tmp_path)),
                device="cpu")
