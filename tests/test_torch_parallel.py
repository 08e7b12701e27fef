"""The port's mesh (``parallel.mesh``) on the CPU: two gloo processes
(``parallel.dryrun``, which imports no JAX) against the one-process port
step on the same global batch, weights and noise. The mesh without
processes (the rows of each rank, its errors) is tests/test_torch_mesh.py.

The two ranks run, in one launch: ``mesh_data=2``; ``mesh_fsdp=2`` (with
the bytes each rank holds, a checkpoint of one process restored on both,
and a run resumed from its step-1 checkpoint, which one process then
restores); ``mesh_dcn=2`` over two one-process nodes (the same layout and
arithmetic as ``mesh_data=2``, so it must repeat that case bit for bit);
``grad_accum=2`` with ``mesh_data=2``; BatchNorm over the ranks' rows
against one BatchNorm over the whole batch; and ``Trainer`` over the
group. 64x128, a global batch of 4, float32, lr 1e-4. Bounds
(``dryrun.check``): losses at rtol 1e-5, grad_norm at 1e-2, parameters
within 2 lr + 1e-6 with at most 4% of them more than 0.1 lr apart, BatchNorm
statistics at atol 2e-5 (tests/test_torch_train.py says why), the ranks
bit-identical, and under fsdp at most 65% of the bytes of the parameters
and of each Adam moment on a rank (the JAX package's
tests/test_train.py bound).
"""

import json

import numpy as np
import pytest
import torch

from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.parallel import dryrun
from unsupervised_pose_estimation_tpu_torch.train import checkpoint as ck
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle
from unsupervised_pose_estimation_tpu_torch.train.loop import Trainer
from unsupervised_pose_estimation_tpu_torch.train.state import \
    create_train_state

H, W, B, LR = 64, 128, 4, 1e-4
COMMON = dict(height=H, width=W, batch_size=B, compute_dtype="float32",
              learning_rate=LR)
# the fsdp case (and its checkpoints) with the small PoseCNN pose network
FSDP = dict(COMMON, mesh_data=1, mesh_fsdp=2, pose_model_type="posecnn")
TRAINER = dict(height=32, width=64, batch_size=4, dataset="synthetic_parallax",
               weights_init="scratch", num_epochs=1, steps_per_epoch=1,
               log_frequency=1, compute_dtype="float32", num_workers=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def one_process_checkpoint(directory):
    """A one-process checkpoint of the fsdp case's configuration at step
    3, with random Adam moments, saved to ``directory``."""
    cfg = Options(**{**FSDP, "mesh_data": -1, "mesh_fsdp": 1})
    bundle = ModelBundle.create(cfg, seed=cfg.seed, device="cpu")
    state = create_train_state(bundle)
    gen = torch.Generator().manual_seed(1)
    for p in bundle.main_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(3.0),
            "exp_avg": torch.randn(p.shape, generator=gen) * 1e-3,
            "exp_avg_sq": torch.rand(p.shape, generator=gen) * 1e-6}
    state.step = 3
    ck.save_checkpoint(directory, bundle, state, cfg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    one_process_checkpoint(str(root / "c1"))
    trainer = dict(TRAINER, mesh_data=2, log_dir=str(root / "logs"))
    cases = [
        {"name": "data", "compare": 1, "options": dict(COMMON,
                                                       mesh_data=2)},
        {"name": "fsdp", "compare": 1, "steps": 2, "options": FSDP,
         "restore": str(root / "c1"), "ckpt_at": 1},
        {"name": "dcn", "local_world": 1,
         "options": dict(COMMON, mesh_data=1, mesh_dcn=2)},
        {"name": "accum", "compare": 1,
         "options": dict(COMMON, mesh_data=2, grad_accum=2)},
        {"name": "batch_norm", "kind": "batch_norm"},
        {"name": "trainer", "kind": "trainer", "options": trainer},
    ]
    results = dryrun.launch(cases, 2, "cpu", str(root / "run"),
                            timeout=240)
    return root, results


@pytest.mark.parametrize("case", ["data", "fsdp", "dcn", "accum"])
def test_two_ranks_match_one_process(ranks, case):
    _, results = ranks
    assert dryrun.check(results, case) == []
    steps = results[0][case]["steps"]
    assert all(s["collectives"] > 0 for s in steps)
    if case == "dcn":
        # two one-process nodes: the layout and sums of mesh_data=2
        data = results[0]["data"]["steps"][0]
        assert steps[0]["digest"] == data["digest"]
        assert steps[0]["losses"] == data["losses"]
    else:
        assert "compare" in steps[0]


def test_fsdp_ranks_hold_half_the_parameters_and_moments(ranks):
    _, results = ranks
    for res in results:
        b = res["fsdp"]["bytes"]
        for key in ("parameters", "exp_avg", "exp_avg_sq"):
            assert 0 < b[key] <= 0.65 * b["total"], (key, b)


def test_batch_norm_over_ranks_matches_one_batch_norm(ranks):
    _, results = ranks
    bn = results[0]["batch_norm"]
    assert results[1]["batch_norm"]["digest"] == bn["digest"]
    for key in ("out", "grad_x", "grad_weight", "grad_bias",
                "running_mean", "running_var"):
        assert bn[key] <= 2e-5, (key, bn[key])


def test_one_process_checkpoint_restores_on_two(ranks):
    _, results = ranks
    assert all(r["fsdp"]["restored"]["equal"] for r in results)


def test_two_rank_checkpoint_restores_on_one_process(ranks):
    _, results = ranks
    saved = results[0]["fsdp"]["ckpt"]
    assert saved["step"] == 4
    cfg = Options(**{**FSDP, "mesh_data": -1, "mesh_fsdp": 1})
    bundle = ModelBundle.create(cfg, seed=cfg.seed + 1, device="cpu")
    state = create_train_state(bundle)
    ck.restore_checkpoint(saved["path"], bundle, state)
    assert state.step == 4
    got = dryrun.state_digest(bundle.state_dict(),
                              state.optimizer.state_dict(), state.step)
    assert got == saved["digest"] == results[1]["fsdp"]["ckpt"]["digest"]


def test_two_rank_run_resumes_bit_equal(ranks):
    _, results = ranks
    assert all(r["fsdp"]["resumed"]["equal"] for r in results)


def test_trainer_over_two_ranks(ranks, tmp_path):
    """Trainer over the group, one step: rank 0 alone writes
    metrics.jsonl, with the records of a one-process run and its training
    and validation losses (the same weights, rows and noise; validation
    after the update); both ranks end with the same parameters; the
    checkpoint restores on one process."""
    root, results = ranks
    assert dryrun.check(results, "trainer") == []
    assert results[0]["trainer"]["step"] == 1
    one = Trainer(Options(**TRAINER, log_dir=str(tmp_path)), device="cpu")
    one.train()

    def records(path):
        lines = (path / "mdp" / "metrics.jsonl").read_text().splitlines()
        return [json.loads(line) for line in lines]

    two, ref = records(root / "logs"), records(tmp_path)
    assert [(r["mode"], r["step"], sorted(r)) for r in two] == [
        (r["mode"], r["step"], sorted(r)) for r in ref]
    assert [r["mode"] for r in two] == ["train", "val"]
    for name in ("loss", "min_loss/0"):
        np.testing.assert_allclose(two[0][name], ref[0][name], rtol=1e-5)
        np.testing.assert_allclose(two[1][name], ref[1][name], rtol=1e-5)
    bundle = ModelBundle.create(one.cfg, device="cpu")
    ck.restore_checkpoint(str(root / "logs" / "mdp" / "models"
                              / "checkpoints"), bundle)


def test_silog_over_ranks_is_the_global_batch_loss():
    """The GAN prior's silog term, the one loss of the step that is not a
    mean: with ``reduce`` adding the other rank's three sums, each half of
    a batch gets the loss of the whole batch."""
    from unsupervised_pose_estimation_tpu_torch.ops.losses import silog_loss

    gen = torch.Generator().manual_seed(0)
    fake = torch.rand((4, 1, 8, 16), generator=gen) + 0.1
    real = torch.rand((4, 1, 8, 16), generator=gen) - 0.05
    whole = silog_loss(fake, real)

    def sums(f, r):
        captured = []
        silog_loss(f, r, reduce=lambda s: captured.append(s) or s)
        return captured[0]

    halves = [(fake[:2], real[:2]), (fake[2:], real[2:])]
    for (f, r), (of, orl) in zip(halves, halves[::-1]):
        got = silog_loss(f, r, reduce=lambda s: s + sums(of, orl))
        torch.testing.assert_close(got, whole, rtol=1e-6, atol=0)
