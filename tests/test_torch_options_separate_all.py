"""Option group C: the separate ResNet pose network over all frames at
once, with every kernel switch (``use_pallas_warp`` and ``use_pallas_loss``
off route the warps and the losses to the plain versions and turn the
fused op off, as in the JAX step), against the JAX package
(tests/torch_option_steps.py has the setup and the bounds); the forward
alone of PoseCNN over pairs and of the stereo frame with no temporal frame
(no pose network); and through ``cli.train`` with a resumed run."""

from unittest import mock

import pytest
import torch

from tests import torch_option_steps as T
from unsupervised_pose_estimation_tpu_torch.train import step as tstep

OPTIONS = dict(pose_model_input="all")
SWITCHES = {"kernels": {}, "plain_warp": dict(use_pallas_warp=False),
            "plain_loss": dict(use_pallas_loss=False)}
# the ops each setting must call: the fused op, or the warp and the loss
ROUTES = {"kernels": {"warp_reproj_loss_op", "reproj_loss_op"},
          "plain_warp": {"grid_sample", "reproj_loss_op"},
          "plain_loss": {"warp_op"}}
SPIED = ("warp_reproj_loss_op", "reproj_loss_op", "warp_op", "grid_sample")
FORWARD_ONLY = {"posecnn_pairs": dict(pose_model_type="posecnn"),
                "stereo_only": dict(frame_ids=(0,), use_stereo=True)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    return T.jax_reference(OPTIONS)


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_step_matches_jax(reference, switch):
    """The same JAX step (the JAX package runs its XLA warp and loss on
    the CPU) against the port in each routing: the fused op (the kernels'
    plain twins on the CPU), the plain warp, the plain loss."""
    called = set()

    def spy(name):
        real = getattr(tstep, name)

        def run(*args, **kwargs):
            called.add(name)
            return real(*args, **kwargs)
        return run

    with mock.patch.multiple(tstep, **{n: spy(n) for n in SPIED}):
        port = T.port_step({**OPTIONS, **SWITCHES[switch]}, reference)
    assert called == ROUTES[switch], called
    T.compare_step(port, reference)


@pytest.mark.parametrize("kind", sorted(FORWARD_ONLY))
def test_forward_matches_jax(kind):
    """Train-mode forward: the losses and the statistics after it."""
    kw = FORWARD_ONLY[kind]
    ref = T.jax_reference(kw, grad=False)
    losses, _, sd = T.port_step(kw, ref, grad=False)
    T.compare_losses(losses, ref["losses"])
    T.compare_stats(sd, ref["after"])
    has_pose = kind == "posecnn_pairs"
    assert any(k.startswith("pose.") for k in sd) == has_pose


def test_cli_train_resumes_bit_exact(tmp_path):
    trainer = T.resume_is_bit_exact(tmp_path, [
        "--dataset", "synthetic_parallax", "--pose_model_input", "all"])
    assert trainer.bundle.pose_encoder.encoder.conv1.weight.shape[1] == 9
