"""Option group A: a shared pose network (the pose decoder over the depth
encoder's features, every frame through the encoder in one forward), the
stereo frame and v1 multiscale (each scale warps and scores its own
pyramid level, with its own identity losses and intrinsics), against the
JAX package (tests/torch_option_steps.py has the setup and the bounds),
and through ``cli.train`` with a resumed run, on a stereo split read from
a frame cache."""

import pytest
import torch

from tests import torch_option_steps as T

OPTIONS = dict(pose_model_type="shared", use_stereo=True, v1_multiscale=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    return T.jax_reference(OPTIONS)


def test_step_matches_jax(reference):
    """Losses, gradients and the encoder's statistics, which the shared
    forward updates once from all 3B frames."""
    T.compare_step(T.port_step(OPTIONS, reference), reference)


def test_bundle_has_no_pose_encoder(reference):
    """The shared pose decoder takes a pair's features (two lists of the
    depth encoder's): no pose encoder, and no pose_encoder weights in the
    reference either."""
    port = T.port_step(OPTIONS, reference, grad=False)[2]
    assert not any(k.startswith("pose_encoder.") for k in port)
    assert "pose_encoder" not in reference["params"]
    assert port["pose.net.1.weight"].shape[1] == 2 * 256


def test_cli_train_resumes_bit_exact(tmp_path):
    args = T.write_stereo_cache(str(tmp_path / "data"))
    trainer = T.resume_is_bit_exact(tmp_path, args + [
        "--pose_model_type", "shared", "--use_stereo", "--v1_multiscale"])
    assert trainer.cfg.use_stereo and trainer.cfg.v1_multiscale
