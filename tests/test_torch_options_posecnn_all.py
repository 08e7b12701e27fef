"""Option group B: PoseCNN over all frames at once (its translation
rescaled by the mean inverse depth at every scale, with the pairs' invert
rule, as the reference trainer does even under "all"), the predictive mask
(with automasking off, as the options require) and the upstream decoder,
against the JAX package (tests/torch_option_steps.py has the setup and the
bounds), and through ``cli.train`` with a resumed run."""

import pytest
import torch

from tests import torch_option_steps as T

OPTIONS = dict(pose_model_type="posecnn", pose_model_input="all",
               predictive_mask=True, disable_automasking=True,
               depth_decoder_variant="upstream")


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
    """Losses, gradients (the mask's BCE term and its product with the
    reprojection included) and the mask decoder's statistics."""
    T.compare_step(T.port_step(OPTIONS, reference), reference)


def test_networks_of_the_options(reference):
    """PoseCNN over 9 channels predicting 2 poses, an upstream depth
    decoder with no BatchNorm, and a fork mask decoder with 2 outputs."""
    sd = T.port_step(OPTIONS, reference, grad=False)[2]
    assert sd["pose.net.0.weight"].shape[1] == 9
    assert sd["pose.pose_conv.weight"].shape[0] == 12
    assert not any(k.startswith(("depth.bn.", "pose_encoder."))
                   for k in sd)
    assert "predictive_mask.bn.0.running_mean" in sd
    assert sd["predictive_mask.decoder.15.conv.weight"].shape[0] == 2


def test_cli_train_resumes_bit_exact(tmp_path):
    trainer = T.resume_is_bit_exact(tmp_path, [
        "--dataset", "synthetic_parallax", "--pose_model_type", "posecnn",
        "--pose_model_input", "all", "--predictive_mask",
        "--disable_automasking", "--depth_decoder_variant", "upstream"])
    assert trainer.bundle.depth.variant == "upstream"
