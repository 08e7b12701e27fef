"""The port's networks at ``compute_dtype="bfloat16"`` against the JAX
package's, on the same weights.

The weights are tests/test_torch_eval.py's: seeded, with BatchNorm
statistics, scales and biases redrawn, read into flax trees by the JAX
package's ``.pth`` importers. Parameters stay float32 on both sides;
convolutions, transposed convolutions and BatchNorm run in bfloat16, the
disparity sigmoid and the pose mean in float32. XLA on the CPU and
PyTorch's CPU convolutions each accumulate a bfloat16 convolution in
float32 in their own order and round once, and flax adds a conv's bias in
bfloat16 after the conv where PyTorch may fold it into the accumulator, so
the two are not bit-equal. Each
comparison is therefore bounded by the JAX package's own bfloat16-against-
float32 gap on the same inputs, computed in the same test:

- the port's bfloat16 against JAX's bfloat16: the largest difference within
  3x the gap's largest, the mean within 2x the gap's mean (measured at
  most 1.6x and 1.2x here; 2.2x on other seeded weights);
- the port's bfloat16 against the port's float32: both within 2x (measured
  at most 1.4x and 1.2x).

Packing: the JAX package packs the encoder's stem (space-to-depth) when H
and W are even and carries the decoder's levels 1 and 0 packed
(``packed_tail``). Each network is compared with packing on (64 rows, the
default tail) and off (65 rows, whose stem cannot pack; ``packed_tail``
off). Inputs have 64 rows or more: the JAX package's pad writes stray
values on one-row maps (ROADMAP.md, section 3).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_eval import jax_trees, perturbed_bundle
from unsupervised_pose_estimation_tpu.config import Options as JOptions
from unsupervised_pose_estimation_tpu.train.bundle import \
    ModelBundle as JBundle
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.models.layers import BatchNorm2d
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle

H, W = 64, 128
DTYPES = ("float32", "bfloat16")
VS_JAX_MAX, VS_JAX_MEAN = 3.0, 2.0
VS_F32_MAX, VS_F32_MEAN = 2.0, 2.0
# packing on: an even height (packed stem) and the default packed tail;
# off: 65 rows (plain stem) and packed_tail=False
PACKING = {"packed": (H, True), "plain": (H + 1, False)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """JAX bundles at both dtypes, the weights as flax trees, and port
    bundles at both dtypes holding them."""
    jax_b = {dt: JBundle.create(JOptions(height=H, width=W, compute_dtype=dt))
             for dt in DTYPES}
    weights = perturbed_bundle()
    params, stats = jax_trees(weights, str(tmp_path_factory.mktemp("pth")))
    port = {}
    for dt in DTYPES:
        port[dt] = ModelBundle.create(
            Options(height=H, width=W, compute_dtype=dt), device="cpu")
        port[dt].load_state_dict(weights.state_dict(), strict=True)
    return jax_b, params, stats, port


def run_jax(module, variables, *args):
    return jax.jit(lambda v, *a: module.apply(v, *a, False))(variables,
                                                             *args)


def variables(params, stats, name):
    return {"params": params[name], "batch_stats": stats[name]}


def as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def within_gap(port_bf16, port_f32, jax_bf16, jax_f32, what):
    """The bounds of the module docstring, on arrays of one output."""
    gap = np.abs(jax_bf16 - jax_f32)
    assert gap.max() > 0, f"{what}: no bfloat16 gap to bound by"
    for got, want, mx, mean, name in (
            (port_bf16, jax_bf16, VS_JAX_MAX, VS_JAX_MEAN, "JAX bf16"),
            (port_bf16, port_f32, VS_F32_MAX, VS_F32_MEAN, "port f32")):
        err = np.abs(got - want)
        assert err.max() <= mx * gap.max(), (
            f"{what} vs {name}: max {err.max():.3e} > {mx} x "
            f"{gap.max():.3e}")
        assert err.mean() <= mean * gap.mean(), (
            f"{what} vs {name}: mean {err.mean():.3e} > {mean} x "
            f"{gap.mean():.3e}")


def images(n, h, channels, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, h, W, channels)).astype(np.float32)


@pytest.mark.parametrize("packing", sorted(PACKING))
def test_bf16_encoder_matches_jax(nets, packing):
    jax_b, params, stats, port = nets
    h, _ = PACKING[packing]
    x = images(2, h, 3, 1)
    want = {dt: run_jax(jax_b[dt].encoder,
                        variables(params, stats, "encoder"), jnp.asarray(x))
            for dt in DTYPES}
    with torch.no_grad():
        got = {dt: port[dt].encoder(nchw(x)) for dt in DTYPES}
    assert all(t.dtype == torch.bfloat16 for t in got["bfloat16"])
    assert all(t.dtype == torch.float32 for t in got["float32"])
    for level in range(5):
        within_gap(nhwc(got["bfloat16"][level]), nhwc(got["float32"][level]),
                   as_np(want["bfloat16"][level]),
                   as_np(want["float32"][level]), f"level {level}")


@pytest.mark.parametrize("packing", sorted(PACKING))
def test_bf16_depth_decoder_matches_jax(nets, packing):
    """Disparities (float32 at both dtypes) from the same float32 encoder
    features, which each decoder casts to its dtype."""
    jax_b, params, stats, port = nets
    _, packed_tail = PACKING[packing]
    feats = run_jax(jax_b["float32"].encoder,
                    variables(params, stats, "encoder"),
                    jnp.asarray(images(2, H, 3, 2)))
    want = {dt: run_jax(jax_b[dt].depth.clone(packed_tail=packed_tail),
                        variables(params, stats, "depth"), feats)
            for dt in DTYPES}
    with torch.no_grad():
        got = {dt: port[dt].depth([nchw(f) for f in feats]) for dt in DTYPES}
    for s in range(4):
        assert got["bfloat16"][s].dtype == torch.float32
        within_gap(nhwc(got["bfloat16"][s]), nhwc(got["float32"][s]),
                   np.asarray(want["bfloat16"][s]),
                   np.asarray(want["float32"][s]), f"scale {s}")


@pytest.mark.parametrize("packing", sorted(PACKING))
def test_bf16_pose_network_matches_jax(nets, packing):
    """Axis-angle and translation (float32 at both dtypes) of the pose
    encoder and decoder on stacked frame pairs."""
    jax_b, params, stats, port = nets
    h, _ = PACKING[packing]
    pairs = images(4, h, 6, 3)
    want = {}
    for dt in DTYPES:
        feats = run_jax(jax_b[dt].pose_encoder,
                        variables(params, stats, "pose_encoder"),
                        jnp.asarray(pairs))
        aa, tt = jax.jit(jax_b[dt].pose.apply)({"params": params["pose"]},
                                               [feats])
        want[dt] = np.concatenate([np.asarray(aa), np.asarray(tt)], -1)
    got = {}
    with torch.no_grad():
        for dt in DTYPES:
            aa, tt = port[dt].pose([port[dt].pose_encoder(nchw(pairs))])
            assert aa.dtype == tt.dtype == torch.float32
            got[dt] = torch.cat([aa, tt], -1).numpy()
    within_gap(got["bfloat16"], got["float32"], want["bfloat16"],
               want["float32"], "pose")


def test_bf16_batchnorm_matches_flax():
    """Train mode on a bfloat16 input: the running statistics (float32,
    formed from the input in float32 as flax does) to 1e-6 relative, the
    output to one bfloat16 rounding of flax's."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 16, 20, 8)) * 2.0 + 0.5).astype(np.float32)
    x16 = jnp.asarray(x, jnp.bfloat16)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    mean = rng.normal(size=8).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.bfloat16)
    want, new = bn.apply({"params": {"scale": scale, "bias": bias},
                          "batch_stats": {"mean": mean, "var": var}}, x16,
                         mutable=["batch_stats"])
    assert want.dtype == jnp.bfloat16

    port = BatchNorm2d(8, torch.bfloat16).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean))
        port.running_var.copy_(torch.from_numpy(var))
        got = port(nchw(np.asarray(x16.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    assert port.running_mean.dtype == torch.float32
    for key, buf in (("mean", port.running_mean), ("var", port.running_var)):
        np.testing.assert_allclose(buf.numpy(), new["batch_stats"][key],
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    want = as_np(want)
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(nhwc(got) - want) <= ulp)


def test_kernels_refuse_bfloat16():
    """A kernel wrapper given a bfloat16 tensor raises; it never converts
    it (the step hands the kernels float32 at either dtype)."""
    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K

    image = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    grid = torch.zeros((1, 2, 8, 8))
    plane = torch.zeros((1, 3, 8, 8))
    calls = [lambda: K.warp_reproj_loss(image, grid.bfloat16(), plane),
             lambda: K.warp_reproj_loss(image, grid, plane.bfloat16()),
             lambda: K.reproj_loss(plane.bfloat16(), plane),
             lambda: K.warp(image, grid.bfloat16())]
    for call in calls:
        with pytest.raises((TypeError, ValueError)):
            call()


def test_defaults_train_in_bf16(tmp_path):
    """cli.train with no --compute_dtype trains the bfloat16 networks:
    parameters, gradients and Adam's moments float32, losses finite."""
    from unsupervised_pose_estimation_tpu_torch.cli.train import main

    trainer = main(["--dataset", "synthetic_parallax", "--height", str(H),
                    "--width", str(W), "--batch_size", "2",
                    "--steps_per_epoch", "2", "--num_epochs", "1",
                    "--weights_init", "scratch", "--num_workers", "2",
                    "--log_dir", str(tmp_path)], device="cpu")
    assert trainer.cfg.compute_dtype == "bfloat16"
    assert trainer.bundle.encoder.compute_dtype == torch.bfloat16
    assert trainer.state.step == 2
    tensors = [*trainer.bundle.parameters(),
               *(p.grad for p in trainer.bundle.parameters()),
               *(t for st in trainer.state.optimizer.state.values()
                 for t in st.values())]
    assert all(t.dtype == torch.float32 for t in tensors)
    records = (tmp_path / "mdp" / "metrics.jsonl").read_text()
    assert '"loss"' in records and "NaN" not in records


def test_defaults_serve_in_bf16():
    """InferenceEngine(Options()) runs the bfloat16 networks and returns
    float32 disparities in (0, 1)."""
    from unsupervised_pose_estimation_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine(Options(height=H, width=W), max_batch=2,
                             device="cpu")
    assert engine.bundle.depth.compute_dtype == torch.bfloat16
    images = np.random.default_rng(5).integers(0, 256, (2, H, W, 3),
                                               dtype=np.uint8)
    disp = engine.predict(images)
    assert disp.dtype == np.float32 and disp.shape == (2, H, W)
    assert 0 < disp.min() and disp.max() < 1
