"""Training pieces of the port against the JAX package: device-side
augmentation (``batch_augment``), BatchNorm's train-mode semantics (flax's
``nn.BatchNorm``) and the learning-rate schedule (optax).

Inputs are made with numpy from a seed and handed to both packages; both
run in float32 on the CPU. Tolerances are stated per comparison.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unsupervised_pose_estimation_tpu.ops import augment_device as JA
from unsupervised_pose_estimation_tpu.train import state as JS
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.models.layers import BatchNorm2d
from unsupervised_pose_estimation_tpu_torch.ops import augment_device as TA
from unsupervised_pose_estimation_tpu_torch.train import state as TS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port, so that pytest's parallel workers
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def frames(b=6, f=3, h=16, w=24, seed=0):
    """Smooth colour gradients plus noise: every hue and some grey pixels
    (S == 0 after truncation), uint8 (B, F, H, W, 3)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    base = np.stack([xs, ys, 1 - xs * ys], -1)[None, None]
    img = base * rng.uniform(0.3, 1.0, size=(b, f, 1, 1, 3))
    img = img + rng.normal(scale=0.05, size=(b, f, h, w, 3))
    img[:, :, :2, :2] = 0.5  # grey corner
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


# rows: [enabled, brightness, contrast, saturation, hue, autocontrast]
PARAMS = np.array([
    [1.0, 1.15, 0.85, 1.1, 0.07, 1.0],    # all stages, autocontrast on
    [1.0, 0.85, 1.2, 0.9, -0.05, 0.0],    # negative hue, no autocontrast
    [1.0, 1.05, 1.1, 0.8, 0.0, 1.0],      # hue 0: the HSV stage skipped
    [1.0, 0.9, 0.95, 1.2, 0.003, 0.0],    # |hue| < 1/255: shift 0, skipped
    [0.0, 1.2, 1.2, 1.2, 0.1, 1.0],       # disabled: pass-through
    [1.0, 1.2, 0.8, 1.2, -0.1, 1.0],
], np.float32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_batch_augment_matches_jax(dtype):
    """Every stage floors onto the 0..255 grid, so both packages land on
    the same integers: exact, in both packed and unpacked JAX forms (the
    per-frame sums are integers below 2**24, exact in float32)."""
    color = frames()
    if dtype == "float32":
        color = color.astype(np.float32) / 255.0
    got = TA.batch_augment(torch.from_numpy(color),
                           torch.from_numpy(PARAMS)).numpy()
    want = np.asarray(JA.batch_augment(jnp.asarray(color),
                                       jnp.asarray(PARAMS)))
    assert got.shape == color.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    packed = np.asarray(JA.batch_augment(jnp.asarray(color),
                                         jnp.asarray(PARAMS), packed=True))
    b, f, h, w, c = color.shape
    unpacked = packed.reshape(b, f, h // 2, w // 2, 2, 2, c).transpose(
        0, 1, 2, 4, 3, 5, 6).reshape(color.shape)
    np.testing.assert_array_equal(got, unpacked)
    # the disabled row passes through (x * float32(1/255), as both do);
    # the others changed
    grid = color.astype(np.float32) * np.float32(
        1.0 if dtype == "uint8" else 255.0)
    unit = grid * np.float32(1.0 / 255.0)
    np.testing.assert_array_equal(got[4], unit[4])
    assert all((got[i] != unit[i]).any() for i in (0, 1, 2, 3, 5))


def test_hue_stage_is_skipped_at_shift_zero():
    color = frames(b=2, seed=1)
    params = np.array([[1, 1, 1, 1, 0.0, 0], [1, 1, 1, 1, 1 / 255.0, 0]],
                      np.float32)
    out = TA.batch_augment(torch.from_numpy(color),
                           torch.from_numpy(params)).numpy()
    unit = color.astype(np.float32) * np.float32(1.0 / 255.0)
    # unit factors and no hue shift: the identity on the 0..255 grid
    np.testing.assert_array_equal(out[0], unit[0])
    # a shift of one uint8 H unit runs the lossy HSV roundtrip
    assert (out[1] != unit[1]).any()


def test_batchnorm_train_matches_flax():
    """Output, running statistics and gradients of BatchNorm2d in train
    mode vs flax nn.BatchNorm(momentum 0.9, epsilon 1e-5), over two
    updates. float32 sums in other orders: rtol 1e-5 / atol 1e-5 on values
    of order 1."""
    rng = np.random.default_rng(2)
    n, c, h, w = 4, 8, 5, 7
    scale = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean0 = rng.normal(size=c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    tbn = BatchNorm2d(c)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(mean0))
        tbn.running_var.copy_(torch.from_numpy(var0))
    tbn.train()
    for _ in range(2):
        x = (rng.normal(size=(n, c, h, w)) * 2 + 3).astype(np.float32)
        cot = rng.normal(size=(n, c, h, w)).astype(np.float32)
        x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))

        def f(params, xx):
            out, upd = bn.apply({**variables, "params": params}, xx,
                                mutable=["batch_stats"])
            return jnp.sum(out * cot.transpose(0, 2, 3, 1)), (out, upd)

        (_, (want, upd)), grads = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(variables["params"], x_nhwc)
        variables = {"params": variables["params"],
                     "batch_stats": upd["batch_stats"]}
        tx = torch.from_numpy(x).requires_grad_()
        tbn.weight.grad = tbn.bias.grad = None
        got = tbn(tx)
        (got * torch.from_numpy(cot)).sum().backward()
        close = dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got.detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2),
            **close)
        np.testing.assert_allclose(
            tbn.running_mean.numpy(),
            np.asarray(upd["batch_stats"]["mean"]), **close)
        # the biased batch variance (nn.BatchNorm2d's own update would
        # take the unbiased one, n h w / (n h w - 1) = 1.007 times larger)
        np.testing.assert_allclose(
            tbn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
            **close)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(
            grads[1]).transpose(0, 3, 1, 2), **close)
        np.testing.assert_allclose(tbn.weight.grad.numpy(),
                                   np.asarray(grads[0]["scale"]), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(tbn.bias.grad.numpy(),
                                   np.asarray(grads[0]["bias"]), rtol=1e-5,
                                   atol=1e-4)
    assert int(tbn.num_batches_tracked) == 2
    # eval mode: the running statistics, as nn.BatchNorm2d
    tbn.eval()
    x = torch.from_numpy(rng.normal(size=(n, c, h, w)).astype(np.float32))
    ref = torch.nn.functional.batch_norm(
        x, tbn.running_mean, tbn.running_var, tbn.weight, tbn.bias,
        training=False, eps=1e-5)
    assert torch.equal(tbn(x).detach(), ref.detach())


@pytest.mark.parametrize("steps_per_epoch", [1, 3])
def test_lr_schedule_matches_optax(steps_per_epoch):
    """The "step" schedule against the reference's optax exponential_decay
    over 40 optimizer steps (float32 in optax, float64 here: rtol 1e-6),
    and "none" as the constant rate."""
    cfg = Options(lr_scheduler="step", scheduler_step_size=4,
                  learning_rate=2e-4)
    want = JS.lr_schedule(cfg, steps_per_epoch)
    got = TS.lr_schedule(cfg, steps_per_epoch)
    for count in range(40):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6)
    assert got(4 * steps_per_epoch) == pytest.approx(2e-5)
    none = Options(learning_rate=3e-4)
    assert JS.lr_schedule(none) == 3e-4
    assert [TS.lr_schedule(none)(k) for k in (0, 7, 1000)] == [3e-4] * 3
    with pytest.raises(ValueError):
        TS.lr_schedule(Options(lr_scheduler="cosine"))


def test_adam_update_matches_optax():
    """make_optimizer's Adam against optax.adam over three updates with a
    changing rate: the same arithmetic in another order, so parameters of
    order 1 may round one ulp apart (atol 1e-6, 0.1% of an update)."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3)]
    rates = [1e-3, 1e-3, 1e-4]
    tx = optax.adam(optax.piecewise_constant_schedule(1e-3, {2: 0.1}),
                    b1=0.9, b2=0.999, eps=1e-8)
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = TS.make_optimizer([tp], rates[0])
    for g, lr in zip(grads, rates):
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.param_groups[0]["lr"] = lr
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=1e-6)
