"""Gradients of the port against the JAX package: the backward kernels' plain
versions (K2, K4), the autograd Functions around K1, K3 and K5, and the
tie and clamp gradients of ``min_reprojection`` and ``unnormalize``.

Inputs are made with numpy from a seed. The JAX side runs its Pallas
kernels in interpret mode, or its XLA path, as its own tests do. The CUDA
kernels are compared with these plain versions on the card by
``chip_smoke.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_pose_estimation_tpu.ops import losses as JL
from unsupervised_pose_estimation_tpu.ops import warp as JW
from unsupervised_pose_estimation_tpu.ops.pallas import warp_loss as JWL
from unsupervised_pose_estimation_tpu.ops.pallas.reproj_loss import \
    _backward as j_reproj_backward
from unsupervised_pose_estimation_tpu.ops.pallas.reproj_loss import \
    reprojection_loss_pallas_planar
from unsupervised_pose_estimation_tpu.ops.pallas.warp_kernel import \
    grid_sample_fast
from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
from unsupervised_pose_estimation_tpu_torch.ops.kernels.reproj_loss import \
    ssim_l1_grads_plain
from unsupervised_pose_estimation_tpu_torch.ops import losses as TL
from unsupervised_pose_estimation_tpu_torch.ops import warp as TW

# the module: the package's name ``reproj_loss`` is the wrapper function
reproj_loss_mod = importlib.import_module(
    "unsupervised_pose_estimation_tpu_torch.ops.kernels.reproj_loss")

# The closed-form adjoints and autodiff of the composed graph associate the
# float32 sums differently; the reference's own fused-gradient test holds
# them at rtol 1e-4 / atol 2e-5 (tests/test_pallas_ops.py).
RTOL, ATOL = 1e-4, 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port, so that pytest's parallel workers
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_grid_grads_close(got, want):
    """rtol 1e-4 and an absolute floor of 1e-6 of the largest gradient:
    the float32 noise of the window sums scales with it (up to ~130 for
    these uint8 frames; JAX's fused kernel and its XLA autodiff differ by
    up to 1.1e-6 of it on these inputs, the port by as much)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


def warp_inputs(kind, b=1, h=48, w=128, c=3, seed=0):
    """uint8 source (B, H, W, C), planar float target and planar grid:
    "small" is a smooth sub-pixel motion, "border" the same with the four
    border lines exactly at -1 and 1, where the coordinate clamp ties."""
    rng = np.random.default_rng(seed)
    img8 = rng.integers(0, 256, size=(b, h, w, c)).astype(np.uint8)
    target = rng.uniform(size=(b, c, h, w)).astype(np.float32)
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    grid = np.stack([xs, ys], 0)[None].repeat(b, 0)
    grid = grid + rng.uniform(-0.02, 0.02, size=grid.shape)
    if kind == "border":
        grid[:, :, [0, -1], :] = [[[-1.0], [1.0]]]
        grid[:, :, :, [0, -1]] = [-1.0, 1.0]
    return img8, target, grid.astype(np.float32)


def port_grid_grad(op, img8, target, grid):
    """d sum(loss^2) / d grid through a port op on the CPU."""
    g = torch.from_numpy(grid).requires_grad_()
    loss = op(torch.from_numpy(img8), g, torch.from_numpy(target))
    (loss ** 2).sum().backward()
    return g.grad.numpy()


def jax_composed(img8, target):
    """sum(loss^2) of XLA grid_sample + the jnp reprojection loss."""
    def f(g):
        warped = JW.grid_sample(jnp.asarray(img8), jnp.moveaxis(g, 1, -1))
        warped = jnp.moveaxis(warped / 255.0, -1, 1)
        return jnp.sum(JL.reprojection_loss_planar(
            warped, jnp.asarray(target)) ** 2)
    return f


@pytest.mark.parametrize("kind", ["small", "border"])
def test_warp_reproj_loss_grid_gradient_matches_jax(kind):
    """K1 + K2 through WarpReprojLoss vs jax.grad of the fused Pallas op
    (interpret mode) and of the composed XLA graph."""
    img8, target, grid = warp_inputs(kind)
    got = port_grid_grad(K.warp_reproj_loss_op, img8, target, grid)

    def fused(g):
        return jnp.sum(JWL.warp_reproj_loss(
            jnp.asarray(img8), g, jnp.asarray(target), interpret=True) ** 2)

    want_fused = jax.grad(fused)(jnp.asarray(grid))
    want_xla = jax.grad(jax_composed(img8, target))(jnp.asarray(grid))
    assert_grid_grads_close(got, want_fused)
    assert_grid_grads_close(got, want_xla)
    if kind == "border":
        # the clamp's tie: half the gradient on the border lines
        assert np.abs(got[:, 0, :, 0]).max() > 0


@pytest.mark.parametrize("kind", ["small", "border"])
def test_warp_grid_gradient_matches_jax(kind):
    """K5 through Warp, then the K3/K4 loss (the unfused training path),
    vs jax.grad of grid_sample_fast (interpret mode) + the Pallas loss and
    of the composed XLA graph."""
    img8, target, grid = warp_inputs(kind)

    def unfused(image, g, t):
        return K.reproj_loss_op(K.warp_op(image, g)[0], t)

    got = port_grid_grad(unfused, img8, target, grid)

    def pallas(g):
        # the Pallas warp returns a uint8 source in [0, 1] units
        warped = grid_sample_fast(jnp.asarray(img8), g, interpret=True,
                                  planar_out=True, planar_grid=True)
        return jnp.sum(reprojection_loss_pallas_planar(
            warped, jnp.asarray(target), True) ** 2)

    want = jax.grad(pallas)(jnp.asarray(grid))
    want_xla = jax.grad(jax_composed(img8, target))(jnp.asarray(grid))
    assert_grid_grads_close(got, want)
    assert_grid_grads_close(got, want_xla)


def test_warp_reproj_loss_bwd_plain_matches_pallas():
    """K2's plain version vs the Pallas backward kernel, which takes the
    forward's residual planes (here ``warp_plain``'s), on the same upstream
    gradient (B=2, C=3, 64x128)."""
    img8, target, grid = (torch.from_numpy(a) for a in warp_inputs(
        "small", b=2, h=64, w=128, seed=1))
    g = torch.from_numpy(
        np.random.default_rng(2).normal(size=(2, 64, 128)).astype(np.float32))
    gx, gy = K.warp_reproj_loss_bwd_plain(img8, grid, target, g)
    warped, ddx, ddy = K.warp_plain(img8, grid)
    jgx, jgy = JWL._warp_loss_bwd_call(
        *(jnp.asarray(t.numpy()) for t in (warped, target, ddx, ddy, g)),
        interpret=True)
    scale = float(np.abs(np.asarray(jgx)).max())
    # the same closed form in the same order, but XLA and PyTorch round
    # the moments' sums in other places: held at 1e-5 of the largest value
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jgy),
                               atol=1e-5 * scale)


@pytest.mark.parametrize("kind", ["small", "border"])
def test_warp_reproj_loss_bwd_plain_equals_residual_form(kind):
    """The plain K2, which warps again, equals bit for bit the form that
    contracted the forward's saved warped / ddx / ddy planes."""
    img8, target, grid = (torch.from_numpy(a) for a in warp_inputs(
        kind, b=2, h=32, w=64, seed=3))
    g = torch.from_numpy(
        np.random.default_rng(4).normal(size=(2, 32, 64)).astype(np.float32))
    warped, ddx, ddy = K.warp_plain(img8, grid)
    gp = ssim_l1_grads_plain(warped, target, g, with_target=False)[0]
    want_x, want_y = gp[:, 0] * ddx[:, 0], gp[:, 0] * ddy[:, 0]
    for ch in range(1, gp.shape[1]):
        want_x = want_x + gp[:, ch] * ddx[:, ch]
        want_y = want_y + gp[:, ch] * ddy[:, ch]
    gx, gy = K.warp_reproj_loss_bwd_plain(img8, grid, target, g)
    assert torch.equal(gx, want_x) and torch.equal(gy, want_y)


def test_fused_op_saves_no_residual_planes():
    """WarpReprojLoss keeps the frame, the grid and the target for its
    backward, and no (B, C, H, W) float plane besides the target."""
    img8, target, grid = (torch.from_numpy(a) for a in warp_inputs(
        "small", b=2, h=16, w=24))
    g = grid.clone().requires_grad_()
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = K.warp_reproj_loss_op(img8, g, target)
    assert [(t.dtype, tuple(t.shape), t.data_ptr()) for t in saved] == [
        (torch.uint8, (2, 16, 24, 3), img8.data_ptr()),
        (torch.float32, (2, 2, 16, 24), g.data_ptr()),
        (torch.float32, (2, 3, 16, 24), target.data_ptr())]
    planes = [t for t in saved if t.is_floating_point()
              and tuple(t.shape) == tuple(target.shape)]
    assert len(planes) == 1 and planes[0].data_ptr() == target.data_ptr()
    loss.sum().backward()
    assert torch.isfinite(g.grad).all() and g.grad.abs().max() > 0


def test_reproj_loss_bwd_plain_matches_pallas_and_autodiff():
    """K4's plain version and ReprojLoss vs the Pallas backward kernel and
    jax.grad (both arguments) of the Pallas op and of the jnp loss."""
    rng = np.random.default_rng(3)
    p = rng.uniform(size=(2, 3, 48, 128)).astype(np.float32)
    t = rng.uniform(size=(2, 3, 48, 128)).astype(np.float32)
    g = rng.normal(size=(2, 48, 128)).astype(np.float32)
    gp, gt = K.reproj_loss_bwd_plain(*map(torch.from_numpy, (p, t, g)))
    jgp, jgt = j_reproj_backward(*map(jnp.asarray, (p, t, g)), True)
    for got, want in ((gp, jgp), (gt, jgt)):
        scale = float(np.abs(np.asarray(want)).max())
        # as above: 1e-5 of the largest value
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5 * scale)

    tp = torch.from_numpy(p).requires_grad_()
    tt = torch.from_numpy(t).requires_grad_()
    (K.reproj_loss_op(tp, tt) ** 2).sum().backward()

    def pallas(a, b):
        return jnp.sum(reprojection_loss_pallas_planar(a, b, True) ** 2)

    def xla(a, b):
        return jnp.sum(JL.reprojection_loss_planar(a, b) ** 2)

    for fn in (pallas, xla):
        want = jax.grad(fn, argnums=(0, 1))(jnp.asarray(p), jnp.asarray(t))
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want[0]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want[1]),
                                   rtol=RTOL, atol=ATOL)


def test_reproj_loss_bwd_plain_without_target_gives_the_same_gp():
    """K4's plain version without the target's gradient: the same dL/dpred
    bits as the call with both, and None for the target."""
    rng = np.random.default_rng(8)
    p, t = (torch.from_numpy(rng.uniform(size=(2, 3, 10, 13)).astype(
        np.float32)) for _ in range(2))
    g = torch.from_numpy(rng.normal(size=(2, 10, 13)).astype(np.float32))
    gp, gt = K.reproj_loss_bwd_plain(p, t, g)
    gp_only, none = K.reproj_loss_bwd_plain(p, t, g, with_target=False)
    assert none is None and gt is not None
    assert torch.equal(gp_only, gp)


def test_reproj_loss_op_asks_for_the_target_gradient_only_when_recorded(
        monkeypatch):
    """ReprojLoss passes ``with_target`` = whether the target's gradient is
    recorded; with a target that needs none (the training step's input
    frames), pred.grad is the same bits as with both recorded."""
    rng = np.random.default_rng(9)
    p, t = (rng.uniform(size=(2, 3, 12, 16)).astype(np.float32)
            for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(2, 12, 16, 1)).astype(np.float32))
    modes = []
    bwd = reproj_loss_mod.reproj_loss_bwd

    def spy(*args, with_target=True):
        modes.append(with_target)
        return bwd(*args, with_target=with_target)

    monkeypatch.setattr(reproj_loss_mod, "reproj_loss_bwd", spy)
    grads = []
    for target_grad in (True, False):
        tp = torch.from_numpy(p).requires_grad_()
        tt = torch.from_numpy(t).requires_grad_(target_grad)
        (K.reproj_loss_op(tp, tt) * w).sum().backward()
        assert (tt.grad is not None) == target_grad
        grads.append(tp.grad)
    assert modes == [True, False]
    assert torch.equal(grads[0], grads[1])


def test_min_reprojection_splits_tied_gradients_like_jax():
    """Where two reprojection maps tie at the min, jnp.min's gradient is
    0.5 to each; torch.min(...).values gave 1 to one of them (0.5 max
    error before the repair)."""
    rng = np.random.default_rng(4)
    reproj = rng.uniform(0.1, 0.5, size=(2, 8, 12, 2)).astype(np.float32)
    tie = rng.uniform(size=(2, 8, 12)) < 0.5
    reproj[..., 1] = np.where(tie, reproj[..., 0], reproj[..., 1])
    identity = rng.uniform(0.6, 0.9, size=(2, 8, 12, 2)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, identity.shape,
                                         jnp.float32) * 1e-5)

    def jfn(r):
        return jnp.mean(JL.min_reprojection(r, jnp.asarray(identity),
                                            key)[0])

    want = np.asarray(jax.grad(jfn)(jnp.asarray(reproj)))
    r = torch.from_numpy(reproj).requires_grad_()
    TL.min_reprojection(r, torch.from_numpy(identity),
                        noise=torch.from_numpy(noise))[0].mean().backward()
    # exact: halves and wholes of 1 / (B H W)
    np.testing.assert_array_equal(r.grad.numpy(), want)
    np.testing.assert_array_equal(want[tie], 0.5 * want[~tie].max())
    # without automasking, the min over the sources alone
    r.grad = None
    TL.min_reprojection(r, None)[0].mean().backward()
    want = np.asarray(jax.grad(lambda a: jnp.mean(JL.min_reprojection(
        a, None, key)[0]))(jnp.asarray(reproj)))
    np.testing.assert_array_equal(r.grad.numpy(), want)


def test_unnormalize_clamp_gradient_is_half_at_the_bounds():
    """jnp.clip's gradient is 0.5 exactly at a bound; torch.clamp's is 1.
    Checked through the plain grid_sample (autograd of unnormalize) and
    through grid_cotangent (the Functions' hand-written backward), on a
    grid whose border lines sit exactly at -1 and 1 (1.0 of 2.0 error
    there before the repair)."""
    img8, _, grid = warp_inputs("border", h=16, w=24, seed=6)
    weights = np.random.default_rng(7).normal(
        size=(1, 16, 24, 3)).astype(np.float32)

    def jfn(g):
        return jnp.sum(JW.grid_sample(jnp.asarray(img8), g, planar_grid=True)
                       * weights)

    want = np.asarray(jax.grad(jfn)(jnp.asarray(grid)))
    g = torch.from_numpy(grid).requires_grad_()
    (TW.grid_sample(torch.from_numpy(img8), g)
     * torch.from_numpy(weights)).sum().backward()
    # lerp arithmetic in another order: float32 noise of values ~1e3
    np.testing.assert_allclose(g.grad.numpy(), want, rtol=1e-5, atol=1e-3)
    ones = torch.ones(1, 16, 24)
    cot = TW.grid_cotangent(torch.from_numpy(grid), ones, ones).numpy()
    assert (cot[:, 0, :, 0] == 0.5 * 0.5 * 23).all()
    assert (cot[:, 1, 0, 1:-1] == 0.5 * 0.5 * 15).all()
    inner = np.abs(grid) < 1.0
    np.testing.assert_array_equal(cot[:, 0][inner[:, 0]], 0.5 * 23)


def test_raw_wrappers_refuse_recorded_gradients_and_ops_do_not():
    img8, target, grid = (torch.from_numpy(a)
                          for a in warp_inputs("small", h=16, w=24))
    g = grid.clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        K.warp_reproj_loss(img8, g, target)
    with torch.no_grad():
        K.warp_reproj_loss(img8, g, target)
    K.reset_counts()
    loss = K.warp_reproj_loss_op(img8, g, target)
    assert loss.requires_grad and loss.shape == (1, 16, 24, 1)
    loss.sum().backward()
    assert g.grad is not None and torch.isfinite(g.grad).all()
    # the CPU runs the plain versions, and counts no launch
    assert set(K.counts().values()) == {0}
