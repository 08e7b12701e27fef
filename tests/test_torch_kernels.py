"""Plain versions of the port's CUDA kernels against the JAX package's Pallas
kernels run in interpret mode, and the wrappers' CPU contract.

K1 (fused warp + loss), K3 (SSIM + L1 loss) and K5 (warp) are compared at
B=2, C=3, 64x128 on inputs made with numpy from a seed. The CUDA kernels
themselves are compared with these plain versions on the card by
``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_pose_estimation_tpu.ops.pallas import \
    reprojection_loss_pallas_planar
from unsupervised_pose_estimation_tpu.ops.pallas.warp_kernel import (
    LANE, _sample_impl, _v8_inputs)
from unsupervised_pose_estimation_tpu.ops.pallas.warp_loss import \
    _impl as _warp_loss_impl
from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
from unsupervised_pose_estimation_tpu_torch.ops.kernels import _lib

B, C, H, W = 2, 3, 64, 128


@pytest.fixture(scope="module")
def jax_kernels():
    """The Pallas kernels in interpret mode, jitted once per module."""
    return dict(
        warp=jax.jit(functools.partial(_sample_impl, 8, True)),
        warp_loss=jax.jit(functools.partial(_warp_loss_impl, True)),
        loss=jax.jit(functools.partial(reprojection_loss_pallas_planar,
                                       interpret=True)))


def make_inputs(kind, seed=0):
    """uint8 source (B, H, W, C), planar float target, planar grid: "small"
    is a sub-pixel shift plus jitter (JAX's v8 miniband rung), "wild" is
    uniform over [-1.3, 1.3] with the border lines at exactly -1 and 1
    (JAX's lower rungs and exact gather)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, size=(B, H, W, C)).astype(np.uint8)
    target = rng.uniform(size=(B, C, H, W)).astype(np.float32)
    ys, xs = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    base = np.stack([xs, ys], 0)[None].repeat(B, 0)
    if kind == "small":
        grid = base + 0.01 + rng.uniform(-0.005, 0.005, size=base.shape)
    else:
        grid = rng.uniform(-1.3, 1.3, size=base.shape)
        grid[:, :, [0, -1], :] = [[[-1.0], [1.0]]]
        grid[:, :, :, [0, -1]] = [-1.0, 1.0]
    return src, target, grid.astype(np.float32)


def jax_xy(grid):
    """The clamped pixel coordinates the JAX ops feed their kernels."""
    g = jnp.asarray(grid)
    x = jnp.clip((g[:, 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    y = jnp.clip((g[:, 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    return x, y


def takes_v8_rung(src, grid):
    """JAX's own gate: does this grid take the v8 (and fused v9) rung?"""
    x, y = jax_xy(grid)
    x0i = jnp.minimum(jnp.floor(x), W - 2).astype(jnp.int32)
    y0i = jnp.minimum(jnp.floor(y), H - 2).astype(jnp.int32)
    col_group = (jnp.arange(W) // LANE)[None, None, :]
    shift_ok = jnp.logical_and(jnp.all(x0i // LANE - col_group >= -1),
                               jnp.all((x0i + 1) // LANE - col_group <= 1))
    return bool(_v8_inputs(jnp.asarray(src), x0i, y0i, shift_ok, H, W)[0])


def assert_planes_close(got, want, atol):
    """ddx / ddy jump where floor() of a coordinate changes: a coordinate
    one ulp apart in the two packages picks the neighbouring taps there.
    Bound the share of such pixels (0.1%) and the error everywhere else."""
    got, want = got.numpy(), np.asarray(want)
    bad = np.abs(got - want) > atol
    assert bad.mean() <= 1e-3, f"{bad.mean():.2%} of values differ"


@pytest.mark.parametrize("kind", ["small", "wild"])
def test_warp_plain_matches_pallas(jax_kernels, kind):
    src, _, grid = make_inputs(kind)
    assert takes_v8_rung(src, grid) == (kind == "small")
    j_warped, j_ddx, j_ddy = jax_kernels["warp"](jnp.asarray(src),
                                                 *jax_xy(grid))
    warped, ddx, ddy = K.warp_plain(torch.from_numpy(src),
                                    torch.from_numpy(grid))
    # values in [0, 1]; JAX's lower rungs scale before the lerp, v8 and the
    # port after it: a few ulp
    np.testing.assert_allclose(warped.numpy(), np.asarray(j_warped),
                               atol=1e-6)
    assert_planes_close(ddx, j_ddx, 1e-5)
    assert_planes_close(ddy, j_ddy, 1e-5)


@pytest.mark.parametrize("kind", ["small", "wild"])
def test_reproj_loss_plain_matches_pallas(jax_kernels, kind):
    src, target, grid = make_inputs(kind)
    pred = K.warp_plain(torch.from_numpy(src), torch.from_numpy(grid))[0]
    want = jax_kernels["loss"](jnp.asarray(pred.numpy()),
                               jnp.asarray(target))
    got = K.reproj_loss_plain(pred, torch.from_numpy(target))
    assert got.shape == (B, H, W, 1)
    # SSIM divides by (sigma_p + sigma_t + C2) >= 9e-4, which amplifies the
    # float32 rounding of the variances; the Pallas kernel also sums the
    # reflect edges in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("kind", ["small", "wild"])
def test_warp_reproj_loss_plain_matches_pallas(jax_kernels, kind):
    src, target, grid = make_inputs(kind)
    j_loss, j_warped, j_ddx, j_ddy = jax_kernels["warp_loss"](
        jnp.asarray(src), *jax_xy(grid), jnp.asarray(target))
    loss, warped, ddx, ddy = K.warp_reproj_loss_plain(
        torch.from_numpy(src), torch.from_numpy(grid),
        torch.from_numpy(target), residuals=True)
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), atol=1e-5)
    np.testing.assert_allclose(warped.numpy(), np.asarray(j_warped),
                               atol=1e-6)
    assert_planes_close(ddx, j_ddx, 1e-5)
    assert_planes_close(ddy, j_ddy, 1e-5)
    alone = K.warp_reproj_loss_plain(torch.from_numpy(src),
                                     torch.from_numpy(grid),
                                     torch.from_numpy(target))
    assert torch.equal(alone, loss)


def test_wrappers_run_the_plain_versions_on_cpu_without_counting():
    src, target, grid = (torch.from_numpy(a) for a in make_inputs("small"))
    _lib.reset_counts()
    for got, want in [
            (K.warp(src, grid), K.warp_plain(src, grid)),
            ((K.reproj_loss(target, target),),
             (K.reproj_loss_plain(target, target),)),
            ((K.warp_reproj_loss(src, grid, target),),
             (K.warp_reproj_loss_plain(src, grid, target),)),
            (K.warp_reproj_loss(src, grid, target, True),
             K.warp_reproj_loss_plain(src, grid, target, True))]:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    x0i = torch.zeros((B, H, W), dtype=torch.int32)
    blocks = torch.zeros((B, H // 8, 1), dtype=torch.int32)
    planes = target.reshape(B * C, H, W)
    for got, want in [
            (K.fetch_corners(planes, x0i, x0i, blocks, 40),
             K.fetch_corners_plain(planes, x0i, x0i, blocks, 40)),
            (K.fetch_corners_packed(src, x0i, x0i, blocks[:, ::2], 40),
             K.fetch_corners_packed_plain(src, x0i, x0i, blocks[:, ::2],
                                          40)),
            (K.fetch_corners_packed_v7(src, x0i, x0i, blocks.new_zeros(
                (B, H, W // 128))),
             K.fetch_corners_packed_v7_plain(src, x0i, x0i, blocks.new_zeros(
                 (B, H, W // 128))))]:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.counts() == {"warp_reproj_loss": 0, "reproj_loss": 0,
                          "warp": 0, "warp_reproj_loss_bwd": 0,
                          "reproj_loss_bwd": 0, "fetch_corners": 0,
                          "fetch_corners_packed": 0,
                          "fetch_corners_packed_v7": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    src, target, grid = (torch.from_numpy(a) for a in make_inputs("small"))
    with pytest.raises(NotImplementedError):
        K.warp(src, grid.clone().requires_grad_())
    with pytest.raises(NotImplementedError):
        K.reproj_loss(target.clone().requires_grad_(), target)
    with pytest.raises(TypeError):
        K.warp(src.float(), grid)
    with pytest.raises(ValueError):
        K.warp(src, grid[:, :, :-1])
    with pytest.raises(ValueError):
        K.warp_reproj_loss(src, grid, target[:, :2])
    with pytest.raises(ValueError):
        K.reproj_loss(target, target.to("meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.build()
    # the library name follows the sources and flags
    assert _lib.library_path() == _lib.library_path()
    assert _lib.library_path().parent == tmp_path / "_build"
