"""The PyTorch port's config and plain tensor ops against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; both
run in float32 on the CPU. Tolerances are stated per comparison.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_pose_estimation_tpu import config as jcfg
from unsupervised_pose_estimation_tpu.ops import geometry as JG
from unsupervised_pose_estimation_tpu.ops import losses as JL
from unsupervised_pose_estimation_tpu.ops import resize as JR
from unsupervised_pose_estimation_tpu.ops import warp as JW
from unsupervised_pose_estimation_tpu_torch import config as tcfg
from unsupervised_pose_estimation_tpu_torch.ops import geometry as TG
from unsupervised_pose_estimation_tpu_torch.ops import losses as TL
from unsupervised_pose_estimation_tpu_torch.ops import resize as TR
from unsupervised_pose_estimation_tpu_torch.ops import warp as TW

# float32 results of the same formula evaluated by XLA and by PyTorch: they
# differ by a few ulp from reassociation and libm (sin, cos, exp).
RTOL, ATOL = 1e-5, 1e-6


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def test_options_have_the_reference_fields_and_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(jcfg.Options)}
    port = {f.name: f.default for f in dataclasses.fields(tcfg.Options)}
    assert port == ref
    opt = jcfg.Options(height=64, width=128, scales=(0, 2), seed=3)
    back = tcfg.Options.from_json(opt.to_json())
    assert dataclasses.asdict(back) == dataclasses.asdict(opt)
    assert jcfg.Options.from_json(back.to_json()) == opt
    assert back.num_pose_frames == opt.num_pose_frames
    assert back.num_scales == opt.num_scales


def test_geometry_matches(rng_np):
    b, h, w = 3, 8, 12
    aa = rng_np.normal(scale=0.3, size=(b, 3)).astype(np.float32)
    tt = rng_np.normal(scale=0.5, size=(b, 3)).astype(np.float32)
    for invert in (False, True):
        close(TG.transformation_from_parameters(
            torch.from_numpy(aa), torch.from_numpy(tt), invert=invert),
            JG.transformation_from_parameters(aa, tt, invert=invert))
    K_norm = np.tile(np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0],
                               [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
                     (b, 1, 1))
    for s in range(3):
        close(TG.scaled_intrinsics(torch.from_numpy(K_norm), w, h, s),
              JG.scaled_intrinsics(jnp.asarray(K_norm), w, h, s))
    K = JG.scaled_intrinsics(jnp.asarray(K_norm), w, h, 0)
    close(TG.invert_intrinsics(torch.from_numpy(np.array(K))),
          JG.invert_intrinsics(K))
    disp = rng_np.uniform(size=(b, h, w, 1)).astype(np.float32)
    for t, j in zip(TG.disp_to_depth(torch.from_numpy(disp), 0.1, 100.0),
                    JG.disp_to_depth(disp, 0.1, 100.0)):
        close(t, j)
    depth = (1.0 + 5.0 * disp).astype(np.float32)
    inv_K = np.array(JG.invert_intrinsics(K))
    T = np.array(JG.transformation_from_parameters(aa * 0.1, tt * 0.1))
    jp = JG.backproject(jnp.asarray(depth), inv_K, homogeneous=False)
    tp = TG.backproject(torch.from_numpy(depth), torch.from_numpy(inv_K))
    close(tp, jp)
    # pixel coordinates of a projection: the perspective divide amplifies
    # the float32 noise of the camera points
    close(TG.project(tp, torch.from_numpy(np.array(K)), torch.from_numpy(T),
                     h, w),
          JG.project(jp, K, T, h, w, planar=True), atol=1e-5)


@pytest.mark.parametrize("shape,out", [((2, 8, 16, 1), (64, 128)),
                                       ((2, 32, 64, 1), (64, 128)),
                                       ((2, 64, 128, 1), (64, 128))])
def test_resize_bilinear_matches(rng_np, shape, out):
    x = rng_np.uniform(size=shape).astype(np.float32)
    close(TR.resize_bilinear(torch.from_numpy(x), *out),
          JR.resize_bilinear(jnp.asarray(x), *out))


def test_image_pyramid_matches_lanczos3(rng_np):
    x = rng_np.uniform(size=(2, 64, 128, 3)).astype(np.float32)
    tp = TR.image_pyramid(torch.from_numpy(x), 4)
    jp = JR.image_pyramid(jnp.asarray(x), 4)
    assert [tuple(t.shape) for t in tp] == [j.shape for j in jp]
    for t, j in zip(tp, jp):
        # weights built in numpy vs in XLA (sin, division) differ by ulps;
        # each chained level adds a 1e-6-sized sum of 12 weighted taps
        close(t, j, atol=5e-6)


@pytest.mark.parametrize("amp,dtype", [(0.05, np.uint8), (1.3, np.uint8),
                                       (1.3, np.float32)])
def test_grid_sample_matches(rng_np, amp, dtype):
    b, h, w = 2, 16, 24
    img = rng_np.integers(0, 256, size=(b, h, w, 3)).astype(dtype)
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    grid = (np.stack([xs, ys], 0)[None]
            + rng_np.uniform(-amp, amp, size=(b, 2, h, w))).astype(np.float32)
    # values are 0..255: the lerp keeps ~1e-5 relative precision
    close(TW.grid_sample(torch.from_numpy(img), torch.from_numpy(grid)),
          JW.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                         planar_grid=True), atol=2e-4)


def test_reprojection_losses_match(rng_np):
    p = rng_np.uniform(size=(2, 3, 16, 24)).astype(np.float32)
    t = np.clip(p + rng_np.normal(scale=0.1, size=p.shape), 0, 1).astype(
        np.float32)
    # SSIM divides by (sigma_p + sigma_t + C2) >= 9e-4: the rounding of the
    # variance terms is amplified up to ~1e3-fold
    close(TL._ssim_planar(torch.from_numpy(p), torch.from_numpy(t)),
          JL._ssim_planar(jnp.asarray(p), jnp.asarray(t)), atol=1e-5)
    for use_ssim in (True, False):
        close(TL.reprojection_loss_planar(torch.from_numpy(p),
                                          torch.from_numpy(t), use_ssim),
              JL.reprojection_loss_planar(jnp.asarray(p), jnp.asarray(t),
                                          use_ssim), atol=1e-5)


def test_smoothness_matches(rng_np):
    disp = rng_np.uniform(0.1, 1.0, size=(2, 16, 24, 1)).astype(np.float32)
    img = rng_np.uniform(size=(2, 16, 24, 3)).astype(np.float32)
    nd_t = TL.normalized_disp(torch.from_numpy(disp))
    nd_j = JL.normalized_disp(jnp.asarray(disp))
    close(nd_t, nd_j)
    close(TL.smooth_loss(nd_t, torch.from_numpy(img)),
          JL.smooth_loss(nd_j, jnp.asarray(img)))


@pytest.mark.parametrize("avg", [False, True])
def test_min_reprojection_matches_with_injected_noise(rng_np, avg):
    reproj = rng_np.uniform(size=(2, 8, 12, 2)).astype(np.float32)
    ident = rng_np.uniform(size=(2, 8, 12, 2)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    shape = (2, 8, 12, 1 if avg else 2)
    noise = np.array(jax.random.normal(key, shape, jnp.float32) * 1e-5)
    j_opt, j_mask = JL.min_reprojection(jnp.asarray(reproj),
                                        jnp.asarray(ident), key,
                                        avg_reprojection=avg)
    t_opt, t_mask = TL.min_reprojection(
        torch.from_numpy(reproj), torch.from_numpy(ident),
        noise=torch.from_numpy(noise), avg_reprojection=avg)
    close(t_opt, j_opt)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    t_opt, t_mask = TL.min_reprojection(torch.from_numpy(reproj), None)
    assert t_mask is None
    close(t_opt, JL.min_reprojection(jnp.asarray(reproj), None, key)[0])
