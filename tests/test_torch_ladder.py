"""The port's warp ladder (``ops.kernels.grid_sample_fast`` at
``pallas_warp_version`` 1-8) and the steps that route through it, against
the JAX package.

- Rungs: on grids swept across the edges of every gate (band heights,
  band alignment, the 128-column window, image shapes that rule rungs
  out), the port runs the rung the reference's ``_sample_impl`` takes. The
  reference's choice is read with its kernels replaced by stand-ins that
  record, through ``jax.debug.callback``, which of them ran (a callback
  inside a ``lax.cond`` branch runs only when the branch is taken).
- Values and coordinate gradients: against ``grid_sample_fast(interpret=
  True)`` for versions 1-8, uint8 frames with planar grids and float
  frames with NHWC grids, on a small-motion grid (the top rung), a vertical
  wave of +-20 rows at H=128 (wide-band v3) and a wild grid (the gather),
  with the rung asserted on each. The objective (the sum of squares) and
  the bounds are the JAX package's own (``tests/test_pallas_ops.py``):
  values 1e-6, coordinate gradients rtol and atol 1e-5, plus 1e-6 of the
  largest gradient. That last term is the port's: XLA on the CPU fuses the
  lerp's multiply-adds and the port rounds each operation, so ddx differs
  in the last bit on most pixels (the coordinates agree bit for bit), and
  a gradient is a sum over channels of terms up to ~300, which cancel to
  near 0 at some pixels and leave a few ulp of 300 there (read: at most
  6.1e-5, 2e-7 of the largest gradient).
- The validation step at versions 3 and 7 against the JAX eval step with
  its Pallas warp and loss in interpret mode; a training step at version 7
  against the port's own unfused version-8 step (K5): the ladder's
  gradient is K5's contraction, and its agreement with JAX is held above.
"""

import copy
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_pose_estimation_tpu.config import Options as JOptions
from unsupervised_pose_estimation_tpu.ops.pallas import warp_kernel as wk
from unsupervised_pose_estimation_tpu.train.bundle import \
    ModelBundle as JBundle
from unsupervised_pose_estimation_tpu.train.state import TrainState
from unsupervised_pose_estimation_tpu.train.step import \
    build_eval_step as j_build_eval_step
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.convert import from_jax
from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
from unsupervised_pose_estimation_tpu_torch.train import step as tstep
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle
from unsupervised_pose_estimation_tpu_torch.train.state import \
    create_train_state

C = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port, so that pytest's parallel workers
    do not oversubscribe the cores (its many small ops slow down tenfold
    and more when they do)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def normalized(x, y, h, w):
    """Pixel coordinates (B, H, W) -> the planar [-1, 1] grid (B, 2, H, W)."""
    return np.stack([x * (2.0 / (w - 1)) - 1.0, y * (2.0 / (h - 1)) - 1.0],
                    1).astype(np.float32)


def ramp_grid(b, h, w, rows, offset=0.5, shift=0.0):
    """Each output pixel (i, j) samples row i + offset + a ramp of ``rows``
    rows across the width (negative: upwards) and column j + 0.5 + shift.
    The half-pixel offsets keep the taps off the floor's edges, so the
    reference and the port floor every coordinate alike."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ramp = np.round(rows * xs / (w - 1))
    y = np.broadcast_to(ys + offset + ramp, (b, h, w))
    x = np.broadcast_to(xs + 0.5 + shift, (b, h, w))
    return normalized(x, y, h, w)


def named_grids(b, h, w, seed=0):
    """small: a sub-pixel shift plus jitter; wave: a vertical sinusoid of
    +-20 rows along x, which spreads an 8-row block over ~48 rows (past the
    40-row band, inside 72); wild: uniform over [-1.5, 1.5]."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    base = np.stack([xs, ys], 0)[None].repeat(b, 0)
    small = base + 0.01 + rng.uniform(-0.02, 0.02, size=base.shape)
    wave = base.copy()
    wave[:, 1] += (20.0 * np.sin(np.linspace(0, 6 * np.pi, w))[None]
                   * (2.0 / (h - 1)))
    wild = rng.uniform(-1.5, 1.5, size=base.shape)
    return {k: g.astype(np.float32)
            for k, g in (("small", small), ("wave", wave), ("wild", wild))}


def frame(dtype, b, h, w, seed=1):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, size=(b, h, w, C)).astype(np.uint8)
    return rng.uniform(size=(b, h, w, C)).astype(np.float32)


def port_rung(image, grid, version):
    """Run the port's ladder once; -> the name of the rung that ran."""
    K.reset_counts()
    K.grid_sample_fast(torch.from_numpy(image), torch.from_numpy(grid),
                       planar_out=True, version=version, planar_grid=True)
    ran = [name for name, n in K.rung_counts().items() if n]
    assert len(ran) == 1 and K.rung_counts()[ran[0]] == 1, ran
    return ran[0]


@pytest.fixture
def reference_rungs(monkeypatch):
    """-> rung(image, grid, version): the rung the JAX package's
    ``_sample_impl`` takes, with its kernels replaced by zero-returning
    stand-ins that report themselves."""
    hits = []

    def stand_in(name, n_out, dtype):
        def fn(src, *args, version=None, band_h=None, **_):
            if name == "_fetch_corners":
                tag = ("v2" if version == 2 else
                       "v3_wide" if band_h == wk.WIDE_BAND_H else
                       f"v{version}")
            else:
                tag = {"_fetch_corners_packed": "v6",
                       "_fetch_corners_packed_v7": "v7",
                       "_warp_lerp_fused_v8": "v8"}[name]
            jax.debug.callback(lambda: hits.append(tag))
            shape = src.shape
            if name == "_warp_lerp_fused_v8":
                h = args[0].shape[1]
                shape = (src.shape[0], src.shape[1] // h, h, src.shape[2])
            return tuple(jnp.zeros(shape, dtype) for _ in range(n_out))
        return fn

    for name, n_out, dtype in (
            ("_fetch_corners", 4, jnp.float32),
            ("_fetch_corners_packed", 4, jnp.bfloat16),
            ("_fetch_corners_packed_v7", 4, jnp.bfloat16),
            ("_warp_lerp_fused_v8", 3, jnp.float32)):
        monkeypatch.setattr(wk, name, stand_in(name, n_out, dtype))
    compiled = {}

    def rung(image, grid, version):
        _, _, h, w = grid.shape
        key = (version, image.shape, image.dtype)
        if key not in compiled:
            compiled[key] = jax.jit(
                functools.partial(wk._sample_impl, version, False))
        x = jnp.clip((grid[:, 0] + 1.0) * 0.5 * (w - 1), 0.0, w - 1)
        y = jnp.clip((grid[:, 1] + 1.0) * 0.5 * (h - 1), 0.0, h - 1)
        hits.clear()
        jax.block_until_ready(compiled[key](jnp.asarray(image), x, y))
        assert len(hits) <= 1, hits
        return hits[0] if hits else "gather"

    return rung


# (B, H, W): H=128 has the wide band and every rung; H=40 rules out v6 and
# v7 (H % 16) and makes the band the whole image; H=24 has a band of 24
# rows; H=48 a band of 40 over 48 rows. W=384 has three column groups, so
# a shift of 128 columns breaks the window of v4-v7.
SHAPES = [(1, 128, 384), (1, 40, 128), (1, 24, 128), (1, 48, 256)]


def gate_sweep(b, h, w):
    """Ramps on both sides of each gate's edge, and shifts on both sides of
    the 128-column window. An 8-row block spans 8 + offset + rows rows
    (offset 0 or 5): past a 40-row band from rows = 32 - offset, past 72
    from 64 - offset; v2's rows span up to 8 + rows (an edge at 8), v6's
    16-row blocks 16 + offset + rows (24 - offset); v7's 128-column chunks
    take a third of the ramp at W = 384. A few upward ramps on the tallest
    image."""
    grids = {}
    for rows in (0, 7, 8, 18, 19, 21, 22, 23, 24, 25, 26, 27, 31, 32, 58,
                 59, 63, 64):
        for offset in (0.5, 5.5):
            for sign in (1, -1) if h == 128 and rows in (8, 32, 64) else (1,):
                grids[f"ramp{sign * rows}+{offset}"] = ramp_grid(
                    b, h, w, sign * rows, offset)
    for shift in (-129, -128, -127, 127, 128, 129):
        grids[f"shift{shift}"] = ramp_grid(b, h, w, 3, shift=shift)
    return grids


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s[1]}x{s[2]}"
                                                 for s in SHAPES])
def test_rungs_follow_the_reference_gates(reference_rungs, shape):
    """Versions 1 and 3, and 4 and 5, share their gates; the dtype changes
    the ladder at 6 and above only. Each version's rung names are held
    by the next test. Float frames and the tallest image take more
    versions than the small images need."""
    b, h, w = shape
    grids = gate_sweep(b, h, w)
    seen = set()
    for dtype in ("uint8", "float32"):
        image = frame(dtype, b, h, w)
        if dtype == "float32":
            versions = (6, 7)  # 8 runs 6's ladder
        elif h == 128:
            versions = (2, 3, 5, 6, 7, 8)
        else:  # the rungs these shapes rule in or out
            versions = (2, 5, 6, 7)
        for version in versions:
            for label, grid in grids.items():
                got = port_rung(image, grid, version)
                want = reference_rungs(image, grid, version)
                if version >= 8 and dtype == "uint8":
                    # the port's K5 is exact at any displacement: no rung
                    # beneath it (the reference's v4/v3/gather rungs)
                    assert got == "v8", label
                else:
                    assert got == want, (dtype, version, label, got, want)
                seen.add(want)
    if h == 128:
        assert seen == set(K.rung_counts()) - {"v1"}, seen


EXPECTED = {  # rung per version on the small, wave and wild grids
    "uint8": {1: "v1", 2: "v2", 3: "v3", 4: "v4", 5: "v5", 6: "v6",
              7: "v7", 8: "v8"},
    "float32": {1: "v1", 2: "v2", 3: "v3", 4: "v4", 5: "v5", 6: "v4",
                7: "v4", 8: "v4"},
}


VALUE_CASES = [(v, "uint8") for v in range(1, 9)] + [
    (v, "float32") for v in range(1, 6)]


@pytest.mark.parametrize("version, dtype", VALUE_CASES,
                         ids=[f"{v}-{d}" for v, d in VALUE_CASES])
def test_grid_sample_fast_matches_the_reference(version, dtype):
    """uint8 frames take planar grids and give planar output; float frames
    NHWC grids and NHWC output. For float frames versions 6-8 run version
    4's ladder (v4, v3, wide-band v3, gather) in both packages, which the
    rung test above holds; their values are version 4's."""
    b, h, w = 1, 128, 128
    planar = dtype == "uint8"
    image = frame(dtype, b, h, w, seed=version)

    def ref(g):  # the objective of the JAX package's own test
        out = wk.grid_sample_fast(jnp.asarray(image), g, interpret=True,
                                  version=version, planar_out=planar,
                                  planar_grid=planar)
        return jnp.sum(out ** 2), out

    ref_grad = jax.jit(jax.value_and_grad(ref, has_aux=True))
    for label, grid in named_grids(b, h, w).items():
        if not planar:
            grid = np.ascontiguousarray(np.moveaxis(grid, 1, -1))
        (_, want), want_g = ref_grad(jnp.asarray(grid))
        g = torch.from_numpy(grid).requires_grad_()
        K.reset_counts()
        out = K.grid_sample_fast(torch.from_numpy(image), g, planar_out=planar,
                                 version=version, planar_grid=planar)
        rung = {"small": EXPECTED[dtype][version], "wave": "v3_wide",
                "wild": "gather"}[label]
        if version == 2 and label == "wave":
            rung = "gather"  # v2 has no wide band
        if version >= 8 and dtype == "uint8":
            rung = "v8"
        assert K.rung_counts()[rung] == 1, (label, K.rung_counts())
        (out ** 2).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   atol=1e-6, err_msg=label)
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(
            g.grad.numpy(), want_g, rtol=1e-5,
            atol=1e-5 + 1e-6 * np.abs(want_g).max(), err_msg=label)


def test_ladder_rejects_what_it_does_not_take():
    image = torch.zeros((1, 64, 128, C), dtype=torch.uint8)
    grid = torch.zeros((1, 2, 64, 128))
    with pytest.raises(ValueError):
        K.grid_sample_fast(image, grid, version=0, planar_grid=True)
    with pytest.raises(ValueError):
        K.grid_sample_fast(image[:, :, :96], grid[..., :96], version=7,
                           planar_grid=True)
    with pytest.raises(TypeError):
        K.grid_sample_fast(image.double(), grid, version=3, planar_grid=True)


# ---- the steps ------------------------------------------------------------

STEP_B, STEP_H, STEP_W = 2, 64, 128
KEY = jax.random.PRNGKey(3)


def step_batch(seed=0):
    """Smooth random texture; frames -1 and 1 are copies shifted by -2 and
    +3 pixels with a little noise; color_aug is a brightness jitter."""
    rng = np.random.default_rng(seed)
    b, h, w = STEP_B, STEP_H, STEP_W
    ys, xs = np.meshgrid(np.arange(h + 8), np.arange(w + 8), indexing="ij")
    scene = np.zeros((b, h + 8, w + 8, 3))
    for _ in range(6):
        f = rng.uniform(0.05, 0.4, size=(b, 1, 1, 3))
        g = rng.uniform(0.05, 0.4, size=(b, 1, 1, 3))
        scene += np.sin(f * xs[None, ..., None] + g * ys[None, ..., None]
                        + rng.uniform(0, 6.3, size=(b, 1, 1, 3)))
    scene = (scene - scene.min()) / (scene.max() - scene.min())
    frames = [scene[:, 4:4 + h, 4 + dx:4 + dx + w] for dx in (0, -2, 3)]
    color = np.stack(frames, 1) + rng.normal(scale=0.01, size=(b, 3, h, w, 3))
    color = (np.clip(color, 0, 1) * 255).round().astype(np.uint8)
    aug = np.clip(color * rng.uniform(0.9, 1.1, size=(b, 3, 1, 1, 1)), 0,
                  255).astype(np.uint8)
    K_norm = np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0],
                       [0, 0, 0, 1]], np.float32)
    return {"color": color, "color_aug": aug,
            "K_norm": np.tile(K_norm, (b, 1, 1))}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# one scale and one source frame keep the reference's compile of its
# interpret-mode ladder to one warp site (a site traces every rung)
SCALES = (0,)
FRAMES = (0, -1)


def step_options(**kw):
    return dict(height=STEP_H, width=STEP_W, batch_size=STEP_B,
                compute_dtype="float32", scales=SCALES, frame_ids=FRAMES,
                **kw)


@pytest.fixture(scope="module")
def reference_weights():
    """Random parameters and statistics in the JAX bundle's tree, drawn with
    numpy from a seed (its shapes by ``jax.eval_shape``, which skips the
    ~10 s compile of its init): He-normal kernels, and biases, scales and
    statistics away from their init values. The pose head is drawn a tenth
    as large, so the poses stay near the identity, as a trained network's
    between neighbouring frames (the warps' top rungs then hold)."""
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            gain = 0.1 if path[-2].key == "pose_2" else 1.0
            return (rng.normal(size=leaf.shape) * gain
                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(scale=0.1, size=leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, size=leaf.shape).astype(np.float32)

    shapes = jax.eval_shape(JBundle.create(JOptions(**step_options())).init,
                            jax.random.PRNGKey(0))
    return tuple(jax.tree_util.tree_map_with_path(draw, shapes[k])
                 for k in ("params", "batch_stats"))


@pytest.mark.parametrize("version", [3, 7])
def test_eval_step_matches_the_reference(reference_weights, version):
    """Losses at 2e-5 relative, warped images at 3e-5, disparities at 1e-4
    / 1e-5, automasks on 99.5% of pixels: ``tests/test_torch_step.py``'s
    bounds, for the same reasons (float32 noise of the networks that the
    warp carries). The test process has eight virtual CPU devices
    (``tests/conftest.py``); the reference's step takes its kernels on one
    device or a sharded mesh, so it is shown one device, as on one card."""
    kw = step_options(pallas_warp_version=version)
    jb = JBundle.create(JOptions(**kw, pallas_warp_interpret=True,
                                 pallas_loss_interpret=True))
    params, stats = reference_weights
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, frozen={}, opt_state=None)
    batch = {k: v[:, :len(FRAMES)] if k != "K_norm" else v
             for k, v in step_batch().items()}
    with mock.patch.object(jax, "device_count", lambda *_: 1):
        losses, outputs = j_build_eval_step(jb, with_images=True)(
            state, batch, KEY)
    noise = {s: torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(KEY, s), (STEP_B, STEP_H, STEP_W, len(FRAMES) - 1),
        jnp.float32) * 1e-5)) for s in SCALES}
    port = ModelBundle.create(Options(**kw), device="cpu")
    port.load_state_dict(from_jax(params, stats), strict=True)
    K.reset_counts()
    got, got_out = tstep.build_eval_step(port, with_images=True)(
        to_torch(batch), noise=noise)
    top = {3: "v3", 7: "v7"}[version]
    assert K.rung_counts()[top] == 1, K.rung_counts()
    assert sorted(got) == sorted(losses)
    for k, want in losses.items():
        np.testing.assert_allclose(float(got[k]), float(want), rtol=2e-5,
                                   err_msg=k)
    assert sorted(got_out) == sorted(outputs)
    for key, want in outputs.items():
        if key == "disp":
            for s in want:
                np.testing.assert_allclose(got_out[key][s].numpy(),
                                           np.asarray(want[s]), rtol=1e-4,
                                           atol=1e-5)
        elif key.startswith("automask"):
            agree = (got_out[key].numpy() == np.asarray(want)).mean()
            assert agree >= 0.995, f"{key}: {agree:.4f}"
        else:
            np.testing.assert_allclose(got_out[key].numpy(),
                                       np.asarray(want), atol=3e-5,
                                       err_msg=key)


def test_train_step_v7_equals_the_v8_unfused_step(monkeypatch):
    """One training step at version 7 (the ladder: K8 or the rungs beneath
    it, then K3/K4) against the unfused version-8 step (K5, K3/K4) and the
    version-4 step (K6), from the same weights, batch and noise.

    Every rung fetches the same corners and lerps them alike, so versions 7
    and 4 agree bit for bit, losses and gradients. K5 scales by 1/255 after
    the lerp, the ladder before it (as the reference does), so the warps
    differ by a few ulp; the losses agree to 1e-6 relative and the gradient
    norm to 1e-5. The SSIM term divides by variances down to 9e-4, which
    turns those ulp into ~3e-5 in per-pixel losses, and one automask choice
    among 16384 pixels flips at scale 1: per element the gradients agree
    only to ~3e-3 of their leaf's largest value, so the whole gradient is
    held in L2, to 1e-3 (read: 5.0e-5, grad_norm 7.8e-6). The step at
    version 7 routes every warp through the ladder and every loss through
    K3/K4, with the fused op selected."""
    torch.manual_seed(0)
    kw = dict(height=STEP_H, width=STEP_W, batch_size=STEP_B,
              compute_dtype="float32")
    ref = ModelBundle.create(Options(**kw, use_pallas_warp_loss=False),
                             seed=1, device="cpu")
    bundles = [ref]
    for version in (7, 4):
        bundles.append(copy.deepcopy(ref))
        bundles[-1].cfg = Options(**kw, pallas_warp_version=version)
    batch = to_torch(step_batch(1))
    del batch["color_aug"]
    batch["aug_params"] = torch.tensor([[1.0, 1.1, 0.9, 1.15, 0.05, 1.0],
                                        [0.0, 1.0, 1.0, 1.0, 0.0, 0.0]])
    noise = {s: torch.randn((STEP_B, STEP_H, STEP_W, 2)) * 1e-5
             for s in range(4)}
    calls = {"warp_reproj_loss_op": 0, "reproj_loss_op": 0, "warp_op": 0,
             "grid_sample_fast": 0}

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    for name in calls:
        monkeypatch.setattr(tstep, name, counted(name, getattr(tstep, name)))
    results = []
    for bundle in bundles:
        for name in calls:
            calls[name] = 0
        K.reset_counts()
        losses = tstep.build_train_step(bundle)(create_train_state(bundle),
                                                batch, noise=noise)
        # both updated by the same Adam step: compare the gradients
        grads = [p.grad for p in bundle.parameters()]
        results.append((losses, grads, dict(calls), K.rung_counts()))
    (want, want_g, want_calls, _), (got, got_g, got_calls, rungs) = \
        results[:2]
    assert want_calls == {"warp_reproj_loss_op": 0, "reproj_loss_op": 10,
                          "warp_op": 8, "grid_sample_fast": 0}
    assert got_calls == {"warp_reproj_loss_op": 0, "reproj_loss_op": 10,
                         "warp_op": 0, "grid_sample_fast": 8}
    assert rungs["v7"] == 8, rungs
    assert results[2][3]["v4"] == 8, results[2][3]
    v4_losses, v4_g = results[2][:2]
    for k, v in got.items():
        assert torch.equal(v, v4_losses[k]), k
    assert all(torch.equal(a, b) for a, b in zip(got_g, v4_g))
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v),
                                   rtol=1e-5 if k == "grad_norm" else 1e-6,
                                   err_msg=k)
    diff = sum(float(((a - b).double() ** 2).sum())
               for a, b in zip(got_g, want_g))
    norm = sum(float((b.double() ** 2).sum()) for b in want_g)
    assert (diff / norm) ** 0.5 <= 1e-3


def test_ladder_versions_fall_back_to_the_plain_warp_off_its_shapes():
    """Where the width is no multiple of 128 the step warps through the
    plain ``ops.warp.grid_sample``, as the reference falls back to its XLA
    warp; the loss equals the version-8 step's (K5) to 1e-6 relative."""
    kw = dict(height=64, width=96, batch_size=STEP_B, compute_dtype="float32")
    batch = {k: v[..., :96, :] if k != "K_norm" else v
             for k, v in to_torch(step_batch(2)).items()}
    batch = {k: v.contiguous() for k, v in batch.items()}
    noise = {s: torch.zeros((STEP_B, 64, 96, 2)) for s in range(4)}
    bundle = ModelBundle.create(Options(**kw, use_pallas_warp_loss=False),
                                seed=2, device="cpu")
    want = tstep.build_eval_step(bundle)(batch, noise=noise)[0]["loss"]
    bundle.cfg = Options(**kw, pallas_warp_version=4)
    K.reset_counts()
    got = tstep.build_eval_step(bundle)(batch, noise=noise)[0]["loss"]
    assert sum(K.rung_counts().values()) == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
