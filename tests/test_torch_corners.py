"""The corner-fetch kernels' plain versions (K6, K7, K8) against the JAX
package's Pallas kernels run in interpret mode.

Each kernel is held on inputs that meet its rung's gate in
``_sample_impl``, as ``tests/test_pallas_ops.py`` holds the Pallas ones:
every tap inside the band (and, for v4-v7, inside the 128-column groups
{c-1, c, c+1} of its output column). There a TPU rung returns the exact
taps, and a gather does no arithmetic, so the port must agree bit for bit.
The band starts and band-local rows are computed here with numpy, by the
reference's formulas, and the gates are asserted before the comparison.
The CUDA kernels are compared with these plain versions on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_pose_estimation_tpu.ops.pallas import warp_kernel as wk
from unsupervised_pose_estimation_tpu_torch.ops import kernels as K

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


def tap_coords(rng, b, h, w, dx=0.0, wave=0.0):
    """Top-left tap (x0i, y0i) (B, H, W) int32 of pixel coordinates near the
    identity: a shift of ``dx`` columns, up to 3 columns and 2 rows of
    jitter, and a vertical wave of amplitude ``wave`` rows along x."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = xs + dx + rng.uniform(-3, 3, size=(b, h, w))
    y = (ys + wave * np.sin(np.linspace(0, 6 * np.pi, w))[None]
         + rng.uniform(-2, 2, size=(b, h, w)))
    x = np.clip(x, 0, w - 1)
    y = np.clip(y, 0, h - 1)
    x0 = np.minimum(np.floor(x), w - 2).astype(np.int32)
    y0 = np.minimum(np.floor(y), h - 2).astype(np.int32)
    return x0, y0


def band_starts(lo, hi, h, band):
    """``_sample_impl``'s band starts and gate for top taps in [lo, hi]."""
    ymin = np.clip((lo // 8) * 8, 0, h - band)
    return ymin, bool(np.all(hi + 1 - ymin <= band - 1))


def shift_ok(x0):
    group = (np.arange(x0.shape[-1]) // 128)[None, None]
    return bool(np.all(x0 // 128 - group >= -1)
                and np.all((x0 + 1) // 128 - group <= 1))


def rung_inputs(x0, y0, rows, band, per_chunk=False):
    """-> ymin (B, H/rows, 1), or (B, H, W/128) per 128-column chunk, and
    the band-local rows clipped to [0, band - 2]; asserts the gate."""
    b, h, w = y0.shape
    if per_chunk:
        blocks = y0.reshape(b, h, w // 128, 128)
        ymin, ok = band_starts(blocks.min(3), blocks.max(3), h, band)
        starts = np.repeat(ymin, 128, axis=2)
    else:
        blocks = y0.reshape(b, h // rows, rows * w)
        ymin, ok = band_starts(blocks.min(2), blocks.max(2), h, band)
        starts = np.repeat(ymin, rows, axis=1)[..., None]
        ymin = ymin[..., None]
    assert ok, "the inputs miss the rung's gate"
    yl = np.clip(y0 - starts, 0, band - 2).astype(np.int32)
    return ymin.astype(np.int32), yl


def as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (version, rows per band start, band, H, W, x shift, vertical wave):
# v1 and v3 visit any column group, so they take a shift past one group;
# the wide-band v3 rung takes a wave that overflows the 40-row band.
K6_CASES = [(1, 8, 40, 64, 256, 150.0, 0.0), (2, 1, 16, 64, 128, 2.0, 0.0),
            (3, 8, 40, 64, 256, -140.0, 0.0), (4, 8, 40, 64, 256, 20.0, 0.0),
            (5, 8, 40, 64, 128, -20.0, 0.0), (3, 8, 72, 128, 128, 0.0, 20.0)]


@pytest.mark.parametrize("case", K6_CASES,
                         ids=[f"v{c[0]}-band{c[2]}" for c in K6_CASES])
def test_fetch_corners_plain_matches_pallas(case):
    version, rows, band, h, w, dx, wave = case
    b = 2
    rng = np.random.default_rng(version + band)
    src = rng.uniform(size=(b * C, h, w)).astype(np.float32)
    x0, y0 = tap_coords(rng, b, h, w, dx, wave)
    if version >= 4:
        assert shift_ok(x0)
    if wave:
        assert not band_starts(*(f(y0.reshape(b, h // 8, 8 * w), 2)
                                 for f in (np.min, np.max)), h, 40)[1]
    ymin, yl = rung_inputs(x0, y0, rows, band)

    def rep(a):  # the JAX kernel takes the indices per plane
        return jnp.asarray(np.repeat(a, C, axis=0))

    want = wk._fetch_corners(jnp.asarray(src), rep(x0), rep(yl), rep(ymin),
                             interpret=True, version=version,
                             band_h=None if version == 2 else band)
    got = K.fetch_corners(*as_torch(src, x0, yl, ymin), band)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (b * C, h, w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("version", [6, 7])
def test_fetch_corners_packed_plain_matches_pallas(version):
    # K8's band starts vary by 128-column chunk: two chunks for it
    b, h, w = 2, 64, 128 if version == 6 else 256
    rng = np.random.default_rng(version)
    image = rng.integers(0, 256, size=(b, h, w, C)).astype(np.uint8)
    x0, y0 = tap_coords(rng, b, h, w, dx=-10.0)
    assert shift_ok(x0)
    raw = jnp.asarray(np.moveaxis(image.astype(np.float32), -1, 1)
                      .reshape(b, C * h, w))
    if version == 6:
        ymin, yl = rung_inputs(x0, y0, 16, 40)
        want = wk._fetch_corners_packed(raw, jnp.asarray(x0), jnp.asarray(yl),
                                        jnp.asarray(ymin), 40, interpret=True)
        got = K.fetch_corners_packed(*as_torch(image, x0, yl, ymin), 40)
    else:
        ymin, yl = rung_inputs(x0, y0, 1, 16, per_chunk=True)
        want = wk._fetch_corners_packed_v7(raw, jnp.asarray(x0),
                                           jnp.asarray(yl),
                                           jnp.asarray(ymin), interpret=True)
        got = K.fetch_corners_packed_v7(*as_torch(image, x0, yl, ymin))
    for g, w_ in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == (b, C * h, w)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w_.astype(jnp.float32)))


def test_corner_reads_stay_in_the_source():
    """Indices past the band or the image are clipped and clamped: the
    taps of a band start beyond the last row and of columns outside the
    image are those of the nearest rows and columns inside."""
    b, h, w = 1, 16, 128
    src = torch.arange(b * C * h * w, dtype=torch.float32).reshape(
        b * C, h, w)
    x0 = torch.full((b, h, w), -5, dtype=torch.int32)
    x0[..., 1] = w + 7
    yl = torch.full((b, h, w), 100, dtype=torch.int32)
    ymin = torch.full((b, 2, 1), 8, dtype=torch.int32)
    v00, v01, v10, v11 = K.fetch_corners(src, x0, yl, ymin, 8)
    # row 8 + clip(100, 0, 6) = 14, the last top-tap row
    assert torch.equal(v00[:, :, 0], src[:, 14, 0:1].expand(-1, h))
    assert torch.equal(v11[:, :, 1], src[:, 15, w - 1:w].expand(-1, h))
    image = torch.randint(0, 256, (b, h, w, C), dtype=torch.uint8)
    starts = torch.full((b, h, 1), 99, dtype=torch.int32)
    taps = K.fetch_corners_packed_v7(image, x0, yl, starts)
    want = image[:, h - 1, w - 1].to(torch.bfloat16)  # (b, C)
    assert torch.equal(taps[3].reshape(b, C, h, w)[:, :, 3, 1], want)


def test_corner_wrappers_reject_what_the_kernels_do_not_take():
    b, h, w = 1, 16, 128
    src = torch.zeros((b * C, h, w))
    idx = torch.zeros((b, h, w), dtype=torch.int32)
    ymin = torch.zeros((b, 2, 1), dtype=torch.int32)
    image = torch.zeros((b, h, w, C), dtype=torch.uint8)
    with pytest.raises(TypeError):
        K.fetch_corners(src.double(), idx, idx, ymin, 8)
    with pytest.raises(TypeError):
        K.fetch_corners(src, idx.long(), idx, ymin, 8)
    with pytest.raises(ValueError):
        K.fetch_corners(src, idx, idx, torch.zeros((b, 3, 1),
                                                   dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        K.fetch_corners(src, idx, idx, ymin, h + 1)
    with pytest.raises(TypeError):
        K.fetch_corners_packed(image.float(), idx, idx,
                               torch.zeros((b, 1, 1), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        K.fetch_corners_packed(image, idx, idx, ymin, 8)
    with pytest.raises(ValueError):
        K.fetch_corners_packed_v7(image, idx, idx, ymin)
    with pytest.raises(NotImplementedError):
        K.fetch_corners(src.requires_grad_(), idx, idx, ymin, 8)
