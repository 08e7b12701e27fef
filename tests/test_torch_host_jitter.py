"""The port's host jitter (``data.augment.apply_augment``, numpy) held to
the JAX package's (PIL's ``ImageEnhance``, HSV round trip and
``ImageOps.autocontrast``) bit for bit: on frames from a seed, on drawn
parameters with the ends of their ranges and flat channels, on the
fixtures' cases, and PIL's RGB <-> HSV conversions over a sample of every
colour."""

import json
from pathlib import Path

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from tests.make_pil_fixtures import jitter_frame, jitter_params
from unsupervised_pose_estimation_tpu.data import augment as JA
from unsupervised_pose_estimation_tpu_torch.data import augment as A

FIXTURES = Path(__file__).resolve().parent / "data" / "pil"


def reference(frame, **params):
    return np.asarray(JA.apply_augment(Image.fromarray(frame),
                                       JA.AugmentParams(True, **params)),
                      np.uint8)


def port(frame, **params):
    return A.apply_augment(frame, A.AugmentParams(True, **params))


def test_matches_reference_on_seeded_frames():
    """Parameters drawn as the datasets draw them, on noise and on a
    smooth picture, at 192x640 and small sizes."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:192, 0:640]
    smooth = np.stack([np.sin(xx / 30.0 + k) * 90 + 128 + yy * 0.1
                       for k in range(3)], -1).astype(np.uint8)
    frames = [smooth, rng.integers(0, 256, (37, 51, 3), np.uint8)]
    n = 0
    while n < 8:
        p = A.AugmentParams.draw(rng, True)
        if not p.enabled:
            continue
        for frame in frames:
            got = A.apply_augment(frame, p)
            want = reference(frame, **{k: getattr(p, k) for k in (
                "brightness", "contrast", "saturation", "hue",
                "autocontrast")})
            np.testing.assert_array_equal(got, want)
        n += 1
    off = A.AugmentParams(False)
    assert A.apply_augment(frames[1], off) is frames[1]


ENDS = st.one_of(st.sampled_from([0.8, 1.2, 1.0]), st.floats(0.8, 1.2))


@settings(max_examples=60, deadline=None)
@given(b=ENDS, c=ENDS, s=ENDS,
       hue=st.one_of(st.sampled_from([-0.1, 0.1, 0.0]),
                     st.floats(-0.1, 0.1)),
       auto=st.booleans(), flat=st.sampled_from([None, 0, 1, 2, "all"]),
       value=st.integers(0, 255), seed=st.integers(0, 2 ** 16),
       h=st.integers(1, 24), w=st.integers(1, 24))
def test_matches_reference_on_drawn_params(b, c, s, hue, auto, flat, value,
                                           seed, h, w):
    frame = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                 np.uint8)
    if flat == "all":
        frame[:] = value
    elif flat is not None:
        frame[..., flat] = value
    params = dict(brightness=b, contrast=c, saturation=s, hue=hue,
                  autocontrast=auto)
    np.testing.assert_array_equal(port(frame, **params),
                                  reference(frame, **params))


def test_fixture_cases():
    """The manifest's jitter cases (what chip_smoke.py holds the card's
    host to) are the reference's outputs here."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    assert len(manifest["jitter"]) == 6
    for case in manifest["jitter"]:
        frame = jitter_frame(case["seed"], *case["shape"], case["flat"])
        params = jitter_params(case)
        del params["enabled"]
        np.testing.assert_array_equal(port(frame, **params),
                                      reference(frame, **params))


def test_hsv_conversions_match_pil():
    """RGB -> HSV on every 7th colour of the 2^24, and HSV -> RGB on every
    7th (h, s, v) triple, against PIL's convert."""
    codes = np.arange(0, 1 << 24, 7, dtype=np.uint32)
    triples = np.stack([(codes >> 16) & 255, (codes >> 8) & 255,
                        codes & 255], -1).astype(np.uint8)
    side = int(np.ceil(np.sqrt(len(triples))))
    grid = np.zeros((side * side, 3), np.uint8)
    grid[:len(triples)] = triples
    grid = grid.reshape(side, side, 3)
    np.testing.assert_array_equal(
        A._rgb_to_hsv(grid), np.asarray(Image.fromarray(grid).convert("HSV")))
    np.testing.assert_array_equal(
        A._hsv_to_rgb(grid),
        np.asarray(Image.fromarray(grid, "HSV").convert("RGB")))
