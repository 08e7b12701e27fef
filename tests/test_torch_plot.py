"""The port's trajectory plot (``eval.evaluate_pose.plot_trajectory``,
without matplotlib) against the JAX package's (matplotlib): the same two
point sets, projected where matplotlib's default 3D view puts them, and a
``vo.png`` of 960x720 whose lines pass through every projected point."""

from unittest import mock

import matplotlib
import matplotlib.figure
import numpy as np
import pytest
from mpl_toolkits.mplot3d import Axes3D

from unsupervised_pose_estimation_tpu.eval import evaluate_pose as JEP
from unsupervised_pose_estimation_tpu_torch.data.png import read_png
from unsupervised_pose_estimation_tpu_torch.eval import evaluate_pose as EP

matplotlib.use("Agg")


def trajectories(seed, n=24, flat_z=False):
    """Two random walks (a prediction apart from the ground truth, so that
    neither line hides the other), the second at another scale."""
    rng = np.random.default_rng(seed)
    gt, pred = np.cumsum(rng.normal(0, 1, (2, n, 3)), 1)
    if flat_z:
        gt[:, 2] = pred[:, 2] = 0.0
    return gt, pred * rng.uniform(0.2, 3)


def reference_lines(gt, pred, out):
    """Runs the JAX plot_trajectory with Axes3D.plot recorded -> the
    (x, y, z) columns it drew and each line's pixels on the canvas."""
    drawn, lines = [], []
    real = Axes3D.plot

    def spy(ax, xs, ys, zs, *args, **kwargs):
        drawn.append(np.stack([xs, ys, zs], -1))
        out_lines = real(ax, xs, ys, zs, *args, **kwargs)
        lines.append((ax, out_lines[0]))
        return out_lines

    def pixels_at_save(fig, path, dpi):
        fig.set_dpi(dpi)
        fig.canvas.draw()
        return [ax.transData.transform(np.column_stack(line.get_data()))
                for ax, line in lines]

    saved = []
    real_save = matplotlib.figure.Figure.savefig

    def save(fig, path, dpi=None, **kwargs):
        saved.append(pixels_at_save(fig, path, dpi))
        return real_save(fig, path, dpi=dpi, **kwargs)

    with mock.patch.object(Axes3D, "plot", spy), \
            mock.patch.object(matplotlib.figure.Figure, "savefig", save):
        JEP.plot_trajectory(gt, pred, str(out))
    return drawn, saved[0]


@pytest.mark.parametrize("seed,flat_z", [(0, False), (1, True)])
def test_points_and_projection_match_reference(seed, flat_z, tmp_path):
    """The scaled points are the ones the JAX function draws, and the
    port's pixels are matplotlib's display coordinates of them at dpi=150
    (to 1e-6 px; a flat z axis widened as matplotlib widens it)."""
    gt, pred = trajectories(seed, flat_z=flat_z)
    drawn, mpl_pixels = reference_lines(gt, pred, tmp_path / "ref.png")
    ours = EP.trajectory_points(gt, pred)
    assert len(drawn) == 2
    for a, b in zip(ours, drawn):
        np.testing.assert_array_equal(a, b)
    pixels = EP.plot_trajectory(gt, pred, str(tmp_path / "vo.png"))
    for got, want in zip(pixels, mpl_pixels):
        want = np.stack([want[:, 0], EP.PLOT_H - want[:, 1]], -1)
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_vo_png_draws_both_lines(tmp_path):
    """vo.png decodes to 720x960x3 on white; every projected point of each
    line has a pixel of its line's colour (C0, C1) within 2 px."""
    gt, pred = trajectories(2, n=40)
    path = tmp_path / "vo.png"
    pixels = EP.plot_trajectory(gt, pred, str(path))
    img = read_png(str(path))
    assert img.shape == (720, 960, 3) and img.dtype == np.uint8
    assert (img[0, 0] == 255).all()
    for pts, color in zip(pixels, EP.COLORS):
        mask = np.all(img == np.array(color, np.uint8), -1)
        ys, xs = np.nonzero(mask)
        assert len(ys)
        for col, row in pts:
            d = np.hypot(xs + 0.5 - col, ys + 0.5 - row).min()
            assert d <= 2.0, (col, row, d)
