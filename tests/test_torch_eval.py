"""The port's depth and pose evaluation against the JAX package's
``eval/evaluate_depth.py`` and ``eval/evaluate_pose.py``.

The weights are the port's seeded ones with BatchNorm statistics, scales
and biases redrawn, written as a folder of reference ``.pth`` files and
read into flax trees by the JAX package's own importers (the depth
decoder's BatchNorms, which the reference files never held, are carried
over by hand). The frames are ``synthetic_parallax`` items, 10 of them,
with their exact depth and poses written to a split directory: the depth
drivers see batches of 8 images (4 flipped pairs with ``post_process``)
and a tail of 2 that ``drop_last`` cuts, which both run one frame at a
time; the pose drivers see batches of 4 pairs and a last one of 2. The
JAX drivers build datasets from file lists only, so the JAX
``make_dataset`` gets the item count the port's ``eval_dataset`` gives
it. In float32 the disparities agree to 1e-5, the poses to 1e-6 and the
metric rows to 1e-4 relative (convolutions summed in other orders). In
bfloat16 the disparities are held to the bounds of
tests/test_torch_bf16_models.py: within 3x the largest and 2x the mean
gap of the JAX package's own bfloat16 disparities from its float32 ones.
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

from unsupervised_pose_estimation_tpu.data import datasets as JD
from unsupervised_pose_estimation_tpu.eval import evaluate_depth as JED
from unsupervised_pose_estimation_tpu.eval import evaluate_pose as JEP
from unsupervised_pose_estimation_tpu.train import checkpoint as JCK
from unsupervised_pose_estimation_tpu.train.bundle import \
    ModelBundle as JBundle
from unsupervised_pose_estimation_tpu_torch.cli import \
    evaluate_depth as cli_depth
from unsupervised_pose_estimation_tpu_torch.cli import \
    evaluate_pose as cli_pose
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.data.png import read_png
from unsupervised_pose_estimation_tpu_torch.eval import evaluate_depth as ED
from unsupervised_pose_estimation_tpu_torch.eval import evaluate_pose as EP
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle
from unsupervised_pose_estimation_tpu_torch.train.checkpoint import \
    save_checkpoint
from unsupervised_pose_estimation_tpu_torch.train.state import \
    create_train_state

H, W, N_ITEMS, BATCH = 64, 128, 10, 4
NAMES = ("encoder", "depth", "pose_encoder", "pose")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def options(root, dtype="float32", batch_size=BATCH, **kw):
    return Options(height=H, width=W, batch_size=batch_size,
                   compute_dtype=dtype,
                   dataset="synthetic_parallax", synthetic_rotation=True,
                   split_dir=os.path.join(root, "splits"), eval_split="synth",
                   load_weights_folder=os.path.join(root, "pth"),
                   eval_mono=True, eval_pose_trajectory=False, **kw)


def perturbed_bundle(seed=3):
    """Seeded weights with BatchNorm statistics and scales and every bias
    redrawn (init leaves them at 0, 1 or 0)."""
    bundle = ModelBundle.create(Options(height=H, width=W,
                                        compute_dtype="float32"),
                                seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in bundle.state_dict().items():
            if name.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif name.endswith(("running_var", "bn1.weight", "bn2.weight",
                                "bn3.weight", "downsample.1.weight")) or \
                    name.startswith("depth.bn."):
                if t.dtype.is_floating_point:
                    t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    return bundle


def write_pth_folder(bundle, folder):
    """The bundle's four networks as reference-layout ``.pth`` files."""
    os.makedirs(folder, exist_ok=True)
    for name in NAMES:
        torch.save(getattr(bundle, name).state_dict(),
                   os.path.join(folder, f"{name}.pth"))


def jax_trees(bundle, folder):
    """-> (params, batch_stats) flax trees of the bundle's weights, read
    from its ``.pth`` folder by the JAX package's importers."""
    write_pth_folder(bundle, folder)
    params, stats = {}, {}
    for name in ("encoder", "pose_encoder"):
        tree = JCK.import_resnet_encoder(os.path.join(folder, f"{name}.pth"))
        params[name], stats[name] = tree["params"], tree["batch_stats"]
    params["depth"] = JCK.import_depth_decoder(
        os.path.join(folder, "depth.pth"))["params"]
    stats["depth"] = {}
    sd = bundle.state_dict()
    for i in range(5):
        params["depth"][f"bn_{i}"] = {
            "scale": sd[f"depth.bn.{i}.weight"].numpy(),
            "bias": sd[f"depth.bn.{i}.bias"].numpy()}
        stats["depth"][f"bn_{i}"] = {
            "mean": sd[f"depth.bn.{i}.running_mean"].numpy(),
            "var": sd[f"depth.bn.{i}.running_var"].numpy()}
    params["pose"] = JCK.import_pose_decoder(
        os.path.join(folder, "pose.pth"))["params"]
    return params, stats


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The split directory, the .pth folder, a port checkpoint of the same
    weights, and the flax trees the JAX importers read from the folder."""
    root = str(tmp_path_factory.mktemp("eval"))
    opt = options(root)
    ED.write_synthetic_split(opt, N_ITEMS)
    bundle = perturbed_bundle()
    params, stats = jax_trees(bundle, opt.load_weights_folder)
    ckpt = os.path.join(root, "checkpoint")
    save_checkpoint(ckpt, bundle, create_train_state(bundle), opt)
    return dict(root=root, ckpt=ckpt, bundle=bundle,
                state=types.SimpleNamespace(params=params,
                                            batch_stats=stats))


@pytest.fixture(scope="module")
def jax_results(setup):
    """The JAX drivers' predictions and metric rows on the split's
    synthetic items, with the weights of ``setup`` in place of the ones
    their ``load_eval_state`` would read. One infer function per dtype, so
    each input shape compiles once; ``evaluate`` scores the predictions
    made here."""
    def make_dataset(name, **kw):
        return JD.make_dataset(name, num_items=len(kw["filenames"]),
                               with_rotation=True, **kw)

    bundles = {dt: JBundle.create(options(setup["root"], dt))
               for dt in ("float32", "bfloat16")}
    infer = {dt: JED.build_infer_step(b) for dt, b in bundles.items()}
    state = setup["state"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for module in (JED, JEP):
            mp.setattr(module, "make_dataset", make_dataset)
        mp.setattr(JED, "build_infer_step",
                   lambda b: infer[b.cfg.compute_dtype])
        for dt, pp in (("float32", False), ("float32", True),
                       ("bfloat16", True)):
            opt = disparity_options(setup["root"], dt, pp)
            out[dt, pp] = JED.predict_disparities(opt, bundles[dt], state,
                                                  files())
        opt = options(setup["root"])
        out["pose"] = JEP.predict_pose_sequence(opt, bundles["float32"],
                                                state, files())
        mp.setattr(JED, "load_eval_state",
                   lambda opt: (bundles["float32"], state))
        mp.setattr(JED, "predict_disparities",
                   lambda *a: out["float32", True])
        mp.setattr(JEP, "predict_pose_sequence", lambda *a: out["pose"])
        out["depth_row"] = JED.evaluate(options(setup["root"],
                                                post_process=True))
        out["pose_row"] = JEP.evaluate(opt)
    return out


def disparity_options(root, dtype, post_process):
    """Batches of 8 images in both modes (4 flipped pairs with
    post_process), so that each dtype's JAX infer compiles two shapes:
    the batch and the one-frame tail."""
    return options(root, dtype, post_process=post_process,
                   batch_size=BATCH if post_process else 2 * BATCH)


def files():
    return [f"synthetic {i} l" for i in range(N_ITEMS)]


@pytest.mark.parametrize("post_process", [False, True])
def test_predict_disparities_matches_jax(setup, jax_results, post_process):
    opt = disparity_options(setup["root"], "float32", post_process)
    want = jax_results["float32", post_process]
    got = ED.predict_disparities(opt, ED.load_eval_state(opt, "cpu"),
                                 files())
    assert got.shape == want.shape == (N_ITEMS, H, W)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_predict_disparities_bf16_within_the_jax_gap(setup, jax_results):
    opt = disparity_options(setup["root"], "bfloat16", True)
    got = ED.predict_disparities(opt, ED.load_eval_state(opt, "cpu"),
                                 files())
    want = jax_results["bfloat16", True]
    gap = np.abs(want - jax_results["float32", True])
    err = np.abs(got - want)
    assert 0 < err.max() <= 3 * gap.max()
    assert err.mean() <= 2 * gap.mean()


def test_depth_metric_row_matches_jax(setup, jax_results, capsys):
    """cli.evaluate_depth on the port's checkpoint against the JAX evaluate
    on the same weights (mono, median scaling, post-process)."""
    opt = options(setup["root"], post_process=True)
    want = jax_results["depth_row"]
    got = cli_depth.main(
        ["--height", str(H), "--width", str(W), "--batch_size", str(BATCH),
         "--compute_dtype", "float32", "--dataset", "synthetic_parallax",
         "--synthetic_rotation", "--split_dir", opt.split_dir,
         "--eval_split", "synth", "--load_weights_folder", setup["ckpt"],
         "--eval_mono", "--post_process"], device="cpu")
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-4, err_msg=key)
    assert "Mono evaluation" in capsys.readouterr().out


def test_predict_pose_sequence_matches_jax(setup, jax_results):
    """Pairs [frame 1, frame 0] in batches of 4 and a last one of 2."""
    opt = options(setup["root"])
    want = jax_results["pose"]
    got = EP.predict_pose_sequence(
        opt, ED.load_eval_state(opt, "cpu", ("pose_encoder", "pose")),
        files())
    assert got.shape == want.shape == (N_ITEMS, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_pose_metric_row_matches_jax(setup, jax_results):
    """cli.evaluate_pose on the .pth folder against the JAX evaluate: ATE
    and rotation error over 5-frame tracks of the split's exact poses."""
    opt = options(setup["root"])
    want = jax_results["pose_row"]
    got = cli_pose.main(
        ["--height", str(H), "--width", str(W), "--batch_size", str(BATCH),
         "--compute_dtype", "float32", "--dataset", "synthetic_parallax",
         "--synthetic_rotation", "--split_dir", opt.split_dir,
         "--eval_split", "synth", "--load_weights_folder",
         opt.load_weights_folder, "--eval_pose_trajectory"], device="cpu")
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-4, err_msg=key)
    assert want["re_mean"] > 0  # the items' camera yaws


@pytest.mark.parametrize("saved,loaded", [("float32", "bfloat16"),
                                          ("bfloat16", "float32")])
def test_checkpoint_evaluates_at_either_dtype(setup, tmp_path, saved,
                                              loaded):
    """A checkpoint holds float32 parameters whatever dtype trained it, and
    evaluates at the other dtype as a bundle of that dtype built from the
    same weights does."""
    weights = setup["bundle"].state_dict()
    writer = ModelBundle.create(options(setup["root"], saved), device="cpu")
    writer.load_state_dict(weights)
    save_checkpoint(str(tmp_path), writer, create_train_state(writer))
    opt = dataclasses.replace(options(setup["root"], loaded),
                              load_weights_folder=str(tmp_path))
    bundle = ED.load_eval_state(opt, "cpu")
    assert all(t.dtype == weights[k].dtype
               for k, t in bundle.state_dict().items())
    direct = ModelBundle.create(options(setup["root"], loaded), device="cpu")
    direct.load_state_dict(weights)
    got = ED.predict_disparities(opt, bundle, files()[:5])
    want = ED.predict_disparities(opt, direct.eval(), files()[:5])
    np.testing.assert_array_equal(got, want)


def test_evaluation_without_pil_or_matplotlib(setup, monkeypatch, tmp_path):
    """Neither is imported: the trajectory plot is drawn without
    matplotlib, the benchmark split's 16-bit PNGs are written without PIL
    (data.png)."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    disps = tmp_path / "disps.npy"
    np.save(disps, np.full((2, 8, 16), 0.5, np.float32))
    opt = Options(ext_disp_to_eval=str(disps), eval_split="benchmark",
                  load_weights_folder=str(tmp_path))
    assert ED.evaluate(opt) is None
    for idx in range(2):
        depth16 = read_png(str(tmp_path / "benchmark_predictions" /
                                f"{idx:010d}.png"))
        assert depth16.shape == (352, 1216)
        assert (depth16 == int(ED.STEREO_SCALE_FACTOR / 0.5 * 256)).all()
    EP.plot_trajectory(np.zeros((3, 3)), np.ones((3, 3)),
                       str(tmp_path / "vo.png"))
    assert read_png(str(tmp_path / "vo.png")).shape == (720, 960, 3)
    # the default routes run without either, the plot included
    (tmp_path / "o").mkdir()
    row = EP.evaluate(dataclasses.replace(options(setup["root"]),
                                          eval_pose_trajectory=True,
                                          eval_out_dir=str(tmp_path / "o")),
                      device="cpu")
    assert np.isfinite(row["ate_mean"])
    assert (tmp_path / "o" / "vo.png").is_file()
