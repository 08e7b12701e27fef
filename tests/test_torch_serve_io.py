"""The port's serving and command-line routes on files, against the JAX
package's where it has them: the HTTP front end (a PNG POST answered with
the engine's disparity at atol 0, its decode and resize equal to the JAX
server's PIL path), the exported artifact reloaded (within 1e-6 of the
engine at either dtype), ``cli.serve`` and ``cli.export_model``, ``cli.test_simple``
against the JAX CLI on weights carried across by ``convert.from_jax`` (both
in float32: ``.npy`` at the float32 infer step's tolerance, rtol 1e-4,
scaled by the disparity range to atol 1e-4; poses within 1e-6; the magma
array bit-equal; the JPEG read back by PIL, its mean error from that
array within 0.25 of the error of Pillow's own quality-75 JPEG of it), and
the card's routes with PIL and matplotlib unimportable."""

import csv
import functools
import io
import os
import sys
import threading
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_option_steps import numpy_variables
from unsupervised_pose_estimation_tpu.cli import test_simple as JTS
from unsupervised_pose_estimation_tpu.config import Options as JOptions
from unsupervised_pose_estimation_tpu.eval import evaluate_depth as JED
from unsupervised_pose_estimation_tpu.train.bundle import \
    ModelBundle as JBundle
from unsupervised_pose_estimation_tpu_torch import serve
from unsupervised_pose_estimation_tpu_torch.cli import build_frame_cache
from unsupervised_pose_estimation_tpu_torch.cli import \
    export_gt_depth as cli_gt
from unsupervised_pose_estimation_tpu_torch.cli import export_model
from unsupervised_pose_estimation_tpu_torch.cli import serve as cli_serve
from unsupervised_pose_estimation_tpu_torch.cli import test_simple as TS
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.convert import from_jax
from unsupervised_pose_estimation_tpu_torch.data import datasets
from unsupervised_pose_estimation_tpu_torch.data.png import (encode_png,
                                                             read_png,
                                                             write_png)
from unsupervised_pose_estimation_tpu_torch.eval import evaluate_depth
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle
from unsupervised_pose_estimation_tpu_torch.train.checkpoint import \
    save_checkpoint
from unsupervised_pose_estimation_tpu_torch.train.logging import MetricLogger
from unsupervised_pose_estimation_tpu_torch.train.state import \
    create_train_state

H, W = 32, 64
OPT = dict(height=H, width=W, compute_dtype="float32",
           weights_init="scratch")
# test_simple's feed against the JAX CLI: 64 rows, since at 32 the JAX
# package's reflect pad of the one-row deepest map (ops.packed._pad1_dus)
# is not numpy's reflect, which the port follows (models.layers.reflect_pad1)
TS_OPT = dict(OPT, height=64, width=64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engine():
    return serve.InferenceEngine(Options(**OPT), max_batch=4, device="cpu")


def picture(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 7.0 + seed) + np.cos(yy / 5.0)) * 60 + 128
    return np.clip(base[..., None] + rng.normal(0, 10, (h, w, 3)), 0,
                   255).astype(np.uint8)


def post(port, body, path="/predict"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return np.load(io.BytesIO(resp.read()))


@pytest.fixture
def http(engine):
    """-> the port of a served engine (the batcher coalesces requests)."""
    batcher = serve.MicroBatcher(engine, max_delay_ms=20.0)
    server = serve.make_http_server(batcher)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.server_address[1]
    server.shutdown()
    server.server_close()
    batcher.close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def pil_feed(body, h, w):
    """The JAX server's decode and resize."""
    img = Image.open(io.BytesIO(body))
    return np.asarray(img.convert("RGB").resize((w, h), Image.LANCZOS),
                      np.uint8)


def test_http_png_post_matches_engine(engine, http, monkeypatch):
    """PNG POSTs of several sizes and colour types: the feed the server
    decodes is the JAX server's (PIL's) bit for bit, and each answer is the
    engine's disparity of it at atol 0: one request alone against
    ``engine.predict`` of the feed, and concurrent ones against the engine
    call that served them (each batch is recorded)."""
    bodies = []
    for i, (h, w) in enumerate([(48, 80), (32, 64), (75, 101), (20, 40)]):
        pix = picture(i, h, w)
        img = Image.fromarray(pix if i % 2 == 0 else pix[..., 0])
        buf = io.BytesIO()
        img.save(buf, "PNG", optimize=bool(i % 2))
        bodies.append(buf.getvalue())
    feeds = [serve.decode_request(body, H, W) for body in bodies]
    for body, feed in zip(bodies, feeds):
        np.testing.assert_array_equal(feed, pil_feed(body, H, W))
    np.testing.assert_array_equal(post(http, bodies[2]),
                                  engine.predict(feeds[2][None])[0])

    served = []
    real = engine.predict

    def recording(images):
        out = real(images)
        served.extend(zip(images, out))
        return out

    monkeypatch.setattr(engine, "predict", recording)
    got = {}

    def client(i):
        got[i] = post(http, bodies[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert sorted(got) == list(range(len(bodies)))
    assert len(served) == len(bodies)
    for i, feed in enumerate(feeds):
        rows = [out for image, out in served if np.array_equal(image, feed)]
        assert len(rows) == 1
        assert got[i].dtype == np.float32 and got[i].shape == (H, W)
        np.testing.assert_array_equal(got[i], rows[0])
    with urllib.request.urlopen(f"http://127.0.0.1:{http}/healthz",
                                timeout=30) as resp:
        assert resp.read() == \
            b'{"status": "ok", "feed": [32, 64], "max_batch": 4}'


def test_http_errors(http, monkeypatch):
    """A broken PNG and, without PIL, a JPEG get a 500 naming the fault; an
    unknown path a 404."""
    with pytest.raises(urllib.error.HTTPError) as err:
        post(http, encode_png(picture(0, 8, 8))[:-20])
    assert err.value.code == 500 and "PNG" in err.value.reason
    buf = io.BytesIO()
    Image.fromarray(picture(1, 16, 16)).save(buf, "JPEG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(urllib.error.HTTPError) as err:
        post(http, buf.getvalue())
    assert err.value.code == 500
    assert "PNG" in err.value.reason and "PIL" in err.value.reason
    with pytest.raises(urllib.error.HTTPError) as err:
        post(http, b"", path="/other")
    assert err.value.code == 404


def test_exported_artifact_matches_engine(engine, tmp_path):
    """export_artifact -> load_artifact at bfloat16: the bfloat16 engine's
    disparities within 1e-6 (the same operations); float32 through
    cli.export_model below."""
    opt = Options(**{**OPT, "compute_dtype": "bfloat16"})
    eng = serve.InferenceEngine(opt, max_batch=4, device="cpu",
                                bundle=engine.bundle)
    path = serve.export_artifact(opt, str(tmp_path / "m.pt2"), max_batch=4,
                                 bundle=eng.bundle, device="cpu")
    fn, meta = serve.load_artifact(path, device="cpu")
    assert meta["max_batch"] == 4
    x = np.random.default_rng(2).random((4, H, W, 3)).astype(np.float32)
    got = fn(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, H, W)
    np.testing.assert_allclose(got.numpy(), eng.predict(x), rtol=0,
                               atol=1e-6)


def test_cli_export_model_and_serve(tmp_path, monkeypatch):
    """cli.export_model writes an artifact of the checkpoint's weights
    (float32, within 1e-6 of the engine; the JAX package's sidecar);
    cli.serve serves them over HTTP."""
    opt = Options(**OPT)
    bundle = ModelBundle.create(opt, seed=7, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, bundle, create_train_state(bundle), opt)
    flags = ["--load_weights_folder", ckpt, "--height", str(H), "--width",
             str(W), "--compute_dtype", "float32"]
    out = str(tmp_path / "art" / "m.pt2")
    assert export_model.main(flags + ["--out", out, "--max_batch", "2"],
                             device="cpu") == out
    fn, meta = serve.load_artifact(out, device="cpu")
    assert meta == {"height": H, "width": W, "max_batch": 2,
                    "min_depth": opt.min_depth, "max_depth": opt.max_depth}
    feed = picture(3, H, W)
    want = serve.InferenceEngine(opt, max_batch=2, device="cpu",
                                 bundle=bundle).predict(feed[None])[0]
    np.testing.assert_allclose(
        fn(torch.from_numpy(np.stack([feed, feed]) / 255.0).float())[0],
        want, atol=1e-6, rtol=0)

    servers = []
    real = cli_serve.make_http_server

    def capture(*args, **kwargs):
        servers.append(real(*args, **kwargs))
        return servers[-1]

    monkeypatch.setattr(cli_serve, "make_http_server", capture)
    thread = threading.Thread(target=cli_serve.main, args=(
        flags + ["--port", "0", "--max_batch", "2"],), kwargs=dict(
            device="cpu"), daemon=True)
    thread.start()
    for _ in range(600):
        if servers:
            break
        thread.join(timeout=0.1)
    port = servers[0].server_address[1]
    try:
        got = post(port, encode_png(feed))
    finally:
        servers[0].shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """JAX weights (drawn with numpy in the shapes of the JAX bundle's
    init, nothing compiled) and a port checkpoint of them
    (convert.from_jax)."""
    root = tmp_path_factory.mktemp("carried")
    jbundle = JBundle.create(JOptions(**TS_OPT))
    v = numpy_variables(jbundle.init, jax.random.PRNGKey(0), seed=4)
    jstate = types.SimpleNamespace(params=v["params"],
                                   batch_stats=v["batch_stats"])
    opt = Options(**TS_OPT)
    bundle = ModelBundle.create(opt, seed=0, device="cpu")
    bundle.load_state_dict(from_jax(jstate.params, jstate.batch_stats))
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, bundle, create_train_state(bundle), opt)
    return dict(jbundle=jbundle, jstate=jstate, ckpt=ckpt)


def image_folder(folder):
    os.makedirs(folder)
    for i, (h, w) in enumerate([(40, 56), (70, 90)]):
        Image.fromarray(picture(10 + i, h, w)).save(
            os.path.join(folder, f"{'ab'[i]}.png"))
    return folder


def test_test_simple_matches_jax(carried, tmp_path, monkeypatch):
    jdir = image_folder(str(tmp_path / "jax"))
    tdir = image_folder(str(tmp_path / "port"))
    size = (TS_OPT["height"], TS_OPT["width"])
    args = ["--model_path", carried["ckpt"], "--height", str(size[0]),
            "--width", str(size[1]), "--pose_prediction"]
    monkeypatch.setattr(JED, "load_eval_state",
                        lambda opt: (carried["jbundle"], carried["jstate"]))
    JTS.main(["--image_path", jdir] + args)
    monkeypatch.setattr(TS, "Options",
                        functools.partial(Options, compute_dtype="float32"))
    TS.main(["--image_path", tdir] + args, device="cpu")
    for name, (h, w) in (("a", (40, 56)), ("b", (70, 90))):
        ours = np.load(os.path.join(tdir, f"{name}_disp.npy"))
        want = np.load(os.path.join(jdir, f"{name}_disp.npy"))
        assert ours.shape == want.shape == (1, 1) + size
        np.testing.assert_allclose(ours, want, rtol=1e-4, atol=1e-4)
        # the colour map of the port's display disparity, both ways
        disp = (ours[0, 0] - 1 / 150) / (10 - 1 / 150)
        shown = evaluate_depth.resize_bilinear_np(disp, h, w)
        magma = TS._magma_colormap(shown)
        np.testing.assert_array_equal(magma, JTS._magma_colormap(shown))
        with Image.open(os.path.join(tdir, f"{name}_disp.jpg")) as img:
            assert img.format == "JPEG" and img.size == (w, h)
            jpeg = np.asarray(img.convert("RGB")).astype(int)
        buf = io.BytesIO()
        Image.fromarray(magma).save(buf, "JPEG")
        pil = np.asarray(Image.open(buf)).astype(int)
        assert np.abs(jpeg - magma).mean() <= \
            np.abs(pil - magma).mean() + 0.25
    with open(os.path.join(tdir, "rot_trans.csv")) as f, \
            open(os.path.join(jdir, "rot_trans.csv")) as g:
        ours, want = list(csv.reader(f)), list(csv.reader(g))
    assert [r[0] for r in ours] == [r[0] for r in want] == \
        ["axisangle", "translation"]
    for a, b in zip(ours, want):
        np.testing.assert_allclose(eval(a[1]), eval(b[1]), atol=1e-6)
    np.testing.assert_allclose(
        np.loadtxt(os.path.join(tdir, "transform.csv"), delimiter=","),
        np.loadtxt(os.path.join(jdir, "transform.csv"), delimiter=","),
        atol=1e-6)


def test_entry_points_default_to_the_card(carried, tmp_path):
    """Without device="cpu" the entry points take the card's route and
    raise here (no card, no nvcc) instead of falling back to the CPU."""
    size = ["--height", str(H), "--width", str(W)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_serve.main(size)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.main(size + ["--out", str(tmp_path / "m.pt2")])
    write_png(str(tmp_path / "x.png"), picture(0, 8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.main(["--image_path", str(tmp_path / "x.png"), "--model_path",
                 carried["ckpt"]] + size)
    (tmp_path / "splits" / "eigen_benchmark").mkdir(parents=True)
    (tmp_path / "splits" / "eigen_benchmark" / "test_files.txt").write_text(
        "d 0 l\n")
    gt = tmp_path / "d" / "proj_depth" / "groundtruth" / "image_02"
    gt.mkdir(parents=True)
    write_png(str(gt / f"{0:010d}.png"), np.ones((4, 4), np.uint16))
    with pytest.raises(RuntimeError, match="nvcc"):
        cli_gt.main(["--data_path", str(tmp_path), "--split",
                     "eigen_benchmark", "--split_dir",
                     str(tmp_path / "splits")])


def test_card_routes_need_no_pil_or_matplotlib(carried, tmp_path, engine,
                                               monkeypatch):
    """With PIL and matplotlib unimportable: the file datasets' items,
    cli.build_frame_cache, the HTTP PNG route, cli.test_simple,
    cli.export_gt_depth, --log_images and the benchmark PNGs."""
    lung = tmp_path / "lung" / "seq1"
    lung.mkdir(parents=True)
    for i in range(8):
        write_png(str(lung / f"{i:010d}.png"), picture(i, 40, 72))
    splits = tmp_path / "splits"
    gt = tmp_path / "kitti" / "d" / "proj_depth" / "groundtruth" / "image_02"
    gt.mkdir(parents=True)
    (splits / "eigen_benchmark").mkdir(parents=True)
    (splits / "eigen_benchmark" / "test_files.txt").write_text("d 0 l\n")
    write_png(str(gt / f"{0:010d}.png"),
              np.arange(24 * 36, dtype=np.uint16).reshape(24, 36) * 50)
    for name in ("PIL", "matplotlib"):
        monkeypatch.setitem(sys.modules, name, None)
    from unsupervised_pose_estimation_tpu_torch.data.make_splits import \
        write_split

    write_split(str(tmp_path / "lung"), str(splits / "lung"), suffix="",
                val_fraction=0.4)
    ds = datasets.make_dataset(
        "endovis", data_path=str(tmp_path / "lung"),
        filenames=["seq1 2 l", "seq1 3 l"], height=H, width=W,
        frame_idxs=[0, -1, 1], is_train=True, device_augment=True)
    assert ds.get_item(1, 0)["color"].shape == (3, H, W, 3)
    stats = build_frame_cache.main(
        ["--dataset", "endovis", "--split", "lung", "--split_dir",
         str(splits), "--data_path", str(tmp_path / "lung"), "--height",
         str(H), "--width", str(W), "--frame_cache", str(tmp_path / "c")],
        device="cpu")
    assert stats["train"]["rows"] > 0
    batcher = serve.MicroBatcher(engine)
    server = serve.make_http_server(batcher)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        disp = post(server.server_address[1], encode_png(picture(5, 50, 60)))
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    assert disp.shape == (H, W) and np.isfinite(disp).all()
    TS.main(["--image_path", str(lung / f"{0:010d}.png"), "--model_path",
             carried["ckpt"], "--height", str(H), "--width", str(W)],
            device="cpu")
    assert (lung / f"{0:010d}_disp.jpg").is_file()
    cli_gt.main(["--data_path", str(tmp_path / "kitti"), "--split",
                 "eigen_benchmark", "--split_dir", str(splits)],
                device="cpu")
    maps = np.load(splits / "eigen_benchmark" / "gt_depths.npz",
                   allow_pickle=True)["data"]
    assert maps[0].shape == (24, 36)
    logger = MetricLogger(str(tmp_path / "logs"), "m", jsonl=False)
    logger.log_images("val", {"disp/0": np.ones((8, 8), np.float32)}, 1)
    assert read_png(str(tmp_path / "logs" / "m" / "images" / "step_1" /
                        "val_disp_0.png")).shape == (8, 8)
    evaluate_depth._save_benchmark_pngs(np.ones((1, 8, 8), np.float32),
                                        str(tmp_path / "bench"))
    assert read_png(str(tmp_path / "bench" / f"{0:010d}.png")).dtype == \
        np.uint16
    with pytest.raises(ImportError, match="not a PNG"):
        serve.decode_request(b"\xff\xd8\xff\xe0 a JPEG", H, W)
