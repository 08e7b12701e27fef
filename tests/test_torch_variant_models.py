"""The networks of the training options against the JAX package's: the
nearest 2x upsample, the upstream monodepth2 decoder, the predictive-mask
decoder (the fork decoder with one output per source frame) and PoseCNN on
pairs and on all frames.

Weights: those of the compared networks of the JAX bundle of each option
set (64x128) are drawn with numpy from a seed
(tests/torch_option_steps.py's ``numpy_variables``), and carried over by
``convert``'s maps of each network (those ``convert.from_jax`` applies to a
whole bundle; the option groups' step tests load whole bundles through it).
In float32 the outputs are held at that file's RTOL/ATOL; in bfloat16 by
the JAX package's own bfloat16-against-float32 gap on the same inputs
(tests/test_torch_bf16_models.py's ``within_gap``). Inputs have 64 rows or
more (the JAX package's pad writes stray values on one-row maps).

Reference-layout ``.pth`` files of PoseCNN (``tests/torch_oracle.py``'s
``RefPoseCNN``) and of an upstream decoder (``RefUpstreamDecoder`` below,
in upstream monodepth2's ModuleList order) load into the same weights
through both packages' importers, and a ``.pth`` folder with the upstream
decoder gives the same disparities through the port's ``load_eval_state``
and ``InferenceEngine`` as through the JAX package's ``load_eval_state``.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from tests import torch_oracle as oracle
from tests.test_torch_bf16_models import within_gap
from tests.test_torch_models import ATOL, RTOL
from tests.torch_option_steps import numpy_variables
from unsupervised_pose_estimation_tpu.config import Options as JOptions
from unsupervised_pose_estimation_tpu.eval.evaluate_depth import \
    load_eval_state as j_load_eval_state
from unsupervised_pose_estimation_tpu.ops.resize import \
    upsample2x_nearest as j_upsample2x_nearest
from unsupervised_pose_estimation_tpu.train import checkpoint as jck
from unsupervised_pose_estimation_tpu.train.bundle import \
    ModelBundle as JBundle
from unsupervised_pose_estimation_tpu.train.step import \
    build_infer_step as j_build_infer_step
from unsupervised_pose_estimation_tpu_torch import convert
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.eval.evaluate_depth import \
    load_eval_state
from unsupervised_pose_estimation_tpu_torch.ops.resize import \
    upsample2x_nearest
from unsupervised_pose_estimation_tpu_torch.serve import InferenceEngine
from unsupervised_pose_estimation_tpu_torch.train import checkpoint as ck
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle
from unsupervised_pose_estimation_tpu_torch.train.step import \
    build_infer_step

H, W = 64, 128
DTYPES = ("float32", "bfloat16")
# the option sets whose networks are compared: the upstream decoder and
# the mask decoder with PoseCNN over all frames, and PoseCNN over pairs
OPTION_SETS = {
    "all": dict(pose_model_type="posecnn", pose_model_input="all",
                predictive_mask=True, disable_automasking=True,
                depth_decoder_variant="upstream"),
    "pairs": dict(pose_model_type="posecnn"),
}
NETWORKS = [("depth", "all"), ("predictive_mask", "all"), ("pose", "all"),
            ("pose", "pairs")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nets():
    """Per option set: JAX bundles and port bundles at both dtypes, their
    compared networks on the same weights (mapped by convert's per-network
    maps, which ``from_jax`` applies to a whole bundle), and those weights
    as flax trees."""
    out = {}
    for key, kw in OPTION_SETS.items():
        jax_b = {dt: JBundle.create(JOptions(height=H, width=W,
                                             compute_dtype=dt, **kw))
                 for dt in DTYPES}
        j32 = jax_b["float32"]
        cfg = Options(height=H, width=W, **kw)
        names = [n for n, o in NETWORKS if o == key]
        params, stats = {}, {}
        for k, name in enumerate(names):
            x = network_inputs(name, cfg, 0)
            mod = getattr(j32, name)
            init = (mod.init if name == "pose" else
                    lambda r, f, m=mod: m.init(r, f, False))
            v = numpy_variables(init, jax.random.PRNGKey(0), x, seed=k)
            params[name] = v["params"]
            stats[name] = v.get("batch_stats", {})
        port = {}
        for dt in DTYPES:
            port[dt] = ModelBundle.create(
                Options(height=H, width=W, compute_dtype=dt, **kw),
                device="cpu")
            for name in names:
                sd = {}
                if name == "pose":
                    convert._pose(sd, "m", params[name])
                else:
                    convert._depth(sd, "m", params[name], stats[name])
                getattr(port[dt], name).load_state_dict(
                    {k[2:]: torch.tensor(np.array(v))
                     for k, v in sd.items()}, strict=True)
        out[key] = (jax_b, params, stats, port)
    return out


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def network_inputs(name, cfg, seed):
    """The network's input at 64x128: encoder features of a random image
    for the decoders (the same features on both sides), stacked frames for
    PoseCNN."""
    rng = np.random.default_rng(seed)
    if name == "pose":
        return rng.uniform(size=(4, H, W, 3 * cfg.num_pose_frames)).astype(
            np.float32)
    chans = (64, 64, 128, 256, 512)
    return [rng.normal(size=(2, H >> (k + 1), W >> (k + 1), c)).astype(
        np.float32) for k, c in enumerate(chans)]


def run_both(net, name, dt, x, train=False):
    """-> (port outputs, JAX outputs, port running stats, JAX stats) of
    network ``name`` at dtype ``dt``: decoders as {scale: NHWC}, PoseCNN
    as [axisangle, translation]."""
    jax_b, params, stats, port = net
    jmod, pmod = getattr(jax_b[dt], name), getattr(port[dt], name)
    if name == "pose":
        want = jax.jit(jmod.apply)({"params": params["pose"]},
                                   jnp.asarray(x))
        with torch.no_grad():
            got = pmod(nchw(x))
        return ([t.numpy() for t in got], [as_np(a) for a in want], {}, {})
    variables = {"params": params[name], "batch_stats": stats.get(name, {})}
    if train:
        want, new = jax.jit(lambda v, f: jmod.apply(
            v, f, True, mutable=["batch_stats"]))(variables, x)
        new = new.get("batch_stats", {})
    else:
        want, new = jax.jit(lambda v, f: jmod.apply(v, f, False))(
            variables, x), {}
    if train:
        # a copy: the forward updates the running statistics
        pmod = copy.deepcopy(pmod).train(True)
    with torch.no_grad():
        got = pmod([nchw(f) for f in x])
    sd = {}
    if new:
        convert._depth(sd, "m", params[name], new)
    ours = {k: v for k, v in pmod.state_dict().items() if "running" in k}
    theirs = {k[2:]: torch.tensor(np.array(v)) for k, v in sd.items()
              if "running" in k}
    return ({s: nhwc(t) for s, t in got.items()},
            {s: as_np(a) for s, a in want.items()}, ours, theirs)


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 16, 2, 4),
                                   (2, 32, 8, 1)])
def test_upsample2x_nearest_matches_jax(shape):
    """The forward is the JAX package's exactly; the backward is the sum
    over each 2x2 block, as JAX's transpose of its broadcast."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    b, c, h, w = shape
    g = rng.normal(size=(b, c, 2 * h, 2 * w)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = upsample2x_nearest(xt)
    out.backward(torch.from_numpy(g))
    want, vjp = jax.vjp(j_upsample2x_nearest,
                        jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(nhwc(out.detach()), np.asarray(want))
    (gx,) = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gx), rtol=0,
                               atol=1e-6)
    blocks = g.reshape(b, c, h, 2, w, 2).sum(axis=(3, 5))
    np.testing.assert_allclose(xt.grad.numpy(), blocks, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,options", NETWORKS)
def test_variant_networks_match_jax(nets, name, options):
    """float32, BatchNorm on running statistics."""
    cfg = Options(**OPTION_SETS[options])
    x = network_inputs(name, cfg, 2)
    got, want, _, _ = run_both(nets[options], name, "float32", x)
    if name == "pose":
        assert got[0].shape == (4, cfg.num_pose_frames - 1, 1, 3)
        for t, j in zip(got, want):
            # 0.01 x a spatial mean: the tolerance scales with it
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-6)
        return
    channels = 2 if name == "predictive_mask" else 1
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for s in want:
        assert got[s].shape == (2, H >> s, W >> s, channels)
        np.testing.assert_allclose(got[s], want[s], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["depth", "predictive_mask"])
def test_variant_decoders_train_mode_match_jax(nets, name):
    """float32, BatchNorm on batch statistics: the outputs, and the mask
    decoder's running statistics after the forward (the upstream decoder
    has no BatchNorm)."""
    x = network_inputs(name, Options(), 3)
    got, want, ours, theirs = run_both(nets["all"], name, "float32", x,
                                       train=True)
    for s in want:
        np.testing.assert_allclose(got[s], want[s], rtol=RTOL, atol=ATOL)
    assert sorted(ours) == sorted(theirs)
    assert bool(ours) == (name == "predictive_mask")
    for k in ours:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name,options", NETWORKS)
def test_bf16_variant_networks_match_jax(nets, name, options):
    """bfloat16 convolutions, float32 sigmoid and pose mean: float32 out,
    within the JAX package's own bfloat16-float32 gap."""
    cfg = Options(**OPTION_SETS[options])
    x = network_inputs(name, cfg, 4)
    runs = {dt: run_both(nets[options], name, dt, x)[:2] for dt in DTYPES}
    if name == "pose":
        # axis-angle and translation together, as test_torch_bf16_models.py
        # holds the pose network
        runs = {dt: tuple([np.concatenate(r, -1)] for r in run)
                for dt, run in runs.items()}
    (got16, want16), (got32, want32) = runs["bfloat16"], runs["float32"]
    keys = range(1) if name == "pose" else want16
    for k in keys:
        assert got16[k].dtype == np.float32
        within_gap(got16[k], got32[k], want16[k], want32[k],
                   f"{name} ({options}) output {k}")


class RefUpstreamDecoder(nn.Module):
    """Upstream monodepth2's DepthDecoder in its ModuleList order: the two
    ConvBlocks of each level i = 4..0 (``decoder.0-9``), then the
    disparity heads by scale (``decoder.10+``); nearest 2x upsample, no
    BatchNorm."""

    CH = (16, 32, 64, 128, 256)

    def __init__(self, enc_ch=(64, 64, 128, 256, 512), scales=(0, 1, 2, 3)):
        super().__init__()
        self.scales = sorted(scales)
        mods = []
        for i in range(4, -1, -1):
            cin = enc_ch[-1] if i == 4 else self.CH[i + 1]
            mods.append(oracle._ConvBlock(cin, self.CH[i]))
            skip = enc_ch[i - 1] if i > 0 else 0
            mods.append(oracle._ConvBlock(self.CH[i] + skip, self.CH[i]))
        mods += [oracle._Conv3x3(self.CH[s], 1) for s in self.scales]
        self.decoder = nn.ModuleList(mods)

    def forward(self, feats):
        out, x = {}, feats[-1]
        for j, i in enumerate(range(4, -1, -1)):
            x = F.interpolate(self.decoder[2 * j](x), scale_factor=2,
                              mode="nearest")
            if i > 0:
                x = torch.cat([x, feats[i - 1]], 1)
            x = self.decoder[2 * j + 1](x)
            if i in self.scales:
                head = self.decoder[10 + self.scales.index(i)]
                out[i] = torch.sigmoid(head(x))
        return out


def seeded(cls, seed, *args):
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return cls(*args)


@pytest.mark.parametrize("kind", ["posecnn_pairs", "posecnn_all",
                                  "upstream"])
def test_pth_imports_match_jax(tmp_path, kind):
    """A reference-layout file loads into the same weights through the
    JAX importer (mapped by from_jax) and the port's, and the port's
    network then computes what the reference module does."""
    path = str(tmp_path / "net.pth")
    if kind == "upstream":
        ref = seeded(RefUpstreamDecoder, 5)
        torch.save(ref.state_dict(), path)
        tree = jck.import_depth_decoder(path)
        assert tree["variant"] == "upstream"
        assert ck.import_depth_decoder(path)["variant"] == "upstream"
        want = {}
        convert._depth(want, "m", tree["params"], {})
        port = ModelBundle.create(Options(
            height=H, width=W, compute_dtype="float32",
            depth_decoder_variant="upstream"), device="cpu").depth
        ck.load_into(port, ck.import_depth_decoder(path)["state_dict"])
        x = [torch.from_numpy(f).permute(0, 3, 1, 2).contiguous()
             for f in network_inputs("depth", Options(), 6)]
    else:
        n = 3 if kind == "posecnn_all" else 2
        ref = seeded(oracle.RefPoseCNN, 5, n)
        torch.save(ref.state_dict(), path)
        want = {}
        convert._pose(want, "m", jck.import_pose_cnn(path)["params"])
        port = ModelBundle.create(Options(
            height=H, width=W, compute_dtype="float32",
            pose_model_type="posecnn",
            pose_model_input="all" if n == 3 else "pairs"),
            device="cpu").pose
        ck.load_into(port, ck.import_pose_cnn(path)["state_dict"])
        x = torch.from_numpy(np.random.default_rng(6).uniform(
            size=(2, 3 * n, H, W)).astype(np.float32))
    ours = port.state_dict()
    assert sorted(ours) == sorted(k[2:] for k in want)
    for k, v in want.items():
        np.testing.assert_array_equal(ours[k[2:]].numpy(), np.asarray(v),
                                      err_msg=k)
    with torch.no_grad():
        got, exp = port(x), ref(x)
    pairs = got.items() if kind == "upstream" else enumerate(got)
    for k, t in pairs:
        np.testing.assert_allclose(t.numpy(), exp[k].numpy(), rtol=RTOL,
                                   atol=1e-6)


def test_upstream_pth_folder_serves_the_detected_variant(tmp_path, capsys):
    """A .pth folder holding an encoder and an upstream decoder, with the
    options at the default fork variant: the port's load_eval_state and
    InferenceEngine build the detected upstream decoder and give the
    disparities of the JAX package's load_eval_state."""
    folder = str(tmp_path / "pth")
    os.makedirs(folder)
    torch.save(seeded(oracle.RefResnetEncoder, 7, 1).state_dict(),
               os.path.join(folder, "encoder.pth"))
    torch.save(seeded(RefUpstreamDecoder, 8).state_dict(),
               os.path.join(folder, "depth.pth"))
    common = dict(height=H, width=W, compute_dtype="float32",
                  load_weights_folder=folder)
    images = np.random.default_rng(9).uniform(size=(2, H, W, 3)).astype(
        np.float32)
    jb, state = j_load_eval_state(JOptions(**common))
    assert jb.cfg.depth_decoder_variant == "upstream"
    want = j_build_infer_step(jb)(state.params, state.batch_stats,
                                  jnp.asarray(images))
    capsys.readouterr()
    bundle = load_eval_state(Options(**common), device="cpu")
    assert "detected as 'upstream'" in capsys.readouterr().out
    assert bundle.depth.variant == "upstream"
    got = build_infer_step(bundle)(torch.from_numpy(images))
    for s in want:
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]),
                                   rtol=RTOL, atol=ATOL)
    engine = InferenceEngine(Options(**common), max_batch=2, device="cpu")
    assert engine.bundle.depth.variant == "upstream"
    np.testing.assert_allclose(engine.predict(images),
                               np.asarray(want[0])[..., 0], rtol=RTOL,
                               atol=ATOL)


def test_pth_folder_of_a_posecnn_run(tmp_path, capsys):
    """``load_pth_folder`` with the default models_to_load for a PoseCNN
    run over all frames: ``pose.pth`` loads as a PoseCNN (the JAX
    importer's weights, mapped by convert), and a ``pose_encoder.pth``
    beside it is skipped, since the run has no pose encoder."""
    folder = tmp_path / "pth"
    folder.mkdir()
    torch.save(seeded(oracle.RefPoseCNN, 9, 3).state_dict(),
               folder / "pose.pth")
    torch.save(seeded(oracle.RefResnetEncoder, 9, 2).state_dict(),
               folder / "pose_encoder.pth")
    bundle = ModelBundle.create(Options(
        height=H, width=W, compute_dtype="float32",
        **OPTION_SETS["all"]), device="cpu")
    ck.load_pth_folder(bundle, str(folder))
    out = capsys.readouterr().out
    assert "This run has no pose_encoder" in out
    want = {}
    convert._pose(want, "m", jck.import_pose_cnn(
        str(folder / "pose.pth"))["params"])
    ours = bundle.pose.state_dict()
    assert sorted(ours) == sorted(k[2:] for k in want)
    for k, v in want.items():
        np.testing.assert_array_equal(ours[k[2:]].numpy(), np.asarray(v),
                                      err_msg=k)
