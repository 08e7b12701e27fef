"""Shared pieces of the option-group tests (tests/test_torch_options_*.py):
the port's ``forward_and_loss`` under a set of training options against the
JAX package's, on one batch, and a run of ``cli.train`` that resumes from
its own checkpoint.

The step: B=2, 64x128, float32; the weights of the JAX bundle of the
options are drawn with numpy from a seed (``numpy_variables``: no JAX
compile) and carried over by ``convert.from_jax``. Both sides take the same
``color_aug`` frames (the augmentation is compared in
tests/test_torch_augment.py) and the same automask noise:
normal(fold_in(key, s)) * 1e-5 at each scale's identity shape. One
``jax.value_and_grad`` of the JAX ``forward_and_loss`` (train mode) gives
the losses, the gradient and the updated BatchNorm statistics.

Bounds, those tests/test_torch_train.py and tests/test_torch_train_grads.py
hold the default configuration to (their docstrings say why): losses at
rtol 1e-5; the gradient, fixed in float32 only up to the loss's kinks
(ReLU, the coordinate clip, min, |.|), with every element within 5e-2 of
the largest gradient of any leaf, its norm at rtol 1e-2 and the whole of it
within 5e-2 in L2; the running statistics after the step at atol 2e-5.
"""

import contextlib
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_models import perturb
from unsupervised_pose_estimation_tpu.config import Options as JOptions
from unsupervised_pose_estimation_tpu.train.bundle import \
    ModelBundle as JBundle
from unsupervised_pose_estimation_tpu.train.step import \
    forward_and_loss as j_forward_and_loss
from unsupervised_pose_estimation_tpu_torch.cli.train import main
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.convert import from_jax
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle
from unsupervised_pose_estimation_tpu_torch.train.loop import Trainer
from unsupervised_pose_estimation_tpu_torch.train.step import \
    forward_and_loss

B, H, W = 2, 64, 128
KEY = jax.random.PRNGKey(7)
LOSS_RTOL, NORM_RTOL, ELEMENT_ATOL, L2_RTOL, STATS_ATOL = (
    1e-5, 1e-2, 5e-2, 5e-2, 2e-5)
# horizontal shift of each frame of the batch, in pixels
SHIFTS = {0: 0, -1: -2, 1: 3, "s": 1}
K_NORM = np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0],
                   [0, 0, 0, 1]], np.float32)


def options(**kw):
    return dict(height=H, width=W, batch_size=B, compute_dtype="float32",
                **kw)


def frame_list(cfg):
    return list(cfg.frame_ids) + (["s"] if cfg.use_stereo else [])


def make_batch(cfg, seed=0):
    """A smooth random texture seen by every frame of ``cfg`` (then the
    stereo frame), each shifted by SHIFTS with a little noise; color_aug a
    brightness jitter of it; a stereo_T of baseline +-0.1."""
    frames = frame_list(cfg)
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(H + 8), np.arange(W + 8), indexing="ij")
    scene = np.zeros((B, H + 8, W + 8, 3))
    for _ in range(6):
        f = rng.uniform(0.05, 0.4, size=(B, 1, 1, 3))
        g = rng.uniform(0.05, 0.4, size=(B, 1, 1, 3))
        scene += np.sin(f * xs[None, ..., None] + g * ys[None, ..., None]
                        + rng.uniform(0, 6.3, size=(B, 1, 1, 3)))
    scene = (scene - scene.min()) / (scene.max() - scene.min())
    color = np.stack([scene[:, 4:4 + H, 4 + SHIFTS[f]:4 + SHIFTS[f] + W]
                      for f in frames], 1)
    color = color + rng.normal(scale=0.01, size=color.shape)
    color = (np.clip(color, 0, 1) * 255).round().astype(np.uint8)
    aug = np.clip(color * rng.uniform(0.9, 1.1, size=(B, len(frames), 1, 1,
                                                      1)),
                  0, 255).astype(np.uint8)
    stereo_T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    stereo_T[:, 0, 3] = [0.1, -0.1][:B]
    return {"color": color, "color_aug": aug,
            "K_norm": np.tile(K_NORM, (B, 1, 1)), "stereo_T": stereo_T}


def jax_noise(cfg):
    """The JAX step's automask noise at each scale (None without
    automasking): (B, h, w, S) at full size, or the scale's own size under
    v1_multiscale."""
    if cfg.disable_automasking:
        return None
    n_src = len(frame_list(cfg)) - 1
    out = {}
    for s in cfg.scales:
        h, w = (H >> s, W >> s) if cfg.v1_multiscale else (H, W)
        out[s] = torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(KEY, s), (B, h, w, n_src), jnp.float32)
            * 1e-5))
    return out


def numpy_variables(init, *args, seed=0):
    """Variables of the shapes flax's ``init(*args)`` makes, drawn with
    numpy (nothing is compiled: ``jax.eval_shape`` only traces): every
    kernel normal with variance 1 / fan_in (flax's lecun_normal scale),
    then BatchNorm statistics and scales and every bias as ``perturb``
    draws them."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, *args)

    def draw(node, name=""):
        if isinstance(node, dict):
            return {k: draw(v, k) for k, v in node.items()}
        if name == "kernel":
            fan_in = int(np.prod(node.shape[:-1]))
            return (rng.normal(size=node.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        return np.zeros(node.shape, np.float32)

    return {k: perturb(draw(v), rng) for k, v in shapes.items()
            if k in ("params", "batch_stats")}


def jax_weights(kw, seed=0):
    """(JAX bundle, params, batch_stats) of options ``kw``, drawn with
    numpy (``numpy_variables``)."""
    jb = JBundle.create(JOptions(**options(**kw)))
    v = numpy_variables(jb.init, jax.random.PRNGKey(0), seed=seed)
    return jb, v["params"], v["batch_stats"]


def gan_weights(jb, seed=0):
    """The GAN prior's trees of JAX bundle ``jb``, drawn with numpy like
    ``numpy_variables`` (after the other networks', from their own seeds):
    (frozen {'pre_trained_generator': ...} or {}, disc_params or None)."""
    x = jnp.zeros((1, H, W, 1), jnp.float32)
    frozen, disc = {}, None
    if jb.generator is not None:
        frozen["pre_trained_generator"] = numpy_variables(
            jb.generator.init, KEY, x, seed=seed + 100)["params"]
    if jb.discriminator is not None:
        disc = numpy_variables(jb.discriminator.init, KEY, x,
                               seed=seed + 200)["params"]
    return frozen, disc


def jax_reference(kw, grad=True, float64=()):
    """The JAX step of options ``kw`` on ``make_batch``: {'params',
    'stats', 'batch', 'losses', and with ``grad`` 'grads' (a port
    state_dict of the gradients), else 'after' (the statistics after the
    forward, as a port state_dict)}. One compile: the value_and_grad, or
    the forward alone. With the GAN prior, also 'frozen' and
    'disc_params' (``gan_weights``). The networks named in ``float64``
    compute in float64 on the JAX side (modules cloned with
    ``compute_dtype=float64`` under ``jax.enable_x64``; the parameters and
    the gradient stay float32), where the reference's own float32 rounding
    would exceed the bounds."""
    jb, params, stats = jax_weights(kw)
    frozen, disc = gan_weights(jb)
    batch = make_batch(jb.cfg)
    jb = dataclasses.replace(jb, **{
        name: getattr(jb, name).clone(compute_dtype=jnp.float64)
        for name in float64})

    # the frozen generator is an argument: as a constant of the program,
    # XLA would fold its convolutions while compiling
    def loss(p, fz):
        total, (losses, _, new) = j_forward_and_loss(
            jb, p, stats, fz, batch, KEY, train=True)
        return total, (losses, new)

    with jax.enable_x64(True) if float64 else contextlib.nullcontext():
        if grad:
            (_, (losses, new)), g = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(params, frozen)
        else:
            _, (losses, new) = jax.jit(loss)(params, frozen)
        host = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), (losses, new))
    out = dict(params=params, stats=stats, frozen=frozen, disc_params=disc,
               batch=batch,
               losses={k: float(v) for k, v in host[0].items()},
               after=from_jax(params, host[1]))
    if grad:
        out["grads"] = from_jax(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), g), host[1])
    return out


def port_step(kw, ref, grad=True):
    """The port's forward_and_loss (train mode) of options ``kw`` from the
    reference's weights, batch and noise -> (losses, {name: gradient} of
    the parameters the step trains, state_dict after)."""
    cfg = Options(**options(**kw))
    bundle = port_bundle(cfg, ref)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    total, (losses, _) = forward_and_loss(bundle, batch, train=True,
                                          noise=jax_noise(cfg))
    grads = {}
    if grad:
        total.backward()
        grads = {n: p.grad for n, p in bundle.named_main_parameters()}
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            bundle.state_dict())


def port_bundle(cfg, ref):
    """A port bundle of ``cfg`` on the CPU holding ``jax_reference``'s
    weights."""
    bundle = ModelBundle.create(cfg, device="cpu")
    bundle.load_state_dict(from_jax(ref["params"], ref["stats"],
                                    ref["frozen"], ref["disc_params"]),
                           strict=True)
    return bundle


def compare_losses(got, want):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=LOSS_RTOL,
                                   err_msg=name)


def compare_stats(sd, want):
    running = [n for n in want if "running" in n]
    assert running
    for n in running:
        np.testing.assert_allclose(sd[n].numpy(), want[n].numpy(), rtol=0,
                                   atol=STATS_ATOL, err_msg=n)


def compare_step(port, ref):
    """Losses, gradient and statistics of ``port_step`` against
    ``jax_reference`` at the module docstring's bounds."""
    losses, grads, sd = port
    compare_losses(losses, ref["losses"])
    want = {n: ref["grads"][n] for n in ref["grads"] if "running" not in n
            and not n.endswith("num_batches_tracked")}
    assert sorted(grads) == sorted(want)
    assert all(g is not None for g in grads.values())
    scale = max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=ELEMENT_ATOL * scale, err_msg=name)
    diff = np.sqrt(sum(float(((grads[n] - want[n]).double() ** 2).sum())
                       for n in want))
    norm = np.sqrt(sum(float((w.double() ** 2).sum())
                       for w in want.values()))
    port_norm = np.sqrt(sum(float((g.double() ** 2).sum())
                            for g in grads.values()))
    np.testing.assert_allclose(port_norm, norm, rtol=NORM_RTOL)
    assert diff <= L2_RTOL * norm, diff / norm
    compare_stats(sd, ref["after"])


# cli.train at a small size: 3 steps, checkpoints at step 2 and at the
# epoch's end, validation at every step
TRAIN_ARGS = ["--height", "32", "--width", "64", "--batch_size", "2",
              "--compute_dtype", "float32", "--weights_init", "scratch",
              "--num_epochs", "1", "--num_workers", "2",
              "--steps_per_epoch", "3", "--log_frequency", "1",
              "--ckpt_frequency", "2"]


def records(log_dir):
    with open(os.path.join(log_dir, "mdp", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def resume_is_bit_exact(tmp_path, args):
    """cli.train with ``args`` for 3 steps, and a Trainer resumed from the
    checkpoint of step 2: the third step's losses, then every parameter,
    BatchNorm statistic and Adam moment (the discriminator's Adam's too),
    bit-equal; -> the first Trainer."""
    straight = main(TRAIN_ARGS + args + ["--log_dir", str(tmp_path / "a")],
                    device="cpu")
    ckpt_dir = tmp_path / "a" / "mdp" / "models" / "checkpoints"
    assert sorted(os.listdir(ckpt_dir)) == ["2.pt", "3.pt", "opt.json"]
    resume_dir = tmp_path / "from_step_2"
    resume_dir.mkdir()
    shutil.copy(ckpt_dir / "2.pt", resume_dir / "2.pt")
    resumed = Trainer(dataclasses.replace(
        straight.cfg, log_dir=str(tmp_path / "b"),
        load_weights_folder=str(resume_dir)), device="cpu")
    assert resumed.state.step == 2
    resumed.train()

    def train_losses(log_dir):
        return {r["step"]: {k: v for k, v in r.items() if k != "time"}
                for r in records(log_dir) if r["mode"] == "train"}

    a, b = train_losses(tmp_path / "a"), train_losses(tmp_path / "b")
    assert sorted(a) == [0, 1, 2] and sorted(b) == [2]
    assert a[2] == b[2]
    assert all(np.isfinite(v) for r in records(tmp_path / "a")
               for k, v in r.items() if isinstance(v, float))
    assert resumed.state.step == straight.state.step == 3
    sa, sb = straight.bundle.state_dict(), resumed.bundle.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
    optimizers = ["optimizer"] + (["disc_optimizer"]
                                  if straight.state.disc_optimizer else [])
    for name in optimizers:
        oa = getattr(straight.state, name).state_dict()["state"]
        ob = getattr(resumed.state, name).state_dict()["state"]
        assert oa.keys() == ob.keys() and oa, name
        for i in oa:
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(oa[i][key], ob[i][key]), (name, i, key)
    return straight


def write_stereo_cache(root, h=32, w=64, lines=8):
    """A lung-style split (``lines`` train and val lines of one sequence,
    left camera) and a frame cache, written with numpy in the format
    data/cache.py reads, of every frame they reach with frames (0, -1, 1)
    and the right camera's frame ("s"); -> the cli.train arguments that
    read it."""
    from unsupervised_pose_estimation_tpu_torch.data.cache import (
        FRAMES_FILE, INDEX_FILE, dataset_fingerprint, enumerate_frames,
        frame_key)
    from unsupervised_pose_estimation_tpu_torch.data.datasets import \
        LungRAWDataset

    data_path = os.path.join(root, "lung_data")  # holds no image file
    os.makedirs(data_path)
    split_dir = os.path.join(root, "splits", "stereo")
    os.makedirs(split_dir)
    rng = np.random.default_rng(12)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for mode, first in (("train", 1), ("val", 101)):
        names = [f"seq1 {i} l" for i in range(first, first + lines)]
        with open(os.path.join(split_dir, f"{mode}_files.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
        ds = LungRAWDataset(data_path, names, h, w, [0, -1, 1, "s"])
        keys = enumerate_frames(ds)
        frames = np.empty((len(keys), h, w, 3), np.uint8)
        for row, (_, fi, side) in enumerate(keys):
            # a smooth texture sliding 2 px a frame; the right camera 1 px
            # further
            x = xs + 2 * fi + (side == "r")
            phase = rng.uniform(0, 6.3, 3)
            for c in range(3):
                frames[row, ..., c] = 127.5 + 127 * np.sin(
                    0.05 * x + 0.03 * ys * (c + 1) + phase[c])
        out = os.path.join(root, "cache", mode)
        os.makedirs(out)
        np.save(os.path.join(out, FRAMES_FILE), frames)
        with open(os.path.join(out, INDEX_FILE), "w") as f:
            json.dump({"height": h, "width": w, "rows": len(keys),
                       "fingerprint": dataset_fingerprint(ds),
                       "index": {frame_key(*k): r
                                 for r, k in enumerate(keys)}}, f)
    return ["--dataset", "endovis", "--split", "stereo", "--split_dir",
            os.path.join(root, "splits"), "--data_path", data_path,
            "--frame_cache", os.path.join(root, "cache")]
