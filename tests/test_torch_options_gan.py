"""Option group D: the GAN prior, ``pre_trained_generator`` with
``adversarial_prior`` on the default configuration, against the JAX
package (tests/torch_option_steps.py has the setup and the bounds): the
training step with each scale's ``gan_loss/{s}``, the discriminator's
step, the gradient norm over the main parameters only, and ``cli.train``
with a reference-layout generator ``.pth``, resumed bit-exactly, whose
checkpoint then evaluates and serves with the run's options.

The reference's pose networks run in float64 here
(``jax_reference(float64=...)``): at these weights its float32 poses are
3-5e-5 of their largest away from its own float64 ones (the port's float32
poses 5e-6), which moves its photometric losses by 1.5e-5, past the
helper's 1e-5 (``test_reference_float32_pose_gap`` measures it). With its
pose networks in float64 the losses agree to 2.6e-6.
"""

import dataclasses
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_option_steps as T
from tests.torch_oracle import RefGenerator
from unsupervised_pose_estimation_tpu.train import step as JS
from unsupervised_pose_estimation_tpu.train.state import TrainState as JState
from unsupervised_pose_estimation_tpu.train.state import \
    make_disc_optimizer as j_disc_optimizer
from unsupervised_pose_estimation_tpu.train.step import \
    build_disc_step as j_build_disc_step
from unsupervised_pose_estimation_tpu.train.step import \
    predict_poses as j_predict_poses
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.convert import \
    discriminator_from_jax
from unsupervised_pose_estimation_tpu_torch.eval.evaluate_depth import \
    load_eval_state
from unsupervised_pose_estimation_tpu_torch.serve import InferenceEngine
from unsupervised_pose_estimation_tpu_torch.train.state import \
    create_train_state
from unsupervised_pose_estimation_tpu_torch.train.step import (
    build_disc_step, build_infer_step, build_train_step, global_norm,
    pose_parameters)

OPTIONS = dict(pre_trained_generator=True, adversarial_prior=True)
FLOAT64 = ("pose_encoder", "pose")
DISC_RTOL = 1e-5
GAN_ARGS = ["--pre_trained_generator", "--adversarial_prior"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    return T.jax_reference(OPTIONS, float64=FLOAT64)


def batch_of(ref):
    return {k: torch.from_numpy(v) for k, v in ref["batch"].items()}


def test_step_matches_jax(reference):
    """Losses (each scale's gan_loss among them), the gradient of the
    parameters the step trains and the statistics after it; the prior is
    masked where the random generator's depth is negative."""
    assert all(f"gan_loss/{s}" in reference["losses"] for s in range(4))
    T.compare_step(T.port_step(OPTIONS, reference), reference)


def test_reference_float32_pose_gap(reference):
    """Why the reference's pose networks run in float64: its float32
    translations on this batch are further than 1e-5 of their largest from
    its float64 ones, and the port's float32 ones are nearer to those."""
    jb, params, stats = T.jax_weights(OPTIONS)
    batch = reference["batch"]
    trans = {}
    for name in ("float32", "float64"):
        net = jb if name == "float32" else dataclasses.replace(jb, **{
            n: getattr(jb, n).clone(compute_dtype=jnp.float64)
            for n in FLOAT64})
        with jax.enable_x64(name == "float64"):
            aug = {f: jnp.asarray(batch["color_aug"][:, i] / 255.0,
                                  jnp.float32)
                   for i, f in enumerate(jb.cfg.frame_ids)}
            raw = jax.jit(lambda p, a: j_predict_poses(
                net, p, stats, a, True)[1])(params, aug)
            trans[name] = {f: np.asarray(raw[f][1], np.float64)
                           for f in (-1, 1)}
    bundle = T.port_bundle(Options(**T.options(**OPTIONS)), reference)
    bundle.train(True)
    port = pose_parameters(bundle, {
        f: torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()
        for f, a in aug.items()})
    for f in (-1, 1):
        truth = trans["float64"][f]
        scale = np.abs(truth).max()
        jax_gap = np.abs(trans["float32"][f] - truth).max() / scale
        port_gap = np.abs(port[f][1].detach().numpy() - truth).max() / scale
        assert jax_gap > 1e-5 and port_gap < jax_gap, (f, jax_gap, port_gap)


def test_jax_step_fails_under_v1_multiscale():
    """What the port's refusal of pre_trained_generator with v1_multiscale
    stands for: the JAX step's silog_loss of the full-size prior against
    scale 1's own disparity fails while it traces (jax.eval_shape: nothing
    compiles)."""
    kw = dict(pre_trained_generator=True, v1_multiscale=True)
    jb, params, stats = T.jax_weights(kw)
    frozen, _ = T.gan_weights(jb)
    batch = T.make_batch(jb.cfg)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda p: JS.forward_and_loss(
            jb, p, stats, frozen, batch, T.KEY, train=True)[0], params)


def test_disc_step_matches_jax(reference):
    """One discriminator step from the same weights and batch as the JAX
    package's build_disc_step, on the real samples that step drew (read
    from inside it with ``jax.debug.callback``: they are the generator's
    disparities, 1 / (1 + 1e5 t) of its tanh output t, which multiplies
    the generator's float32 rounding by up to 1e5 where t is near 0, and
    a random generator puts pixels there, so that two compiles of the
    same JAX generator already move the loss by 0.2%; the generators are
    held to each other in tests/test_torch_gan_models.py): the loss to
    DISC_RTOL; the discriminator's parameters after its Adam step within
    2 lr of the reference's plus 1e-6 (an element whose gradient is at
    the level of float32 rounding can move either way, as chip_smoke.py
    bounds a step), and the update of all but 1e-3 of them to 1e-3 lr."""
    cfg = Options(**T.options(**OPTIONS))
    disc = reference["disc_params"]
    state = JState(step=jnp.zeros((), jnp.int32), params=reference["params"],
                   batch_stats=reference["stats"], frozen=reference["frozen"],
                   opt_state=None, disc_params=disc,
                   disc_opt_state=j_disc_optimizer(
                       cfg.discriminator_lr, cfg.b1, cfg.b2).init(disc))
    seen = []
    depth_to_disp = JS.G.depth_to_disp

    def recorded(depth):
        out = depth_to_disp(depth)
        jax.debug.callback(lambda d: seen.append(np.array(d)), out[1])
        return out

    with mock.patch.object(JS.G, "depth_to_disp", recorded):
        new, want = j_build_disc_step(T.JBundle.create(T.JOptions(
            **T.options(**OPTIONS))))(state, reference["batch"], T.KEY)
        jax.block_until_ready(new.disc_params)
    assert len(seen) == 1
    real = torch.from_numpy(seen[0].transpose(0, 3, 1, 2).copy())
    want_sd = discriminator_from_jax(jax.tree_util.tree_map(
        np.asarray, new.disc_params))

    bundle = T.port_bundle(cfg, reference)
    port_state = create_train_state(bundle)
    before = {k: v.clone() for k, v in bundle.discriminator.state_dict()
              .items()}
    got = build_disc_step(bundle)(port_state, batch_of(reference),
                                  real=real)
    np.testing.assert_allclose(float(got["disc_loss"]),
                               float(want["disc_loss"]), rtol=DISC_RTOL)
    lr = cfg.discriminator_lr
    off = total = 0
    for name, value in bundle.discriminator.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_sd[name].numpy(),
                                   rtol=0, atol=2 * lr + 1e-6, err_msg=name)
        step_err = ((value - before[name]) - (want_sd[name] - before[name]))
        off += int((step_err.abs() > 1e-3 * lr).sum())
        total += value.numel()
    assert off <= 1e-3 * total, off / total
    # the main networks are not touched
    assert port_state.step == 0


def test_grad_norm_is_over_the_main_parameters(reference):
    """The training step updates and measures only the JAX package's
    ``params``: grad_norm is the norm of the main parameters' gradients
    (the reference's to NORM_RTOL), the generator has no gradient, the
    discriminator's parameters get none from this step, and the main Adam
    holds neither network."""
    cfg = Options(**T.options(**OPTIONS))
    bundle = T.port_bundle(cfg, reference)
    state = create_train_state(bundle)
    held = [p for g in state.optimizer.param_groups for p in g["params"]]
    assert [id(p) for p in held] == [id(p) for p in bundle.main_parameters()]
    assert [id(p) for p in state.disc_optimizer.param_groups[0]["params"]] \
        == [id(p) for p in bundle.discriminator.parameters()]
    losses = build_train_step(bundle)(state, batch_of(reference),
                                      noise=T.jax_noise(cfg))
    main = bundle.main_parameters()
    assert torch.equal(losses["grad_norm"],
                       global_norm([p.grad for p in main]))
    want = np.sqrt(sum(float((g.double() ** 2).sum())
                       for n, g in reference["grads"].items()
                       if "running" not in n
                       and not n.endswith("num_batches_tracked")))
    np.testing.assert_allclose(float(losses["grad_norm"]), want,
                               rtol=T.NORM_RTOL)
    assert all(p.grad is None for p in bundle.generator.parameters())
    assert all(p.grad is None for p in bundle.discriminator.parameters())


def test_cli_train_resumes_bit_exact_and_evaluates(tmp_path, reference):
    """cli.train with a reference-layout generator .pth (9 residual blocks)
    for 3 steps, and a resumed step 3 bit-equal, the discriminator's weights
    and Adam moments included; metrics.jsonl has the JAX Trainer's keys
    (the JAX step's losses, grad_norm and disc_loss); the checkpoint
    evaluates (load_eval_state) and serves (InferenceEngine) with the run's
    options and no generator_weights, and is refused without the prior's
    options, as the JAX package refuses it."""
    gen = torch.Generator().manual_seed(8)
    ref_gen = RefGenerator(n_res=9)
    with torch.no_grad():
        for p in ref_gen.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    path = str(tmp_path / "G_AB.pth")
    torch.save(ref_gen.state_dict(), path)
    trainer = T.resume_is_bit_exact(tmp_path, [
        "--dataset", "synthetic_parallax", "--generator_weights", path,
        *GAN_ARGS])
    for name, value in ref_gen.state_dict().items():
        assert torch.equal(trainer.bundle.generator.state_dict()[name],
                           value), name

    want = set(reference["losses"]) | {"grad_norm", "disc_loss"}
    with open(tmp_path / "a" / "mdp" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    for r in records:
        keys = set(r) - {"mode", "step", "time", "learning_rate"}
        if r["mode"] == "train":
            assert keys == want, keys ^ want
        else:
            assert set(reference["losses"]) <= keys

    ckpt = str(tmp_path / "a" / "mdp" / "models" / "checkpoints")
    opt = dataclasses.replace(trainer.cfg, generator_weights=None,
                              load_weights_folder=ckpt)
    bundle = load_eval_state(opt, "cpu")
    trained = trainer.bundle.state_dict()
    for name, value in bundle.state_dict().items():
        assert torch.equal(value, trained[name]), name
    images = torch.rand((2, 32, 64, 3), generator=gen)
    engine = InferenceEngine(opt, max_batch=2, device="cpu")
    want_disp = build_infer_step(trainer.bundle)(images)[0][..., 0]
    np.testing.assert_array_equal(engine.predict(images.numpy()),
                                  want_disp.numpy())
    plain = dataclasses.replace(opt, pre_trained_generator=False,
                                adversarial_prior=False)
    with pytest.raises(ValueError, match="pre_trained_generator"):
        load_eval_state(plain, "cpu")
    assert os.path.isfile(os.path.join(ckpt, "3.pt"))
