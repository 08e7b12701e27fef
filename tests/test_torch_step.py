"""The port's validation step, inference step and serving against the JAX
package, with the JAX weights carried over by ``convert.from_jax``.

The batch (B=2, 64x128, three frames) is made with numpy from a seed:
smooth textured frames, the sources shifted copies of the target, so the
photometric terms see structure rather than noise. The JAX step runs its
plain XLA path on the CPU; the automask tie-break noise it draws is handed
to the port. Both sides run in float32.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_pose_estimation_tpu.config import Options as JOptions
from unsupervised_pose_estimation_tpu.train.bundle import \
    ModelBundle as JBundle
from unsupervised_pose_estimation_tpu.train.state import TrainState
from unsupervised_pose_estimation_tpu.train.step import \
    build_eval_step as j_build_eval_step
from unsupervised_pose_estimation_tpu.train.step import \
    build_infer_step as j_build_infer_step
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.convert import from_jax
from unsupervised_pose_estimation_tpu_torch.serve import (InferenceEngine,
                                                           MicroBatcher)
from unsupervised_pose_estimation_tpu_torch.train import step as tstep
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle

B, H, W = 2, 64, 128
KEY = jax.random.PRNGKey(3)


def perturb(tree, rng):
    """Redraw BatchNorm statistics/scales and biases away from their init."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.array(node, np.float32)
        if name in ("mean", "bias"):
            return rng.normal(scale=0.1, size=a.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        return a
    return walk(tree)


def make_batch(seed=0):
    """Smooth random texture; frames -1 and 1 are copies shifted by -2 and
    +3 pixels with a little noise; color_aug is a brightness jitter."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(H + 8), np.arange(W + 8), indexing="ij")
    scene = np.zeros((B, H + 8, W + 8, 3))
    for _ in range(6):
        f = rng.uniform(0.05, 0.4, size=(B, 1, 1, 3))
        g = rng.uniform(0.05, 0.4, size=(B, 1, 1, 3))
        scene += np.sin(f * xs[None, ..., None] + g * ys[None, ..., None]
                        + rng.uniform(0, 6.3, size=(B, 1, 1, 3)))
    scene = (scene - scene.min()) / (scene.max() - scene.min())
    frames = [scene[:, 4:4 + H, 4 + dx:4 + dx + W] for dx in (0, -2, 3)]
    color = np.stack(frames, 1) + rng.normal(scale=0.01, size=(B, 3, H, W, 3))
    color = (np.clip(color, 0, 1) * 255).round().astype(np.uint8)
    aug = np.clip(color * rng.uniform(0.9, 1.1, size=(B, 3, 1, 1, 1)), 0,
                  255).astype(np.uint8)
    K = np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    return {"color": color, "color_aug": aug,
            "K_norm": np.tile(K, (B, 1, 1))}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    jopt = JOptions(height=H, width=W, batch_size=B, compute_dtype="float32")
    jb = JBundle.create(jopt)
    v = jax.jit(jb.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = perturb(v["params"], rng)
    stats = perturb(v["batch_stats"], rng)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, frozen={}, opt_state=None)
    port = ModelBundle.create(Options(height=H, width=W, batch_size=B,
                                      compute_dtype="float32"), device="cpu")
    port.load_state_dict(from_jax(params, stats), strict=True)
    batch = make_batch()
    losses, outputs = j_build_eval_step(jb, with_images=True)(state, batch,
                                                              KEY)
    noise = {s: torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(KEY, s), (B, H, W, 2), jnp.float32) * 1e-5))
        for s in jopt.scales}
    return dict(jb=jb, state=state, port=port, batch=batch, noise=noise,
                losses={k: float(x) for k, x in losses.items()},
                outputs=jax.tree_util.tree_map(np.asarray, outputs))


@pytest.mark.parametrize("with_images", [False, True])
def test_eval_step_losses_match(setup, with_images):
    losses, outputs = tstep.build_eval_step(setup["port"], with_images)(
        to_torch(setup["batch"]), noise=setup["noise"])
    assert sorted(losses) == sorted(setup["losses"])
    for k, want in setup["losses"].items():
        # means over the image of per-pixel losses that follow the
        # disparity (float32 noise of the networks) through the warp: they
        # agree to ~2e-6 relative, held at 2e-5
        np.testing.assert_allclose(float(losses[k]), want, rtol=2e-5,
                                   err_msg=k)
    if not with_images:
        assert sorted(outputs) == ["disp"]
        return
    assert sorted(outputs) == sorted(setup["outputs"])
    for key, want in setup["outputs"].items():
        if key == "disp":
            for s in want:
                np.testing.assert_allclose(outputs[key][s].numpy(), want[s],
                                           rtol=1e-4, atol=1e-5)
        elif key.startswith("automask"):
            # a pixel where a warped source and the identity tie to within
            # the networks' noise may go either way
            agree = (outputs[key].numpy() == want).mean()
            assert agree >= 0.995, f"{key}: {agree:.4f}"
        else:
            # warped values in [0, 1], ~3e-6 apart, held at 3e-5
            np.testing.assert_allclose(outputs[key].numpy(), want, atol=3e-5,
                                       err_msg=key)


def test_eval_step_routes_through_the_kernel_wrappers(setup, monkeypatch):
    """The launches chip_smoke.py asserts on the card: with_images=False
    runs K1 eight times and K3 twice; with_images=True K5 eight times and
    K3 ten times."""
    calls = {"warp_reproj_loss": 0, "reproj_loss": 0, "warp": 0}

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    for name in calls:
        monkeypatch.setattr(tstep, name, counted(name, getattr(tstep, name)))
    for with_images, want in ((False, (8, 2, 0)), (True, (0, 10, 8))):
        for name in calls:
            calls[name] = 0
        tstep.build_eval_step(setup["port"], with_images)(
            to_torch(setup["batch"]), noise=setup["noise"])
        assert tuple(calls.values()) == want, (with_images, calls)


def test_eval_step_draws_noise_from_a_generator(setup):
    step = tstep.build_eval_step(setup["port"])
    batch = to_torch(setup["batch"])
    a = step(batch, torch.Generator().manual_seed(1))[0]["loss"]
    b = step(batch, torch.Generator().manual_seed(1))[0]["loss"]
    assert float(a) == float(b)
    # another draw of the 1e-5 tie-break moves the mean by far less
    np.testing.assert_allclose(float(a), setup["losses"]["loss"], rtol=1e-4)


def test_training_inputs_raise(setup):
    batch = to_torch(setup["batch"])
    with pytest.raises(NotImplementedError):
        tstep.forward_and_loss(setup["port"], batch, train=True)
    with pytest.raises(NotImplementedError):
        tstep.build_eval_step(setup["port"])(
            {**batch, "aug_params": torch.zeros(B, 3, 6)})


def test_infer_step_matches(setup):
    img = make_batch(1)["color"][:, 0].astype(np.float32) / 255.0
    state = setup["state"]
    want = j_build_infer_step(setup["jb"])(state.params, state.batch_stats,
                                           jnp.asarray(img))
    got = tstep.build_infer_step(setup["port"])(torch.from_numpy(img))
    for s in want:
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]),
                                   rtol=1e-4, atol=1e-5)


def test_serving_answers_concurrent_requests(setup):
    opt = Options(height=H, width=W, compute_dtype="float32")
    engine = InferenceEngine(opt, max_batch=4, device="cpu",
                             bundle=setup["port"])
    imgs = make_batch(2)["color"].reshape(B * 3, H, W, 3)
    want = engine.predict(imgs[:4])
    batcher = MicroBatcher(engine, max_delay_ms=50.0)
    got = {}

    def client(i):
        got[i] = batcher.submit(imgs[i], timeout=60.0)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(imgs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        batcher.close()
    assert not any(t.is_alive() for t in threads)
    assert not batcher.running
    assert sorted(got) == list(range(len(imgs)))
    for i in range(4):
        # another batch composition: BatchNorm is in inference mode, so
        # only the convolution's summation order may differ
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=1e-6)
    assert engine.calls >= 3
    depth = engine.predict_depth(imgs[:1])
    assert depth.shape == (1, H, W) and np.isfinite(depth).all()
    with pytest.raises(ValueError):
        engine.predict(imgs[:5])
