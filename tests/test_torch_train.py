"""Three training steps of the port against the JAX package's
``build_train_step``, fused (K1 + K2) and unfused (K5 + K3/K4).

B=2, 64x128, three frames, float32, automask on, Adam at lr 1e-4, weights
carried over by ``convert.from_jax``. The port takes ``aug_params`` and
augments on its own; the JAX step takes the same augmented frames as
``color_aug``. (JAX's ``batch_augment`` under ``jit`` rounds before a
floor differently from its own eager form, in 0.24% of values at this
size, by up to 4/255; the port matches the eager form exactly,
tests/test_torch_augment.py. The step compares everything after that.)
Both sides get the same automask noise: normal(fold_in(fold_in(key,
step), scale)) * 1e-5, per microbatch under grad_accum.

Each port step starts from the reference's parameters and BatchNorm
statistics before that step; the port's Adam moments and step count carry
over from its own earlier steps. A free-running port drifts off the
reference within a step: Adam's first updates are about lr * sign(g), so
elements whose gradient is at the level of float32 rounding move 2 lr
apart, and the next step starts elsewhere.

Tolerances. Losses at rtol 1e-5 (measured <= 3.2e-6). In float32 the
gradient is fixed only up to the loss's kinks (ReLU, the coordinate clip,
min, |.|): the packages round differently, and an input within rounding
distance of a kink can take the other branch. At step 1 one sampling
coordinate does, at the clip (tests/test_torch_train_grads.py::
test_float32_gap_is_a_clip_kink), which moves the gradient norm by 0.61%.
So grad_norm is held at rtol 1e-2, the parameters within 2 lr + 1e-6
(Adam's reach from a shared start, and the rounding of parameters of
order 1) and within 0.1 lr on all but 4% of the elements (measured 2.1%),
and the BatchNorm statistics at atol 2e-5 (measured 5.5e-6). The networks'
gradients are compared per parameter in float64 in
tests/test_torch_train_grads.py, where nothing lands that close to a kink.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_step import make_batch, perturb
from unsupervised_pose_estimation_tpu.config import Options as JOptions
from unsupervised_pose_estimation_tpu.train.bundle import \
    ModelBundle as JBundle
from unsupervised_pose_estimation_tpu.train.state import TrainState
from unsupervised_pose_estimation_tpu.train.state import \
    make_optimizer as j_make_optimizer
from unsupervised_pose_estimation_tpu.train.step import \
    build_train_step as j_build_train_step
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.convert import from_jax
from unsupervised_pose_estimation_tpu_torch.ops.augment_device import \
    batch_augment
from unsupervised_pose_estimation_tpu_torch.parallel import dryrun
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle
from unsupervised_pose_estimation_tpu_torch.train.state import \
    create_train_state
from unsupervised_pose_estimation_tpu_torch.train.step import \
    build_train_step

B, H, W = 2, 64, 128
KEY = jax.random.PRNGKey(7)
LR = 1e-4
STEPS = 3
# rows: [enabled, brightness, contrast, saturation, hue, autocontrast]
AUG = np.array([[1, 1.1, 0.9, 1.15, 0.05, 1],
                [1, 0.9, 1.1, 0.85, -0.04, 0]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port: its sums run in one order on any
    machine, and pytest's parallel workers do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_setup(accum=1):
    """JAX bundle, perturbed weights and statistics, and the batch: the
    port's (with aug_params) and the reference's (with color_aug)."""
    jopt = JOptions(height=H, width=W, batch_size=B, compute_dtype="float32",
                    grad_accum=accum, learning_rate=LR)
    jb = JBundle.create(jopt)
    v = jax.jit(jb.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = perturb(v["params"], rng)
    stats = perturb(v["batch_stats"], rng)
    raw = make_batch()
    aug = batch_augment(torch.from_numpy(raw["color"]), torch.from_numpy(AUG))
    color_aug = np.round(aug.numpy() * 255.0).astype(np.uint8)
    port_batch = {"color": raw["color"], "K_norm": raw["K_norm"],
                  "aug_params": AUG}
    jax_batch = {"color": raw["color"], "K_norm": raw["K_norm"],
                 "color_aug": color_aug}
    return jb, params, stats, port_batch, jax_batch


def jax_trajectory(jb, params, stats, batch, steps=STEPS):
    """-> per step of the reference step {'before': (params, batch_stats),
    'losses', 'after': (params, batch_stats)}. Adam per leaf
    (``flatten=False``: the same arithmetic as the flattened form)."""
    tx = j_make_optimizer(LR, flatten=False)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, frozen={},
                       opt_state=tx.init(params))
    step = j_build_train_step(jb, tx, donate=False)

    def host(s):
        return tuple(jax.tree_util.tree_map(np.asarray, t)
                     for t in (s.params, s.batch_stats))

    out = []
    for _ in range(steps):
        before = host(state)
        state, losses = step(state, batch, KEY)
        out.append({"before": before, "after": host(state),
                    "losses": {k: float(v) for k, v in losses.items()}})
    return out


def jax_noise(step, accum=1):
    """The reference's automask noise of ``step`` for the whole batch."""
    key = jax.random.fold_in(KEY, step)
    keys = ([key] if accum == 1
            else [jax.random.fold_in(key, i) for i in range(accum)])
    return {s: torch.from_numpy(np.concatenate([np.array(
        jax.random.normal(jax.random.fold_in(k, s), (B // accum, H, W, 2),
                          jnp.float32) * 1e-5) for k in keys], 0))
        for s in range(4)}


def port_run(trajectory, batch, **options):
    """The port's step from each of the reference's states in turn, with
    one bundle and one train state throughout -> per step (losses,
    state_dict after, {name: grad})."""
    cfg = Options(height=H, width=W, batch_size=B, compute_dtype="float32",
                  learning_rate=LR, **options)
    bundle = ModelBundle.create(cfg, device="cpu")
    state = create_train_state(bundle)
    step = build_train_step(bundle)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    out = []
    for k, ref in enumerate(trajectory):
        bundle.load_state_dict(from_jax(*ref["before"]), strict=True)
        losses = step(state, tb, noise=jax_noise(k, cfg.grad_accum))
        out.append(({n: float(v) for n, v in losses.items()},
                    {n: t.clone() for n, t in bundle.state_dict().items()},
                    {n: p.grad.clone() for n, p in bundle.named_parameters()}))
    assert state.step == len(trajectory)
    return out


def compare_steps(port, trajectory, norm_rtol=1e-2, share=0.04):
    """Per step, against the reference: losses at rtol 1e-5, grad_norm at
    ``norm_rtol``, parameters within 2 lr + 1e-6 and within 0.1 lr on all
    but ``share`` of the elements, BatchNorm statistics at atol 2e-5 (the
    module docstring says why)."""
    params = [n for n in port[0][1] if n in port[0][2]]
    for k, ((losses, sd, _), ref) in enumerate(zip(port, trajectory)):
        assert sorted(losses) == sorted(ref["losses"])
        for name, want in ref["losses"].items():
            rtol = norm_rtol if name == "grad_norm" else 1e-5
            np.testing.assert_allclose(losses[name], want, rtol=rtol,
                                       err_msg=f"step {k} {name}")
        want = from_jax(*ref["after"])
        diff = torch.cat([(sd[n] - want[n]).abs().flatten() for n in params])
        assert float(diff.max()) <= 2 * LR + 1e-6, (k, float(diff.max()))
        beyond = float((diff > 0.1 * LR).float().mean())
        assert beyond <= share, (k, beyond)
        for n in want:
            if "running" in n:
                np.testing.assert_allclose(sd[n].numpy(), want[n].numpy(),
                                           rtol=0, atol=2e-5,
                                           err_msg=f"step {k} {n}")


@pytest.fixture(scope="module")
def reference():
    jb, params, stats, port_batch, jax_batch = jax_setup()
    return dict(port_batch=port_batch,
                trajectory=jax_trajectory(jb, params, stats, jax_batch))


@pytest.mark.parametrize("fused", [True, False])
def test_train_trajectory_matches_jax(reference, fused):
    """Three Adam steps, fused warp + loss kernels (K1/K2) or warp and loss
    kernels (K5, K3/K4): the two routes run the same arithmetic."""
    port = port_run(reference["trajectory"], reference["port_batch"],
                    use_pallas_warp_loss=fused)
    compare_steps(port, reference["trajectory"])


def test_two_ranks_match_the_first_jax_step(reference, tmp_path):
    """The same first step over two gloo processes of one row each
    (``parallel.dryrun``, ``mesh_data=2``), at this file's bounds: each
    rank's BatchNorm takes the statistics of both rows, its automask noise
    is its row of the reference's draw, and the gradients are averaged over
    the ranks, which end with the same parameters."""
    ref = reference["trajectory"][0]
    torch.save(from_jax(*ref["before"]), tmp_path / "init.pt")
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in reference["port_batch"].items()}
    torch.save({"batches": [batch], "noise": [jax_noise(0)]},
               tmp_path / "batch.pt")
    cfg = dict(height=H, width=W, batch_size=B, compute_dtype="float32",
               learning_rate=LR, mesh_data=2)
    case = {"name": "jax", "options": cfg, "return_after": True,
            "init": str(tmp_path / "init.pt"),
            "batch": str(tmp_path / "batch.pt")}
    results = dryrun.launch([case], 2, "cpu", str(tmp_path / "run"),
                            timeout=240)
    assert dryrun.check(results, "jax") == []  # the ranks agree
    after = torch.load(tmp_path / "run" / "jax" / "after.pt",
                       weights_only=True)
    with torch.device("meta"):
        names = {n: None for n, _ in ModelBundle(Options(**cfg))
                 .named_parameters()}
    losses = results[0]["jax"]["steps"][0]["losses"]
    compare_steps([(losses, after, names)], reference["trajectory"][:1])
