"""The port's training step at ``compute_dtype="bfloat16"`` against the JAX
package's, on the inputs of tests/test_torch_train.py (B=2, 64x128, the
same augmented frames and automask noise) and the weights of
tests/test_torch_eval.py.

This file's one compile of a JAX training step is the bfloat16 step. The
float32 reference R is the port's float32 step, which tests/test_torch_train.py
holds to the JAX one; on these inputs the two float32 gradients differ by
1.3% of the bfloat16 gap below. "The gap" is the JAX package's own
bfloat16-against-float32 gap, JAX bf16 against R. At these random weights
it is 40% of the gradient's norm in L2, and 3-143% of each parameter's
(median 31%), because bfloat16 moves pixels across the automask's min and
the ReLUs' kinks. So the gradient is held per network (encoder, depth
decoder, pose encoder, pose decoder), over its parameters:

- scale: the median over its parameters of the least-squares factor that
  takes JAX's bfloat16 gradient P_jax to the port's, <P, P_jax> / <P_jax,
  P_jax>, within 2x the largest distance from 1 of the same factor for R
  over the four networks (measured 0.915-1.071 against R's 0.918-1.029, so
  at most 0.52 of the bound); a network's gradient scaled by 0.5, 2 or -1
  fails it, and so does one scaled by 0.8 except the pose decoder's
  (test_bf16_step_checks_catch_a_scaled_gradient, which scales the sums
  the checks take);
- spread: the median over its parameters of |P - P_jax| / |P_jax - R|
  within 2 (measured 0.97-1.47);
- the whole gradient in L2 within 2x the gap of JAX's bfloat16 and of R
  (measured 1.08x and 1.15x), and its global norm within 0.5x the gap of
  JAX's (measured 0.20x; a gradient halved reads 1.07x);
- each loss: within 4x the largest gap over the losses of JAX's bfloat16
  (the two packages' bfloat16 losses lie on opposite sides of float32's),
  and within 2x of R, each plus the float32 bound of
  tests/test_torch_train.py (rtol 1e-5), which is of the gap's size here.

Parameters, their gradients and the Adam update stay float32; everything
the loss kernels receive is float32.
"""

import math

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_eval import jax_trees, perturbed_bundle
from tests.test_torch_train import (  # noqa: F401 (fixture)
    AUG, B, H, KEY, LR, W, jax_noise, one_torch_thread)
from tests.test_torch_step import make_batch
from unsupervised_pose_estimation_tpu.config import Options as JOptions
from unsupervised_pose_estimation_tpu.train.bundle import \
    ModelBundle as JBundle
from unsupervised_pose_estimation_tpu.train.step import \
    forward_and_loss as j_forward_and_loss
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.convert import from_jax
from unsupervised_pose_estimation_tpu_torch.ops.augment_device import \
    batch_augment
from unsupervised_pose_estimation_tpu_torch.train import step as tstep
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle
from unsupervised_pose_estimation_tpu_torch.train.state import \
    create_train_state
from unsupervised_pose_estimation_tpu_torch.train.step import \
    build_train_step

DTYPES = ("float32", "bfloat16")
GAP_MULT = 2.0
LOSS_VS_JAX = 4.0
LOSS_RTOL_F32 = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(losses, {name: gradient}) of the JAX bfloat16 step ("jax") and of
    the port's ``build_train_step`` at each dtype (("port", dtype)) on the
    same weights, batch and noise."""
    weights = perturbed_bundle()
    params, stats = jax_trees(weights, str(tmp_path_factory.mktemp("pth")))
    raw = make_batch()
    aug = batch_augment(torch.from_numpy(raw["color"]), torch.from_numpy(AUG))
    jax_batch = {"color": raw["color"], "K_norm": raw["K_norm"],
                 "color_aug": np.round(aug.numpy() * 255.0).astype(np.uint8)}
    port_batch = {"color": torch.from_numpy(raw["color"]),
                  "K_norm": torch.from_numpy(raw["K_norm"]),
                  "aug_params": torch.from_numpy(AUG)}

    jopt = JOptions(height=H, width=W, batch_size=B, learning_rate=LR,
                    compute_dtype="bfloat16")
    jb = JBundle.create(jopt)

    def value_and_grad(p):
        (_, (losses, _, _)), g = jax.value_and_grad(
            lambda q: j_forward_and_loss(
                jb, q, stats, {}, jax_batch, jax.random.fold_in(KEY, 0),
                train=True), has_aux=True)(p)
        return losses, g

    j_losses, grads = jax.jit(value_and_grad)(params)
    grads = from_jax(jax.tree_util.tree_map(np.asarray, grads), stats)
    result = {}
    for dt in DTYPES:
        port = ModelBundle.create(Options(height=H, width=W, batch_size=B,
                                          compute_dtype=dt,
                                          learning_rate=LR), device="cpu")
        port.load_state_dict(weights.state_dict())
        seen = []
        kernel = tstep.warp_reproj_loss_op

        def spy(image, grid, target):
            seen.append((grid.dtype, target.dtype))
            return kernel(image, grid, target)

        tstep.warp_reproj_loss_op = spy
        try:
            losses = build_train_step(port)(create_train_state(port),
                                            port_batch, noise=jax_noise(0))
        finally:
            tstep.warp_reproj_loss_op = kernel
        assert seen and all(d == (torch.float32, torch.float32)
                            for d in seen)
        result["port", dt] = ({k: float(v) for k, v in losses.items()},
                              {n: p.grad.clone()
                               for n, p in port.named_parameters()})
        assert all(p.dtype == torch.float32 for p in port.parameters())
        assert all(g.dtype == torch.float32
                   for g in result["port", dt][1].values())
    result["jax"] = ({k: float(v) for k, v in j_losses.items()},
                     {n: grads[n] for n in result["port", "bfloat16"][1]})
    return result


NETWORKS = ("encoder.", "depth.", "pose_encoder.", "pose.")
SCALE_MULT = 2.0
SPREAD = 2.0
NORM_MULT = 0.5


def l2(a, b=None):
    return float(np.sqrt(sum(
        float(((a[n] - (0 if b is None else b[n])).double() ** 2).sum())
        for n in a)))


def leaf_sums(port, jax_bf16, ref):
    """{name: the sums the checks take} of the gradients ``port``,
    ``jax_bf16`` and the float32 reference ``ref``: float32 products summed
    in float64."""
    def dot(a, b):
        return float(torch.sum(a * b, dtype=torch.float64))

    return {n: {"pj": dot(port[n], j), "pr": dot(port[n], ref[n]),
                "rj": dot(ref[n], j), "pp": dot(port[n], port[n]),
                "jj": dot(j, j), "rr": dot(ref[n], ref[n])}
            for n, j in jax_bf16.items()}


def scaled(sums, net, factor):
    """``leaf_sums`` of the port's gradient with the parameters of ``net``
    (a name prefix, or "all") scaled by ``factor``."""
    out = {}
    for n, t in sums.items():
        f = factor if net == "all" or n.startswith(net) else 1.0
        out[n] = {**t, "pj": f * t["pj"], "pr": f * t["pr"],
                  "pp": f * f * t["pp"]}
    return out


def gradient_failures(sums):
    """The checks of the module docstring on ``leaf_sums``; -> the failed
    ones."""
    def sq_dist(t, a, b):  # |a - b|^2 from the sums
        return t[a + a] - 2.0 * t[a + b if a + b in t else b + a] + t[b + b]

    def total(fn, names=sums):
        return math.sqrt(sum(fn(sums[n]) for n in names))

    gap = total(lambda t: sq_dist(t, "j", "r"))
    assert gap > 0
    failed = []
    for other in ("j", "r"):
        err = total(lambda t: sq_dist(t, "p", other))
        if not err <= GAP_MULT * gap:
            failed.append(("L2", other, err / gap))
    norms = total(lambda t: t["pp"]), total(lambda t: t["jj"])
    if not abs(norms[0] - norms[1]) <= NORM_MULT * gap:
        failed.append(("norm", abs(norms[0] - norms[1]) / gap))
    leaves = {net: [n for n in sums if n.startswith(net)]
              for net in NETWORKS}

    def scale(key, net):
        return float(np.median([sums[n][key] / sums[n]["jj"]
                                for n in leaves[net]]))

    ref_dev = max(abs(scale("rj", net) - 1.0) for net in NETWORKS)
    for net in NETWORKS:
        dev = abs(scale("pj", net) - 1.0)
        if not dev <= SCALE_MULT * ref_dev:
            failed.append(("scale", net, dev / ref_dev))
        spread = float(np.median([
            math.sqrt(sq_dist(sums[n], "p", "j") / sq_dist(sums[n], "j", "r"))
            for n in leaves[net]]))
        if not spread <= SPREAD:
            failed.append(("spread", net, spread))
    return failed


@pytest.fixture(scope="module")
def sums(runs):
    return leaf_sums(runs["port", "bfloat16"][1], runs["jax"][1],
                     runs["port", "float32"][1])


def test_bf16_step_gradient_within_the_jax_gap(runs, sums):
    """The whole gradient, per network and in all, and its norm."""
    assert gradient_failures(sums) == []
    norm = runs["port", "bfloat16"][0]["grad_norm"]
    np.testing.assert_allclose(
        norm, math.sqrt(sum(t["pp"] for t in sums.values())), rtol=1e-5)


@pytest.mark.parametrize("net", NETWORKS + ("all",))
@pytest.mark.parametrize("factor", (0.5, 2.0, -1.0))
def test_bf16_step_checks_catch_a_scaled_gradient(sums, net, factor):
    """The port's bfloat16 gradient with one network's part (or all of it)
    scaled by ``factor`` fails the checks."""
    assert gradient_failures(scaled(sums, net, factor))


def test_bf16_step_losses_within_the_jax_gap(runs):
    want, ref = runs["jax"][0], runs["port", "float32"][0]
    got = runs["port", "bfloat16"][0]
    gap = max(abs(want[k] - ref[k]) for k in want)
    assert gap > 0
    for other, mult in ((want, LOSS_VS_JAX), (ref, GAP_MULT)):
        for key in want:  # the port's also hold grad_norm
            value = other[key]
            bound = mult * gap + LOSS_RTOL_F32 * abs(value)
            assert abs(got[key] - value) <= bound, (key, got[key], value,
                                                     bound)
