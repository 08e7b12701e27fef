"""The port's networks against the JAX package's, with the JAX weights carried
over by ``convert.from_jax``.

The JAX bundle (64x128, float32) is initialised from a seed, and its
BatchNorm statistics and scales and every bias are then redrawn with numpy,
so that the comparison also covers how they are carried. Both sides run on
the CPU in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_pose_estimation_tpu.config import Options as JOptions
from unsupervised_pose_estimation_tpu.train.bundle import \
    ModelBundle as JBundle
from unsupervised_pose_estimation_tpu.train.checkpoint import _resnet_tree
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.convert import from_jax
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle

H, W = 64, 128
# Seven to twenty float32 conv layers summed in another order by XLA and by
# PyTorch's CPU convolutions: relative noise grows to ~1e-5 of the
# activations' scale.
RTOL, ATOL = 1e-4, 1e-4


def perturb(tree, rng):
    """Redraw BatchNorm statistics/scales and biases (init leaves them at
    0, 1 or 0), keeping activations of order one."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.array(node, np.float32)
        if name == "mean" or name == "bias":
            return rng.normal(scale=0.1, size=a.shape).astype(np.float32)
        if name == "var" or name == "scale":
            return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        return a
    return walk(tree)


def jax_and_port(seed=0):
    """(JAX bundle, params, batch_stats, port bundle) with shared weights."""
    jb = JBundle.create(JOptions(height=H, width=W, compute_dtype="float32"))
    v = jax.jit(jb.init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = perturb(v["params"], rng)
    stats = perturb(v["batch_stats"], rng)
    port = ModelBundle.create(Options(height=H, width=W,
                                      compute_dtype="float32"),
                              device="cpu")
    port.load_state_dict(from_jax(params, stats), strict=True)
    return jb, params, stats, port


@pytest.fixture(scope="module")
def bundles():
    return jax_and_port()


def images(n, channels, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, H, W, channels)).astype(np.float32)


def apply_bn(module, params, stats, *args):
    """Inference-mode apply, jitted (the op-by-op flax apply is slow)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, False))(
        {"params": params, "batch_stats": stats}, *args)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close_nhwc(t, j):
    np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(j),
                               rtol=RTOL, atol=ATOL)


def test_encoder_matches(bundles):
    jb, params, stats, port = bundles
    x = images(2, 3, 1)
    want = apply_bn(jb.encoder, params["encoder"], stats["encoder"],
                    jnp.asarray(x))
    with torch.no_grad():
        got = port.encoder(nchw(x))
    assert len(got) == len(want) == 5
    for t, j in zip(got, want):
        close_nhwc(t, j)


def test_depth_decoder_matches(bundles):
    jb, params, stats, port = bundles
    feats = apply_bn(jb.encoder, params["encoder"], stats["encoder"],
                     jnp.asarray(images(2, 3, 2)))
    want = apply_bn(jb.depth, params["depth"], stats["depth"], feats)
    with torch.no_grad():
        got = port.depth([nchw(np.asarray(f)) for f in feats])
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for s in want:
        assert tuple(got[s].shape) == (2, 1, H >> s, W >> s)
        close_nhwc(got[s], want[s])


def test_pose_network_matches(bundles):
    jb, params, stats, port = bundles
    pairs = images(4, 6, 3)
    feats = apply_bn(jb.pose_encoder, params["pose_encoder"],
                     stats["pose_encoder"], jnp.asarray(pairs))
    j_aa, j_tt = jax.jit(jb.pose.apply)({"params": params["pose"]}, [feats])
    with torch.no_grad():
        t_aa, t_tt = port.pose([port.pose_encoder(nchw(pairs))])
    # outputs are 0.01 x a spatial mean: scale the tolerance with them
    np.testing.assert_allclose(t_aa.numpy(), np.asarray(j_aa), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(t_tt.numpy(), np.asarray(j_tt), rtol=RTOL,
                               atol=1e-6)


def test_from_jax_inverts_the_reference_importer(bundles):
    """The reference's own .pth importer maps the port's encoder
    state_dict back to the flax trees it came from."""
    _, params, stats, port = bundles
    for name in ("encoder", "pose_encoder"):
        sd = {k[len(name) + 1:]: v.numpy()
              for k, v in port.state_dict().items()
              if k.startswith(name + ".")}
        p, s = _resnet_tree(sd, 18)
        for tree, ref in ((p, params[name]), (s, stats[name])):
            flat = jax.tree_util.tree_leaves_with_path(tree)
            flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
            assert len(flat) == len(flat_ref)
            for path, leaf in flat:
                np.testing.assert_array_equal(leaf, flat_ref[path])


def test_seeded_init_is_deterministic_and_leaves_global_rng():
    opt = Options(height=H, width=W, compute_dtype="float32")
    state = torch.get_rng_state()
    a = ModelBundle.create(opt, seed=5, device="cpu").state_dict()
    b = ModelBundle.create(opt, seed=5, device="cpu").state_dict()
    c = ModelBundle.create(opt, seed=6, device="cpu").state_dict()
    assert torch.equal(torch.get_rng_state(), state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.encoder.conv1.weight"],
                           c["encoder.encoder.conv1.weight"])


@pytest.mark.parametrize("kw, names", [
    (dict(adversarial_prior=True),
     ("adversarial_prior", "pre_trained_generator")),
    (dict(pre_trained_generator=True, v1_multiscale=True),
     ("pre_trained_generator", "v1_multiscale")),
    (dict(pre_trained_generator=True, adversarial_prior=True,
          v1_multiscale=True), ("pre_trained_generator", "v1_multiscale")),
])
def test_gan_option_refusals(kw, names):
    """The GAN prior's combinations that cannot run raise ValueError naming
    both options: the discriminator without the generator whose samples
    it takes, and the prior under v1 multiscale, where the JAX step's
    silog_loss of the full-size prior against a scale's own disparity
    raises TypeError (incompatible shapes for broadcasting) while it
    traces."""
    with pytest.raises(ValueError) as err:
        ModelBundle.create(Options(height=H, width=W,
                                   compute_dtype="float32", **kw),
                           device="cpu")
    assert all(name in str(err.value) for name in names)


def test_stereo_with_predictive_mask_is_refused():
    """The mask has no channel for the stereo frame (the reference fails
    to broadcast in its first step); the bundle names both options."""
    with pytest.raises(ValueError, match="use_stereo and predictive_mask"):
        ModelBundle.create(Options(height=H, width=W, compute_dtype="float32",
                                   use_stereo=True, predictive_mask=True),
                           device="cpu")


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 1, 2), (1, 1, 2, 1),
                                   (1, 1, 1, 1)])
def test_reflect_pad_of_one_row(shape):
    """Conv3x3's pad is numpy's reflect, which repeats an axis of one
    element (the deepest feature map of a 32-row input); torch's own
    reflect pad refuses that axis and is used everywhere else."""
    import torch.nn.functional as F

    from unsupervised_pose_estimation_tpu_torch.models.layers import \
        reflect_pad1

    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    want = np.pad(x.numpy(), [(0, 0), (0, 0), (1, 1), (1, 1)], "reflect")
    np.testing.assert_array_equal(reflect_pad1(x).numpy(), want)
    if min(shape[2:]) > 1:
        assert torch.equal(reflect_pad1(x),
                           F.pad(x, (1, 1, 1, 1), mode="reflect"))


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 1, 4), (1, 1, 4, 1),
                                   (1, 1, 1, 1), (1, 2, 2, 2), (1, 1, 2, 3)])
def test_reflect_pad_backward_is_the_pads_transpose(shape):
    """reflect_pad1's own backward (fixed summation order) is the transpose
    of its forward: on integer-valued float64 gradients, where every order
    sums exactly, it equals autograd through numpy's pad rule built from
    torch's one-axis pads."""
    import torch.nn.functional as F

    from unsupervised_pose_estimation_tpu_torch.models.layers import \
        reflect_pad1

    def composed(x):
        for pad, n in (((1, 1, 0, 0), x.shape[-1]),
                       ((0, 0, 1, 1), x.shape[-2])):
            x = F.pad(x, pad, mode="reflect" if n > 1 else "replicate")
        return x

    gen = torch.Generator().manual_seed(1)
    x = torch.randint(-9, 10, shape, generator=gen).double()
    x.requires_grad_()
    g = torch.randint(-9, 10, (*shape[:2], shape[2] + 2, shape[3] + 2),
                      generator=gen).double()
    got, = torch.autograd.grad(reflect_pad1(x), x, g)
    want, = torch.autograd.grad(composed(x), x, g)
    assert torch.equal(got, want)
    assert torch.autograd.gradcheck(reflect_pad1, (torch.randn(
        shape, dtype=torch.float64, generator=gen, requires_grad=True),))
