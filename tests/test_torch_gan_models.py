"""The GAN prior's pieces in the port against the JAX package: instance
normalisation, ``depth_to_disp``, the silog and log-RMSE losses, the
CycleGAN generator and the PatchGAN discriminator (float32 and bfloat16),
a reference generator ``.pth`` through both packages' importers, and
``convert.from_jax`` of the prior's trees.

Weights are drawn with numpy over ``jax.eval_shape``
(``tests/torch_option_steps.py::numpy_variables``). At float32 the networks
agree to 2e-4 absolute, the bound tests/test_checkpoint_import.py holds the
JAX generator to against torch; at bfloat16 each output is held to the JAX
package's own bfloat16-against-float32 gap on the same inputs, with the
bounds of tests/test_torch_bf16_models.py (``within_gap``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_models import within_gap
from tests.torch_option_steps import numpy_variables
from tests.torch_oracle import RefGenerator
from unsupervised_pose_estimation_tpu.config import Options as JOptions
from unsupervised_pose_estimation_tpu.models import cyclegan as jgan
from unsupervised_pose_estimation_tpu.models.layers import \
    instance_norm as j_instance_norm
from unsupervised_pose_estimation_tpu.ops import geometry as JG
from unsupervised_pose_estimation_tpu.ops import losses as JL
from unsupervised_pose_estimation_tpu.train import checkpoint as jck
from unsupervised_pose_estimation_tpu.train.bundle import \
    ModelBundle as JBundle
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.convert import (
    discriminator_from_jax, from_jax, generator_from_jax)
from unsupervised_pose_estimation_tpu_torch.models import (
    GeneratorResNet, PatchGANDiscriminator)
from unsupervised_pose_estimation_tpu_torch.models.layers import \
    instance_norm
from unsupervised_pose_estimation_tpu_torch.ops import geometry as G
from unsupervised_pose_estimation_tpu_torch.ops import losses as L
from unsupervised_pose_estimation_tpu_torch.train import checkpoint as ck
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle

NET_ATOL = 2e-4
KEY = jax.random.PRNGKey(3)
DTYPES = {"float32": (jnp.float32, None), "bfloat16": (jnp.bfloat16,
                                                       torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_instance_norm_matches_jax():
    """Per sample and channel over space, in float32 to 1e-5; in bfloat16
    the result is bfloat16 (the statistics summed in float32 and rounded,
    as jnp.mean and jnp.var of a bfloat16 array) and within the JAX
    package's own bfloat16-against-float32 gap."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 24, 40, 8)) * 3 + 1).astype(np.float32)
    out = {}
    for name, (jdt, tdt) in DTYPES.items():
        j = j_instance_norm(jnp.asarray(x, jdt))
        p = instance_norm(nchw(x).to(tdt or torch.float32))
        assert str(j.dtype) == name and p.dtype == (tdt or torch.float32)
        out[name] = as_np(j), nhwc(p)
    np.testing.assert_allclose(out["float32"][1], out["float32"][0],
                               rtol=0, atol=1e-5)
    within_gap(out["bfloat16"][1], out["float32"][1], out["bfloat16"][0],
               out["float32"][0], "instance_norm")


def prior_and_prediction(seed=0, shape=(2, 16, 24, 1)):
    """A prior from depth_to_disp of uniform(-1, 1) depths (about half of
    them negative, as a random tanh generator gives) and a prediction in
    (0.01, 1.5) with some pixels at 0 and below."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(-1, 1, size=shape).astype(np.float32)
    fake = np.array(JG.depth_to_disp(jnp.asarray(depth))[1])
    real = rng.uniform(0.01, 1.5, size=shape).astype(np.float32)
    real.flat[::7] = 0.0
    real.flat[3::11] = -0.3
    return depth, fake, real


def test_depth_to_disp_matches_jax():
    depth, _, _ = prior_and_prediction()
    want = JG.depth_to_disp(jnp.asarray(depth))
    got = G.depth_to_disp(torch.from_numpy(depth))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert (want[1] < 0).any() and (want[1] > 0).any()


@pytest.mark.parametrize("name", ["silog_loss", "rmse_log_loss"])
def test_log_losses_match_jax(name):
    """Values to 1e-5 relative and the gradient with respect to the
    prediction to 1e-4 of its largest element, on inputs where either
    operand is <= 0 at some pixels; with no valid pixel the silog loss is
    0 (N is clamped at 1)."""
    _, fake, real = prior_and_prediction()
    assert (fake <= 0).any() and (real <= 0).any() and (real > 1).any()
    jfn, pfn = getattr(JL, name), getattr(L, name)
    want, want_g = jax.value_and_grad(jfn, argnums=1)(jnp.asarray(fake),
                                                      jnp.asarray(real))
    real_t = torch.from_numpy(real).requires_grad_()
    got = pfn(torch.from_numpy(fake), real_t)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(real_t.grad.numpy(), want_g, rtol=0,
                               atol=1e-4 * np.abs(want_g).max())
    if name == "silog_loss":
        none = -np.abs(real)
        assert float(pfn(torch.from_numpy(fake), torch.from_numpy(none))) \
            == float(jfn(jnp.asarray(fake), jnp.asarray(none))) == 0.0


def run_both(jax_module, port_module, x, seed):
    """The flax module on numpy-drawn weights and the port's module holding
    them (``from_jax``), on NHWC ``x`` -> (JAX output, port output), both
    NHWC numpy."""
    params = numpy_variables(jax_module.init, KEY, jnp.asarray(x),
                             seed=seed)["params"]
    convert = (generator_from_jax
               if isinstance(port_module, GeneratorResNet)
               else discriminator_from_jax)
    port_module.load_state_dict(convert(params), strict=True)
    want = jax.jit(jax_module.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port_module(nchw(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    return as_np(want), nhwc(got)


NETS = {
    # 2 residual blocks on a 64x64 frame, and the discriminator on 64x128
    "generator": (lambda jdt: jgan.GeneratorResNet(
        channels=1, num_residual_blocks=2, compute_dtype=jdt),
        lambda tdt: GeneratorResNet(1, 2, compute_dtype=tdt), (2, 64, 64, 1)),
    "discriminator": (lambda jdt: jgan.PatchGANDiscriminator(
        compute_dtype=jdt), lambda tdt: PatchGANDiscriminator(
        compute_dtype=tdt), (2, 64, 128, 1)),
}


@pytest.mark.parametrize("net", sorted(NETS))
def test_gan_network_matches_flax(net):
    """float32 to NET_ATOL; bfloat16 within the JAX package's own gap. The
    generator's output is (B, H, W) in (-1, 1), the discriminator's an
    (H/16, W/16) patch map."""
    make_jax, make_port, shape = NETS[net]
    x = np.random.default_rng(1).uniform(0, 1, size=shape).astype(
        np.float32)
    out = {name: run_both(make_jax(jdt), make_port(tdt), x, seed=2)
           for name, (jdt, tdt) in DTYPES.items()}
    want, got = out["float32"]
    b, h, w, _ = shape
    assert got.shape == ((b, h, w, 1) if net == "generator"
                         else (b, h // 16, w // 16, 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_ATOL)
    within_gap(out["bfloat16"][1], got, out["bfloat16"][0], want, net)


def test_reference_generator_pth_imports_alike(tmp_path):
    """A reference-layout generator .pth of 9 residual blocks: the JAX
    package's import_generator and the port's give the same outputs, and
    the port's module reproduces the reference network it was written
    from, each to NET_ATOL (float32 rounding compounds over the 9 blocks:
    3.5e-5 against the reference network on the CPU)."""
    gen = torch.Generator().manual_seed(4)
    ref = RefGenerator(n_res=9).eval()
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    path = str(tmp_path / "G_AB.pth")
    torch.save(ref.state_dict(), path)
    x = np.random.default_rng(5).uniform(0, 1, size=(1, 32, 64, 1)).astype(
        np.float32)

    tree = jck.import_generator(path)
    want = jax.jit(jgan.GeneratorResNet(num_residual_blocks=9).apply)(
        {"params": tree["params"]}, jnp.asarray(x))
    bundle = ModelBundle.create(Options(height=32, width=64,
                                        compute_dtype="float32",
                                        pre_trained_generator=True),
                                device="cpu")
    assert ck.import_generator(path)["num_residual_blocks"] == 9
    ck.load_generator(bundle, path)
    with torch.no_grad():
        got = bundle.generator(nchw(x))
        theirs = ref(nchw(x))
    np.testing.assert_allclose(nhwc(got), as_np(want), rtol=0,
                               atol=NET_ATOL)
    np.testing.assert_allclose(got.numpy(), theirs.numpy(), rtol=0,
                               atol=NET_ATOL)
    two = str(tmp_path / "two_blocks.pth")
    torch.save(RefGenerator(n_res=2).state_dict(), two)
    with pytest.raises(ValueError, match="2 residual blocks"):
        ck.load_generator(bundle, two)


def test_from_jax_carries_the_gan_trees():
    """A JAX bundle's frozen generator and disc_params land on the port
    bundle's generator and discriminator (a strict load), kernels
    transposed to torch's layout; the generator's parameters are frozen
    and neither network is among the main parameters."""
    kw = dict(height=64, width=128, compute_dtype="float32",
              pre_trained_generator=True, adversarial_prior=True)
    jb = JBundle.create(JOptions(**kw))
    shapes = jax.eval_shape(jb.init, KEY)
    rng = np.random.default_rng(6)

    def draw(tree):
        return jax.tree_util.tree_map(
            lambda s: rng.normal(size=s.shape).astype(np.float32), tree)

    params, stats = draw(shapes["params"]), draw(shapes["batch_stats"])
    frozen, disc = draw(shapes["frozen"]), draw(shapes["disc_params"])
    sd = from_jax(params, stats, frozen, disc)
    port = ModelBundle.create(Options(**kw), device="cpu")
    port.load_state_dict(sd, strict=True)
    g, d = frozen["pre_trained_generator"], disc
    np.testing.assert_array_equal(
        port.generator.model[10 + 8].block[5].weight.detach().numpy(),
        np.transpose(g["res_8"]["conv2"]["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(port.generator.model[28].bias.numpy(),
                                  g["output"]["bias"])
    np.testing.assert_array_equal(
        port.discriminator.model[12].weight.detach().numpy(),
        np.transpose(d["final"]["kernel"], (3, 2, 0, 1)))
    assert not any(p.requires_grad for p in port.generator.parameters())
    assert all(p.requires_grad for p in port.discriminator.parameters())
    main = {n for n, _ in port.named_main_parameters()}
    assert main and not any(n.startswith(("generator.", "discriminator."))
                            for n in main)
    # without the prior's trees the map is what it was
    plain = ModelBundle.create(dataclasses.replace(
        Options(**kw), pre_trained_generator=False, adversarial_prior=False),
        device="cpu")
    plain.load_state_dict(from_jax(params, stats), strict=True)
