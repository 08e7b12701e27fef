"""The operation and byte counts against hand counts and against
``torch.utils.flop_counter`` over the plain reference."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, harness, inputs
from benchmark.reference import monodepth2 as ref
from benchmark.reference.precision import Precision
from benchmark.traffic import train_loop

SMALL = dict(height=64, width=128, batch_size=2)


def test_one_conv_by_hand():
    opts = harness.config("monodepth2_m640x192")["options"]
    first = counts.network_convs(opts, 12, pose=False)[0]
    # conv1: 7x7, 3 -> 64 channels, stride 2: 96x320 outputs, 12 images,
    # 2 operations per multiply-add
    assert first[:5] == (3, 64, 7, (192, 640), (96, 320))
    assert counts._forward(first) == 2 * 12 * (96 * 320) * (7 * 7 * 3) * 64
    assert counts._forward(first) == 6_936_330_240


def test_kernel_bytes_at_chip_smoke_shapes():
    table = {e["name"]: e for e in counts.kernels()}
    # chip_smoke.py's bounds at B=12, 192x640: K1 39.8 MB, K2 51.6, K3
    # 41.3
    assert sorted(table) == ["reproj_loss", "warp_loss", "warp_loss_bwd"]
    pixels = 12 * 192 * 640
    assert table["warp_loss"]["bytes_per_pixel"] * pixels == 39_813_120
    for name, mb in (("warp_loss_bwd", 51.6), ("reproj_loss", 41.3)):
        assert table[name]["bytes_per_pixel"] * pixels / 1e6 == \
            pytest.approx(mb, abs=0.05)
    peak = harness.peaks("NVIDIA H100 80GB HBM3")
    secs, by = counts.least_seconds(table["warp_loss"], 12 * 192 * 640, peak)
    assert by == "bytes" and secs == pytest.approx(39_813_120 / 3.35e12)


def test_kernel_names_match_their_launches():
    table = counts.kernels()
    names = {
        "void warp_loss_kernel<3>(unsigned char const*, float const*)":
            "warp_loss",
        "void warp_loss_bwd_kernel<3>(unsigned char const*)":
            "warp_loss_bwd",
        "void reproj_loss_kernel<3>(float const*)": "reproj_loss",
    }
    for kernel, entry in names.items():
        assert counts.port_kernel(kernel, table)["name"] == entry
    for other in ("sm90_xmma_fprop_implicit_gemm",
                  "void reproj_loss_bwd_kernel<3, false>(float const*)"):
        assert counts.port_kernel(other, table) is None


@pytest.mark.parametrize("variant", ["upstream", "fork"])
def test_step_flops_match_the_flop_counter(variant):
    cfg = harness.config("fork_m640x192_f32")
    opt = train_loop.options(cfg, dict(SMALL, depth_decoder_variant=variant,
                                       num_workers=1))
    mix = dict(harness.mix("train_pool96"), pool_items=4)
    opt, batches, noises = train_loop.first_batches(
        cfg, mix, 3, torch.device("cpu"), dict(
            SMALL, depth_decoder_variant=variant, num_workers=1))
    P = {n: t.clone() for n, t in inputs.weights(
        train_loop.layout(opt), 3, "cpu").items()}
    names = [n for n in P if ref.is_parameter(n)]
    for n in names:
        P[n].requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        total = ref.loss(P, train_loop.ref_opts(opt), batches[0], noises[0],
                         Precision("float32"))
        torch.autograd.grad(total, [P[n] for n in names])
    by_op = fc.get_flop_counts()["Global"]
    conv = sum(v for k, v in by_op.items() if "convolution" in str(k))
    assert conv == counts.train_step_flops(vars(opt))

    images = batches[0]["color"][:, 0]
    with FlopCounterMode(display=False) as fc:
        ref.infer(P, train_loop.ref_opts(opt), images, Precision("float32"))
    by_op = fc.get_flop_counts()["Global"]
    conv = sum(v for k, v in by_op.items() if "convolution" in str(k))
    # inference computes the scale-0 head only
    heads = sum(counts._forward(c) for c in counts.network_convs(
        vars(opt), SMALL["batch_size"], pose=False) if c[1] == 1 and
        c[4] != (opt.height, opt.width))
    assert conv == counts.depth_forward_flops(vars(opt),
                                              SMALL["batch_size"]) - heads
