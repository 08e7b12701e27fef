"""The plain reference against the port's plain CPU path at a small
size, and the result line a run prints."""

import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import monodepth2 as ref
from benchmark.reference.precision import Precision
from benchmark.traffic import train_loop

CPU = torch.device("cpu")
SMALL = dict(height=64, width=128, batch_size=2, num_workers=2,
             compute_dtype="float32")


def small_mix(name):
    m = harness.mix(name)
    if m["kind"] == "train_loop":
        return dict(m, pool_items=6)
    return dict(m, pool_frames=6, clients=4, check_share=0.5, warmup_s=0.3)


@pytest.mark.parametrize("variant", ["upstream", "fork"])
def test_loss_and_gradient_match_the_port(variant):
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.step import \
        forward_and_loss

    cfg = harness.config("monodepth2_m640x192")
    over = dict(SMALL, depth_decoder_variant=variant)
    opt, batches, noises = train_loop.first_batches(
        cfg, small_mix("train_pool96"), 21, CPU, over)
    lay = train_loop.layout(opt)
    with torch.device("meta"):
        bundle = ModelBundle(opt)
    bundle = bundle.to_empty(device=CPU)
    bundle.load_state_dict(inputs.weights(lay, 21, CPU))
    for batch, noise in zip(batches, noises):
        total, _ = forward_and_loss(bundle, batch, train=True, noise=noise)
        P = {n: t.clone() for n, t in inputs.weights(lay, 21, CPU).items()}
        expect = ref.loss(P, train_loop.ref_opts(opt), batch, noise,
                          Precision("float32"))
        assert float(total.detach()) == pytest.approx(float(expect.detach()),
                                                     rel=1e-5)
    # gradients: rounding moves some sampling points across a pixel edge,
    # where the bilinear warp's gradient jumps, so leaves differ by a
    # little more than rounding
    bundle.zero_grad()
    total.backward()
    names = [n for n, _ in bundle.named_main_parameters()]
    for n in names:
        P[n].requires_grad_(True)
    expect = ref.loss(P, train_loop.ref_opts(opt), batch, noise,
                      Precision("float32"))
    grads = torch.autograd.grad(expect, [P[n] for n in names])
    gaps = [float((p.grad.norm() - g.norm()).abs() / g.norm())
            for (_, p), g in zip(bundle.named_main_parameters(), grads)]
    assert max(gaps) < 0.02


def test_jitter_matches_the_port():
    from unsupervised_pose_estimation_tpu_torch.ops.augment_device import \
        batch_augment

    g = torch.Generator().manual_seed(4)
    color = torch.randint(0, 256, (6, 2, 16, 24, 3), generator=g,
                          dtype=torch.uint8)
    params = torch.tensor([[1, 0.8, 1.2, 0.9, 0.1, 1],
                           [1, 1.2, 0.8, 1.1, -0.1, 0],
                           [1, 1.05, 0.95, 1.0, 0.003, 1],
                           [0, 1.1, 1.1, 1.1, 0.05, 1],
                           [1, 0.9, 1.0, 1.2, -0.07, 1],
                           [1, 1.0, 1.0, 1.0, 0.0, 0]])
    # equal bytes (the two scale them to [0, 1] in other roundings)
    got = (ref.jitter(color, params) * 255).round()
    assert torch.equal(got, (batch_augment(color, params) * 255).round())


def test_inference_matches_the_port():
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.step import \
        build_infer_step

    for variant in ("upstream", "fork"):
        opt = train_loop.options(harness.config("fork_m640x192_f32"),
                                 dict(SMALL, depth_decoder_variant=variant))
        lay = train_loop.layout(opt)
        with torch.device("meta"):
            bundle = ModelBundle(opt)
        bundle = bundle.to_empty(device=CPU)
        bundle.load_state_dict(inputs.weights(lay, 8, CPU))
        images = torch.from_numpy(inputs.textures(
            8, "t", 3, (0,), 64, 128, (0, 0), 4, CPU)[:, 0])
        got = build_infer_step(bundle)(images.float() / 255.0)[0][..., 0]
        want = ref.infer(inputs.weights(lay, 8, CPU),
                         train_loop.ref_opts(opt), images,
                         Precision("float32"))
        assert (got - want).abs().max() < 1e-5
        # not saturated: the check compares values that move
        assert 0.05 < float(want.min()) and float(want.max()) < 0.95


def run_cell(cell, **fault):
    from benchmark.tests import runner

    return runner.result_line(cell, 31, 0.5, False, CPU, overrides=dict(
        SMALL), **fault)


@pytest.mark.parametrize("cell", ["kitti640_train", "fork640_f32_serve16"])
def test_result_line(cell):
    line, _ = run_cell(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    spec = harness.load_spec()
    want = {m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    limits = harness.limits(cell)["limits"]
    assert set(line["checks"]) == set(limits)
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
