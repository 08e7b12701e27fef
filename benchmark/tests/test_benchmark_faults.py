"""The check comes out false when the timed path is broken underneath,
and when the control (the reference in the precision below the
configuration's) is put in the program's place. A run here skips the look
for a card and drives the rest at a small size on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import harness

CPU = torch.device("cpu")
SMALL = dict(height=64, width=128, batch_size=2, num_workers=2)
# the control's test size: at 64x128 and batch 2 the fp8 control's
# median-leaf gradient gap fell to 0.022 on one seed of three, under the
# bf16 cell's limit; at 96x320 and batch 4 it read 0.042-0.097
CONTROL_SIZE = dict(height=96, width=320, batch_size=4, num_workers=2)


def run_cell(cell, over=None, **fault):
    from benchmark.tests import runner

    line, _ = runner.result_line(cell, 41, 0.5, False, CPU,
                                 overrides=dict(SMALL, **(over or {})),
                                 **fault)
    return line


def state_unchanged(step, bundle, state):
    def broken(state_, batch, noise=None):
        saved = [p.detach().clone() for p in bundle.main_parameters()]
        losses = step(state_, batch, noise=noise)
        with torch.no_grad():
            for p, s in zip(bundle.main_parameters(), saved):
                p.copy_(s)
        return losses
    return broken


def half_batch(step, bundle, state):
    def broken(state_, batch, noise=None):
        half = batch["color"].shape[0] // 2
        return step(state_, {k: v[:half] for k, v in batch.items()},
                    noise={s: t[:half] for s, t in noise.items()})
    return broken


@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
@pytest.mark.parametrize("cell", ["kitti640_train", "fork640_f32_train"])
def test_broken_step_is_not_correct(cell, fault):
    line = run_cell(cell, dict(compute_dtype="float32"), wrap_step=fault)
    assert line["correct"] is False


def answer_altered(engine):
    predict = engine.predict

    def broken(images):
        return predict(images) + np.float32(1e-3)
    engine.predict = broken


def answers_swapped(engine):
    predict = engine.predict

    def broken(images):
        return predict(images)[::-1].copy()
    engine.predict = broken


@pytest.mark.parametrize("fault", [answer_altered, answers_swapped])
def test_broken_answer_is_not_correct(fault):
    # one frame a batch and many in a pool: swapped replies answer other
    # frames
    line = run_cell("fork640_f32_serve16", wrap_engine=fault)
    assert line["correct"] is False


@pytest.mark.parametrize("cell", ["kitti640_train", "fork640_f32_train",
                                  "fork640_f32_serve16"])
def test_control_is_not_correct(cell):
    spec = harness.load_spec()
    entry = harness.find(spec["workloads"], cell, "workload")
    cfg = harness.config(entry["config"])
    mix = harness.mix(entry["traffic"])
    traffic = harness.traffic_module(mix["kind"])
    over = dict(CONTROL_SIZE)
    if mix["kind"] == "train_loop":
        mix = dict(mix, pool_items=12)
    else:
        mix = dict(mix, pool_frames=6)
    readings = traffic.control(cfg, mix, 43, CPU,
                           harness.CONTROL[cfg["options"]["compute_dtype"]],
                           overrides=over)
    limits = harness.limits(cell)["limits"]
    checks = {k: (readings.get(k, 0.0), v) for k, v in limits.items()}
    assert not harness.judge(checks), checks
