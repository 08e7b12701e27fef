"""On the card, at each cell's own size: the control (the reference in
the precision below the configuration's, put in the program's place) and,
for training cells, the reference trained on half of each batch, come
out not correct under the cell's limits, on three seeds. Each test skips
without a card."""

import pytest

from benchmark import harness

SEEDS = (2600000001, 2600000002, 2600000003)
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def cell_parts(cell):
    entry = harness.find(harness.load_spec()["workloads"], cell, "workload")
    cfg = harness.config(entry["config"])
    mix = harness.mix(entry["traffic"])
    return cfg, mix, harness.traffic_module(mix["kind"])


def judged(cell, readings):
    limits = harness.limits(cell)["limits"]
    return harness.judge({k: (readings.get(k, 0.0), v)
                          for k, v in limits.items()})


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, card):
    cfg, mix, traffic = cell_parts(cell)
    control = harness.CONTROL[cfg["options"]["compute_dtype"]]
    for seed in SEEDS:
        readings = traffic.control(cfg, mix, seed, card, control)
        assert not judged(cell, readings)


@pytest.mark.chip
@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if cell_parts(c)[1]["kind"] == "train_loop"])
def test_half_batch_fails_on_the_card(cell, card):
    cfg, mix, traffic = cell_parts(cell)
    half = slice(0, cfg["options"]["batch_size"] // 2)
    for seed in SEEDS:
        readings = traffic.control(cfg, mix, seed, card, "float32",
                                   rows=half)
        assert not judged(cell, readings)
