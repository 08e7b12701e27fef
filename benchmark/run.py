"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix and per-layer readers are found by name under
``benchmark/`` (``harness.py``). Needs as many CUDA cards as the cell asks
for and never falls back to the CPU. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the correctness check compared, with its limit. The checks are
also the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# caches of the program's builds, at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "benchmark" / "_cache"
                                              / "triton"))
os.environ["USE_FLAX"] = "0"


def fail(message: str, code: int = 2):
    print(message, file=sys.stderr, flush=True)
    sys.exit(code)


def result_line(workload: str, seed: int, seconds: float, trace: bool,
                device, chips: int = 1, overrides=None, **fault) -> dict:
    """Run the cell on ``device`` -> (the result line, the checks).
    ``overrides`` (option fields) and ``fault`` (a traffic module's
    ``wrap_step`` or ``wrap_engine``) serve the tests, which run it on the
    CPU at a small size."""
    import torch

    from benchmark import harness

    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], workload, "workload")
    limits = harness.limits(workload)
    if limits is None:
        fail(f"no limits/{workload}.json: the check has no limits")
    cfg_file = harness.config(cell["config"])
    mix = harness.mix(cell["traffic"])
    traffic = harness.traffic_module(mix["kind"])
    spans = harness.Spans()
    out = traffic.run(cfg_file, mix, seed, seconds, trace, device, spans,
                      T_START, overrides=overrides, **fault)

    readings = out["readings"]
    checks = {name: (readings.get(name), limit)
              for name, limit in limits["limits"].items()}
    summary = traffic.summary(out)
    metrics = {}
    if trace:
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        ctx = dict(summary["ctx"], peak=harness.peaks(name))
        metrics = harness.per_layer(spec, workload, ctx)
    else:
        for m in spec["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                metrics[m["name"]] = {"value": summary["metrics"][m["name"]],
                                      "unit": m["unit"]}
    line = {"correct": harness.judge(checks), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": harness.device_info(device, chips, out.get("trace"))}
    line["device"]["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    if out.get("trace") is not None:
        line["breakdown"] = out["trace"].breakdown()
    line["checks"] = harness.check_line(checks)
    return line, checks


def report(line: dict, checks: dict):
    """Print the checks (the last lines of standard error), then the line
    (the last of standard output). Exit without a line when JAX or the
    JAX package is loaded: checked last, after the readers and the
    breakdown have loaded what they need."""
    from benchmark import harness

    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    found = harness.banned_modules()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}", 3)
    print(json.dumps(line), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.find(harness.load_spec()["workloads"], args.workload,
                        "workload")
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} found")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line, checks = result_line(args.workload, args.seed, args.seconds,
                               bool(args.trace), device, cell["chips"])
    report(line, checks)


if __name__ == "__main__":
    main()
