"""What every run shares: the benchmark's files found by name, seeds,
spans, the device, the per-layer readers and the result line.

A cell of ``BENCHMARK.json`` names a configuration
(``configs/<config>.json``: the port's options, its precision settings,
its plain reference) and a traffic mix (``mixes/<traffic>.json``:
parameters, and the ``kind`` of traffic, whose module
``traffic/<kind>.py`` runs them). A per-layer metric is read by
``metrics/<name>.py``. Limits of the correctness check are data too
(``limits/<cell>.json``). Nothing here is edited to add any of them.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "unsupervised_pose_estimation_tpu")
# the control of a configuration's precision: the nearest one below it
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r}")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return load_json(HERE / "mixes" / f"{name}.json")


def limits(cell: str) -> Optional[dict]:
    path = HERE / "limits" / f"{cell}.json"
    return load_json(path) if path.is_file() else None


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (metric files carry
    dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic_module(kind: str):
    """The module that runs a kind of traffic, ``traffic/<kind>.py``."""
    return importlib.import_module(f"benchmark.traffic.{kind}")


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (weights, pool, noise of
    step k, ...), the same on every machine."""
    text = ":".join(str(t) for t in (seed,) + tags)
    digest = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``BANNED``."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in BANNED})


class Spans:
    """Host spans by name: durations kept in memory; inside a profiled
    sub-window (``annotate``) each is also a profiler annotation, so the
    trace can name what the host was doing."""

    def __init__(self):
        self.durations: Dict[str, List[float]] = {}
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        if self.annotate:
            import torch

            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.durations.setdefault(name, []).append(
            time.perf_counter() - start)

    def reset(self):
        self.durations = {}


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    pos = (len(ordered) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def device_info(device, chips: int, trace=None) -> dict:
    import torch

    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def peaks(device_name: str) -> Optional[dict]:
    table = load_json(HERE / "counts" / "peaks.json")
    return table.get(device_name)


def per_layer(spec: dict, cell: str, ctx: dict) -> Dict[str, dict]:
    """Every per-layer metric of the cell that its reader finds."""
    out = {}
    for metric in spec["per_layer"]:
        if cell not in metric.get("workloads", [cell]):
            continue
        path = HERE / "metrics" / f"{metric['name']}.py"
        reader = load_module(path, "_metric_" + metric["name"].replace(
            ".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def check_line(checks: Dict[str, tuple]) -> Dict[str, dict]:
    """{name: (value, limit)} -> the result line's last key."""
    return {name: {"value": v, "limit": lim}
            for name, (v, lim) in checks.items()}


def judge(checks: Dict[str, tuple]) -> bool:
    """Correct when every compared number is a finite number within its
    limit."""
    return all(v is not None and math.isfinite(v) and v <= lim
               for v, lim in checks.values())
