"""A profiled sub-window and what is read from its device trace.

``Profiled`` wraps a short stretch of a run in ``torch.profiler`` (CPU and
CUDA activities), inside an annotation ``bench.window`` that ends with a
synchronize. The trace is written as Chrome JSON to the run's temporary
directory, read back and deleted. From it:

- ``window_s``: the length of the ``bench.window`` annotation;
- ``busy_s``: the union of the device's kernel, copy and set intervals
  within it (concurrent kernels count once);
- ``kernels``: every kernel as (name, start us, duration us);
- ``breakdown``: the ten device operations that took the most time, by
  name, and the ten longest idle gaps, each named by the host span that
  was open when it began.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the host spans that name an idle gap, most specific first
HOST_SPANS = ("engine call", "step enqueue", "loader wait", "client")
TOP = 10


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


class Trace:
    """The parsed trace of one profiled sub-window (times in us)."""

    def __init__(self, events: List[dict], steps: int):
        self.steps = steps
        windows = [e for e in events if e.get("name") == WINDOW
                   and e.get("cat") == "user_annotation"]
        if not windows:
            raise RuntimeError("the trace holds no bench.window annotation")
        w = windows[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.kernels: List[Tuple[str, float, float]] = []
        device: List[Tuple[float, float]] = []
        self.device_ops: Dict[str, float] = {}
        self.host: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            start, dur = float(e["ts"]), float(e["dur"])
            if start + dur < self.t0 or start > self.t1:
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                s, t = max(start, self.t0), min(start + dur, self.t1)
                device.append((s, t))
                name = e.get("name", "?")
                self.device_ops[name] = self.device_ops.get(name, 0.0) + dur
                if cat == "kernel":
                    self.kernels.append((name, start, dur))
            elif cat == "user_annotation" and e.get("name") in HOST_SPANS:
                self.host.append((e["name"], start, start + dur))
        self.busy = union(device)
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.busy_s = sum(t - s for s, t in self.busy) * 1e-6

    def host_span_at(self, t: float) -> str:
        for name in HOST_SPANS:
            for n, s, e in self.host:
                if n == name and s <= t < e:
                    return name
        return "other"

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = []
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        for i in range(0, len(edges), 2):
            start, end = edges[i], edges[i + 1]
            if end > start:
                gaps.append((end - start, start))
        gaps.sort(reverse=True)
        return {"device_ops": [[name[:160], us * 1e-6] for name, us in ops],
                "idle_gaps": [[self.host_span_at(start), us * 1e-6]
                              for us, start in gaps[:TOP]]}


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Profiled:
    """``with Profiled(spans) as p: ... p.trace``: profile the body, with
    the spans annotated; the body's device work is synchronised inside
    the window."""

    def __init__(self, spans, steps: int = 1):
        self.spans = spans
        self.steps = steps
        self.trace: Optional[Trace] = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        _sync()
        self.window = torch.profiler.record_function(WINDOW)
        self.window.__enter__()
        self.spans.annotate = True
        return self

    def __exit__(self, *exc):
        _sync()
        self.window.__exit__(*exc)
        self.spans.annotate = False
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.trace = Trace(events, self.steps)
        return False
