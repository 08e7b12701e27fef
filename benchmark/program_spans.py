"""The port's own spans (``unsupervised_pose_estimation_tpu_torch.tracing``)
for the per-layer readers, read in-process after the run.

The recorder stamps spans in ns of the profiler's host clock; the
profiled sub-window's trace (``ctx["trace"]``) is in us from the
profiler's base, ``tracing.profiler_base_ns()``, so ``ns = base + 1000 *
us``. Host times are read over the unprofiled window:

- training: the last ``ctx["steps"]`` ``step`` spans that begin before the
  profiled sub-window (warm-up comes before them, the profiled steps
  after);
- serving: the last ``ctx["engine_calls"]`` ``engine.predict`` calls of
  the batcher and the last ``ctx["completed"]`` ``serve.queue`` requests
  that end before the profiled sub-window (the few late requests of the
  window's close shift it by under 1%).

Idle shares read the profiled sub-window: the device's idle intervals
(the complement of ``Trace.busy`` within ``[t0, t1]``) overlapped with
spans' intervals, as a % of all its idle time. Every function returns
None when the program has no recorder (an older program), when the spans
are missing, or when the ring dropped part of the stretch read.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple


def _tracing():
    try:
        from unsupervised_pose_estimation_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


class Spans:
    """The recorder's records with the sub-window on their clock."""

    def __init__(self, tracing, trace):
        self.tracing = tracing
        self.events = tracing.events()
        base = tracing.profiler_base_ns()
        self.t0 = base + int(trace.t0 * 1e3)
        self.t1 = base + int(trace.t1 * 1e3)
        self.base = base
        self.trace = trace

    def named(self, *names) -> list:
        return [s for s in self.events if s.name in names]

    def covers(self, since_ns: int) -> bool:
        return self.tracing.covers(since_ns, self.events)

    def idle_share(self, spans) -> Optional[float]:
        """% of the sub-window's device-idle time inside ``spans``."""
        trace = self.trace
        edges = [trace.t0] + [x for iv in trace.busy for x in iv] + [trace.t1]
        idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        total = sum(b - a for a, b in idle)
        if not total or not self.covers(self.t0):
            return None
        inside = _union([((s.start - self.base) * 1e-3,
                          (s.end - self.base) * 1e-3) for s in spans])
        return 100.0 * _overlap(idle, inside) / total


def load(ctx: dict, kind: str) -> Optional[Spans]:
    """The run's spans, if the cell is of ``kind`` and was traced."""
    trace = ctx.get("trace")
    if ctx.get("kind") != kind or trace is None:
        return None
    tracing = _tracing()
    if tracing is None:
        return None
    return Spans(tracing, trace)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def _overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]
             ) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def train_phases(ctx: dict) -> Optional[Dict[str, List[float]]]:
    """{phase: its host seconds in each of the window's steps} for
    ``step.forward``, ``step.backward`` and ``step.optimizer`` (a step's
    microbatches summed)."""
    spans = load(ctx, "train")
    if spans is None or not ctx.get("steps"):
        return None
    steps = sorted((s for s in spans.named("step") if s.start < spans.t0),
                   key=lambda s: s.start)[-ctx["steps"]:]
    if len(steps) < ctx["steps"] or not spans.covers(steps[0].start):
        return None
    return {p: children_seconds(spans, steps, p)
            for p in ("step.forward", "step.backward", "step.optimizer")}


def phase_ms(ctx: dict, phase: str) -> Optional[float]:
    """Median host ms of ``phase`` over the window's steps."""
    phases = train_phases(ctx)
    if phases is None or not any(phases[phase]):
        return None
    return statistics.median(phases[phase]) * 1e3


def train_idle_share(ctx: dict, phase: str) -> Optional[float]:
    """% of the profiled steps' device-idle time while the main thread is
    in ``phase``."""
    spans = load(ctx, "train")
    if spans is None:
        return None
    if not [s for s in spans.named("step") if s.start >= spans.t0]:
        return None
    return spans.idle_share([s for s in spans.named(phase)
                             if s.end > spans.t0 and s.start < spans.t1])


def serve_calls(ctx: dict) -> Optional[Tuple[Spans, list]]:
    """The batcher's last ``engine_calls`` + 1 engine calls that end
    before the sub-window (one more than the window's, for the gap before
    the first), oldest first."""
    spans = load(ctx, "serve")
    if spans is None or not ctx.get("engine_calls"):
        return None
    n = ctx["engine_calls"] + 1
    calls = sorted((s for s in spans.named("engine.predict")
                    if s.end < spans.t0 and s.ids and "batch" in s.ids),
                   key=lambda s: s.start)[-n:]
    if len(calls) < n or not spans.covers(calls[0].start):
        return None
    return spans, calls


def serve_requests(ctx: dict) -> Optional[list]:
    """The last ``completed`` requests' ``serve.queue`` spans that end
    before the sub-window."""
    spans = load(ctx, "serve")
    if spans is None or not ctx.get("completed"):
        return None
    n = ctx["completed"]
    queued = sorted((s for s in spans.named("serve.queue")
                     if s.end < spans.t0), key=lambda s: s.end)[-n:]
    if len(queued) < n or not spans.covers(queued[0].start):
        return None
    return queued


def children_seconds(spans: Spans, parents: list, *names) -> List[float]:
    """For each of ``parents``, the seconds of its child spans named
    ``names``, summed."""
    total = {p.id: 0.0 for p in parents}
    for s in spans.named(*names):
        if s.parent in total:
            total[s.parent] += s.seconds
    return [total[p.id] for p in parents]
