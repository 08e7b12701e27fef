"""The port's spans and counters: one recorder, always on, in memory.

    from unsupervised_pose_estimation_tpu_torch import tracing

    with tracing.span("step.forward"):
        ...
    tracing.record("serve.queue", submitted_ns, taken_ns, request=7, batch=3)
    tracing.count("serve.requests", 8)

A span records its name, a span id, the span open on the same thread when
it began (its parent), the thread, its start and end in ns, and the ids it
is given (a request id, a batch id). A span given no ids takes those of
the span or ``ids()`` block around it, so the spans of one request or
batch share an identifier. ``record`` adds a span timed elsewhere, such as
one that starts on one thread and ends on another. Ended spans go into a
ring of ``RING`` records; each carries a sequence number, so a reader can
tell whether the ring dropped part of the stretch it reads (``covers``).
Counters are plain sums, kept per thread and added up when read.

The hot path takes no lock (a deque's append is atomic), never
synchronises the device and reads no tensor. When a ``torch.profiler``
records the calling thread (it records only the threads it was started
on), a span also opens ``torch.profiler.record_function`` of its name, so
the trace shows it.

Times are ``time.time_ns()``, the clock of the profiler's host events: a
Chrome trace that ``torch.profiler`` exports places an event at
``(ns - baseTimeNanoseconds) / 1000`` us, and ``profiler_base_ns()`` gives
that base for this process, so the spans can be laid on any trace taken
in it (``chrome_events``).
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

RING = 1 << 17
_clock = time.time_ns
# whether a torch profiler records the calling thread (the profiler's
# state is per thread: a thread it was not started on reads False)
_profiled = torch._C._autograd._profiler_enabled
# the first record_function of a process takes ~1 ms in setting up (after
# its start is stamped); take that here, so that a mirror's start agrees
# with its span's
with torch.profiler.record_function("upe.tracing.warm"):
    pass


class Span:
    """One span: the context manager that times it, then its record.
    ``start`` and ``end`` are ns of ``time.time_ns()``; ``ids`` is a dict
    or None."""

    __slots__ = ("seq", "name", "id", "parent", "thread", "start", "end",
                 "ids", "_owner", "_stack", "_mirror")

    def __init__(self, owner, name: str, **ids):
        self._owner = owner
        self.name = name
        self.ids = ids or None

    def __enter__(self):
        owner = self._owner
        local = owner._local
        self._stack = stack = local.stack
        self.thread = local.tid
        self.id = next(owner._ids)
        if stack:
            top = stack[-1]
            self.parent = top.id
            if top.ids:
                self.ids = {**top.ids, **self.ids} if self.ids else top.ids
        else:
            self.parent = None
        stack.append(self)
        if _profiled():
            self._mirror = torch.profiler.record_function(self.name)
            self._mirror.__enter__()
        else:
            self._mirror = None
        self.start = _clock()
        return self

    def __exit__(self, kind, value, tb):
        self.end = _clock()
        if self._mirror is not None:
            self._mirror.__exit__(kind, value, tb)
            self._mirror = None
        self._stack.pop()
        self._stack = None
        owner = self._owner
        self.seq = next(owner._seqs)
        owner._ring.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def as_dict(self) -> dict:
        return {"seq": self.seq, "name": self.name, "id": self.id,
                "parent": self.parent, "thread": self.thread,
                "start_ns": self.start, "end_ns": self.end,
                "ids": self.ids or {}}


class _Thread(threading.local):
    """Per thread: the open spans, the thread's id and its counters."""

    def __init__(self, owner):
        self.stack: list = []
        self.tid = threading.get_native_id()
        self.counts: Dict[str, float] = {}
        with owner._lock:
            owner._threads.append((self.tid, threading.current_thread().name,
                                   self.counts))


class Recorder:
    """Spans in a ring of ``capacity`` records, and counters. The module's
    functions use one recorder for the process; tests make their own."""

    def __init__(self, capacity: int = RING):
        self._ring: "collections.deque[Span]" = collections.deque(
            maxlen=capacity)
        self._ids = itertools.count(1)
        self._seqs = itertools.count()
        self._first = 0
        self._lock = threading.Lock()   # taken once per thread
        self._threads: list = []
        self._local = _Thread(self)

    def span(self, name: str, **ids) -> Span:
        """``with recorder.span(name, request=.., batch=..):`` times the
        block."""
        return Span(self, name, **ids)

    def record(self, name: str, start_ns: int, end_ns: int, **ids) -> Span:
        """Record a span timed by the caller (``time.time_ns()``): one
        that began on another thread, say. It has no parent."""
        s = Span(self, name, **ids)
        s.id = next(self._ids)
        s.parent = None
        s.thread = self._local.tid
        s.start, s.end = start_ns, end_ns
        s.seq = next(self._seqs)
        self._ring.append(s)
        return s

    def ids(self, **ids):
        """``with recorder.ids(batch=3):``: the spans opened inside take
        these ids (with any they are given)."""
        return _IdsBlock(self, ids)

    def count(self, name: str, n=1):
        counts = self._local.counts
        counts[name] = counts.get(name, 0) + n

    def counters(self) -> Dict[str, float]:
        """Every counter, summed over the threads."""
        out: Dict[str, float] = {}
        for _, _, counts in list(self._threads):
            for name, n in counts.copy().items():
                out[name] = out.get(name, 0) + n
        return out

    def events(self) -> List[Span]:
        """The ring's records, oldest first (in the order they ended)."""
        return list(self._ring)

    def dropped(self) -> int:
        """Records the ring dropped since the last reset."""
        try:
            return self._ring[0].seq - self._first
        except IndexError:  # empty
            return 0

    def covers(self, since_ns: int, events: Optional[List[Span]] = None
               ) -> bool:
        """Whether the ring still holds every record that ended after
        ``since_ns`` (of ``events``, a copy taken earlier, if given)."""
        events = self.events() if events is None else events
        if not events or events[0].seq == self._first:
            return True
        return events[0].end <= since_ns

    def reset(self):
        """Empty the ring and zero the counters (for quiet moments: a
        count racing the reset may survive it)."""
        self._ring.clear()
        self._first = next(self._seqs) + 1
        for _, _, counts in list(self._threads):
            counts.clear()

    def thread_names(self) -> Dict[int, str]:
        return {tid: name for tid, name, _ in list(self._threads)}

    def write_jsonl(self, path: str):
        """One line per record (``Span.as_dict``), then one with the
        counters, the threads' names and the records dropped."""
        events = self.events()
        with open(path, "w") as f:
            for s in events:
                f.write(json.dumps(s.as_dict()) + "\n")
            f.write(json.dumps({
                "counters": self.counters(), "dropped": self.dropped(),
                "threads": {str(t): n for t, n in
                            self.thread_names().items()}}) + "\n")

    def chrome_events(self, base_ns: int, start_ns: int, end_ns: int,
                      pid: int) -> List[dict]:
        """The records that overlap [start_ns, end_ns] as Chrome trace
        events on a trace whose ``baseTimeNanoseconds`` is ``base_ns``:
        process ``pid`` (named "upe spans"), one row per thread."""
        names = self.thread_names()
        out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": "upe spans"}}]
        rows = set()
        for s in self.events():
            if s.end < start_ns or s.start > end_ns:
                continue
            rows.add(s.thread)
            out.append({"ph": "X", "cat": "upe_span", "name": s.name,
                        "pid": pid, "tid": s.thread,
                        "ts": (s.start - base_ns) / 1e3,
                        "dur": (s.end - s.start) / 1e3,
                        "args": {"id": s.id, "parent": s.parent,
                                 **(s.ids or {})}})
        out += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": t,
                 "args": {"name": names.get(t, str(t))}} for t in sorted(rows)]
        return out


class _IdsBlock:
    """An ``ids()`` block: on its thread's stack it gives the spans opened
    inside its ids (merged with those around it); it records nothing."""

    __slots__ = ("_owner", "id", "ids")

    def __init__(self, owner: Recorder, ids: dict):
        self._owner = owner
        self.ids = ids

    def __enter__(self):
        stack = self._owner._local.stack
        top = stack[-1] if stack else None
        self.id = None if top is None else top.id
        if top is not None and top.ids:
            self.ids = {**top.ids, **self.ids}
        stack.append(self)
        return self

    def __exit__(self, kind, value, tb):
        self._owner._local.stack.pop()
        return False


_default = Recorder()
span = functools.partial(Span, _default)
record = _default.record
ids = _default.ids
count = _default.count
counters = _default.counters
events = _default.events
dropped = _default.dropped
covers = _default.covers
reset = _default.reset
write_jsonl = _default.write_jsonl
chrome_events = _default.chrome_events
now_ns = _clock


@functools.cache
def profiler_base_ns() -> int:
    """``baseTimeNanoseconds`` of the Chrome traces ``torch.profiler``
    exports in this process (fixed for the process), from a CPU-only
    profile of nothing; taken once. Call it while no profiler runs."""
    if _profiled():
        raise RuntimeError("profiler_base_ns() needs the profiler idle")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return int(json.load(f).get("baseTimeNanoseconds", 0))
    finally:
        os.unlink(path)
