"""The port's span-and-counter recorder (``tracing``), the counters and the
span that replaced the scattered instruments, ``profile_step``'s idle
arithmetic, and the benchmark's per-layer readers of the spans on a
synthetic run."""

import importlib
import importlib.util
import json
import sys
import threading
import time
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from unsupervised_pose_estimation_tpu_torch import tracing
from unsupervised_pose_estimation_tpu_torch.tracing import Recorder

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import program_spans  # noqa: E402
from benchmark.trace import Trace  # noqa: E402


def test_spans_nest_and_share_ids():
    rec = Recorder()
    with rec.span("outer", batch=3) as outer:
        with rec.span("inner") as inner:
            pass
        with rec.ids(request=7):
            with rec.span("leaf", extra=1) as leaf:
                pass
    with rec.span("alone") as alone:
        pass
    assert [s.name for s in rec.events()] == ["inner", "leaf", "outer",
                                              "alone"]
    assert [s.seq for s in rec.events()] == [0, 1, 2, 3]
    assert outer.parent is None and alone.parent is None
    assert inner.parent == leaf.parent == outer.id
    assert len({outer.id, inner.id, leaf.id, alone.id}) == 4
    assert inner.ids == {"batch": 3}
    assert leaf.ids == {"batch": 3, "request": 7, "extra": 1}
    assert alone.ids is None
    for s in rec.events():
        assert s.thread == threading.get_native_id()
        assert 0 <= s.end - s.start and s.seconds == (s.end - s.start) * 1e-9
    assert outer.start <= inner.start <= inner.end <= outer.end


def test_record_spans_a_handover_between_threads():
    """A request submitted on one thread and taken on another: ``record``
    keeps the submitter's start and the taker's thread."""
    rec = Recorder()
    box = {}

    def take(start):
        time.sleep(0.002)
        box["span"] = rec.record("queue", start, tracing.now_ns(),
                                 request=5, batch=2)
        box["thread"] = threading.get_native_id()

    start = tracing.now_ns()
    t = threading.Thread(target=take, args=(start,))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    s = box["span"]
    assert rec.events() == [s]
    assert s.start == start and s.seconds >= 0.002
    assert s.thread == box["thread"] != threading.get_native_id()
    assert s.parent is None and s.ids == {"request": 5, "batch": 2}


def test_ring_is_bounded_and_tells_what_it_dropped():
    rec = Recorder(capacity=4)
    spans = []
    for i in range(10):
        with rec.span(f"s{i}") as s:
            pass
        spans.append(s)
    kept = rec.events()
    assert [s.name for s in kept] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped() == 6
    # complete from the oldest record kept on, not before it
    assert rec.covers(spans[6].end) and rec.covers(spans[9].end)
    assert not rec.covers(spans[6].start)
    rec.reset()
    assert rec.events() == [] and rec.dropped() == 0
    with rec.span("after") as s:
        pass
    assert rec.dropped() == 0 and rec.covers(0)
    assert tracing.RING >= 131072 and Recorder()._ring.maxlen == tracing.RING


def test_counters_sum_over_eight_threads():
    rec = Recorder()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(5000):
                rec.count("hits")
                rec.count("seconds", 0.5)
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters() == {"hits": 40000, "seconds": 20000.0}
    rec.reset()
    assert rec.counters() == {}


def test_a_span_costs_a_few_microseconds():
    rec = Recorder()
    best = float("inf")
    for _ in range(5):
        start = time.perf_counter()
        for _ in range(2000):
            with rec.span("cost", batch=1):
                pass
        best = min(best, (time.perf_counter() - start) / 2000)
    # ~2-4 us on an idle core; held at 50 us for a loaded test machine
    assert best < 50e-6, f"{best * 1e6:.1f} us a span"


def test_spans_lie_on_the_profilers_clock(tmp_path):
    base = tracing.profiler_base_ns()
    assert base == tracing.profiler_base_ns()
    rec = Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("upe.clock") as s:
            with record_function("upe.inner"):
                time.sleep(0.001)
    path = str(tmp_path / "clock.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    assert int(trace["baseTimeNanoseconds"]) == base
    ts = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
          for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    start_us, end_us = (s.start - base) / 1e3, (s.end - base) / 1e3
    assert abs(start_us - ts["upe.inner"][0]) < 500
    # the span itself is mirrored into the trace, around its own times
    mirror = ts["upe.clock"]
    assert abs(start_us - mirror[0]) < 500 and abs(end_us - mirror[1]) < 500


def test_spans_mirror_only_on_the_profiled_thread():
    rec = Recorder()

    def other():
        with rec.span("upe.other"):
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("upe.main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
    keys = {e.key for e in prof.key_averages()}
    assert "upe.main" in keys and "upe.other" not in keys
    assert {s.name for s in rec.events()} == {"upe.main", "upe.other"}


def test_write_jsonl_and_chrome_events(tmp_path):
    rec = Recorder()
    with rec.span("a", batch=1):
        rec.count("n", 2)
    path = tmp_path / "spans.jsonl"
    rec.write_jsonl(str(path))
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[0]["name"] == "a" and lines[0]["ids"] == {"batch": 1}
    assert lines[-1]["counters"] == {"n": 2} and lines[-1]["dropped"] == 0
    s = rec.events()[0]
    events = rec.chrome_events(s.start - 5000, s.start, s.end, pid=9)
    span = [e for e in events if e["ph"] == "X"]
    assert len(span) == 1 and span[0]["ts"] == 5.0 and span[0]["pid"] == 9
    assert span[0]["tid"] == s.thread and span[0]["args"]["batch"] == 1
    assert rec.chrome_events(0, s.end + 1, s.end + 2, pid=9)[1:] == []


def test_replaced_instruments_count_through_the_recorder(tmp_path,
                                                         monkeypatch):
    """The mesh's collectives (``mesh.all_reduce``, ``mesh.all_gather``),
    the kernel build's seconds (``kernels.build_s``) and the warp ladder's
    gate reads (the span ``warp.ladder_gates``)."""
    import torch.distributed as dist

    from unsupervised_pose_estimation_tpu_torch.ops.kernels import _lib
    from unsupervised_pose_estimation_tpu_torch.parallel import mesh as M

    warp = importlib.import_module(
        "unsupervised_pose_estimation_tpu_torch.ops.kernels.warp")

    before = tracing.counters()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        x = torch.ones(3)
        M.all_reduce_(x, None)
        M.all_gather_into([torch.empty(3)], x, None)
    finally:
        dist.destroy_process_group()
    after = tracing.counters()
    for name in ("mesh.all_reduce", "mesh.all_gather"):
        assert after.get(name, 0) == before.get(name, 0) + 1
    assert M.collectives() >= 2

    monkeypatch.setattr(_lib, "_nvcc", lambda: "/bin/true")
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_lib, "library_path", lambda: tmp_path / "lib.so")
    _lib.build()
    assert (tracing.counters().get("kernels.build_s", 0.0)
            > before.get("kernels.build_s", 0.0))

    start = tracing.now_ns()
    image = torch.zeros(1, 16, 128, 3, dtype=torch.uint8)
    grid = torch.zeros(1, 2, 16, 128)
    warp.sample(image, grid, 7)
    gates = [s for s in tracing.events()
             if s.name == "warp.ladder_gates" and s.start >= start]
    assert len(gates) == 1


def test_profile_step_idle_share_unions_concurrent_kernels(tmp_path):
    """Two kernels at once count once, and time outside the window not at
    all (the old arithmetic summed kernel times)."""
    from unsupervised_pose_estimation_tpu_torch import profile_step

    events = [{"name": profile_step.WINDOW, "cat": "user_annotation",
               "ph": "X", "ts": 100.0, "dur": 100.0},
              {"name": "k1", "cat": "kernel", "ph": "X", "ts": 110.0,
               "dur": 40.0},
              {"name": "k2", "cat": "kernel", "ph": "X", "ts": 120.0,
               "dur": 40.0},
              {"name": "c", "cat": "gpu_memcpy", "ph": "X", "ts": 190.0,
               "dur": 30.0},
              {"name": "early", "cat": "kernel", "ph": "X", "ts": 0.0,
               "dur": 50.0}]

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    assert profile_step.device_busy_us(Prof()) == (60.0, 100.0)


# --- the benchmark's readers of the spans, on a synthetic run -------------

BASE = 10 ** 18


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "_reader", ROOT / "benchmark" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def synthetic_trace(t0_us, t1_us, busy):
    """A ``benchmark.trace.Trace`` of a sub-window [t0, t1] (us from the
    profiler's base) whose device is busy over ``busy``."""
    events = [{"name": "bench.window", "cat": "user_annotation", "ph": "X",
               "ts": t0_us, "dur": t1_us - t0_us}]
    events += [{"name": "k", "cat": "kernel", "ph": "X", "ts": a,
                "dur": b - a} for a, b in busy]
    return Trace(events, 1)


def with_recorder(monkeypatch, rec):
    monkeypatch.setattr(program_spans, "_tracing", lambda: types.
                        SimpleNamespace(events=rec.events, covers=rec.covers,
                                        profiler_base_ns=lambda: BASE))


def us(t):
    """us from the base -> the recorder's ns."""
    return BASE + int(t * 1e3)


def train_run(rec, steps=3, profiled=1):
    """Window steps each 100 us long from t = 1000 us on (forward 30 us,
    backward 50, optimizer 10), then ``profiled`` steps inside the
    sub-window [2000, 2200]."""
    starts = [1000 + 100 * k for k in range(steps)]
    starts += [2000 + 100 * k for k in range(profiled)]
    for t in starts:
        # children end first, as in the step
        children = [rec.record(name, us(t + a), us(t + b))
                    for name, a, b in (("step.forward", 0, 30),
                                       ("step.backward", 30, 80),
                                       ("step.optimizer", 80, 90))]
        step = rec.record("step", us(t), us(t + 100))
        for child in children:
            child.parent = step.id


def test_train_readers_read_the_window_and_its_idle_time(monkeypatch):
    rec = Recorder()
    with_recorder(monkeypatch, rec)
    train_run(rec)
    # busy 2030-2080 (during the backward): idle 2000-2030 (forward) and
    # 2080-2200 (10 us optimizer, 10 us between, 100 us after the step)
    ctx = {"kind": "train", "steps": 3,
           "trace": synthetic_trace(2000.0, 2200.0, [(2030.0, 2080.0)])}
    got = {n: reader(n)(ctx) for n in (
        "forward_host_ms.train", "backward_host_ms.train",
        "optimizer_host_ms.train", "idle_in_forward_share.train",
        "idle_in_backward_share.train", "idle_in_optimizer_share.train")}
    assert got["forward_host_ms.train"] == pytest.approx(0.030)
    assert got["backward_host_ms.train"] == pytest.approx(0.050)
    assert got["optimizer_host_ms.train"] == pytest.approx(0.010)
    assert got["idle_in_forward_share.train"] == pytest.approx(100 * 30 / 150)
    assert got["idle_in_backward_share.train"] == pytest.approx(0.0)
    assert got["idle_in_optimizer_share.train"] == pytest.approx(
        100 * 10 / 150)


def test_train_readers_return_none_without_their_spans(monkeypatch):
    names = ("forward_host_ms.train", "idle_in_forward_share.train")
    trace = synthetic_trace(2000.0, 2200.0, [(2030.0, 2080.0)])
    rec = Recorder()
    with_recorder(monkeypatch, rec)
    train_run(rec)
    for ctx in ({"kind": "serve", "steps": 3, "trace": trace},
                {"kind": "train", "steps": 3, "trace": None}):
        assert [reader(n)(ctx) for n in names] == [None, None]
    # more window steps asked for than recorded; no profiled step
    assert reader(names[0])({"kind": "train", "steps": 4,
                             "trace": trace}) is None
    rec.reset()
    train_run(rec, profiled=0)
    assert reader(names[1])({"kind": "train", "steps": 3,
                             "trace": trace}) is None
    # the ring dropped the first window step's phases, not the step
    small = Recorder(capacity=13)
    with_recorder(monkeypatch, small)
    train_run(small)
    ctx = {"kind": "train", "steps": 3, "trace": trace}
    assert reader(names[0])(ctx) is None
    assert reader(names[1])(ctx) is not None
    # an older program, without the recorder
    monkeypatch.setattr(program_spans, "_tracing", lambda: None)
    assert [reader(n)(ctx) for n in names] == [None, None]


def test_graph_replay_share_reads_the_window_steps(monkeypatch):
    """``graph_replay_share.train``: % of the window's ``step`` spans that
    hold a ``step.replay``; 0 for a program that runs every step eagerly,
    None without the spans."""
    trace = synthetic_trace(2000.0, 2200.0, [(2030.0, 2080.0)])
    read = reader("graph_replay_share.train")
    rec = Recorder()
    with_recorder(monkeypatch, rec)
    # five window steps (the first two eager), then one profiled step
    for k, t in enumerate([1000, 1100, 1200, 1300, 1400, 2000]):
        children = ([("step.forward", 0, 30), ("step.backward", 30, 80),
                     ("step.optimizer", 80, 90)] if k < 2 else
                    [("step.inputs", 0, 5), ("step.replay", 5, 20)])
        children = [rec.record(name, us(t + a), us(t + b))
                    for name, a, b in children]
        step = rec.record("step", us(t), us(t + 100))
        for child in children:
            child.parent = step.id
    assert read({"kind": "train", "steps": 5, "trace": trace}) == \
        pytest.approx(60.0)
    assert read({"kind": "train", "steps": 3, "trace": trace}) == \
        pytest.approx(100.0)
    assert read({"kind": "train", "steps": 6, "trace": trace}) is None
    assert read({"kind": "train", "steps": 5, "trace": None}) is None
    rec.reset()
    train_run(rec)
    assert read({"kind": "train", "steps": 3, "trace": trace}) == 0.0
    monkeypatch.setattr(program_spans, "_tracing", lambda: None)
    assert read({"kind": "train", "steps": 3, "trace": trace}) is None


def serve_run(rec, calls=3):
    """Engine calls of 20 us every 50 us from t = 1000 us, each with h2d 2
    us and forward 8 us, two requests queued 5 us before each call, and
    the batcher's loop spans between the calls; then one call inside the
    sub-window [2000, 2100]."""
    starts = [1000 + 50 * k for k in range(calls)] + [2050]
    for b, t in enumerate(starts):
        for r in (2 * b, 2 * b + 1):
            rec.record("serve.queue", us(t - 10 - r % 2), us(t - 5),
                       request=r, batch=b)
        rec.record("serve.gather", us(t - 5), us(t - 1), batch=b)
        rec.record("serve.stack", us(t - 1), us(t), batch=b)
        call = rec.record("engine.predict", us(t), us(t + 20), batch=b)
        for name, a, z in (("engine.h2d", 0, 2), ("engine.forward", 2, 10),
                           ("engine.d2h", 10, 20)):
            rec.record(name, us(t + a), us(t + z), batch=b).parent = call.id
        rec.record("serve.reply", us(t + 20), us(t + 25), batch=b)
        rec.record("serve.first", us(t + 25), us(t + 45))


def test_serve_readers_read_the_window_and_the_batchers_idle(monkeypatch):
    rec = Recorder()
    with_recorder(monkeypatch, rec)
    serve_run(rec)
    # busy 2055-2070: idle 2000-2055 and 2070-2100 (85 us)
    ctx = {"kind": "serve", "engine_calls": 2, "completed": 4,
           "trace": synthetic_trace(2000.0, 2100.0, [(2055.0, 2070.0)])}
    got = {n: reader(n)(ctx) for n in (
        "queue_wait_ms.serve", "batcher_gap_ms.serve",
        "engine_enqueue_ms.serve", "idle_in_batcher_share.serve")}
    assert got["queue_wait_ms.serve"] == pytest.approx(0.0055)
    assert got["batcher_gap_ms.serve"] == pytest.approx(0.030)
    assert got["engine_enqueue_ms.serve"] == pytest.approx(0.010)
    # the batcher's loop in the sub-window: gather and stack 2045-2050,
    # reply and first 2070-2095
    assert got["idle_in_batcher_share.serve"] == pytest.approx(
        100 * (5 + 25) / (55 + 30))


def test_serve_readers_return_none_without_their_spans(monkeypatch):
    names = ("queue_wait_ms.serve", "batcher_gap_ms.serve",
             "engine_enqueue_ms.serve", "idle_in_batcher_share.serve")
    trace = synthetic_trace(2000.0, 2100.0, [(2055.0, 2070.0)])
    rec = Recorder()
    with_recorder(monkeypatch, rec)
    serve_run(rec)
    for ctx in ({"kind": "train", "engine_calls": 2, "completed": 4,
                 "trace": trace},
                {"kind": "serve", "engine_calls": 2, "completed": 4,
                 "trace": None}):
        assert [reader(n)(ctx) for n in names] == [None] * 4
    # more calls and requests asked for than there were
    ctx = {"kind": "serve", "engine_calls": 3, "completed": 7,
           "trace": trace}
    assert [reader(n)(ctx) for n in names[:3]] == [None] * 3
    # no loop span of the batcher inside the sub-window
    late = synthetic_trace(3000.0, 3100.0, [])
    assert reader(names[3])({"kind": "serve", "trace": late}) is None
    monkeypatch.setattr(program_spans, "_tracing", lambda: None)
    ctx = {"kind": "serve", "engine_calls": 2, "completed": 4,
           "trace": trace}
    assert [reader(n)(ctx) for n in names] == [None] * 4
