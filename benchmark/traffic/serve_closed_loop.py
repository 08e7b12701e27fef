"""Serving traffic: a closed loop of client streams through the port's
``serve.MicroBatcher`` over an ``InferenceEngine``.

Each of ``clients`` threads submits a frame from a seeded pool of
``pool_frames`` uint8 frames at the configuration's size, waits for its
disparity, and sends its next frame (a video stream that waits for each
frame's depth). The engine batches up to ``max_batch`` requests, waiting
at most ``max_delay_ms`` for a batch to fill. Set-up warms every batch size
the batcher can form, then runs the loop for ``warmup_s``. The window
counts the depth maps returned within ``seconds``; p95 is over the
latencies (submit to reply) of every request completed in it. Requests
still open at the close finish within ``late_s`` and are not counted.
Replies are kept for a share ``check_share`` of the requests, drawn from
the seed, and compared after the window with the plain reference of their
own frame. With ``trace`` a profiled sub-window of ``trace_s`` follows;
``trace_completed`` counts the requests completed in it.
"""

from __future__ import annotations

import gc
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import inputs
from ..harness import derive, percentile
from ..reference import monodepth2 as ref
from ..reference.precision import Precision
from ..trace import Profiled
from .train_loop import layout, options, set_precision


class Loop:
    """The client threads of one phase of the closed loop."""

    def __init__(self, batcher, frames: np.ndarray, mix: dict, seed: int,
                 phase: str, spans, keep: bool):
        self.batcher, self.frames, self.mix = batcher, frames, mix
        self.seed, self.phase, self.spans, self.keep = seed, phase, spans, keep
        self.stop = threading.Event()
        self.go = threading.Event()
        self.records: List[List[tuple]] = [[] for _ in range(mix["clients"])]
        self.errors: List[List[tuple]] = [[] for _ in range(mix["clients"])]
        self.threads = [threading.Thread(target=self._client, args=(c,),
                                         daemon=True, name=f"client-{c}")
                        for c in range(mix["clients"])]
        for t in self.threads:
            t.start()

    def _client(self, c: int):
        rng = np.random.default_rng(derive(self.seed, "client", self.phase,
                                           c))
        n = self.frames.shape[0]
        share = self.mix["check_share"]
        self.go.wait()
        while not self.stop.is_set():
            idx = int(rng.integers(n))
            kept = self.keep and rng.random() < share
            t0 = time.perf_counter()
            try:
                with self.spans.span("client"):
                    disp = self.batcher.submit(self.frames[idx],
                                               timeout=self.mix["late_s"])
            except Exception as err:  # a request that never came back
                self.errors[c].append((t0, repr(err)))
                continue
            t1 = time.perf_counter()
            self.records[c].append((t0, t1, idx, disp if kept else None))

    def start(self) -> float:
        t0 = time.perf_counter()
        self.go.set()
        return t0

    def close(self):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=self.mix["late_s"] + 5)
        if any(t.is_alive() for t in self.threads):
            raise RuntimeError("a client did not finish its last request")


def run(cfg_file: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device, spans, t_start: float, overrides: Optional[dict] = None,
        wrap_engine: Optional[Callable] = None) -> dict:
    from unsupervised_pose_estimation_tpu_torch.serve import (
        InferenceEngine, MicroBatcher)
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle

    opt = options(cfg_file, overrides)
    set_precision(cfg_file)
    lay = layout(opt)
    with torch.device("meta"):
        bundle = ModelBundle(opt)
    bundle = bundle.to_empty(device=device)
    bundle.load_state_dict(inputs.weights(lay, seed, device))
    bundle.eval()
    engine = InferenceEngine(opt, max_batch=mix["max_batch"], device=device,
                             bundle=bundle)
    predict = engine.predict

    def timed_predict(images):
        with spans.span("engine call"):
            return predict(images)

    engine.predict = timed_predict
    if wrap_engine is not None:
        wrap_engine(engine)
    frames = inputs.textures(seed, "serve", mix["pool_frames"], (0,),
                             opt.height, opt.width, (0, 0),
                             mix["texture_components"], device)[:, 0]
    batcher = MicroBatcher(engine, max_delay_ms=mix["max_delay_ms"])
    out: Dict[str, object] = {}
    try:
        for n in range(1, mix["max_batch"] + 1):
            for _ in range(2):
                engine.predict(frames[:n])
        warm = Loop(batcher, frames, mix, seed, "warmup", spans, False)
        warm.start()
        time.sleep(mix["warmup_s"])
        warm.close()
        out["setup_s"] = time.perf_counter() - t_start

        spans.reset()
        peak0 = 0
        if device.type == "cuda":
            peak0 = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        loop = Loop(batcher, frames, mix, seed, "window", spans, True)
        calls0 = engine.calls
        t0 = loop.start()
        time.sleep(seconds)
        t_end = time.perf_counter()
        calls = engine.calls - calls0
        loop.close()
        window = t_end - t0
        done = [r for rs in loop.records for r in rs if r[1] <= t_end]
        failed = [e for es in loop.errors for e in es if e[0] < t_end]
        late = [r for rs in loop.records for r in rs if r[1] > t_end]
        out.update(window_s=window, completed=len(done),
                   attempted=len(done) + len(failed) + len(late),
                   failed=len(failed), engine_calls=calls,
                   images_per_s=len(done) / window,
                   p95_ms=percentile([(t1 - s) * 1e3 for s, t1, _, _ in
                                      done], 95) if done else None,
                   engine_call_s=list(spans.durations.get("engine call",
                                                          [])))
        out["peak_window_bytes"] = (torch.cuda.max_memory_allocated(device)
                                    if device.type == "cuda" else 0)
        if trace:
            traced = Loop(batcher, frames, mix, seed, "trace", spans, False)
            with Profiled(spans) as prof:
                traced.start()
                time.sleep(mix["trace_s"])
                traced.stop.set()
                for t in traced.threads:
                    t.join(timeout=mix["late_s"] + 5)
            out["trace"] = prof.trace
            out["trace_completed"] = sum(len(r) for r in traced.records)
        out["memory_peak_bytes"] = (max(peak0, torch.cuda.max_memory_allocated(
            device)) if device.type == "cuda" else 0)
    finally:
        batcher.close()
    kept = [(idx, disp) for s, t1, idx, disp in done if disp is not None]
    del engine, batcher, bundle, predict
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["readings"] = compare(kept, reference(opt, lay, seed, frames, kept,
                                              "float32", device))
    out["readings"]["failed"] = float(len(failed))
    out["options"] = opt
    return out


def reference(opt, lay, seed: int, frames: np.ndarray, kept, precision: str,
              device) -> Dict[int, np.ndarray]:
    """The reference's disparity of every frame a kept reply answered."""
    P = inputs.weights(lay, seed, device)
    idxs = sorted({idx for idx, _ in kept})
    if not idxs:
        return {}
    images = torch.from_numpy(frames[idxs]).to(device)
    disp = ref.infer(P, {"depth_decoder_variant": opt.depth_decoder_variant,
                         "scales": tuple(opt.scales)}, images,
                     Precision(precision)).cpu().numpy()
    return dict(zip(idxs, disp))


def compare(kept, ref_disp: Dict[int, np.ndarray]) -> Dict[str, float]:
    """disp_gap: the largest |reply - reference| over every pixel of every
    kept reply, each against the reference of its own request's frame;
    checked: how many replies were compared."""
    gap = 0.0
    for idx, disp in kept:
        gap = max(gap, float(np.abs(disp - ref_disp[idx]).max()))
    return {"disp_gap": gap if kept else float("nan"),
            "checked": float(len(kept))}


def control(cfg_file: dict, mix: dict, seed: int, device, precision: str,
            overrides: Optional[dict] = None, count: int = 256
            ) -> Dict[str, float]:
    """disp_gap of the reference in ``precision`` put in the program's
    place, over ``count`` requests drawn from the pool as the clients
    draw them."""
    opt = options(cfg_file, overrides)
    set_precision(cfg_file)
    lay = layout(opt)
    frames = inputs.textures(seed, "serve", mix["pool_frames"], (0,),
                             opt.height, opt.width, (0, 0),
                             mix["texture_components"], device)[:, 0]
    rng = np.random.default_rng(derive(seed, "control"))
    idxs = sorted(set(int(i) for i in rng.integers(frames.shape[0],
                                                   size=count)))
    fake = reference(opt, lay, seed, frames, [(i, None) for i in idxs],
                     precision, device)
    ref_disp = reference(opt, lay, seed, frames, [(i, None) for i in idxs],
                         "float32", device)
    return compare([(i, fake[i]) for i in idxs], ref_disp)


def summary(out: dict) -> dict:
    opt = out["options"]
    calls = out["engine_call_s"]
    return {"metrics": {"serve_images_per_s": out["images_per_s"],
                        "serve_p95_ms": out["p95_ms"],
                        "setup_s": out["setup_s"]},
            "ctx": {"kind": "serve", "options": opt,
                    "dtype": opt.compute_dtype, "window_s": out["window_s"],
                    "completed": out["completed"],
                    "engine_calls": out["engine_calls"],
                    "engine_call_s": calls,
                    "engine_call_median_s": (statistics.median(calls)
                                             if calls else None),
                    "images_per_s": out["images_per_s"],
                    "trace_completed": out.get("trace_completed"),
                    "peak_window_bytes": out["peak_window_bytes"],
                    "trace": out.get("trace")}}
