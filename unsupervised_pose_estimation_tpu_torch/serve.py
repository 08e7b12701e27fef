"""Depth serving: a batched inference engine, a micro-batcher, an HTTP
front end and an exported artifact.

Port of ``unsupervised_pose_estimation_tpu/serve.py``. The engine runs the
depth encoder and decoder (``train.step.build_infer_step``) on batches of up
to ``max_batch`` images; the batcher coalesces concurrent single-image
requests into shared engine calls, flushing on size or deadline. PyTorch
runs eagerly, so partial batches are not padded to a compiled shape.

  * ``make_http_server`` (stdlib): POST /predict with an image body -> .npy
    bytes of the float32 disparity; GET /healthz. A PNG or JPEG body is
    decoded and resized with ``data.png``, ``data.jpeg`` and
    ``data.resample`` (PIL's bytes, without PIL; the native host routines
    on a CUDA engine); any other format goes through PIL, imported for
    that request only.
  * ``export_artifact`` / ``load_artifact``: ``torch.export`` of the
    batched depth forward at a fixed (max_batch, H, W, 3) float32 input,
    with a ``.json`` sidecar of the feed; the artifact loads and runs
    without the model code.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from . import tracing
from .config import Options
from .data.png import decode_image
from .data.resample import resize_lanczos
from .eval.evaluate_depth import load_eval_state
from .ops.geometry import disp_to_depth
from .ops.kernels._lib import native_route
from .train.bundle import ModelBundle
from .train.loop import float32_setting, resolve_device
from .train.step import build_infer_step


class InferenceEngine:
    """Batched depth inference on one device, at ``opt.compute_dtype``;
    disparities come back in float32."""

    def __init__(self, opt: Options, max_batch: int = 8, device="cuda",
                 bundle: Optional[ModelBundle] = None):
        """The weights: ``bundle``'s when given (for example loaded from
        ``convert.from_jax``), else those of ``opt.load_weights_folder``
        through ``eval.evaluate_depth.load_eval_state`` (a checkpoint
        directory of this package, or a folder holding the reference's
        ``encoder.pth`` and ``depth.pth``, whose decoder variant it
        detects), else drawn from ``opt.seed``."""
        self.opt = opt
        self.max_batch = max_batch
        self.height, self.width = opt.height, opt.width
        self.device = resolve_device(device)
        print(float32_setting(opt))
        if bundle is None and opt.load_weights_folder is not None:
            bundle = load_eval_state(opt, self.device)
        elif bundle is None:
            bundle = ModelBundle.create(opt, seed=opt.seed,
                                        device=self.device)
        self.bundle = bundle
        self._infer = build_infer_step(self.bundle)
        self.calls = 0

    def predict(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 or float [0, 1] -> (N, H, W) disparity,
        N <= max_batch."""
        n = images.shape[0]
        if n > self.max_batch:
            raise ValueError(f"batch {n} > max_batch {self.max_batch}")
        if images.shape[1:] != (self.height, self.width, 3):
            raise ValueError(f"images must be (N, {self.height}, "
                             f"{self.width}, 3), got {images.shape}")
        with tracing.span("engine.predict"):
            with tracing.span("engine.h2d"):
                x = torch.from_numpy(np.ascontiguousarray(images)).to(
                    self.device)
                x = (x.float() * (1.0 / 255.0) if x.dtype == torch.uint8
                     else x.float())
            with tracing.span("engine.forward"):
                disp = self._infer(x)[0][..., 0]
            self.calls += 1
            with tracing.span("engine.d2h"):
                return disp.cpu().numpy()

    def predict_depth(self, images: np.ndarray) -> np.ndarray:
        _, depth = disp_to_depth(self.predict(images), self.opt.min_depth,
                                 self.opt.max_depth)
        return depth


class MicroBatcher:
    """Coalesce concurrent single-image requests into shared engine calls.

    Its thread's loop is tiled by ``tracing`` spans: ``serve.first``
    (waiting for a batch's first request), ``serve.gather`` (from it to the
    batch's close, on size or deadline), ``serve.stack``, the engine's
    ``engine.predict`` and ``serve.reply``, all with the batch's id. Each
    request's ``serve.queue`` runs from ``submit`` to the batcher taking
    it, with its request id and batch id; counters ``serve.requests`` and
    ``serve.batches``."""

    def __init__(self, engine: InferenceEngine, max_delay_ms: float = 5.0):
        self.engine = engine
        self.max_delay = max_delay_ms / 1000.0
        self._queue: "queue.Queue[tuple]" = queue.Queue()
        self._requests = itertools.count()
        self._batches = itertools.count()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="micro-batcher")
        self._thread.start()

    def submit(self, image: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        """(H, W, 3) -> (H, W) disparity; blocks until served."""
        reply: "queue.Queue" = queue.Queue(maxsize=1)
        self._queue.put((image, reply, next(self._requests),
                         tracing.now_ns()))
        out = reply.get(timeout=timeout)
        if isinstance(out, Exception):
            raise out
        return out

    def _run(self):
        while not self._stop.is_set():
            with tracing.span("serve.first"):
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                bid = next(self._batches)
                _queued(first, bid)
            with tracing.ids(batch=bid):
                self._serve(first, bid)

    def _serve(self, first: tuple, bid: int):
        with tracing.span("serve.gather"):
            batch = [first]
            deadline = time.monotonic() + self.max_delay
            while len(batch) < self.engine.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=left))
                except queue.Empty:
                    break
                _queued(batch[-1], bid)
            tracing.count("serve.requests", len(batch))
            tracing.count("serve.batches")
        try:
            with tracing.span("serve.stack"):
                images = np.stack([b[0] for b in batch])
            disps = self.engine.predict(images)
        except Exception as err:  # every waiter gets the failure
            with tracing.span("serve.reply"):
                for b in batch:
                    b[1].put(err)
            return
        with tracing.span("serve.reply"):
            for b, d in zip(batch, disps):
                b[1].put(d)

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def close(self, timeout: float = 30.0):
        """Stop the batching thread and wait up to ``timeout`` s for it."""
        self._stop.set()
        self._thread.join(timeout=timeout)


def _queued(request: tuple, batch: int):
    """The request's ``serve.queue`` span: submitted to taken now."""
    tracing.record("serve.queue", request[3], tracing.now_ns(),
                   request=request[2], batch=batch)


def decode_request(body: bytes, height: int, width: int,
                   native: bool = False) -> np.ndarray:
    """An image file's bytes -> the (height, width, 3) uint8 feed: PIL's
    ``convert("RGB")`` and LANCZOS resize, bit for bit. A PNG or a JPEG
    never loads PIL; any other format needs it
    (``data.png.decode_image``)."""
    return resize_lanczos(decode_image(body, native), height, width, native)


def make_http_server(batcher: MicroBatcher, host: str = "127.0.0.1",
                     port: int = 0):
    """-> http.server.ThreadingHTTPServer serving the engine.

    POST /predict: image file body (PNG, JPEG; others through PIL) ->
    .npy bytes of the (H, W) float32 disparity (resized server-side to the
    feed shape); a request that fails gets a 500 with the error's message.
    GET /healthz: {"status": "ok", "feed": [H, W], "max_batch": N}.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    engine = batcher.engine
    native = native_route(engine.device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            body = json.dumps({
                "status": "ok",
                "feed": [engine.height, engine.width],
                "max_batch": engine.max_batch,
            }).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/predict":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                feed = decode_request(self.rfile.read(n), engine.height,
                                      engine.width, native)
                disp = batcher.submit(feed)
                buf = io.BytesIO()
                np.save(buf, disp.astype(np.float32))
                payload = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "application/x-npy")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            except Exception as err:  # the client gets the failure
                self.send_error(500, str(err))

    class Server(ThreadingHTTPServer):
        # the listen backlog: with socketserver's 5, a burst of concurrent
        # clients beyond it waits a TCP retransmit (1 s) to connect
        request_queue_size = 128

    return Server((host, port), Handler)


# ---------------------------------------------------------------------------
# Exported artifact
# ---------------------------------------------------------------------------


class _DepthForward(torch.nn.Module):
    """The batched depth forward as a module: (B, H, W, 3) float32 in
    [0, 1] -> (B, H, W) float32 disparity of scale 0."""

    def __init__(self, bundle: ModelBundle):
        super().__init__()
        self.bundle = bundle
        self._infer = build_infer_step(bundle)

    def forward(self, images):
        return self._infer(images)[0][..., 0]


def export_artifact(opt: Options, out_path: str, max_batch: int = 8,
                    bundle: Optional[ModelBundle] = None,
                    device="cuda") -> str:
    """Export the batched depth forward at ``opt.compute_dtype``
    (``torch.export`` at a fixed (max_batch, H, W, 3) float32 input) to
    ``out_path``, with ``<out_path>.json`` holding the feed (height, width,
    max_batch, min_depth, max_depth); -> ``out_path``. The weights are
    ``bundle``'s, else those ``InferenceEngine`` would load."""
    device = resolve_device(device)
    if bundle is None and opt.load_weights_folder is not None:
        bundle = load_eval_state(opt, device)
    elif bundle is None:
        bundle = ModelBundle.create(opt, seed=opt.seed, device=device)
    example = torch.zeros(max_batch, opt.height, opt.width, 3,
                          dtype=torch.float32, device=device)
    program = torch.export.export(_DepthForward(bundle).eval(), (example,))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)
    meta = {"height": opt.height, "width": opt.width, "max_batch": max_batch,
            "min_depth": opt.min_depth, "max_depth": opt.max_depth}
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f)
    return out_path


def load_artifact(path: str, device="cuda"):
    """-> (callable images -> disparity, meta): the callable takes a
    (max_batch, H, W, 3) float32 tensor in [0, 1] on ``device`` and returns
    the (max_batch, H, W) float32 disparity; it runs the exported program
    (``torch.export.load``), no model code."""
    device = resolve_device(device)
    module = torch.export.load(path).module().to(device)
    with open(path + ".json") as f:
        meta = json.load(f)

    def call(images):
        with torch.inference_mode():
            return module(images)

    return call, meta
