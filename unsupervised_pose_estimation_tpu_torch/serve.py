"""Depth serving: a batched inference engine and a micro-batcher.

Port of ``InferenceEngine`` and ``MicroBatcher`` of
``unsupervised_pose_estimation_tpu/serve.py``. The engine runs the depth
encoder and decoder (``train.step.build_infer_step``) on batches of up to
``max_batch`` images; the batcher coalesces concurrent single-image
requests into shared engine calls, flushing on size or deadline. PyTorch
runs eagerly, so partial batches are not padded to a compiled shape. The
HTTP front end and the exported artifact of the reference are not ported
yet (the front end decodes images with PIL).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .config import Options
from .eval.evaluate_depth import load_eval_state
from .ops.geometry import disp_to_depth
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
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        x = x.float() * (1.0 / 255.0) if x.dtype == torch.uint8 else x.float()
        disp = self._infer(x)[0][..., 0]
        self.calls += 1
        return disp.cpu().numpy()

    def predict_depth(self, images: np.ndarray) -> np.ndarray:
        _, depth = disp_to_depth(self.predict(images), self.opt.min_depth,
                                 self.opt.max_depth)
        return depth


class MicroBatcher:
    """Coalesce concurrent single-image requests into shared engine calls."""

    def __init__(self, engine: InferenceEngine, max_delay_ms: float = 5.0):
        self.engine = engine
        self.max_delay = max_delay_ms / 1000.0
        self._queue: "queue.Queue[Tuple[np.ndarray, queue.Queue]]" = \
            queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="micro-batcher")
        self._thread.start()

    def submit(self, image: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        """(H, W, 3) -> (H, W) disparity; blocks until served."""
        reply: "queue.Queue" = queue.Queue(maxsize=1)
        self._queue.put((image, reply))
        out = reply.get(timeout=timeout)
        if isinstance(out, Exception):
            raise out
        return out

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
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
            try:
                disps = self.engine.predict(np.stack([b[0] for b in batch]))
            except Exception as err:  # every waiter gets the failure
                for _, reply in batch:
                    reply.put(err)
                continue
            for (_, reply), d in zip(batch, disps):
                reply.put(d)

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def close(self, timeout: float = 30.0):
        """Stop the batching thread and wait up to ``timeout`` s for it."""
        self._stop.set()
        self._thread.join(timeout=timeout)
