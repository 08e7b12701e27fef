"""Training observability: console throughput lines, JSONL metrics,
optional Weights & Biases, and profiler traces.

Port of ``unsupervised_pose_estimation_tpu/train/logging.py``, with the same
``metrics.jsonl`` records and console lines. Over a mesh of processes
only rank 0 prints, writes and logs (the values are global already). W&B is
opt-in and skipped with
a message when not installed. ``Profiler`` traces a window of steps with
``torch.profiler`` (CPU and CUDA activities) and writes a Chrome trace to
``profile_dir``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.png import write_png


def sec_to_hm_str(t: float) -> str:
    """10239 -> '02h50m39s'."""
    t = int(t)
    s = t % 60
    t //= 60
    m = t % 60
    t //= 60
    return f"{t:02d}h{m:02d}m{s:02d}s"


def normalize_image(x):
    """Per-image min-max rescale for visualization."""
    x = np.asarray(x)
    ma, mi = x.max(), x.min()
    return (x - mi) / (ma - mi + 1e-5)


class MetricLogger:
    """Console lines, ``metrics.jsonl`` and W&B, from rank 0 only
    (``rank``: this process's)."""

    def __init__(self, log_dir: str, model_name: str, use_wandb: bool = False,
                 jsonl: bool = True, config: Optional[dict] = None,
                 total_steps: Optional[int] = None, rank: int = 0):
        self.log_path = os.path.join(log_dir, model_name)
        os.makedirs(self.log_path, exist_ok=True)
        self.start_time = time.time()
        self.total_steps = total_steps
        self.writes = rank == 0
        self._jsonl = None
        self._wandb = None
        if not self.writes:
            return
        if jsonl:
            self._jsonl = open(os.path.join(self.log_path, "metrics.jsonl"),
                               "a", buffering=1)
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project="unsupervised_pose_estimation_tpu",
                           config=config or {})
            except Exception as e:  # optional; training goes on without it
                print(f"[logging] wandb unavailable ({e}); continuing")

    def log_time(self, epoch: int, batch_idx: int, step: int,
                 duration: float, batch_size: int, loss: float):
        """The reference trainer's console line."""
        if not self.writes:
            return
        samples_per_sec = batch_size / max(duration, 1e-9)
        elapsed = time.time() - self.start_time
        if self.total_steps and step > 0:
            left = (self.total_steps / step - 1.0) * elapsed
        else:
            left = 0
        print(f"epoch {epoch:>3} | batch {batch_idx:>6} | "
              f"examples/s: {samples_per_sec:5.1f} | loss: {loss:.5f} | "
              f"time elapsed: {sec_to_hm_str(elapsed)} | "
              f"time left: {sec_to_hm_str(left)}")

    def log_scalars(self, mode: str, scalars: Dict[str, float], step: int,
                    learning_rate: Optional[float] = None):
        record = {"mode": mode, "step": step,
                  "time": time.time() - self.start_time}
        record.update({k: float(v) for k, v in scalars.items()})
        if learning_rate is not None:
            record["learning_rate"] = learning_rate
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
        if self._wandb:
            self._wandb.log({f"{mode}/{k}": v for k, v in record.items()
                             if k not in ("mode",)}, step=step)

    def log_images(self, mode: str, images: Dict[str, np.ndarray], step: int):
        """Per-scale disp/automask/warped images: to W&B when enabled,
        else 8-bit PNGs under ``<log_path>/images/step_<N>/``
        (``data.png.write_png``)."""
        if not self.writes:
            return
        if self._wandb:
            payload = {}
            for name, img in images.items():
                arr = normalize_image(img)
                payload[f"{mode}/{name}"] = self._wandb.Image(arr)
            self._wandb.log(payload, step=step)
            return
        out_dir = os.path.join(self.log_path, "images", f"step_{step}")
        os.makedirs(out_dir, exist_ok=True)
        for name, img in images.items():
            arr = np.asarray(normalize_image(img))
            if arr.ndim == 3 and arr.shape[0] in (1, 3) \
                    and arr.shape[-1] not in (1, 3):
                arr = np.moveaxis(arr, 0, -1)  # CHW -> HWC
            if arr.ndim == 3 and arr.shape[-1] == 1:
                arr = arr[..., 0]
            u8 = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
            safe = f"{mode}_{name}".replace("/", "_")
            write_png(os.path.join(out_dir, f"{safe}.png"), u8)

    def finish(self):
        if self._jsonl:
            self._jsonl.close()
        if self._wandb:
            self._wandb.finish()


class Profiler:
    """A ``torch.profiler`` trace of steps ``start_step`` to ``start_step +
    num_steps`` (the reference's window), written to
    ``<profile_dir>/trace_<start_step>.json``."""

    def __init__(self, profile_dir: Optional[str], start_step: int = 10,
                 num_steps: int = 5):
        self.dir = profile_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None

    def maybe_start(self, step: int):
        if self.dir and self._prof is None and step == self.start_step:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()

    def maybe_stop(self, step: int):
        if self._prof is not None and step >= self.stop_step:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            os.makedirs(self.dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.dir, f"trace_{self.start_step}.json"))
            self._prof = None
