"""Host -> device input pipeline: worker decode, batching, prefetch.

Port of ``unsupervised_pose_estimation_tpu/data/pipeline.py``. Thread (or
spawned process) workers build items, a producer thread stacks them into
batches, and a queue of depth ``prefetch`` overlaps host work with the
device. The per-epoch shuffle and the per-(epoch, index) item draws are the
reference's, so both packages give the same batches, and a resumed run
replays them (``epoch(epoch, start_batch)``).

On a CUDA device the producer stacks each batch straight into pinned host
buffers, and the consumer copies batch N+1 to the device on a side stream
while the caller runs step N: the caller's stream waits on the copy's event
before it sees the batch, the device tensors are recorded on the caller's
stream, and a pinned buffer is refilled only after its copy has completed.
Multi-host row selection (the reference's ``process_local_rows``) is not
ported.
"""

from __future__ import annotations

import pickle
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import get_context
from typing import Dict, Iterator, Optional

import numpy as np
import torch

_POLL_S = 0.1  # how often a blocked producer looks for a stop request


def collate(items, out: Optional[Dict[str, np.ndarray]] = None) -> dict:
    """Stack items key by key along a new leading axis (into ``out``'s
    arrays when given)."""
    if out is None:
        return {key: np.stack([it[key] for it in items], 0)
                for key in items[0]}
    for key in items[0]:
        np.stack([it[key] for it in items], 0, out=out[key])
    return out


# Process workers: the dataset is pickled once into each spawned worker,
# items are fetched by index. get_item(index, epoch) is deterministic, so
# process- and thread-produced batches are bit-identical. The workers do
# numpy work only; importing torch creates no CUDA context.
_PROC_DATASET = None


def _proc_init(payload: bytes):
    global _PROC_DATASET
    _PROC_DATASET = pickle.loads(payload)


def _proc_get(index: int, epoch: int):
    return _PROC_DATASET.get_item(int(index), epoch)


class _PinnedSlot:
    """One batch's pinned host buffers and the event of their last copy to
    the device."""

    def __init__(self):
        self.tensors: Dict[str, torch.Tensor] = {}
        self.copied: Optional[torch.cuda.Event] = None

    def arrays(self, items) -> Dict[str, np.ndarray]:
        """numpy views of buffers shaped for ``items``, once the previous
        copy out of them has completed."""
        if self.copied is not None:
            self.copied.synchronize()
            self.copied = None
        out = {}
        for key, value in items[0].items():
            shape = (len(items),) + np.shape(value)
            dtype = torch.from_numpy(np.asarray(value)[None]).dtype
            t = self.tensors.get(key)
            if t is None or t.shape != shape or t.dtype != dtype:
                t = torch.empty(shape, dtype=dtype, pin_memory=True)
                self.tensors[key] = t
            out[key] = t.numpy()
        return out


def _get(q: "queue.Queue", stop: threading.Event):
    """q.get that gives up (-> None) when ``stop`` is set."""
    while not stop.is_set():
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            continue
    return None


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """q.put that gives up when ``stop`` is set; -> whether it was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            continue
    return False


class Loader:
    """Iterable over batches: dicts of tensors on ``device``.

    Args:
      dataset: object with __len__ and get_item(index, epoch).
      batch_size: items per batch (drop_last always).
      shuffle: reshuffle the indices each epoch, from ``seed + epoch``.
      device: where the batches go; on CUDA through pinned buffers and a
        side stream, one batch ahead.
      num_workers: item threads.
      num_worker_procs: item processes (spawned) instead of threads, when
        > 0; falls back to threads if the dataset cannot be pickled.
      prefetch: host batches queued ahead of the consumer.
      infinite: iterate over epochs 0, 1, ... without end.

    ``wait_seconds`` sums the time the consumer waited on the queue (the
    host's share of an input-bound step), ``batches`` counts the batches
    handed out.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 device="cpu", num_workers: int = 8, prefetch: int = 2,
                 seed: int = 0, infinite: bool = False,
                 num_worker_procs: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.device = torch.device(device)
        self.num_workers = max(1, num_workers)
        self.num_worker_procs = max(0, num_worker_procs)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.infinite = infinite
        self.wait_seconds = 0.0
        self.batches = 0
        self._proc_pool = None
        self._slots: Optional["queue.Queue[_PinnedSlot]"] = None
        self._copy_stream = None
        if len(dataset) < batch_size:
            raise ValueError(
                f"dataset ({len(dataset)}) smaller than batch ({batch_size})")

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _get_proc_pool(self):
        """Spawned process pool, created on first use and kept across
        epochs (spawning is slow)."""
        if self._proc_pool is not None:
            return self._proc_pool
        from concurrent.futures import ProcessPoolExecutor

        try:
            payload = pickle.dumps(self.dataset)
        except (pickle.PicklingError, TypeError, AttributeError) as e:
            import warnings

            warnings.warn(f"dataset not picklable ({e}); "
                          f"falling back to thread workers")
            self.num_worker_procs = 0
            return None
        self._proc_pool = ProcessPoolExecutor(
            self.num_worker_procs, mp_context=get_context("spawn"),
            initializer=_proc_init, initargs=(payload,))
        return self._proc_pool

    def close(self):
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=True, cancel_futures=True)
            self._proc_pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        n = len(self)
        return idx[: n * self.batch_size].reshape(n, self.batch_size)

    def _pinned(self) -> bool:
        return self.device.type == "cuda"

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator[dict]:
        """Yield the batches of one epoch, from batch ``start_batch`` on
        (mid-epoch resume: batch N is the one an uninterrupted run sees).
        Worker errors are raised here, in the consumer."""
        batches = self._indices(epoch)[start_batch:]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        proc_pool = self._get_proc_pool() if self.num_worker_procs else None
        if self._pinned() and self._slots is None:
            # enough buffers for a full queue, the batch being stacked and
            # the one being copied
            self._slots = queue.Queue()
            for _ in range(self.prefetch + 2):
                self._slots.put(_PinnedSlot())
            self._copy_stream = torch.cuda.Stream(self.device)
        slots = self._slots

        def fetch(pool, row):
            if proc_pool is not None:
                return list(proc_pool.map(_proc_get, [int(i) for i in row],
                                          [epoch] * len(row)))
            return list(pool.map(
                lambda i: self.dataset.get_item(int(i), epoch), row))

        def produce():
            slot = None
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for row in batches:
                        if stop.is_set():
                            return
                        items = fetch(pool, row)
                        if slots is None:
                            batch = (collate(items), None)
                        else:
                            slot = _get(slots, stop)
                            if slot is None:
                                return
                            batch = (collate(items, slot.arrays(items)), slot)
                        if not _put(q, batch, stop):
                            return
                        slot = None
            except BaseException as e:  # surface worker errors to consumer
                _put(q, e, stop)
                return
            finally:
                if slot is not None:
                    slots.put(slot)
            _put(q, None, stop)

        thread = threading.Thread(target=produce, daemon=True,
                                  name="loader-producer")
        thread.start()
        try:
            pending = None
            while True:
                start = time.perf_counter()
                got = q.get()
                self.wait_seconds += time.perf_counter() - start
                if isinstance(got, BaseException):
                    raise got
                batch = None if got is None else self._to_device(*got)
                if pending is not None:
                    yield self._hand_out(*pending)
                if batch is None:
                    return
                pending = batch
        finally:
            stop.set()
            thread.join(timeout=60)
            # hand back the buffers of batches that were never consumed
            while True:
                try:
                    got = q.get_nowait()
                except queue.Empty:
                    break
                if isinstance(got, tuple) and got[1] is not None:
                    slots.put(got[1])

    def _to_device(self, host: Dict[str, np.ndarray],
                   slot: Optional[_PinnedSlot]):
        """Start the batch's transfer; -> (tensors, event to wait on)."""
        if slot is None:
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in host.items()}, None
        with torch.cuda.stream(self._copy_stream):
            out = {k: slot.tensors[k].to(self.device, non_blocking=True)
                   for k in host}
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        slot.copied = done
        self._slots.put(slot)
        return out, done

    def _hand_out(self, batch: Dict[str, torch.Tensor],
                  copied: Optional[torch.cuda.Event]):
        """Order the caller's stream after the batch's copy."""
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            for t in batch.values():
                t.record_stream(stream)
        self.batches += 1
        return batch

    def __iter__(self):
        epoch = 0
        while True:
            yield from self.epoch(epoch)
            epoch += 1
            if not self.infinite:
                return
