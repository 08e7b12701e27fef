"""Pre-decoded frame cache: one memory-mapped uint8 array per dataset.

Port of ``unsupervised_pose_estimation_tpu/data/cache.py``, in the same
format, so a cache either package builds is read by both: ``frames_u8.npy``
(N, H, W, 3) uint8, written through ``open_memmap``, and ``index.json``
holding the height, the width, the dataset fingerprint and a
``{folder|frame|side: row}`` index. Reading needs numpy alone; building
decodes and resizes as the dataset's own items do (``data.png``,
``data.resample.resize_lanczos``: PIL's LANCZOS bytes, native host routines
when the dataset's ``native`` is set), so the port's cache holds the bytes
of the reference's. The flip and the jitter stay per item, so cached and
uncached items are bit-identical.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .resample import resize_lanczos
from .split import parse_split_line

FRAMES_FILE = "frames_u8.npy"
INDEX_FILE = "index.json"

_OTHER_SIDE = {"r": "l", "l": "r"}


def frame_key(folder: str, frame_index: int, side: Optional[str]) -> str:
    return f"{folder}|{frame_index}|{side}"


def dataset_fingerprint(dataset) -> str:
    """Identity of the pixel source a cache was built from (data_path,
    dataset class, feed size), the same string as the reference package's,
    so a cache either package built is accepted by both. The split list is
    not part of it: a cache over a subset of the same source is valid, and
    misses fall back to the files."""
    import hashlib

    h = hashlib.sha256()
    h.update(os.path.abspath(dataset.data_path).encode())
    h.update(type(dataset).__name__.encode())
    h.update(f"{dataset.height}x{dataset.width}".encode())
    return h.hexdigest()[:16]


def enumerate_frames(dataset) -> list:
    """Every (folder, frame_index, side) the dataset's items can touch:
    the temporal window fi + i*sampling_frequency per split line, plus the
    opposite-side frame for stereo items."""
    seen, keys = set(), []
    for line in dataset.filenames:
        folder, fi, side = parse_split_line(line)
        for i in dataset.frame_idxs:
            if i == "s":
                key = (folder, fi, _OTHER_SIDE[side])
            else:
                key = (folder, fi + int(i) * dataset.sampling_frequency,
                       side)
            if key not in seen:
                seen.add(key)
                keys.append(key)
    return keys


def build_frame_cache(dataset, cache_dir: str, log=None) -> dict:
    """Decode every reachable frame once and write the cache.

    Frames whose source file is missing are skipped (items touching them
    fall back to the disk path at runtime). Returns summary stats.
    """
    keys = enumerate_frames(dataset)
    h, w = dataset.height, dataset.width
    os.makedirs(cache_dir, exist_ok=True)
    # build into a pid-suffixed temp file and publish via rename so a
    # concurrent writer can never truncate an array a reader already mapped
    frames_tmp = os.path.join(cache_dir, FRAMES_FILE + f".tmp.{os.getpid()}")
    arr = np.lib.format.open_memmap(
        frames_tmp, mode="w+", dtype=np.uint8,
        shape=(len(keys), h, w, 3))
    index = {}
    row = 0
    skipped = 0
    for folder, fi, side in keys:
        try:
            img = dataset.load_frame(folder, fi, side)
        except (FileNotFoundError, OSError):
            skipped += 1
            continue
        arr[row] = resize_lanczos(img, h, w, dataset.native)
        index[frame_key(folder, fi, side)] = row
        row += 1
        if log is not None and row % 500 == 0:
            log(f"frame cache: {row}/{len(keys)} decoded")
    arr.flush()
    del arr  # close the mmap before renaming
    os.replace(frames_tmp, os.path.join(cache_dir, FRAMES_FILE))
    meta = {"height": h, "width": w, "rows": row, "skipped": skipped,
            "dataset": type(dataset).__name__,
            "fingerprint": dataset_fingerprint(dataset), "index": index}
    # temp-file + rename: readers either see no index (cache "missing") or
    # a complete one — never a torn write from a concurrent writer
    tmp = os.path.join(cache_dir, INDEX_FILE + f".tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(cache_dir, INDEX_FILE))
    if log is not None:
        log(f"frame cache: {row} frames ({skipped} missing skipped) -> "
            f"{cache_dir}")
    return {"rows": row, "skipped": skipped}


class FrameCache:
    """Read side: mmap the frame array, resolve (folder, frame, side) keys."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        with open(os.path.join(cache_dir, INDEX_FILE)) as f:
            meta = json.load(f)
        self.height = int(meta["height"])
        self.width = int(meta["width"])
        self.fingerprint = meta.get("fingerprint")
        self.index = meta["index"]
        self.frames = np.load(os.path.join(cache_dir, FRAMES_FILE),
                              mmap_mode="r")

    # pickle by path, not by mmap contents: process-pool loader workers
    # re-open the mapping in their own address space
    def __getstate__(self):
        return {"cache_dir": self.cache_dir}

    def __setstate__(self, state):
        self.__init__(state["cache_dir"])

    def get(self, folder: str, frame_index: int,
            side: Optional[str]) -> Optional[np.ndarray]:
        row = self.index.get(frame_key(folder, frame_index, side))
        if row is None:
            return None
        return np.asarray(self.frames[row])  # one-copy materialize


def attach_frame_cache(dataset, cache_dir: str,
                       build_if_missing: bool = False):
    """Point a MonoDataset at a cache; its load_resized hook then serves
    cache hits from the mmap and falls back to disk on misses."""
    if build_if_missing and not os.path.isfile(
            os.path.join(cache_dir, INDEX_FILE)):
        build_frame_cache(dataset, cache_dir)
    cache = FrameCache(cache_dir)
    if (cache.height, cache.width) != (dataset.height, dataset.width):
        raise ValueError(
            f"frame cache is {cache.width}x{cache.height} but the dataset "
            f"feeds {dataset.width}x{dataset.height}; rebuild the cache")
    want = dataset_fingerprint(dataset)
    if cache.fingerprint is not None and cache.fingerprint != want:
        raise ValueError(
            f"frame cache at {cache_dir} was built from a different "
            f"data_path/split (fingerprint {cache.fingerprint} != {want}); "
            f"reusing it would serve stale pixels — rebuild the cache")
    dataset.frame_cache = cache
    return dataset
