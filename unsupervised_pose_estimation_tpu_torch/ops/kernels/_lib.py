"""Build, load and count the CUDA kernels of ``csrc/``.

One ``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a``, and the host
routines of ``csrc/*.cpp`` (the image codec's native route), into a shared
library with a plain C interface; ``ctypes`` loads it. Nothing includes
PyTorch's headers, so the build takes seconds. The library goes into
``_build/`` beside the package (listed in ``.gitignore``), named by a hash
of the sources and flags: it is built at first use and rebuilt only when a
source changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -fmad=false: no multiply-add contraction, so each kernel rounds like the
# plain PyTorch version it is checked against (see csrc/common.cuh).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "upe_warp": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "upe_reproj_loss": [_P, _P, _P, _I, _I, _I, _I, _P],
    "upe_warp_reproj_loss": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "upe_warp_reproj_loss_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "upe_reproj_loss_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "upe_fetch_corners": [_P] * 8 + [_I] * 7 + [_P],
    "upe_fetch_corners_packed": [_P] * 8 + [_I] * 7 + [_P],
}
# The host routines of csrc/image_host.cpp (data.png, data.resample).
HOST_SIGNATURES = {
    "upe_png_unfilter": [_P, _I, _I, _I, _P],
    "upe_resample_horizontal_u8": [_P, _I, _I, _I, _I, _P, _I, _P, _P, _I],
    "upe_resample_vertical_u8": [_P, _I, _I, _P, _I, _P, _P, _I, _P],
}

# Launches per kernel since the last reset_counts(); a wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES = {"warp_reproj_loss": 0, "reproj_loss": 0, "warp": 0,
            "warp_reproj_loss_bwd": 0, "reproj_loss_bwd": 0,
            "fetch_corners": 0, "fetch_corners_packed": 0,
            "fetch_corners_packed_v7": 0}
# Calls of the warp ladder (ops.kernels.warp.sample) since the last
# reset_counts(), by the rung that ran: the kernel of a version's top rung,
# one beneath it, or the plain gather at the bottom.
RUNGS = {"v1": 0, "v2": 0, "v3": 0, "v4": 0, "v5": 0, "v6": 0, "v7": 0,
         "v3_wide": 0, "v8": 0, "gather": 0}
# Calls of the host routines since the last reset_counts().
HOST_CALLS = {"png_unfilter": 0, "resample_horizontal_u8": 0,
              "resample_vertical_u8": 0}

_lock = threading.Lock()
_lib = None
build_log = ""      # nvcc's output of the build this process ran, if any
build_seconds = 0.0


def _compiled():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cpp"))


def _sources():
    return _compiled() + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA "
            "kernels are built on a machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libupe_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the current sources' build exists."""
    global build_log, build_seconds
    out = library_path()
    if out.is_file():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus = [str(s) for s in _compiled()]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        start = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *cus],
                              capture_output=True, text=True)
        build_seconds = time.perf_counter() - start
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            declare(lib, {**SIGNATURES, **HOST_SIGNATURES})
            lib.upe_error_string.argtypes = [ctypes.c_int]
            lib.upe_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def declare(lib: ctypes.CDLL, signatures: dict) -> None:
    """Set the argument types and the int return type of ``lib``'s
    functions named in ``signatures``."""
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def native_route(device) -> bool:
    """Whether an entry point on ``device`` runs the image codec's native
    host routines (a CUDA device: the library is built with the kernels, or
    the call raises) or their numpy versions (the CPU)."""
    return torch.device(device).type == "cuda"


def counts() -> dict:
    with _lock:
        return dict(LAUNCHES)


def rung_counts() -> dict:
    with _lock:
        return dict(RUNGS)


def host_counts() -> dict:
    with _lock:
        return dict(HOST_CALLS)


def reset_counts() -> None:
    """Zero the launch counts, the rung counts and the host routines'
    call counts."""
    with _lock:
        for table in (LAUNCHES, RUNGS, HOST_CALLS):
            for name in table:
                table[name] = 0


def count_rung(name: str) -> None:
    with _lock:
        RUNGS[name] += 1


def launch(name: str, fn: str, *args) -> None:
    """Call launcher ``fn`` of the library, raise if it returns a CUDA error
    (a refused launch never runs), else count one launch of ``name``."""
    lib = library()
    code = getattr(lib, fn)(*args)
    if code != 0:
        msg = lib.upe_error_string(code).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {code} ({msg})")
    with _lock:
        LAUNCHES[name] += 1


def call_host(name: str, fn: str, *args) -> int:
    """Call host routine ``fn`` of the library, count one call of ``name``
    and return its code (0: done; the caller raises on any other)."""
    code = getattr(library(), fn)(*args)
    with _lock:
        HOST_CALLS[name] += 1
    return code


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_channels(name: str, c: int) -> None:
    """The CUDA kernels that hold the channels in template instances (K1-K4,
    K7, K8) take 1-4 channels."""
    if not 1 <= c <= 4:
        raise ValueError(f"{name}: the CUDA kernel takes 1-4 channels, got "
                         f"{c}")


def on_cuda(name: str, *tensors) -> bool:
    """True if every tensor is on one CUDA device, False if every one is on
    the CPU; raises on a mix, on non-contiguous inputs and on inputs that
    require grad while grad mode is on: gradients go through the
    ``torch.autograd.Function`` of each op (``*_op``), whose forward runs
    with grad mode off."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the kernel wrapper records no gradient; differentiate "
            "through the op's autograd Function (ops.kernels.*_op), or call "
            "it under torch.no_grad()")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return True
