"""Hand-written CUDA kernels of the port, each with its plain PyTorch twin.

A wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors; it never falls back from one to the other. ``_lib`` builds the
kernels (one nvcc call, loaded through ctypes) and counts launches.

| wrapper                          | kernel              | replaces (TPU)           |
| -------------------------------- | ------------------- | ------------------------ |
| warp_loss.warp_reproj_loss  (K1) | csrc/warp_loss.cu   | warp_loss.py v9          |
| reproj_loss.reproj_loss     (K3) | csrc/reproj_loss.cu | reproj_loss.py _kernel   |
| warp.warp                   (K5) | csrc/warp.cu        | warp_kernel.py v8 + rungs|
"""

from ._lib import counts, reset_counts  # noqa: F401
from .reproj_loss import reproj_loss, reproj_loss_plain  # noqa: F401
from .warp import warp, warp_plain  # noqa: F401
from .warp_loss import warp_reproj_loss, warp_reproj_loss_plain  # noqa: F401
