"""Hand-written CUDA kernels of the port, each with its plain PyTorch twin.

A wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors; it never falls back from one to the other, and it records no
gradient. The ``*_op`` functions and ``grid_sample_fast`` are the
differentiable ops: a ``torch.autograd.Function`` whose forward and
backward call the wrappers. ``grid_sample_fast`` runs the warp ladder of
``pallas_warp_version`` (``warp.py``). ``_lib`` builds the kernels (one
nvcc call, loaded through ctypes) and counts launches and ladder rungs.

| wrapper                              | kernel                  | replaces (TPU)             |
| ------------------------------------ | ----------------------- | -------------------------- |
| warp_loss.warp_reproj_loss      (K1) | csrc/warp_loss.cu       | warp_loss.py v9            |
| warp_loss.warp_reproj_loss_bwd  (K2) | csrc/warp_loss_bwd.cu   | warp_loss.py _bwd_kernel   |
| reproj_loss.reproj_loss         (K3) | csrc/reproj_loss.cu     | reproj_loss.py _kernel     |
| reproj_loss.reproj_loss_bwd     (K4) | csrc/reproj_loss_bwd.cu | reproj_loss.py _bwd_kernel |
| warp.warp                       (K5) | csrc/warp.cu            | warp_kernel.py v8 + rungs  |
| corners.fetch_corners           (K6) | csrc/corners.cu         | warp_kernel.py v1-v5       |
| corners.fetch_corners_packed    (K7) | csrc/corners.cu         | warp_kernel.py v6          |
| corners.fetch_corners_packed_v7 (K8) | csrc/corners.cu         | warp_kernel.py v7          |
"""

from ._lib import counts, reset_counts, rung_counts  # noqa: F401
from .corners import (fetch_corners, fetch_corners_packed,  # noqa: F401
                      fetch_corners_packed_plain, fetch_corners_packed_v7,
                      fetch_corners_packed_v7_plain, fetch_corners_plain)
from .reproj_loss import (reproj_loss, reproj_loss_bwd,  # noqa: F401
                          reproj_loss_bwd_plain, reproj_loss_op,
                          reproj_loss_plain)
from .warp import (grid_sample_fast, warp, warp_op,  # noqa: F401
                   warp_plain)
from .warp_loss import (warp_reproj_loss, warp_reproj_loss_bwd,  # noqa: F401
                        warp_reproj_loss_bwd_plain, warp_reproj_loss_op,
                        warp_reproj_loss_plain)
