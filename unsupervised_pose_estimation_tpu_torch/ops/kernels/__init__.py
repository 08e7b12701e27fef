"""Hand-written CUDA kernels of the port, each with its plain PyTorch twin.

A wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors; it never falls back from one to the other, and it records no
gradient. The ``*_op`` functions are the differentiable ops: a
``torch.autograd.Function`` whose forward and backward call the wrappers.
``_lib`` builds the kernels (one nvcc call, loaded through ctypes) and
counts launches.

| wrapper                              | kernel                  | replaces (TPU)             |
| ------------------------------------ | ----------------------- | -------------------------- |
| warp_loss.warp_reproj_loss      (K1) | csrc/warp_loss.cu       | warp_loss.py v9            |
| warp_loss.warp_reproj_loss_bwd  (K2) | csrc/warp_loss_bwd.cu   | warp_loss.py _bwd_kernel   |
| reproj_loss.reproj_loss         (K3) | csrc/reproj_loss.cu     | reproj_loss.py _kernel     |
| reproj_loss.reproj_loss_bwd     (K4) | csrc/reproj_loss_bwd.cu | reproj_loss.py _bwd_kernel |
| warp.warp                       (K5) | csrc/warp.cu            | warp_kernel.py v8 + rungs  |
"""

from ._lib import counts, reset_counts  # noqa: F401
from .reproj_loss import (reproj_loss, reproj_loss_bwd,  # noqa: F401
                          reproj_loss_bwd_plain, reproj_loss_op,
                          reproj_loss_plain)
from .warp import warp, warp_op, warp_plain  # noqa: F401
from .warp_loss import (warp_reproj_loss, warp_reproj_loss_bwd,  # noqa: F401
                        warp_reproj_loss_bwd_plain, warp_reproj_loss_op,
                        warp_reproj_loss_plain)
