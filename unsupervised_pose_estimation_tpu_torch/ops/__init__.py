"""Tensor ops of the port: camera geometry, resizing, warping, losses, and
the CUDA kernels (``ops.kernels``) with their plain PyTorch versions."""
