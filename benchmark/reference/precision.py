"""The arithmetic the reference runs its networks' convolutions in.

- ``float32``: float32 with TF32 off (the reference as it stands).
- ``tf32``: the control of a float32 configuration. On a CUDA device the
  convolutions and matmuls run with TF32 on (cuDNN's and cuBLAS's switch);
  on the CPU, which has no TF32, each convolution's input and weight are
  rounded to TF32's 10-bit mantissa first, which is what the tensor cores
  do with them.
- ``fp8``: the control of a bfloat16 configuration. Each convolution's
  input and weight are scaled per tensor into float8 e4m3's range (largest
  magnitude to 448), rounded to e4m3 and scaled back; the product is then
  accumulated in float32, as an fp8 tensor-core GEMM does. The gradient
  passes the rounding unchanged (straight through).
- ``bfloat16``: a witness for a bfloat16 configuration, not a control:
  each convolution's input, weight and result are rounded to bfloat16,
  and so are the gradients that pass them, with float32 accumulation, as
  autocast's bfloat16 convolutions compute.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

KINDS = ("float32", "tf32", "fp8", "bfloat16")
E4M3_MAX = 448.0


def _round_tf32(t):
    """Round float32 ``t`` to 10 mantissa bits (nearest, ties to even)."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(t):
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _straight_through(t, rounded):
    return t + (rounded - t).detach()


class _RoundBF16(torch.autograd.Function):
    """Round to bfloat16 going forward and the gradient going back."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16).to(grad.dtype)


class Precision:
    """Convolutions at one of ``KINDS``; ``scope()`` sets the backend
    switches while the reference runs and restores them after."""

    def __init__(self, kind: str = "float32"):
        if kind not in KINDS:
            raise ValueError(f"precision must be one of {KINDS}, got {kind!r}")
        self.kind = kind

    def _operand(self, t):
        if self.kind == "bfloat16":
            return _RoundBF16.apply(t)
        if self.kind == "fp8":
            return _straight_through(t, _round_fp8(t))
        if self.kind == "tf32" and t.device.type != "cuda":
            return _straight_through(t, _round_tf32(t))
        return t

    def conv(self, x, w, b=None, stride=1, padding=0):
        return self._result(F.conv2d(self._operand(x), self._operand(w), b,
                                     stride, padding))

    def deconv(self, x, w, b, stride, padding, output_padding):
        return self._result(F.conv_transpose2d(
            self._operand(x), self._operand(w), b, stride, padding,
            output_padding))

    def _result(self, y):
        return _RoundBF16.apply(y) if self.kind == "bfloat16" else y

    @contextlib.contextmanager
    def scope(self):
        before = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
        on = self.kind == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = before
