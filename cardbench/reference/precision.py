"""Arithmetic precision of the plain reference.

The reference computes in float32 with TF32 off. For the lower-precision
control it rounds the operands and the result of every convolution and matrix
product to a narrower type, and computes the product itself in float32:

- ``bf16``: round to bfloat16;
- ``fp8``: scale each tensor by its absolute maximum over 448 and round to
  float8 e4m3 (the scale undone after the rounding).

The rounding is straight-through (the forward value is rounded, the gradient
passes unchanged), so a training step can run under it.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

KINDS = ("fp32", "bf16", "fp8")
FP8_MAX = 448.0


def _rounded(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class Precision:
    """What a reference module rounds to (``kind``, one of ``KINDS``)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in KINDS:
            raise ValueError(f"precision must be one of {KINDS}, got {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32" or x is None:
            return x
        return x + (_rounded(x.detach(), self.kind) - x.detach())


@contextmanager
def strict_fp32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
