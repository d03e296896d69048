"""The RePaint step epilogue: the CUDA kernel's wrapper and its plain version.

Counterpart of ``polyffusion_tpu/ops/pallas_sampler.py``: the kernel
(``csrc/repaint_epilogue.cu``) replaces ``_epilogue_kernel`` and
``fused_repaint_epilogue`` keeps its argument order; the plain version is
``repaint_epilogue_reference``, the same name. In one fp32 pass over six
same-shape tensors, with seven scalars a..g::

    x0    = a * x - b * eps
    x_unk = c * x0 + d * x + e * p_noise
    x_kn  = f * orig + g * q_noise
    out   = x_kn * mask + x_unk * (1 - mask)

The JAX package keeps the kernel opt-in, because XLA fuses the chain by
itself; eager PyTorch fuses nothing, so on a CUDA tensor every step of
``diffusion/sampler.py:ddpm_paint``'s masked body is the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

_entry = []  # the C entry point, with its argument types set once


def repaint_epilogue_reference(x, eps, p_noise, orig, q_noise, mask, scalars: Sequence[float]):
    """The plain composition the kernel must match (the sampler's default
    path in the JAX package)."""
    a, b, c, d, e, f, g = (float(s) for s in scalars)
    x0 = a * x - b * eps
    x_unknown = c * x0 + d * x + e * p_noise
    x_known = f * orig + g * q_noise
    return x_known * mask + x_unknown * (1.0 - mask)


def _check(tensors, scalars) -> None:
    names = ("x", "eps", "p_noise", "orig", "q_noise", "mask")
    x = tensors[0]
    if any(t.shape != x.shape for t in tensors):
        raise ValueError("the six tensors must share one shape, got "
                         + ", ".join(f"{n} {tuple(t.shape)}" for n, t in zip(names, tensors)))
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("the six tensors must be float32, got "
                         + ", ".join(f"{n} {t.dtype}" for n, t in zip(names, tensors)))
    if any(t.device != x.device for t in tensors):
        raise ValueError("the six tensors must lie on one device")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_repaint_epilogue runs on cuda or cpu, not {x.device}")
    if len(scalars) != 7:
        raise ValueError(f"expected 7 scalars a..g, got {len(scalars)}")
    if x.device.type == "cuda":
        if x.numel() % 4:
            raise ValueError(f"{x.numel()} elements: the kernel takes a multiple of 4")
        for n, t in zip(names, tensors):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{n} must be contiguous and 16-byte aligned")


def fused_repaint_epilogue(
    x: torch.Tensor,
    eps: torch.Tensor,
    p_noise: torch.Tensor,
    orig: torch.Tensor,
    q_noise: torch.Tensor,
    mask: torch.Tensor,
    scalars: Sequence[float],
) -> torch.Tensor:
    """The RePaint update over six fp32 tensors of one shape (any layout, the
    same for all six) and the scalars a..g as host floats.

    On a CUDA tensor this launches the kernel (and raises if it cannot); on a
    CPU tensor it runs ``repaint_epilogue_reference``."""
    tensors = (x, eps, p_noise, orig, q_noise, mask)
    _check(tensors, scalars)
    if x.device.type == "cpu":
        return repaint_epilogue_reference(*tensors, scalars)
    if not _entry:
        from ._build import load

        fn = load("repaint_epilogue").repaint_epilogue
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_float] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entry.append(fn)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _entry[0](*(t.data_ptr() for t in tensors), out.data_ptr(), x.numel(),
                        *(float(s) for s in scalars),
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"repaint_epilogue launch failed: cudaError {err}")
    fused_repaint_epilogue.launches += 1
    return out


fused_repaint_epilogue.launches = 0
