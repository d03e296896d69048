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


_NAMES = ("x", "eps", "p_noise", "orig", "q_noise", "mask")


def _check(tensors, scalars):
    """Raises ``ValueError`` on what the wrapper does not take; returns the six
    tensors' addresses on a CUDA device. One pass over the tensors: a
    host-bound sampler pays for these checks once per step."""
    x = tensors[0]
    shape, device = x.shape, x.device
    ptrs = []
    for t in tensors:
        if t.shape != shape:
            raise ValueError("the six tensors must share one shape, got " + ", ".join(
                f"{n} {tuple(u.shape)}" for n, u in zip(_NAMES, tensors)))
        if t.dtype is not torch.float32:
            raise ValueError("the six tensors must be float32, got " + ", ".join(
                f"{n} {u.dtype}" for n, u in zip(_NAMES, tensors)))
        if t.device != device:
            raise ValueError("the six tensors must lie on one device")
        if device.type == "cuda":
            ptrs.append(t.data_ptr())
            if ptrs[-1] % 16 or not t.is_contiguous():
                raise ValueError(f"{_NAMES[len(ptrs) - 1]} must be contiguous and 16-byte aligned")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_repaint_epilogue runs on cuda or cpu, not {device}")
    if len(scalars) != 7:
        raise ValueError(f"expected 7 scalars a..g, got {len(scalars)}")
    if device.type == "cuda" and x.numel() % 4:
        raise ValueError(f"{x.numel()} elements: the kernel takes a multiple of 4")
    return ptrs


def _launch_entry():
    """The C entry point with its argument types set."""
    from ._build import load

    fn = load("repaint_epilogue").repaint_epilogue
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_float] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _entry.append(fn)
    return fn


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
    CPU tensor it runs ``repaint_epilogue_reference``. The kernel may start
    while the kernel before it on the stream finishes (programmatic dependent
    launch); it reads its inputs only once that one is complete."""
    tensors = (x, eps, p_noise, orig, q_noise, mask)
    ptrs = _check(tensors, scalars)
    if not x.is_cuda:
        return repaint_epilogue_reference(*tensors, scalars)
    fn = _entry[0] if _entry else _launch_entry()
    out = torch.empty_like(x)
    dev = x.get_device()
    with torch.cuda.device(dev):  # the raw stream handle: a Stream object costs host time
        stream = torch._C._cuda_getCurrentRawStream(dev)
        err = fn(*ptrs, out.data_ptr(), x.numel(), *scalars, stream)
    if err != 0:
        raise RuntimeError(f"repaint_epilogue launch failed: cudaError {err}")
    fused_repaint_epilogue.launches += 1
    return out


fused_repaint_epilogue.launches = 0
