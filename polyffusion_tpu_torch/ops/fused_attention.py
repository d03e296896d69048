"""Packed whole-sequence self-attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``polyffusion_tpu/ops/fused_attention.py``: the kernel
(``csrc/packed_attention.cu``) replaces ``_packed_kernel`` and the plain version
is ``_einsum_reference_packed``. Both take q, k, v as the attention projections
produce them, packed (B, T, H*D), and return the output in the same layout.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # the kernel's query and key tile: T must be a multiple of it
HEAD_DIMS = (64, 128)

_fwd = None  # the kernel's C entry point, with its argument types set once


def packed_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, n_heads: int
) -> torch.Tensor:
    """The plain version: fp32 logits and softmax, P cast to v's dtype, fp32
    accumulation of P V, output in q's dtype."""
    b, t, hd = q.shape
    d = hd // n_heads
    qh = q.reshape(b, t, n_heads, d).float()
    kh = k.reshape(b, k.shape[1], n_heads, d).float()
    vh = v.reshape(b, v.shape[1], n_heads, d)
    s = torch.einsum("bihd,bjhd->bhij", qh, kh)
    p = torch.softmax(s * scale, dim=-1)
    o = torch.einsum("bhij,bjhd->bihd", p.to(v.dtype).float(), vh.float())
    return o.reshape(b, t, hd).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, T, H*D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, hd = q.shape
    if hd % n_heads or hd // n_heads not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}/{n_heads} not in {HEAD_DIMS}")
    if t % TILE:
        raise ValueError(f"sequence length {t} is not a multiple of {TILE}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype must be float32 or bfloat16 for all of q, k, v, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def packed_self_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, n_heads: int
) -> torch.Tensor:
    """(B, T, H*D) packed self-attention, T % 64 == 0, D in {64, 128}.

    On a CUDA tensor this launches the kernel (and raises if it cannot); on a
    CPU tensor it runs ``packed_attention_reference``."""
    _check(q, k, v, n_heads)
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v, scale, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"packed_self_attention runs on cuda or cpu, not {q.device}")
    global _fwd
    if _fwd is None:
        from ._build import load

        fn = load("packed_attention").packed_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fwd = fn
    b, t, hd = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, t, n_heads, hd // n_heads, _DTYPE_CODES[q.dtype], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"packed_attention_fwd launch failed: cudaError {err}")
    packed_self_attention.launches += 1
    return out


packed_self_attention.launches = 0
