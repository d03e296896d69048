"""Whole-sequence self-attention: the CUDA kernels' wrappers, their plain
PyTorch versions, and the autograd functions that join them.

Counterpart of ``polyffusion_tpu/ops/fused_attention.py``. Packed (B, T, H*D),
as the attention projections produce it: the forward kernel
(``csrc/packed_attention.cu``) replaces ``_packed_kernel`` and its plain version
is ``_einsum_reference_packed``; the backward kernel
(``csrc/packed_attention_bwd.cu``) replaces ``_packed_bwd_kernel`` and its plain
version is that kernel's arithmetic in torch; ``packed_self_attention`` is the
custom VJP ``_fused_packed``. Head-major (BH, T, D): ``fused_self_attention``
is the custom VJP ``_fused``, whose forward kernel (the packed kernel's bodies
with one head and a ragged tail, ``head_major_attention_fwd`` in the same
source) replaces ``_attn_kernel``, and whose backward differentiates the plain
version ``head_major_attention_reference`` (``_einsum_reference``), as JAX's
does. No model path calls the head-major op: the UNet's attention goes
through ``ops/attention.py`` to the packed kernels, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # the kernels' query and key tile: T must be a multiple of it
HEAD_DIMS = (64, 128)

_entry = {}  # C entry points by name, with their argument types set once


def _kernel(source: str, name: str, argtypes):
    """The C function ``name`` of ``csrc/<source>.cu``, built and loaded."""
    if name not in _entry:
        from ._build import load

        fn = getattr(load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entry[name] = fn
    return _entry[name]


def packed_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, n_heads: int
) -> torch.Tensor:
    """The plain forward: fp32 logits and softmax, P cast to v's dtype, fp32
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


def packed_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, scale: float, n_heads: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward, ``_packed_bwd_kernel``'s arithmetic: P recomputed in
    fp32 and rounded to the input dtype (Pc) after its normalisation; dV = Pc^T
    dO, dP = dO V^T, dS = Pc (dP - rowsum(dP Pc)) scale rounded to the input
    dtype, dQ = dS K, dK = dS^T Q, all accumulated in fp32."""
    b, t, hd = q.shape
    d = hd // n_heads
    qh, kh, vh, doh = (x.reshape(b, x.shape[1], n_heads, d).float() for x in (q, k, v, do))
    s = torch.einsum("bihd,bjhd->bhij", qh, kh) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    pc = p.to(q.dtype).float()
    dv = torch.einsum("bhij,bihd->bjhd", pc, doh)
    dp = torch.einsum("bihd,bjhd->bhij", doh, vh)
    dsum = (dp * pc).sum(dim=-1, keepdim=True)
    ds = (pc * (dp - dsum) * scale).to(q.dtype).float()
    dq = torch.einsum("bhij,bjhd->bihd", ds, kh)
    dk = torch.einsum("bhij,bihd->bjhd", ds, qh)
    return tuple(x.reshape(b, x.shape[1], hd).to(q.dtype) for x in (dq, dk, dv))


def _check(*xs: torch.Tensor, n_heads: int) -> None:
    q = xs[0]
    if q.dim() != 3 or any(x.shape != q.shape for x in xs):
        raise ValueError(f"q, k, v must share one (B, T, H*D) shape, got "
                         f"{', '.join(str(tuple(x.shape)) for x in xs)}")
    b, t, hd = q.shape
    if hd % n_heads or hd // n_heads not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}/{n_heads} not in {HEAD_DIMS}")
    if t % TILE:
        raise ValueError(f"sequence length {t} is not a multiple of {TILE}")
    if any(x.dtype != q.dtype for x in xs) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype must be float32 or bfloat16 for all of q, k, v, "
                         f"got {', '.join(str(x.dtype) for x in xs)}")
    if any(x.device != q.device for x in xs):
        raise ValueError("q, k, v must lie on one device")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"packed attention runs on cuda or cpu, not {q.device}")
    for name, x in zip(("q", "k", "v", "dO"), xs):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _forward(q, k, v, scale: float, n_heads: int) -> torch.Tensor:
    """The forward kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v, scale, n_heads)
    fn = _kernel("packed_attention", "packed_attention_fwd",
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    b, t, hd = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, t, n_heads, hd // n_heads, _DTYPE_CODES[q.dtype], float(scale), _stream(q))
    if err != 0:
        raise RuntimeError(f"packed_attention_fwd launch failed: cudaError {err}")
    packed_self_attention.launches += 1
    return out


def packed_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, scale: float, n_heads: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of packed self-attention for the output gradient ``do``.

    On a CUDA tensor this launches the backward kernel (and raises if it
    cannot); on a CPU tensor it runs ``packed_attention_bwd_reference``."""
    _check(q, k, v, do, n_heads=n_heads)
    if q.device.type == "cpu":
        return packed_attention_bwd_reference(q, k, v, do, scale, n_heads)
    fn = _kernel("packed_attention_bwd", "packed_attention_bwd",
                 [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    b, t, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(b, n_heads, t, 3, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, t, n_heads, hd // n_heads,
                 _DTYPE_CODES[q.dtype], float(scale), _stream(q))
    if err != 0:
        raise RuntimeError(f"packed_attention_bwd launch failed: cudaError {err}")
    packed_attention_bwd.launches += 1
    return dq, dk, dv


packed_attention_bwd.launches = 0


class _PackedAttention(torch.autograd.Function):
    """Forward kernel with the backward kernel as its gradient (the JAX
    package's ``_fused_packed`` custom VJP); q, k, v are kept for the backward,
    which recomputes the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, scale, n_heads):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.n_heads = scale, n_heads
        return _forward(q, k, v, scale, n_heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        # autograd's incoming gradient need not be contiguous
        dq, dk, dv = packed_attention_bwd(q, k, v, do.contiguous(), ctx.scale, ctx.n_heads)
        return dq, dk, dv, None, None


def packed_self_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, n_heads: int
) -> torch.Tensor:
    """(B, T, H*D) packed self-attention, T % 64 == 0, D in {64, 128};
    differentiable, with ``packed_attention_bwd`` as its backward.

    On a CUDA tensor this launches the kernels (and raises if it cannot); on a
    CPU tensor it runs their plain versions."""
    _check(q, k, v, n_heads=n_heads)
    return _PackedAttention.apply(q, k, v, scale, n_heads)


packed_self_attention.launches = 0


# -- head-major (BH, T, D) -------------------------------------------------------

MAX_BH = 65535  # the kernel's grid puts BH on gridDim.z


def head_major_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """The plain (BH, T, D) forward (JAX's ``_einsum_reference``): fp32
    logits and softmax, P cast to v's dtype after its normalisation, fp32
    accumulation of P V, output in q's dtype."""
    s = torch.einsum("bid,bjd->bij", q.float(), k.float())
    p = torch.softmax(s * scale, dim=-1)
    return torch.einsum("bij,bjd->bid", p.to(v.dtype).float(), v.float()).to(q.dtype)


def _check_head_major(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (BH, T, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if t < 1 or bh < 1:
        raise ValueError(f"empty attention: BH {bh}, T {t}")
    if bh > MAX_BH:
        raise ValueError(f"BH {bh} exceeds {MAX_BH}, the kernel grid's bound")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype must be float32 or bfloat16 for all of q, k, v, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"head-major attention runs on cuda or cpu, not {q.device}")
    for name, x in zip("qkv", (q, k, v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _head_major_forward(q, k, v, scale: float) -> torch.Tensor:
    """The head-major kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return head_major_attention_reference(q, k, v, scale)
    fn = _kernel("packed_attention", "head_major_attention_fwd",
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    bh, t, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, t, d,
                 _DTYPE_CODES[q.dtype], float(scale), _stream(q))
    if err != 0:
        raise RuntimeError(f"head_major_attention_fwd launch failed: cudaError {err}")
    fused_self_attention.launches += 1
    return out


class _HeadMajorAttention(torch.autograd.Function):
    """The head-major kernel forward; the backward recomputes through the
    plain version under autograd (JAX's ``_fused_bwd``: no backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _head_major_forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = head_major_attention_reference(q, k, v, ctx.scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
        return dq, dk, dv, None


def fused_self_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, *, block_bh: int = 0
) -> torch.Tensor:
    """(BH, T, D) x (BH, T, D) -> (BH, T, D) whole-sequence attention, any
    T >= 1, D in {64, 128}, fp32 or bf16, BH <= 65535; differentiable.

    On a CUDA tensor the forward launches the head-major kernel (and raises if
    it cannot); on a CPU tensor it runs ``head_major_attention_reference``. The
    backward differentiates that plain version on either device.

    ``block_bh`` is JAX's (batch*head) pairs per TPU grid step: it shapes the
    TPU's grid only and cannot change the result, so it is checked (a
    non-negative int) and otherwise unused."""
    if isinstance(block_bh, bool) or not isinstance(block_bh, int) or block_bh < 0:
        raise ValueError(f"block_bh must be a non-negative int, got {block_bh!r}")
    _check_head_major(q, k, v)
    return _HeadMajorAttention.apply(q, k, v, scale)


fused_self_attention.launches = 0
