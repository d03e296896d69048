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

When a gradient will be taken in bf16, the packed forward also returns the
row log-sum-exp of the logits (``packed_attention_lse_reference``), and the
backward forms P from it instead of recomputing the row max and sum. The fp32
backward recomputes them, so an fp32 forward saves none.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import tracing

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


def packed_attention_lse_reference(
    q: torch.Tensor, k: torch.Tensor, scale: float, n_heads: int
) -> torch.Tensor:
    """The row log-sum-exp of the fp32 logits S * scale, (B, H, T) fp32: the
    forward's second output when a gradient will be taken."""
    b, t, hd = q.shape
    d = hd // n_heads
    qh = q.reshape(b, t, n_heads, d).float()
    kh = k.reshape(b, k.shape[1], n_heads, d).float()
    return torch.logsumexp(torch.einsum("bihd,bjhd->bhij", qh, kh) * scale, dim=-1)


def packed_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, scale: float,
    n_heads: int, lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward, ``_packed_bwd_kernel``'s arithmetic: P recomputed in
    fp32 and rounded to the input dtype (Pc) after its normalisation; dV = Pc^T
    dO, dP = dO V^T, dS = Pc (dP - rowsum(dP Pc)) scale rounded to the input
    dtype, dQ = dS K, dK = dS^T Q, all accumulated in fp32. Given the forward's
    ``lse`` (B, H, T), P is exp(S scale - lse), the backward kernel's form;
    without it, P is normalised by its own row max and sum."""
    b, t, hd = q.shape
    d = hd // n_heads
    qh, kh, vh, doh = (x.reshape(b, x.shape[1], n_heads, d).float() for x in (q, k, v, do))
    s = torch.einsum("bihd,bjhd->bhij", qh, kh) * scale
    if lse is None:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
    else:
        p = torch.exp(s - lse[..., None])
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


def _forward(q, k, v, scale: float, n_heads: int, with_lse: bool = False, *,
             count: bool = True):
    """(out, lse): the forward kernel on a CUDA tensor, its plain version on a
    CPU tensor; lse (B, H, T) fp32 only ``with_lse`` (bf16 inputs only), else
    None. ``count``: whether the launch adds to the forward's count."""
    b, t, hd = q.shape
    if with_lse and q.dtype != torch.bfloat16:
        raise ValueError(f"the forward writes lse for bfloat16 only, not {q.dtype}")
    if q.device.type == "cpu":
        lse = packed_attention_lse_reference(q, k, scale, n_heads) if with_lse else None
        return packed_attention_reference(q, k, v, scale, n_heads), lse
    fn = _kernel("packed_attention", "packed_attention_fwd",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty_like(q)
    lse = (torch.empty(b, n_heads, t, dtype=torch.float32, device=q.device) if with_lse
           else None)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, t, n_heads, hd // n_heads,
                 _DTYPE_CODES[q.dtype], float(scale), _stream(q))
    if err != 0:
        raise RuntimeError(f"packed_attention_fwd launch failed: cudaError {err}")
    if count:
        packed_self_attention.launches += 1
    return out, lse


def _check_lse(lse: torch.Tensor, q: torch.Tensor, n_heads: int) -> None:
    b, t, _ = q.shape
    if lse.shape != (b, n_heads, t) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 of shape {(b, n_heads, t)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if lse.device != q.device:
        raise ValueError(f"lse lies on {lse.device}, q on {q.device}")
    if not lse.is_contiguous() or lse.data_ptr() % 16:
        raise ValueError("lse must be contiguous and 16-byte aligned")


def packed_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, scale: float,
    n_heads: int, *, lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of packed self-attention for the output gradient ``do``.

    ``lse``: the forward's row log-sum-exp (B, H, T) fp32. On a CUDA tensor
    this launches the backward kernel (and raises if it cannot); given no
    ``lse`` there, it first computes it with the forward kernel (not counted as
    a forward launch). The bf16 kernel forms P from ``lse``; the fp32 kernel
    recomputes its row statistics and reads none. On a CPU tensor it runs
    ``packed_attention_bwd_reference`` (with ``lse`` where given)."""
    _check(q, k, v, do, n_heads=n_heads)
    if lse is not None:
        _check_lse(lse, q, n_heads)
    if q.device.type == "cpu":
        return packed_attention_bwd_reference(q, k, v, do, scale, n_heads, lse)
    fn = _kernel("packed_attention_bwd", "packed_attention_bwd",
                 [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    b, t, hd = q.shape
    if q.dtype == torch.bfloat16:
        if lse is None:
            lse = _forward(q, k, v, scale, n_heads, True, count=False)[1]
        scratch = torch.empty(b, n_heads, t, dtype=torch.float32, device=q.device)  # dsum
    else:
        scratch = torch.empty(b, n_heads, t, 3, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 None if lse is None else lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), scratch.data_ptr(), b, t, n_heads, hd // n_heads,
                 _DTYPE_CODES[q.dtype], float(scale), _stream(q))
    if err != 0:
        raise RuntimeError(f"packed_attention_bwd launch failed: cudaError {err}")
    packed_attention_bwd.launches += 1
    return dq, dk, dv


packed_attention_bwd.launches = 0
tracing.register("ops.packed_attention_bwd.launches", packed_attention_bwd, "launches")


class _PackedAttention(torch.autograd.Function):
    """Forward kernel with the backward kernel as its gradient (the JAX
    package's ``_fused_packed`` custom VJP); q, k, v and the forward's row
    log-sum-exp are kept for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, n_heads, with_lse):
        out, lse = _forward(q, k, v, scale, n_heads, with_lse)
        ctx.save_for_backward(q, k, v, lse)
        ctx.scale, ctx.n_heads = scale, n_heads
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        # autograd's incoming gradient need not be contiguous
        dq, dk, dv = packed_attention_bwd(q, k, v, do.contiguous(), ctx.scale, ctx.n_heads,
                                          lse=lse)
        return dq, dk, dv, None, None, None


def packed_self_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, n_heads: int
) -> torch.Tensor:
    """(B, T, H*D) packed self-attention, T % 64 == 0, D in {64, 128};
    differentiable, with ``packed_attention_bwd`` as its backward. The forward
    writes the row log-sum-exp only when a gradient will be taken in bf16.

    On a CUDA tensor this launches the kernels (and raises if it cannot); on a
    CPU tensor it runs their plain versions."""
    _check(q, k, v, n_heads=n_heads)
    with_lse = (q.dtype == torch.bfloat16 and torch.is_grad_enabled()
                and any(x.requires_grad for x in (q, k, v)))
    return _PackedAttention.apply(q, k, v, scale, n_heads, with_lse)


packed_self_attention.launches = 0
tracing.register("ops.packed_self_attention.launches", packed_self_attention, "launches")


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
tracing.register("ops.fused_self_attention.launches", fused_self_attention, "launches")
