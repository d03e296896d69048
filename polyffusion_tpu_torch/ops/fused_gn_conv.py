"""Fused GroupNorm-affine + SiLU + 3x3 convolution: the CUDA kernels' wrappers,
their plain PyTorch versions, and the autograd function around them.

Counterpart of ``polyffusion_tpu/ops/fused_gn_conv.py``, over NCHW tensors
and the port's (O, C, 3, 3) weights::

    out = conv3x3(SiLU(x * a + off), w) + b (+ residual)

with a and off the fp32 per-(batch, channel) GroupNorm affine
(``ops/gn_bwd.py:gn_affine``), stride 1, padding 1, the output in x's dtype.
The ``_concat`` forms take two inputs and convolve their channel concat, which
exists only inside the kernel (the decoder's skip concat). Kernel 4
(``csrc/gn_silu_conv.cu``, fp32 and bf16) replaces the TPU kernel
``_kernel``; its plain version ``gn_silu_conv3x3_reference`` is
``_reference`` / ``_reference2``. Kernel 5 (the same source, int8 operands)
replaces ``_kernel`` with ``quantized=True``; its plain version
``gn_silu_conv3x3_q_reference`` is ``_reference_q``.

On a CUDA tensor each function launches its kernel or raises; on a CPU tensor
it runs the plain version. The bf16/fp32 functions are differentiable: the
backward recomputes through the plain version, as JAX's custom VJP does. The
int8 functions are for sampling only: their backward raises.

The kernels read the weights packed tap-major, (9, O, L), each input's
channels 16-aligned (``packed_weight``); the packed copy is made once per
weight and version and kept beside it, so a sampling loop packs each weight
once and a train step once per optimizer update.

Launch counts: ``gn_silu_conv3x3.launches`` counts kernel 4's launches and
``gn_silu_conv3x3_q.launches`` kernel 5's convolutions, one- and two-input
alike (``.two_input_launches`` the two-input ones); kernel 5's amax pass
(``gn_silu_amax``), a launch of its own before each convolution, counts in
``gn_silu_amax.launches``.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .quant import quantize_weight

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_entry = {}  # C entry points by name, with their argument types set once
_PART_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2


def _kernel(name: str, argtypes):
    if name not in _entry:
        from ._build import load

        fn = getattr(load("gn_silu_conv"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entry[name] = fn
    return _entry[name]


# -- plain versions -------------------------------------------------------------


def _silu_affine32(x: torch.Tensor, a: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """SiLU(x * a + off) in fp32, as y * (1 / (1 + exp(-y))) (the kernel's
    arithmetic; torch.sigmoid computes the same on the card)."""
    y = x.float() * a[:, :, None, None] + off[:, :, None, None]
    return y * torch.sigmoid(y)


def gn_silu_conv3x3_reference(
    x, a, off, w, b, residual=None, x2=None, a2=None, off2=None
) -> torch.Tensor:
    """The plain version of kernel 4 (``_reference`` / ``_reference2``): the
    SiLU output rounded to x's dtype, convolved in fp32 with w rounded to x's
    dtype, the bias and the residual added in fp32, one cast at the end."""
    y = _silu_affine32(x, a, off).to(x.dtype)
    if x2 is not None:
        y = torch.cat([y, _silu_affine32(x2, a2, off2).to(x.dtype)], dim=1)
    out = F.conv2d(y.float(), w.to(x.dtype).float(), padding=1) + b.float()[:, None, None]
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def gn_silu_conv3x3_q_reference(
    x, a, off, w_q, w_scale, b, residual=None, x2=None, a2=None, off2=None
) -> torch.Tensor:
    """The plain version of kernel 5 (``_reference_q``): per batch item amax =
    max |SiLU| in fp32 over both inputs (at least 1e-6); each SiLU output
    rounded to x's dtype, times 127 / amax, rounded half to even and clipped to
    +-127; the integer convolution (in fp32, exact at these sizes) times
    amax / 127 and the weights' scales, plus the bias and the residual in fp32,
    one cast at the end."""
    ts = [_silu_affine32(x, a, off)]
    if x2 is not None:
        ts.append(_silu_affine32(x2, a2, off2))
    amax = torch.clamp(torch.stack([t.abs().amax(dim=(1, 2, 3)) for t in ts]).amax(0), min=1e-6)
    # a true division (``127.0 / amax`` would take the reciprocal, then multiply)
    inv = (torch.full_like(amax, 127.0) / amax)[:, None, None, None]
    qx = torch.cat(
        [torch.clamp(torch.round(t.to(x.dtype).float() * inv), -127, 127) for t in ts], dim=1
    )
    acc = F.conv2d(qx, w_q.float(), padding=1)
    out = acc * (amax[:, None, None, None] / 127.0) * w_scale[None, :, None, None]
    out = out + b.float()[:, None, None]
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def quantize_conv_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, C, 3, 3) float weight -> (int8 weight, (O,) fp32 scales), the
    per-output-channel scheme of ``ops/quant.py:quantize_weight``. Made once per
    weight, not per call (``models/unet.py:UNetModel.prepare_gn_conv``)."""
    return quantize_weight(w)


# -- checks and launches ---------------------------------------------------------


def _check(x, a, off, x2, a2, off2, w, b, residual, w_scale=None) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be (B, C, H, W) float32 or bfloat16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    bsz, c1, h, wd = x.shape
    parts = [("x", x, a, off)]
    if x2 is not None:
        if x2.dim() != 4 or x2.dtype != x.dtype or x2.shape[0] != bsz or x2.shape[2:] != x.shape[2:]:
            raise ValueError(f"x2 must share x's dtype, batch and H, W: x {x.dtype} "
                             f"{tuple(x.shape)}, x2 {x2.dtype} {tuple(x2.shape)}")
        parts.append(("x2", x2, a2, off2))
    ctot = c1 + (x2.shape[1] if x2 is not None else 0)
    for name, t, aa, oo in parts:
        for vname, v in (("a", aa), ("off", oo)):
            if v is None or v.dtype != torch.float32 or v.shape != (bsz, t.shape[1]):
                raise ValueError(f"{vname} of {name} must be float32 of shape "
                                 f"{(bsz, t.shape[1])}, got "
                                 f"{None if v is None else (v.dtype, tuple(v.shape))}")
    quantized = w_scale is not None
    if w.dim() != 4 or w.shape[1:] != (ctot, 3, 3):
        raise ValueError(f"w must be (O, {ctot}, 3, 3), got {tuple(w.shape)}")
    o = w.shape[0]
    if quantized:
        if w.dtype != torch.int8 or w_scale.dtype != torch.float32 or w_scale.shape != (o,):
            raise ValueError(f"the int8 form takes int8 w and float32 w_scale of shape ({o},), "
                             f"got {w.dtype} and {w_scale.dtype} {tuple(w_scale.shape)}")
    elif w.dtype != x.dtype:
        raise ValueError(f"w must be in x's dtype {x.dtype}, got {w.dtype}")
    if b.shape != (o,) or b.dtype not in _DTYPE_CODES:
        raise ValueError(f"b must be float32 or bfloat16 of shape ({o},), got {b.dtype} "
                         f"{tuple(b.shape)}")
    if residual is not None and (residual.shape != (bsz, o, h, wd) or residual.dtype != x.dtype):
        raise ValueError(f"residual must be {x.dtype} of shape {(bsz, o, h, wd)}, got "
                         f"{residual.dtype} {tuple(residual.shape)}")
    tensors = [t for t in (x, a, off, x2, a2, off2, w, b, residual, w_scale) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must lie on one device")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the fused GroupNorm-SiLU-conv runs on cuda or cpu, not {x.device}")
    # the kernels' layout, held on the CPU too, so that CPU runs catch a caller
    # that would hand the card something it refuses
    for name, t in (("x", x), ("x2", x2), ("w", w), ("b", b), ("residual", residual),
                    ("w_scale", w_scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("a", a), ("off", off), ("a2", a2), ("off2", off2)):
        if t is not None and t.stride(1) != 1:
            raise ValueError(f"{name} must have unit stride along its channels")
    if x.device.type == "cuda":
        if ctot * h * wd >= 2**31 or bsz > 65535:
            raise ValueError(f"{(bsz, ctot, h, wd)}: the kernel takes B <= 65535 and "
                             "C * H * W < 2^31")


_PACKED: Dict[int, tuple] = {}  # id(w) -> (weakref to w, key, packed weight)


def packed_weight(w: torch.Tensor, c1: Optional[int] = None) -> torch.Tensor:
    """(O, C, 3, 3) weight -> the kernels' layout (9, O, L): element (tap, o,
    c) is ``w[o, c, tap // 3, tap % 3]`` for the first input's channels c < C1
    (``c1``, all of C for one input), and the second input's channel j lies at
    c = C1 rounded up to 16, plus j, so that each input's rows start 16-byte
    aligned for the weight map; L is rounded up to 16 as well, zeros elsewhere.
    Cached for as long as w lives and is unchanged: a new storage or an
    in-place update (an optimizer step, ``copy_``: each bumps ``w._version``)
    packs it anew."""
    o, c = w.shape[:2]
    c1 = c if c1 is None else c1
    key = (w.data_ptr(), w._version, w.dtype, w.device, tuple(w.shape), c1)
    hit = _PACKED.get(id(w))
    if hit is not None and hit[0]() is w and hit[1] == key:
        return hit[2]
    start2 = -(-c1 // 16) * 16
    packed = w.new_zeros(9, o, -(-(start2 + c - c1) // 16) * 16)
    taps = w.detach().permute(2, 3, 0, 1).reshape(9, o, c)
    packed[:, :, :c1] = taps[:, :, :c1]
    packed[:, :, start2:start2 + c - c1] = taps[:, :, c1:]
    ident = id(w)
    _PACKED[ident] = (weakref.ref(w, lambda _, i=ident: _PACKED.pop(i, None)), key, packed)
    return packed


def _part_args(x, a, off):
    if x is None:
        return [None, None, None, 0, 0]
    return [x.data_ptr(), a.data_ptr(), off.data_ptr(), x.shape[1], a.stride(0)]


def _launch(x, a, off, x2, a2, off2, w, b, residual, w_scale=None) -> torch.Tensor:
    """Launches kernel 4, or kernel 5's amax pass and convolution when
    ``w_scale`` is given, on CUDA tensors that ``_check`` accepted."""
    bsz, _, h, wd = x.shape
    o = w.shape[0]
    out = torch.empty(bsz, o, h, wd, dtype=x.dtype, device=x.device)
    parts = [*_part_args(x, a, off), *_part_args(x2, a2, off2)]
    res = residual.data_ptr() if residual is not None else None
    bias = [b.data_ptr(), int(b.dtype == torch.bfloat16), res, out.data_ptr()]
    shape = [bsz, h, wd, o, _DTYPE_CODES[x.dtype]]
    wp = packed_weight(w, x.shape[1])
    weight = [wp.data_ptr(), wp.shape[2]]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if w_scale is None:
        fn = _kernel("gn_silu_conv", _PART_ARGS * 2 + [vp, ci, vp, ci, vp, vp] + [ci] * 5 + [vp])
        with torch.cuda.device(x.device):
            err = fn(*parts, *weight, *bias, *shape,
                     torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"gn_silu_conv launch failed: cudaError {err}")
        gn_silu_conv3x3.launches += 1
        gn_silu_conv3x3.two_input_launches += x2 is not None
        return out
    amax = gn_silu_amax(x, a, off, x2, a2, off2)
    fn = _kernel("gn_silu_conv_q", _PART_ARGS * 2 + [vp, ci, vp, vp, ci, vp, vp, vp] + [ci] * 5
                 + [vp])
    with torch.cuda.device(x.device):
        err = fn(*parts, *weight, w_scale.data_ptr(), *bias, amax.data_ptr(), *shape,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gn_silu_conv_q launch failed: cudaError {err}")
    gn_silu_conv3x3_q.launches += 1
    gn_silu_conv3x3_q.two_input_launches += x2 is not None
    return out


def gn_silu_amax(x, a, off, x2=None, a2=None, off2=None) -> torch.Tensor:
    """Kernel 5's first pass: (B, P) fp32 partial maxima of |SiLU(x * a + off)|
    over both inputs, whose max over P is ``gn_silu_amax_reference`` (P = 1 on
    the CPU, where this is the plain version). On the card the convolution that
    follows reads them, so it needs no second pass over the item."""
    if x.device.type == "cpu":
        return gn_silu_amax_reference(x, a, off, x2, a2, off2)[:, None]
    bsz, _, h, wd = x.shape
    n_parts = _kernel("gn_silu_amax_parts", [])()
    amax = torch.empty(bsz, n_parts, dtype=torch.float32, device=x.device)
    fn = _kernel("gn_silu_amax", _PART_ARGS * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 4
                 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(*_part_args(x, a, off), *_part_args(x2, a2, off2), amax.data_ptr(), bsz, h, wd,
                 _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gn_silu_amax launch failed: cudaError {err}")
    gn_silu_amax.launches += 1
    return amax


def gn_silu_amax_reference(x, a, off, x2=None, a2=None, off2=None) -> torch.Tensor:
    """(B,) max |SiLU(x * a + off)| in fp32 over both inputs (not floored)."""
    ts = [_silu_affine32(x, a, off)] + ([_silu_affine32(x2, a2, off2)] if x2 is not None else [])
    return torch.stack([t.abs().amax(dim=(1, 2, 3)) for t in ts]).amax(0)


# -- the functions ---------------------------------------------------------------


class _GNSiLUConv(torch.autograd.Function):
    """Kernel 4 forward on a CUDA tensor (the plain version on the CPU); the
    backward recomputes through the plain version, as JAX's ``_fused_bwd`` /
    ``_fused2_bwd`` do (there is no backward kernel)."""

    @staticmethod
    def forward(ctx, x, a, off, x2, a2, off2, w, b, residual):
        ctx.save_for_backward(x, a, off, x2, a2, off2, w, b, residual)
        if x.device.type == "cpu":
            return gn_silu_conv3x3_reference(x, a, off, w, b, residual, x2, a2, off2)
        return _launch(x, a, off, x2, a2, off2, w, b, residual)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) if t is not None else None
                      for t, need in zip(saved, ctx.needs_input_grad)]
            x, a, off, x2, a2, off2, w, b, residual = leaves
            out = gn_silu_conv3x3_reference(x, a, off, w, b, residual, x2, a2, off2)
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        return tuple(next(grads) if t is not None and t.requires_grad else None for t in leaves)


def gn_silu_conv3x3(x, a, off, w, b, residual=None) -> torch.Tensor:
    """``conv3x3(SiLU(x * a + off), w) + b (+ residual)``: x (B, C, H, W) fp32
    or bf16, a and off (B, C) fp32, w (O, C, 3, 3) in x's dtype, b (O,) fp32 or
    bf16, residual (B, O, H, W) in x's dtype; out (B, O, H, W) in x's dtype.
    Differentiable."""
    _check(x, a, off, None, None, None, w, b, residual)
    return _GNSiLUConv.apply(x, a, off, None, None, None, w, b, residual)


def gn_silu_conv3x3_concat(x, a, off, x2, a2, off2, w, b, residual=None) -> torch.Tensor:
    """The two-input form: the convolution of the channel concat [x, x2] (never
    built), a/off over x's C1 channels and a2/off2 over x2's C2 (slices of
    the concat's GroupNorm affine); w (O, C1 + C2, 3, 3). Differentiable."""
    _check(x, a, off, x2, a2, off2, w, b, residual)
    return _GNSiLUConv.apply(x, a, off, x2, a2, off2, w, b, residual)


class _GNSiLUConvQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, off, x2, a2, off2, w_q, w_scale, b, residual):
        if x.device.type == "cpu":
            return gn_silu_conv3x3_q_reference(x, a, off, w_q, w_scale, b, residual, x2, a2, off2)
        return _launch(x, a, off, x2, a2, off2, w_q, b, residual, w_scale)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the int8 GroupNorm-SiLU-conv has no gradient (round and clip): gn_conv='int8' "
            "is a sampling-only mode, train with 'unfused' or 'fused'"
        )


def gn_silu_conv3x3_q(x, a, off, w_q, w_scale, b, residual=None) -> torch.Tensor:
    """int8 ``conv3x3(SiLU(x * a + off))``: w_q (O, C, 3, 3) int8 and w_scale
    (O,) fp32 from ``quantize_conv_kernel``; the activation is quantized per
    batch item inside the kernel. Sampling only: backward raises."""
    _check(x, a, off, None, None, None, w_q, b, residual, w_scale)
    return _GNSiLUConvQ.apply(x, a, off, None, None, None, w_q, w_scale, b, residual)


def gn_silu_conv3x3_concat_q(x, a, off, x2, a2, off2, w_q, w_scale, b,
                             residual=None) -> torch.Tensor:
    """The two-input int8 form; one activation scale covers both inputs, which
    are one virtual tensor. Sampling only: backward raises."""
    _check(x, a, off, x2, a2, off2, w_q, b, residual, w_scale)
    return _GNSiLUConvQ.apply(x, a, off, x2, a2, off2, w_q, w_scale, b, residual)


gn_silu_conv3x3.launches = 0
gn_silu_conv3x3.two_input_launches = 0
gn_silu_conv3x3_q.launches = 0
gn_silu_conv3x3_q.two_input_launches = 0
gn_silu_amax.launches = 0
