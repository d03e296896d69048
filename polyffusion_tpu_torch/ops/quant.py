"""Symmetric int8 quantization and the int8 convolution of the XLA int8 route
(counterpart of ``polyffusion_tpu/ops/quant.py``), on NCHW activations and
(O, C, kh, kw) weights; sampling only.

Two int8 routes exist, as in the JAX package:
- this one (``gn_conv="int8_xla"``, JAX's ``POLYFF_INT8_XLA=1``): plain
  PyTorch around an exact integer product, ``int8_conv``;
- the fused kernel (``gn_conv="int8"``, kernel 5, ``ops/fused_gn_conv.py``),
  which quantizes its activations itself inside the GroupNorm-SiLU-conv pass
  and uses ``quantize_weight`` for its weights.

``int8_conv`` contracts the int8 codes exactly, as JAX's s8 x s8 -> s32
convolution does: ``torch._int_mm`` (s8 operands, s32 sums) over an im2col of
the codes. A float convolution of the codes is not exact in general: a sum of
C x 9 products of up to 127^2 passes 2^24 at 256 channels (and cuDNN runs an
fp32 convolution in TF32 unless told not to). It is a library product, as
JAX's is XLA's; no TPU kernel stands behind it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _full_127(like: torch.Tensor) -> torch.Tensor:
    """127 as a tensor: a quotient of two tensors is rounded once, as JAX
    divides, on every device; with a Python number on either side torch
    multiplies by a reciprocal instead (for a divisor on CUDA, for a
    numerator everywhere), an ulp off now and then, which moves a scale or
    flips a code."""
    return torch.full_like(like, 127.0)


def quantize_act(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) float -> (int8 of the same shape, (B,) fp32 scales):
    per batch item, amax = max(max |y| over (C, H, W), 1e-6), q =
    clip(round(y * (127 / amax)), -127, 127), rounding half to even as
    ``jnp.round`` does, scale = amax / 127."""
    y32 = y.float()
    amax = torch.clamp(y32.abs().amax(dim=(1, 2, 3)), min=1e-6)
    k = _full_127(amax)
    q = torch.clamp(torch.round(y32 * (k / amax)[:, None, None, None]), -127, 127)
    return q.to(torch.int8), amax / k


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, C, kh, kw) float -> (int8 of the same shape, (O,) fp32 scales):
    per output channel, scale = max(amax over (C, kh, kw), 1e-8) / 127 and
    q = clip(round(w / scale), -127, 127), rounding half to even as
    ``jnp.round`` does."""
    w32 = w.float()
    amax = torch.clamp(w32.abs().amax(dim=(1, 2, 3)), min=1e-8)
    scale = amax / _full_127(amax)
    q = torch.clamp(torch.round(w32 / scale[:, None, None, None]), -127, 127)
    return q.to(torch.int8), scale


def int8_conv_sums(q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of the stride-1, same-padded convolution of int8
    codes ``q`` (B, C, H, W) by int8 weights ``w_q`` (O, C, kh, kw), as
    (B, H, W, O): an im2col of the codes (NHWC, the (C, kh, kw) order of the
    weights) times the weights by ``torch._int_mm``, whose shape rules (the
    contraction C kh kw and O multiples of 8) are checked here."""
    b, c, h, w = q.shape
    o, c_w, kh, kw = w_q.shape
    if c_w != c or q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8 codes (B, C, H, W) and weights (O, C, kh, kw) expected, got "
                         f"{q.dtype} {tuple(q.shape)} and {w_q.dtype} {tuple(w_q.shape)}")
    k = c * kh * kw
    if k % 8 or o % 8:
        raise ValueError(f"the int8 product needs C kh kw ({k}) and O ({o}) multiples of 8")
    padded = F.pad(q.permute(0, 2, 3, 1), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    cols = torch.stack([padded[:, i:i + h, j:j + w] for i in range(kh) for j in range(kw)],
                       dim=-1)  # (B, H, W, C, kh kw)
    acc = torch._int_mm(cols.reshape(b * h * w, k), w_q.reshape(o, k).t())
    return acc.view(b, h, w, o)


class _Int8Conv(torch.autograd.Function):
    """The forward of ``int8_conv``; its backward refuses (JAX's custom VJP)."""

    @staticmethod
    def forward(ctx, y, w_q, w_scale, bias, out_dtype):
        q, act_scale = quantize_act(y)
        acc = int8_conv_sums(q, w_q)
        out = acc.float() * act_scale[:, None, None, None] * w_scale
        if bias is not None:
            out = out + bias.float()
        return out.to(out_dtype or y.dtype).permute(0, 3, 1, 2).contiguous()

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "int8_conv has no gradient (round and clip): gn_conv='int8_xla' is a sampling-only "
            "mode; train with gn_conv 'unfused' or 'fused'")


def int8_conv(y: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The 3 x 3 (any odd kernel), stride-1, same-padded ``conv(y, w)`` with
    int8 operands (JAX's ``int8_conv``): ``y`` (B, C, H, W) is the
    already-activated input, quantized per item here (``quantize_act``);
    ``w_q`` and ``w_scale`` come from ``quantize_weight`` (once per weight).
    The exact int32 sums are rescaled in fp32 by the activation and weight
    scales, the bias added in fp32, then cast to ``out_dtype`` (default
    ``y.dtype``). Sampling only: a backward raises ``NotImplementedError``."""
    return _Int8Conv.apply(y, w_q, w_scale, bias, out_dtype)


def int8_concat_conv(y: torch.Tensor, y2: torch.Tensor, parts, bias: torch.Tensor) -> torch.Tensor:
    """``int8_conv`` of the channel concat [y, y2] without building it (JAX's
    ``Int8ConcatConv``): each part quantized with its own activation scale
    and, in ``parts`` (one (int8 weight, scales) pair per part, from
    ``quantize_weight`` of its kernel slice), its own per-channel weight
    scales; the two partial outputs (``y.dtype``) added, then the bias."""
    out = int8_conv(y, *parts[0]) + int8_conv(y2, *parts[1])
    return out + bias.to(out.dtype)[:, None, None]
