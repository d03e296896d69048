"""Stable-Diffusion-style conditional UNet (counterpart of ``polyffusion_tpu/models/unet.py``).

Under tensor parallelism ``parallel/tp.py:shard_state`` replaces the
ResBlocks' convs, time-embedding projections and out-norms, the attention
projections and the GeGLU feed-forward with its column- and row-parallel
modules (same parameter names, full shapes in the state dict); the blocks'
forwards here run unchanged on them.

NCHW inside. The module tree and parameter names are the reference torch
UNet's (``time_embed.0``, ``input_blocks.1.0.in_layers.0``, ``emb_layers.1``,
``out_layers.3``, ``transformer_blocks.0.attn1.to_q``, ``ff.net.0.proj``, ...),
so reference checkpoints load with a strict ``load_state_dict``.

The compute dtype is the dtype of the weights (see ``utils/precision.py``):
norm scales and biases stay fp32, the statistics of every norm and the
attention softmax run in fp32, and the output is fp32.

``gn_conv`` picks how each ResBlock runs its two GroupNorm -> SiLU -> conv3x3
sites (the JAX package's ``POLYFF_FUSED_GN_CONV`` / ``POLYFF_INT8_CONV``):
"unfused" as three modules, "fused" through the fused kernel
(``ops/fused_gn_conv.py``, kernel 4) with the decoder's skip concat never built
and the block's residual added inside the second kernel, "int8" the same with
int8 operands (kernel 5, sampling only; ``UNetModel.prepare_gn_conv`` makes
the int8 weights once), "int8_xla" as three modules with the convolution an
exact int8 product (JAX's ``POLYFF_INT8_XLA``: ``ops/quant.py:int8_conv``,
per-item activation and per-channel weight scales; the decoder's concat as
two products, each part with its own scales; sampling only, the int8 weights
made once as for "int8"), "s2d" the unfused route with level 0 folded
(JAX's ``POLYFF_S2D=1``, ``ops/s2d.py``): every level-0 activation is
(B, 2C, H, W/2), every level-0 conv an exact conv of the folded layout with a
kernel made from the same weights at each call (``S2dConv`` and the rest),
the level-0 GroupNorms take their statistics per unfolded channel
(``FoldedGroupNorm32``, whose backward is autograd's, not kernel 6), and the
head unfolds the output. The folded convs do twice the multiply-adds of the
plain ones. Level 0 must not attend. Parameter names and shapes are the same
in every mode.

``cfg_fork`` (JAX's ``cfg_fork=True``): ``x`` and the time steps at batch B,
the condition at 2B ([uncond | cond]); the net runs once at B up to its first
cross-attention, then duplicates its activations, time embedding and stored
skips and runs at 2B: the double batch of classifier-free guidance up to
float reassociation, with the condition-free prefix computed once.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multihead_attention
from ..ops.fused_gn_conv import (
    gn_silu_conv3x3,
    gn_silu_conv3x3_concat,
    gn_silu_conv3x3_concat_q,
    gn_silu_conv3x3_q,
)
from ..ops.gn_bwd import gn_affine, group_norm_affine
from ..ops.gn_fwd import group_norm_silu, kernel_takes
from ..ops.quant import int8_concat_conv, int8_conv, quantize_weight
from ..ops.s2d import (
    fold_channel_vec,
    from_s2d,
    s2d_entry_kernel,
    s2d_exit_stride2_kernel,
    s2d_kernel,
    to_s2d,
    upsample2x_s2d,
)

GN_CONV_MODES = ("unfused", "fused", "int8", "int8_xla", "s2d")
INT8_MODES = ("int8", "int8_xla")  # sampling only: int8 weights made by prepare_gn_conv


def timestep_embedding(time_steps: torch.Tensor, channels: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, cos-first. Always fp32."""
    half = channels // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=time_steps.device)
        / half
    )
    args = time_steps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm32(nn.Module):
    """GroupNorm with one-pass fp32 statistics (E[x^2] - E[x]^2) whose per-channel
    affine is folded in fp32 and applied in the activation dtype, as the JAX
    package's ``FP32GroupNorm`` does (``nn.GroupNorm`` is two-pass and applies in
    fp32, so it would round differently in bf16). Its backward is the GroupNorm
    backward kernel on a CUDA tensor (``ops/gn_bwd.py``). ``groups``: 32, the
    reference's normalization(32), unless a model asks for another count (the
    plain DDPM UNet's final norm has 8). Outside autograd on a CUDA tensor
    that kernel 8 takes (``ops/gn_fwd.py:kernel_takes``: the samplers), the
    forward is one launch of it, with the same roundings."""

    def __init__(self, channels: int, eps: float = 1e-5, groups: int = 32):
        super().__init__()
        if channels % groups:
            raise ValueError(f"GroupNorm needs channels divisible by {groups}, got {channels}")
        self.eps = eps
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if kernel_takes(x, self.groups):
            return group_norm_silu(x, self.weight, self.bias, self.groups, self.eps)
        return group_norm_affine(x, self.weight, self.bias, self.groups, self.eps)


def norm_silu(layers: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """``layers[1](layers[0](x))``, a GroupNorm32 and its SiLU, as one launch
    of kernel 8 where ``kernel_takes`` x; the norm's subclasses (the folded
    and the tensor-parallel ones) keep their own forward."""
    norm = layers[0]
    if type(norm) is GroupNorm32 and kernel_takes(x, norm.groups):
        return group_norm_silu(x, norm.weight, norm.bias, norm.groups, norm.eps, silu=True)
    return layers[1](norm(x))


class FoldedGroupNorm32(GroupNorm32):
    """``GroupNorm32`` of space-to-depth folded inputs (JAX's
    ``FP32GroupNorm(folded=True)``): the fp32 statistics per unfolded channel,
    the fp32 affine folded back (``fold_channel_vec``) and applied in the
    activation dtype. ``forward(x, x2)`` normalises the virtual channel concat
    [x, x2] (the decoder's skip, never built) and returns both parts. Its
    backward is autograd's, as in JAX: a folded group spans two channel
    ranges, which kernel 6 cannot read without a copy."""

    def forward(self, x: torch.Tensor, x2: Optional[torch.Tensor] = None):
        a, off = gn_affine(x, self.weight, self.bias, self.groups, self.eps, x2, folded=True)
        a, off = a.to(x.dtype), off.to(x.dtype)

        def apply(t, a_c, off_c):
            a_f, off_f = fold_channel_vec(a_c), fold_channel_vec(off_c)
            return t * a_f[:, :, None, None] + off_f[:, :, None, None]

        if x2 is None:
            return apply(x, a, off)
        c1 = x.shape[1] // 2
        return apply(x, a[:, :c1], off[:, :c1]), apply(x2, a[:, c1:], off[:, c1:])


def _conv3x3(c_in: int, c_out: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, stride=stride, padding=1)


class S2dConv(nn.Conv2d):
    """A stride-1 3 x 3 or 1 x 1 ``nn.Conv2d`` (its weight and bias, of the same
    names and shapes) over folded inputs, (B, 2I, H, J) -> (B, 2O, H, J),
    through ``s2d_kernel`` of its weight (JAX's ``S2dConv``)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__(c_in, c_out, kernel_size, padding=kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, s2d_kernel(self.weight), fold_channel_vec(self.bias),
                        padding=self.padding)


class S2dConcatConv(S2dConv):
    """``S2dConv`` of the virtual channel concat [x, x2] of two folded inputs
    (JAX's ``S2dConcatConv``): a folded conv of each part by its slice of the
    weight, summed."""

    def forward(self, x: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        c1, w = x.shape[1] // 2, self.weight
        y = F.conv2d(x, s2d_kernel(w[:, :c1]), fold_channel_vec(self.bias), padding=self.padding)
        return y + F.conv2d(x2, s2d_kernel(w[:, c1:]), padding=self.padding)


class S2dEntryConv(nn.Conv2d):
    """The input conv (a 3 x 3 ``nn.Conv2d``'s weight and bias) from the plain
    input to the folded layout in one conv of stride (1, 2) through
    ``s2d_entry_kernel`` (JAX's ``S2dEntryConv``)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(c_in, c_out, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, s2d_entry_kernel(self.weight), fold_channel_vec(self.bias),
                        stride=(1, 2), padding=1)


class S2dExitConv(nn.Conv2d):
    """The level-0 DownSample conv (a stride-2 3 x 3 ``nn.Conv2d``'s weight and
    bias) from the folded layout to the plain stride-2 output through
    ``s2d_exit_stride2_kernel`` (JAX's ``S2dExitConv``): H padded by one on
    both sides, the blocks by one on the left only, then stride (2, 1)."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(F.pad(x, (1, 0, 1, 1)), s2d_exit_stride2_kernel(self.weight), self.bias,
                        stride=(2, 1))


class ResBlock(nn.Module):
    """GN -> SiLU -> conv, + time embedding, GN -> SiLU -> conv, + skip.

    ``skip``: the decoder's skip tensor; the block then acts on the channel
    concat [x, skip], which the fused modes never build (as the JAX package's
    ``ResBlock(skip=...)`` does) and the unfused ones build.
    ``skip_channels``: the skip tensor's channels in a decoder block, whose
    in conv the "int8_xla" route quantizes as two parts.
    ``folded`` (level 0 under "s2d"; JAX's ``ResBlock._folded``): x, skip and
    the output are folded, the norms ``FoldedGroupNorm32`` (the decoder's two
    parts normalised apart, the concat never built), the convs their ``S2d``
    forms; the other blocks of an "s2d" UNet run unfused."""

    def __init__(self, channels: int, d_t_emb: int, out_channels: Optional[int] = None,
                 gn_conv: str = "unfused", skip_channels: int = 0, folded: bool = False):
        super().__init__()
        if gn_conv not in GN_CONV_MODES:
            raise ValueError(f"gn_conv must be one of {GN_CONV_MODES}, got {gn_conv!r}")
        if folded and gn_conv != "s2d":
            raise ValueError(f"a folded ResBlock is the s2d route's, not gn_conv={gn_conv!r}'s")
        out = out_channels or channels
        self.gn_conv = gn_conv
        self.skip_channels = skip_channels
        self.folded = folded
        norm = FoldedGroupNorm32 if folded else GroupNorm32

        def conv(c_in, c_out, k, of_concat=False):  # "same" padding, stride 1
            if not folded:
                return nn.Conv2d(c_in, c_out, k, padding=k // 2)
            return (S2dConcatConv if of_concat else S2dConv)(c_in, c_out, k)

        concat = skip_channels > 0
        self.in_layers = nn.Sequential(norm(channels), nn.SiLU(), conv(channels, out, 3, concat))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(d_t_emb, out))
        # index 2 stands where the reference keeps its Dropout
        self.out_layers = nn.Sequential(norm(out), nn.SiLU(), nn.Identity(), conv(out, out, 3))
        self.skip_connection = nn.Identity() if out == channels else conv(channels, out, 1, concat)
        # per conv: (weight data_ptr, int8 weight, scales[, int8 weight, scales
        # of the skip part])
        self._int8 = None

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.folded:
            return self._forward_folded(x, t_emb, skip)
        if self.gn_conv in ("unfused", "s2d"):
            if skip is not None:
                x = torch.cat([x, skip], dim=1)
            h = self.in_layers[2](norm_silu(self.in_layers, x))
            h = h + self.emb_layers(t_emb).to(h.dtype)[:, :, None, None]
            return self.skip_connection(x) + self.out_layers[3](norm_silu(self.out_layers, h))
        if self.gn_conv == "int8_xla":
            return self._forward_int8_xla(x, t_emb, skip)
        # the kernels take contiguous NCHW (a SpatialTransformer's output is not)
        x = x.contiguous()
        skip = skip.contiguous() if skip is not None else None
        norm = self.in_layers[0]
        a, off = gn_affine(x, norm.weight, norm.bias, norm.groups, norm.eps, skip)
        if skip is None:
            h = self._gn_conv(0, x, a, off)
        else:
            c1 = x.shape[1]
            h = self._gn_conv(0, x, a[:, :c1], off[:, :c1], skip, a[:, c1:], off[:, c1:])
        h = h + self.emb_layers(t_emb).to(h.dtype)[:, :, None, None]
        norm = self.out_layers[0]
        a, off = gn_affine(h, norm.weight, norm.bias, norm.groups, norm.eps)
        # the residual is added in fp32 inside the kernel, before its one cast
        return self._gn_conv(1, h, a, off, residual=self._residual(x, skip).contiguous())

    def _residual(self, x: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
        sc = self.skip_connection
        if skip is None:
            return sc(x)
        if isinstance(sc, nn.Identity):
            return torch.cat([x, skip], dim=1)
        # the 1x1 conv of the concat as two convs of its parts (JAX's ConcatConv)
        c1 = x.shape[1]
        y = F.conv2d(x, sc.weight[:, :c1]) + F.conv2d(skip, sc.weight[:, c1:])
        return y + sc.bias.to(y.dtype)[:, None, None]

    def _forward_folded(self, x, t_emb, skip):
        norm, act, conv = self.in_layers
        if skip is None:
            h = conv(act(norm(x)))
        else:
            h1, h2 = norm(x, skip)
            h = conv(act(h1), act(h2))
        h = h + fold_channel_vec(self.emb_layers(t_emb).to(h.dtype))[:, :, None, None]
        sc = self.skip_connection
        if not isinstance(sc, nn.Identity):
            res = sc(x) if skip is None else sc(x, skip)
        elif skip is not None:
            # the folded concat interleaves the parities: [x even, skip even, x odd, skip odd]
            cx, ck = x.shape[1] // 2, skip.shape[1] // 2
            res = torch.cat([x[:, :cx], skip[:, :ck], x[:, cx:], skip[:, ck:]], dim=1)
        else:
            res = x
        return res + self.out_layers(h)

    def _forward_int8_xla(self, x, t_emb, skip):
        """The unfused block with its two 3x3 convs as int8 products (JAX's
        ``Int8Conv3x3`` and, for the decoder's concat, ``Int8ConcatConv``:
        each part quantized with its own scales, the two partial outputs
        added in the activation dtype, then the bias)."""
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        y = norm_silu(self.in_layers, x)
        parts = self._int8_parts(0)
        if len(parts) == 1:
            h = int8_conv(y, *parts[0], self.in_layers[2].bias)
        else:
            c1 = x.shape[1] - self.skip_channels
            h = int8_concat_conv(y[:, :c1], y[:, c1:], parts, self.in_layers[2].bias)
        h = h + self.emb_layers(t_emb).to(h.dtype)[:, :, None, None]
        y = norm_silu(self.out_layers, h)
        return self.skip_connection(x) + int8_conv(y, *self._int8_parts(1)[0],
                                                   self.out_layers[3].bias)

    def _int8_parts(self, i):
        """Conv i's int8 weights and scales, one pair per input part."""
        conv = (self.in_layers[2], self.out_layers[3])[i]
        entry = self._int8[i] if self._int8 is not None else (None,)
        if entry[0] != conv.weight.data_ptr():
            raise RuntimeError(f"gn_conv={self.gn_conv!r} needs UNetModel.prepare_gn_conv() "
                               "after the weights are set, cast or moved")
        return list(zip(entry[1::2], entry[2::2]))

    def _gn_conv(self, i, x, a, off, x2=None, a2=None, off2=None, residual=None):
        """Site i (0: in_layers, 1: out_layers) through kernel 4 or 5."""
        conv = (self.in_layers[2], self.out_layers[3])[i]
        if self.gn_conv == "fused":
            if x2 is None:
                return gn_silu_conv3x3(x, a, off, conv.weight, conv.bias, residual)
            return gn_silu_conv3x3_concat(x, a, off, x2, a2, off2, conv.weight, conv.bias, residual)
        w_q, w_scale = self._int8_parts(i)[0]
        if x2 is None:
            return gn_silu_conv3x3_q(x, a, off, w_q, w_scale, conv.bias, residual)
        return gn_silu_conv3x3_concat_q(x, a, off, x2, a2, off2, w_q, w_scale, conv.bias, residual)

    @torch.no_grad()
    def prepare_gn_conv(self) -> None:
        """In an int8 mode, quantize both 3x3 weights as they are now (once
        per weight, as JAX hoists ``quantize_conv_kernel`` out of its sampling
        loop; ``quantize_weight`` is ``quantize_conv_kernel``): whole for
        kernel 5 ("int8"), and for "int8_xla" a decoder block's in conv per
        input part (x's channels, then the skip's), as JAX's per-call
        ``quantize_weight`` of each kernel slice. A no-op otherwise."""
        if self.gn_conv not in INT8_MODES:
            self._int8 = None
            return
        convs = (self.in_layers[2], self.out_layers[3])
        split = self.skip_channels if self.gn_conv == "int8_xla" else 0
        self._int8 = []
        for i, conv in enumerate(convs):
            w = conv.weight
            pieces = [w] if i == 1 or not split else [w[:, :-split], w[:, -split:]]
            self._int8.append((w.data_ptr(), *[t for p in pieces for t in quantize_weight(p)]))


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when ``cond`` is None."""

    def __init__(self, d_model: int, d_cond: int, n_heads: int, d_head: int):
        super().__init__()
        d_attn = n_heads * d_head
        self.n_heads, self.d_head = n_heads, d_head
        self.to_q = nn.Linear(d_model, d_attn, bias=False)
        self.to_k = nn.Linear(d_cond, d_attn, bias=False)
        self.to_v = nn.Linear(d_cond, d_attn, bias=False)
        self.to_out = nn.Sequential(nn.Linear(d_attn, d_model))

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        cond = x if cond is None else cond
        b, s, _ = x.shape
        t = cond.shape[1]
        # the heads of the projections' width: all of them, or this rank's
        # under tensor parallelism (parallel/tp.py)
        q = self.to_q(x).view(b, s, -1, self.d_head)
        k = self.to_k(cond).view(b, t, -1, self.d_head)
        v = self.to_v(cond).view(b, t, -1, self.d_head)
        out = multihead_attention(q, k, v, self.d_head**-0.5).to(x.dtype)
        return self.to_out(out.reshape(b, s, -1))


class GeGLU(nn.Module):
    """``gelu``: the GELU's ``approximate`` form, "tanh" (flax's) or "none"
    (the exact one)."""

    def __init__(self, d_in: int, d_out: int, gelu: str = "tanh"):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out * 2)
        self.gelu = gelu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        val, gate = self.proj(x).chunk(2, dim=-1)
        return val * F.gelu(gate, approximate=self.gelu)


class FeedForward(nn.Module):
    """GeGLU feed-forward, 4x wide; index 1 stands where the reference keeps its Dropout."""

    def __init__(self, d_model: int, gelu: str = "tanh"):
        super().__init__()
        self.net = nn.Sequential(
            GeGLU(d_model, d_model * 4, gelu), nn.Identity(), nn.Linear(d_model * 4, d_model)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """pre-LN self-attention -> cross-attention -> GeGLU FF. The LayerNorms run
    in fp32, by default with flax's epsilon 1e-6 and the GeGLU with the tanh
    GELU (``ln_eps``, ``gelu``: a published model's own)."""

    def __init__(self, d_model: int, n_heads: int, d_head: int, d_cond: int,
                 ln_eps: float = 1e-6, gelu: str = "tanh"):
        super().__init__()
        self.attn1 = CrossAttention(d_model, d_model, n_heads, d_head)
        self.norm1 = nn.LayerNorm(d_model, eps=ln_eps)
        self.attn2 = CrossAttention(d_model, d_cond, n_heads, d_head)
        self.norm2 = nn.LayerNorm(d_model, eps=ln_eps)
        self.ff = FeedForward(d_model, gelu)
        self.norm3 = nn.LayerNorm(d_model, eps=ln_eps)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x.float()).to(x.dtype)) + x
        x = self.attn2(self.norm2(x.float()).to(x.dtype), cond.to(x.dtype)) + x
        return self.ff(self.norm3(x.float()).to(x.dtype)) + x


class SpatialTransformer(nn.Module):
    """GN -> 1x1 conv -> flatten HW -> transformer blocks -> 1x1 conv, + residual.
    ``linear`` (SDXL's ``use_linear_in_transformer``): proj_in and proj_out
    are Linear layers on the (B, HW, C) tokens, and the sum with the input
    keeps the input's NCHW layout."""

    def __init__(self, channels: int, n_heads: int, n_layers: int, d_cond: int,
                 linear: bool = False, ln_eps: float = 1e-6, gelu: str = "tanh"):
        super().__init__()
        self.linear = linear

        def proj():
            return nn.Linear(channels, channels) if linear else nn.Conv2d(channels, channels, 1)

        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, n_heads, channels // n_heads, d_cond, ln_eps, gelu)
            for _ in range(n_layers)
        )
        self.proj_out = proj()

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        x_in = x
        if self.linear:
            x = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            x = self.proj_in(self.norm(x))
            x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, cond)
        if self.linear:
            # x_in first: the sum takes its NCHW layout, which the next
            # GroupNorm's kernel reads whole
            return x_in + self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(x) + x_in


class DownSample(nn.Module):
    """``folded_input``: level 0's exit under "s2d", folded in, plain out."""

    def __init__(self, channels: int, folded_input: bool = False):
        super().__init__()
        self.op = S2dExitConv(channels) if folded_input else _conv3x3(channels, channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class UpSample(nn.Module):
    """``fold_output``: the way back into level 0 under "s2d", plain in, the
    upsample made in the folded layout and a folded conv."""

    def __init__(self, channels: int, fold_output: bool = False):
        super().__init__()
        self.fold_output = fold_output
        self.conv = S2dConv(channels, channels, 3) if fold_output else _conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fold_output:
            return self.conv(upsample2x_s2d(to_s2d(x)))
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class TimestepEmbedSequential(nn.Sequential):
    """Runs its layers in order, handing each the inputs it takes (``skip`` to
    the first ResBlock). ``before_attention``: called on the activations just
    before a SpatialTransformer, whose result it takes (the CFG fork)."""

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor, cond: torch.Tensor,
                skip: Optional[torch.Tensor] = None,
                before_attention: Optional[Callable] = None) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, t_emb, skip)
                skip = None
            elif isinstance(layer, SpatialTransformer):
                if before_attention is not None:
                    x = before_attention(x)
                x = layer(x, cond)
            else:
                x = layer(x)
        return x


class UNetModel(nn.Module):
    """The epsilon-prediction UNet: ``x`` (B, in_channels, H, W), ``time_steps``
    (B,), ``cond`` (B, n_cond, d_cond) and, where ``adm_in_channels`` is set,
    ``y`` (B, adm_in_channels) -> (B, out_channels, H, W) in fp32.
    ``gn_conv``: "unfused", "fused", "int8", "int8_xla" or "s2d" (see the
    module's docstring). "s2d" is refused where level 0 attends (JAX's
    ``POLYFF_S2D`` gate falls back to the plain route there) and, in the
    forward, for a width the folds do not divide.

    The keys after ``gn_conv`` describe SDXL's UNet (sgm's ``UNetModel``);
    their defaults keep the Polyffusion UNet as it is. ``tf_layers``: the
    transformer depth of every attending level, or one depth a level, 0
    exactly at the levels ``attention_levels`` leaves out; the middle block
    takes the last level's depth. ``d_head``: heads of this width (a level's
    heads are its channels over it) in place of ``n_heads`` heads.
    ``linear_proj``: Linear proj_in and proj_out (``SpatialTransformer``).
    ``adm_in_channels``: a ``label_emb`` MLP (Linear, SiLU, Linear) on ``y``
    added to the time embedding. ``ln_eps``, ``gelu``: the transformer
    blocks' LayerNorm epsilon and GELU form."""

    def __init__(
        self,
        in_channels: int = 2,
        out_channels: int = 2,
        channels: int = 64,
        n_res_blocks: int = 2,
        attention_levels: Sequence[int] = (2, 3),
        channel_multipliers: Sequence[int] = (1, 2, 4, 4),
        n_heads: int = 4,
        tf_layers: Union[int, Sequence[int]] = 1,
        d_cond: int = 512,
        gn_conv: str = "unfused",
        d_head: Optional[int] = None,
        linear_proj: bool = False,
        adm_in_channels: int = 0,
        ln_eps: float = 1e-6,
        gelu: str = "tanh",
    ):
        super().__init__()
        if gn_conv == "s2d" and 0 in attention_levels:
            raise ValueError("gn_conv='s2d' folds level 0, which must not attend (JAX's "
                             "POLYFF_S2D gate runs such a UNet unfolded)")
        self.channels = channels
        self.s2d = gn_conv == "s2d"
        levels = len(channel_multipliers)
        # the folds halve the width at level 0 and at the upsample into it
        self.width_multiple = 2 if levels == 1 else 4
        d_time_emb = channels * 4
        self.time_embed = nn.Sequential(
            nn.Linear(channels, d_time_emb), nn.SiLU(), nn.Linear(d_time_emb, d_time_emb)
        )
        self.label_emb = None
        if adm_in_channels:
            self.label_emb = nn.Sequential(nn.Sequential(
                nn.Linear(adm_in_channels, d_time_emb), nn.SiLU(),
                nn.Linear(d_time_emb, d_time_emb)))
        depths = [tf_layers] * levels if isinstance(tf_layers, int) else list(tf_layers)
        if not isinstance(tf_layers, int) and (
                len(depths) != levels
                or sorted(attention_levels) != [i for i, d in enumerate(depths) if d]):
            raise ValueError(f"tf_layers {depths} must give each of the {levels} levels a "
                             f"depth, 0 exactly where attention_levels "
                             f"{list(attention_levels)} leaves a level out")

        def transformer(ch, depth):
            heads = ch // d_head if d_head else n_heads
            return SpatialTransformer(ch, heads, depth, d_cond, linear_proj, ln_eps, gelu)

        s2d = self.s2d
        entry = S2dEntryConv(in_channels, channels) if s2d else _conv3x3(in_channels, channels)
        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(entry)])
        skip_channels = [channels]
        channels_list = [channels * m for m in channel_multipliers]
        ch = channels
        for i in range(levels):
            for _ in range(n_res_blocks):
                layers = [ResBlock(ch, d_time_emb, channels_list[i], gn_conv,
                                   folded=s2d and i == 0)]
                ch = channels_list[i]
                if i in attention_levels:
                    layers.append(transformer(ch, depths[i]))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                skip_channels.append(ch)
            if i != levels - 1:
                self.input_blocks.append(
                    TimestepEmbedSequential(DownSample(ch, folded_input=s2d and i == 0)))
                skip_channels.append(ch)

        self.middle_block = TimestepEmbedSequential(
            ResBlock(ch, d_time_emb, gn_conv=gn_conv), transformer(ch, depths[-1]),
            ResBlock(ch, d_time_emb, gn_conv=gn_conv)
        )

        self.output_blocks = nn.ModuleList()
        for i in reversed(range(levels)):
            for j in range(n_res_blocks + 1):
                skip_ch = skip_channels.pop()
                layers = [ResBlock(ch + skip_ch, d_time_emb, channels_list[i], gn_conv, skip_ch,
                                   folded=s2d and i == 0)]
                ch = channels_list[i]
                if i in attention_levels:
                    layers.append(transformer(ch, depths[i]))
                if i != 0 and j == n_res_blocks:
                    layers.append(UpSample(ch, fold_output=s2d and i == 1))
                self.output_blocks.append(TimestepEmbedSequential(*layers))

        self.out = nn.Sequential(
            FoldedGroupNorm32(ch) if s2d else GroupNorm32(ch), nn.SiLU(),
            S2dConv(ch, out_channels, 3) if s2d else _conv3x3(ch, out_channels))

    def forward(self, x: torch.Tensor, time_steps: torch.Tensor, cond: torch.Tensor,
                cfg_fork: bool = False, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """With ``cfg_fork``, ``x`` and ``time_steps`` have batch B and ``cond``
        2B (``[uncond | cond]``): ``h``, the time embedding and every stored
        skip are tiled once, just before the input half's first
        SpatialTransformer, or before the middle block where no input level
        attends; the output has batch 2B. ``y``: the vector condition of a
        UNet with a ``label_emb`` (which does not fork)."""
        if self.s2d and x.shape[-1] % self.width_multiple:
            raise ValueError(f"gn_conv='s2d' needs a width divisible by {self.width_multiple} "
                             f"(the folds halve it at level 0 and at the upsample into it), "
                             f"got {x.shape[-1]}")
        if (self.label_emb is None) != (y is None):
            raise ValueError("y is the vector condition of a UNet with a label_emb, and only "
                             "of one")
        if cfg_fork and y is not None:
            raise ValueError("cfg_fork forks the time embedding, which y's label_emb is part of")
        dtype = self.out[2].weight.dtype
        t_emb = self.time_embed(timestep_embedding(time_steps, self.channels).to(dtype))
        if y is not None:
            t_emb = t_emb + self.label_emb(y.to(dtype))
        h = x.to(dtype)
        skips = []
        forked = not cfg_fork

        def fork(a):
            nonlocal t_emb, skips, forked
            t_emb = torch.cat([t_emb, t_emb])
            skips = [torch.cat([s, s]) for s in skips]
            forked = True
            return torch.cat([a, a])

        for block in self.input_blocks:
            h = block(h, t_emb, cond, before_attention=None if forked else fork)
            skips.append(h)
        if not forked:
            h = fork(h)
        h = self.middle_block(h, t_emb, cond)
        for block in self.output_blocks:
            h = block(h, t_emb, cond, skip=skips.pop())
        h = self.out[2](norm_silu(self.out, h))
        return (from_s2d(h) if self.s2d else h).float()

    def prepare_gn_conv(self) -> None:
        """Make each ResBlock's int8 weights from its weights as they are now:
        in the int8 modes, call after the weights are set, cast or moved
        (``SDFTask`` does). A no-op in the other modes."""
        for m in self.modules():
            if isinstance(m, ResBlock):
                m.prepare_gn_conv()


def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every Linear, Conv2d, ConvTranspose2d and GRU parameter from
    ``generator`` with the bounds of torch's default init (U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), fan_in the size of ``weight[0]``, and
    U(-1/sqrt(H), 1/sqrt(H)) for a GRU); norms keep scale 1 and bias 0. The
    module must lie on the generator's device."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.GRU):
                bound = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters():
                    p.uniform_(-bound, bound, generator=generator)
    return module


def init_vae_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """``init_weights_`` for the Linear and GRU layers, then U(0, 1), the
    reference's ``torch.rand``, for the learned inputs that modules hold
    themselves (``init_input``, ``dec_init_input``, ``dur_sos_token``)."""
    init_weights_(module, generator)
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, (nn.Linear, nn.GRU)):
                for p in m.parameters(recurse=False):
                    p.uniform_(0.0, 1.0, generator=generator)
    return module
