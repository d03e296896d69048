"""Stable-Diffusion-style conditional UNet (counterpart of ``polyffusion_tpu/models/unet.py``,
without its space-to-depth, XLA-int8 and ``cfg_fork`` branches).

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
the int8 weights once). Parameter names and shapes are the same in every mode.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multihead_attention
from ..ops.fused_gn_conv import (
    gn_silu_conv3x3,
    gn_silu_conv3x3_concat,
    gn_silu_conv3x3_concat_q,
    gn_silu_conv3x3_q,
    quantize_conv_kernel,
)
from ..ops.gn_bwd import gn_affine, group_norm_affine

GN_CONV_MODES = ("unfused", "fused", "int8")


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
    plain DDPM UNet's final norm has 8)."""

    def __init__(self, channels: int, eps: float = 1e-5, groups: int = 32):
        super().__init__()
        if channels % groups:
            raise ValueError(f"GroupNorm needs channels divisible by {groups}, got {channels}")
        self.eps = eps
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_affine(x, self.weight, self.bias, self.groups, self.eps)


def _conv3x3(c_in: int, c_out: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, stride=stride, padding=1)


class ResBlock(nn.Module):
    """GN -> SiLU -> conv, + time embedding, GN -> SiLU -> conv, + skip.

    ``skip``: the decoder's skip tensor; the block then acts on the channel
    concat [x, skip], which the fused modes never build (as the JAX package's
    ``ResBlock(skip=...)`` does) and the unfused one builds."""

    def __init__(self, channels: int, d_t_emb: int, out_channels: Optional[int] = None,
                 gn_conv: str = "unfused"):
        super().__init__()
        if gn_conv not in GN_CONV_MODES:
            raise ValueError(f"gn_conv must be one of {GN_CONV_MODES}, got {gn_conv!r}")
        out = out_channels or channels
        self.gn_conv = gn_conv
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(), _conv3x3(channels, out))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(d_t_emb, out))
        # index 2 stands where the reference keeps its Dropout
        self.out_layers = nn.Sequential(GroupNorm32(out), nn.SiLU(), nn.Identity(), _conv3x3(out, out))
        self.skip_connection = nn.Identity() if out == channels else nn.Conv2d(channels, out, 1)
        self._int8 = None  # per conv: (weight data_ptr, int8 weight, scales)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.gn_conv == "unfused":
            if skip is not None:
                x = torch.cat([x, skip], dim=1)
            h = self.in_layers(x)
            h = h + self.emb_layers(t_emb).to(h.dtype)[:, :, None, None]
            return self.skip_connection(x) + self.out_layers(h)
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

    def _gn_conv(self, i, x, a, off, x2=None, a2=None, off2=None, residual=None):
        """Site i (0: in_layers, 1: out_layers) through kernel 4 or 5."""
        conv = (self.in_layers[2], self.out_layers[3])[i]
        if self.gn_conv == "fused":
            if x2 is None:
                return gn_silu_conv3x3(x, a, off, conv.weight, conv.bias, residual)
            return gn_silu_conv3x3_concat(x, a, off, x2, a2, off2, conv.weight, conv.bias, residual)
        ptr, w_q, w_scale = self._int8[i] if self._int8 is not None else (None, None, None)
        if ptr != conv.weight.data_ptr():
            raise RuntimeError("gn_conv='int8' needs UNetModel.prepare_gn_conv() after the "
                               "weights are set, cast or moved")
        if x2 is None:
            return gn_silu_conv3x3_q(x, a, off, w_q, w_scale, conv.bias, residual)
        return gn_silu_conv3x3_concat_q(x, a, off, x2, a2, off2, w_q, w_scale, conv.bias, residual)

    @torch.no_grad()
    def prepare_gn_conv(self) -> None:
        """In int8 mode, quantize both 3x3 weights as they are now (once per
        weight, as JAX hoists ``quantize_conv_kernel`` out of its sampling
        loop); a no-op otherwise."""
        if self.gn_conv != "int8":
            self._int8 = None
            return
        self._int8 = [(conv.weight.data_ptr(), *quantize_conv_kernel(conv.weight))
                      for conv in (self.in_layers[2], self.out_layers[3])]


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
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        val, gate = self.proj(x).chunk(2, dim=-1)
        return val * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GeGLU feed-forward, 4x wide; index 1 stands where the reference keeps its Dropout."""

    def __init__(self, d_model: int):
        super().__init__()
        self.net = nn.Sequential(
            GeGLU(d_model, d_model * 4), nn.Identity(), nn.Linear(d_model * 4, d_model)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """pre-LN self-attention -> cross-attention -> GeGLU FF. The LayerNorms run
    in fp32 with flax's default epsilon 1e-6."""

    def __init__(self, d_model: int, n_heads: int, d_head: int, d_cond: int):
        super().__init__()
        self.attn1 = CrossAttention(d_model, d_model, n_heads, d_head)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.attn2 = CrossAttention(d_model, d_cond, n_heads, d_head)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.ff = FeedForward(d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x.float()).to(x.dtype)) + x
        x = self.attn2(self.norm2(x.float()).to(x.dtype), cond.to(x.dtype)) + x
        return self.ff(self.norm3(x.float()).to(x.dtype)) + x


class SpatialTransformer(nn.Module):
    """GN -> 1x1 conv -> flatten HW -> transformer blocks -> 1x1 conv, + residual."""

    def __init__(self, channels: int, n_heads: int, n_layers: int, d_cond: int):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, n_heads, channels // n_heads, d_cond)
            for _ in range(n_layers)
        )
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        x_in = x
        x = self.proj_in(self.norm(x))
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, cond)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(x) + x_in


class DownSample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = _conv3x3(channels, channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class UpSample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class TimestepEmbedSequential(nn.Sequential):
    """Runs its layers in order, handing each the inputs it takes (``skip`` to
    the first ResBlock)."""

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor, cond: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, t_emb, skip)
                skip = None
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, cond)
            else:
                x = layer(x)
        return x


class UNetModel(nn.Module):
    """The epsilon-prediction UNet: ``x`` (B, in_channels, H, W), ``time_steps``
    (B,), ``cond`` (B, n_cond, d_cond) -> (B, out_channels, H, W) in fp32.
    ``gn_conv``: "unfused", "fused" or "int8" (see the module's docstring)."""

    def __init__(
        self,
        in_channels: int = 2,
        out_channels: int = 2,
        channels: int = 64,
        n_res_blocks: int = 2,
        attention_levels: Sequence[int] = (2, 3),
        channel_multipliers: Sequence[int] = (1, 2, 4, 4),
        n_heads: int = 4,
        tf_layers: int = 1,
        d_cond: int = 512,
        gn_conv: str = "unfused",
    ):
        super().__init__()
        self.channels = channels
        levels = len(channel_multipliers)
        d_time_emb = channels * 4
        self.time_embed = nn.Sequential(
            nn.Linear(channels, d_time_emb), nn.SiLU(), nn.Linear(d_time_emb, d_time_emb)
        )

        def transformer(ch):
            return SpatialTransformer(ch, n_heads, tf_layers, d_cond)

        self.input_blocks = nn.ModuleList(
            [TimestepEmbedSequential(_conv3x3(in_channels, channels))]
        )
        skip_channels = [channels]
        channels_list = [channels * m for m in channel_multipliers]
        ch = channels
        for i in range(levels):
            for _ in range(n_res_blocks):
                layers = [ResBlock(ch, d_time_emb, channels_list[i], gn_conv)]
                ch = channels_list[i]
                if i in attention_levels:
                    layers.append(transformer(ch))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                skip_channels.append(ch)
            if i != levels - 1:
                self.input_blocks.append(TimestepEmbedSequential(DownSample(ch)))
                skip_channels.append(ch)

        self.middle_block = TimestepEmbedSequential(
            ResBlock(ch, d_time_emb, gn_conv=gn_conv), transformer(ch),
            ResBlock(ch, d_time_emb, gn_conv=gn_conv)
        )

        self.output_blocks = nn.ModuleList()
        for i in reversed(range(levels)):
            for j in range(n_res_blocks + 1):
                layers = [ResBlock(ch + skip_channels.pop(), d_time_emb, channels_list[i], gn_conv)]
                ch = channels_list[i]
                if i in attention_levels:
                    layers.append(transformer(ch))
                if i != 0 and j == n_res_blocks:
                    layers.append(UpSample(ch))
                self.output_blocks.append(TimestepEmbedSequential(*layers))

        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), _conv3x3(ch, out_channels))

    def forward(self, x: torch.Tensor, time_steps: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        dtype = self.out[2].weight.dtype
        t_emb = self.time_embed(timestep_embedding(time_steps, self.channels).to(dtype))
        h = x.to(dtype)
        skips = []
        for block in self.input_blocks:
            h = block(h, t_emb, cond)
            skips.append(h)
        h = self.middle_block(h, t_emb, cond)
        for block in self.output_blocks:
            h = block(h, t_emb, cond, skip=skips.pop())
        return self.out(h).float()

    def prepare_gn_conv(self) -> None:
        """Make each ResBlock's int8 weights from its weights as they are now:
        in int8 mode, call after the weights are set, cast or moved
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
