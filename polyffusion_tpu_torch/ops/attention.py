"""Attention dispatch (counterpart of ``polyffusion_tpu/ops/attention.py``).

Self-attention whose length is a multiple of the kernel's tile and whose head
dim the kernel takes goes to ``packed_self_attention``: the CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor. Everything else (on the UNet's
path only the cross-attention over the n_cond = 1 condition) runs that plain
version, with fp32 logits and softmax, on any device.
"""

from __future__ import annotations

import torch

from .fused_attention import HEAD_DIMS, TILE, packed_attention_reference, packed_self_attention


def multihead_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """(B, Tq, H, D) x (B, Tk, H, D) -> (B, Tq, H, D)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    # (B, T, H, D) -> (B, T, H*D) is a free view; the kernel reads heads by stride
    packed = [x.reshape(b, x.shape[1], h * d) for x in (q, k, v)]
    if tq == tk and tq % TILE == 0 and d in HEAD_DIMS:
        out = packed_self_attention(*packed, scale, h)
    else:
        out = packed_attention_reference(*packed, scale, h)
    return out.reshape(b, tq, h, d)
