"""Attention dispatch (counterpart of ``polyffusion_tpu/ops/attention.py``).

Self-attention whose length is a multiple of the kernel's tile and whose head
dim the kernel takes goes to ``packed_self_attention``: the CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor. Everything else (on the UNet's
path the cross-attention over the condition: one token, or SDXL's 77) runs
that plain version, with fp32 logits and softmax, on any device.

Counters (``tracing.counters()``): ``ops.attention.plain_calls``, the calls
that took the plain version, and ``ops.attention.plain_cross_calls``, those
of them whose keys are another sequence than the queries (a key length other
than the query length: a cross-attention).
"""

from __future__ import annotations

import torch

from .. import tracing
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
        multihead_attention.plain_calls += 1
        multihead_attention.plain_cross_calls += int(tq != tk)
        out = packed_attention_reference(*packed, scale, h)
    return out.reshape(b, tq, h, d)


multihead_attention.plain_calls = 0
multihead_attention.plain_cross_calls = 0
tracing.register("ops.attention.plain_calls", multihead_attention, "plain_calls")
tracing.register("ops.attention.plain_cross_calls", multihead_attention, "plain_cross_calls")
