"""Attention and the port's hand-written CUDA kernels (built at first use)."""

from .attention import multihead_attention  # noqa: F401
from .fused_attention import (  # noqa: F401
    fused_self_attention,
    head_major_attention_reference,
    packed_attention_reference,
    packed_self_attention,
)
