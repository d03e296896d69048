"""Cells at a size the CPU runs in seconds: the benchmark's own cells with
the widths cut and short traffic, for the CPU tests of the harness."""

from __future__ import annotations

import copy

from cardbench import spec as specs

TINY = {
    "sdf_chd8bar": {"channels": 32, "channel_multipliers": [1, 1], "attention_levels": [1],
                    "n_res_blocks": 1, "n_heads": 2, "d_cond": 16, "chd_hidden_dim": 8,
                    "chd_z_dim": 16, "img_h": 16, "img_w": 16, "n_steps": 100, "bf16": False,
                    "precision": "fp32"},
    "ddpm": {"n_channels": 32, "channel_multipliers": [1, 2], "is_attention": [False, True],
             "image_size_h": 16, "image_size_w": 16, "n_steps": 100},
}
TRAFFIC = {"generate": {"batch": 3, "ddim_steps": 5, "check_rows": 4},
           "train": {"batch": 4, "reference_block": 3, "trace_steps": 2, "pool": 4},
           "serve": {"batch": 3, "ddim_steps": 5, "rate": 6.0, "check_requests": 3,
                     "trace_seconds": 1.0}}


def tiny_spec(cell: str, bf16: bool = False) -> specs.Spec:
    """The cell's spec with TINY's widths and TRAFFIC's sizes; ``bf16``: an
    sdf configuration computed in bf16 on fp32 masters, as the full one is."""
    s = specs.load(cell, held=True)
    s = copy.deepcopy(s)
    s.config.update(TINY[s.cell["config"]])
    if bf16:
        s.config.update(bf16=True, precision="bf16")
    s.traffic.update(TRAFFIC[s.traffic["driver"]])
    return s
