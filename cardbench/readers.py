"""Arithmetic the per-layer readers (``metrics/*.py``) share: the peak of
the configuration's precision, FLOPs and kernel sites of the reference at a
cell's shapes, a kernel's share of its roofline over a profiled slice."""

from __future__ import annotations

import json
import sys
from functools import lru_cache

from . import yardstick as Y

PRECISION_PEAK = {"bf16": "bfloat16", "tf32": "tf32", "fp32": "float32"}


def peak_flops(spec) -> float:
    return Y.PEAK_OPS_PER_S[PRECISION_PEAK[spec.config["precision"]]]


def itemsize(spec) -> int:
    return Y.ITEMSIZE[PRECISION_PEAK[spec.config["precision"]]]


@lru_cache(maxsize=None)
def _flops(family, config_json: str, batch: int) -> int:
    cfg = json.loads(config_json)
    return Y.forward_flops(family.meta_unet(cfg), *family.eval_inputs(cfg, batch, "meta"))


@lru_cache(maxsize=None)
def _sites(family, config_json: str, batch: int) -> Y.Sites:
    cfg = json.loads(config_json)
    return Y.sites(family.meta_unet(cfg), *family.eval_inputs(cfg, batch, "meta"))


def forward_flops(spec, batch: int) -> int:
    """FLOPs of one forward of the reference UNet at ``batch``."""
    return _flops(spec.family, json.dumps(spec.config, sort_keys=True), batch)


def sites(spec, batch: int) -> Y.Sites:
    """The self-attention and GroupNorm sites of one forward at ``batch``."""
    return _sites(spec.family, json.dumps(spec.config, sort_keys=True), batch)


def idle_share(ctx):
    """The card's idle share of the window, in %: the profiled slice's
    device busy time a unit (an evaluation, a step, a pass), which the
    profiler does not stretch, times the window's units, over the window's
    seconds; the slice's own wall time is stretched by the profiler's host
    work."""
    trace = ctx.get("trace")
    if trace is None or not trace.device or not trace.units or not ctx.get("units"):
        return None
    busy = Y.busy_us(trace.device) / 1e6 / trace.units * ctx["units"]
    return 100.0 * (1.0 - busy / ctx["seconds"])


def roofline(ctx, fragment: str, bound_ms_per_unit: float, launches_per_unit: int = None):
    """100 x (least ms per unit x units) / (device ms of the kernels whose
    names hold ``fragment``); nothing when the slice holds none of them, or
    (with ``launches_per_unit``) another number of launches than the model
    makes."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    us, n = Y.kernel_us(trace, fragment)
    if n == 0:
        return None
    if launches_per_unit is not None and n != launches_per_unit * trace.units:
        print(f"[readers] {fragment}: {n} launches in {trace.units} units, "
              f"expected {launches_per_unit} a unit", file=sys.stderr)
        return None
    return 100.0 * bound_ms_per_unit * trace.units / (us / 1e3)
