"""What the traffic drivers share: the profiled slice, the comparisons that
decide ``correct``, and the record a driver hands back."""

from __future__ import annotations

import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..yardstick import Trace, trace_of


@dataclass
class Outcome:
    """One run's result before the metrics are read: end-to-end values, the
    counts, each compared number with its limit, what the per-layer readers
    read (``ctx``), the peak device memory and the profiled slice."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]
    ctx: Dict = field(default_factory=dict)
    peak_bytes: int = 0
    trace: Optional[Trace] = None


def stamp(t0: float, what: str) -> None:
    """Where set-up's time goes: seconds since the process started."""
    print(f"[setup] {what} at {time.perf_counter() - t0:.2f} s", file=sys.stderr)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def profiled(fn: Callable[[], int], device) -> Trace:
    """``fn`` (which returns how many units it ran) under ``torch.profiler``,
    CPU and CUDA activity, ending in a synchronize; the slice's wall seconds
    by the host clock."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        units = fn()
        sync(device)
        wall = time.perf_counter() - t0
    return trace_of(prof, wall, units)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def release(device) -> None:
    """Return the program's freed memory to the card before the reference."""
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest relative distance of a row: max over rows of
    ||got - want|| / ||want||, in float64."""
    got, want = got.double().flatten(1), want.double().flatten(1).to(got.device)
    return float(((got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-30)).max())


def leaf_gap(got: Dict[str, float], want: Dict[str, float], keep: Optional[List[str]] = None):
    """The worst leaf's |got - want| over the larger of want and the median
    leaf's want (norms per leaf), over the leaves in ``keep`` (all by default);
    returns (gap, leaf)."""
    names = list(want) if keep is None else keep
    med = statistics.median(want[n] for n in names)
    worst, leaf = 0.0, None
    for n in names:
        g = abs(got[n] - want[n]) / max(want[n], med, 1e-30)
        if g > worst or leaf is None:
            worst, leaf = g, n
    return worst, leaf
