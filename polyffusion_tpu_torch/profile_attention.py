"""Host and device cost per launch of the attention kernels 1, 2 and 3 on the card.

    python -m polyffusion_tpu_torch.profile_attention

For each shape it prints one JSON line: the host microseconds per call of the
public op (a host clock around a run of calls that ends before the device
does: what a host-bound request pays per launch, wrapper, argument checks,
output allocation and launch included) and the device milliseconds per call
(CUDA events around a queued run), with the card's name and power limit.
Kernel 1 is ``packed_self_attention`` under ``no_grad``, kernel 3
``fused_self_attention`` under ``no_grad``, kernel 2 ``packed_attention_bwd``
given the forward's row log-sum-exp, each at the shapes of ``PERF.md``
(``SHAPES``). Every call of a shape passes the same tensors, so the bf16
kernels' tensor maps always come from their cache here;
``map_cache_counts`` reads that cache's hits and misses on a real path.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import time

import torch

from .ops.fused_attention import (
    fused_self_attention,
    packed_attention_bwd,
    packed_attention_lse_reference,
    packed_self_attention,
)

CALLS = 200  # fewer than the launch queue holds: the host never waits on the card
ROUNDS = 5


def _host_and_device(fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(ROUNDS):
        torch.cuda._sleep(50_000_000)  # the card stays busy while the host enqueues
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        host.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end) / CALLS)
    return sorted(host)[ROUNDS // 2], sorted(device)[ROUNDS // 2]


# (kernel, shape): kernel 1 at the sampling, CLI and training shapes (B, T)
# with 4 heads of 64; kernel 2 at the train step's; kernel 3 at the
# head-major shapes (BH, T, D) of PERF.md
SHAPES = [("packed_attention", (b, t)) for b, t in
          ((128, 1024), (128, 256), (4, 1024), (4, 256), (16, 1024), (16, 256))]
SHAPES += [("packed_attention_bwd", (16, 1024)), ("packed_attention_bwd", (16, 256))]
SHAPES += [("head_major_attention", s) for s in
           ((512, 1024, 64), (512, 256, 64), (3, 1000, 128), (4, 200, 64))]


def measure():
    """One dict per shape: kernel, shape, host_us_per_call, device_ms_per_call."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, dims in SHAPES:
        if name == "head_major_attention":
            bh, t, d = dims
            q, k, v = (torch.randn(bh, t, d, device="cuda", generator=g, dtype=torch.bfloat16)
                       for _ in range(3))
            shape = f"BH={bh} T={t} D={d} bfloat16"

            def fn():
                with torch.no_grad():
                    fused_self_attention(q, k, v, d**-0.5)
        else:
            (b, t), h, d = dims, 4, 64
            q, k, v, do = (torch.randn(b, t, h * d, device="cuda", generator=g,
                                       dtype=torch.bfloat16) for _ in range(4))
            shape = f"B={b} T={t} H={h} D={d} bfloat16"
            if name == "packed_attention":
                def fn():
                    with torch.no_grad():
                        packed_self_attention(q, k, v, d**-0.5, h)
            else:
                lse = packed_attention_lse_reference(q, k, d**-0.5, h)

                def fn():
                    packed_attention_bwd(q, k, v, do, d**-0.5, h, lse=lse)
        host_us, device_ms = _host_and_device(fn)
        rows.append({"kernel": name, "shape": shape, "host_us_per_call": host_us,
                     "device_ms_per_call": device_ms})
        del q, k, v
    return rows


def map_cache_counts():
    """{source: (hits, misses)} of the tensor-map cache (``csrc/hopper.cuh``)
    in each bf16 attention kernel's library, summed over the process so far."""
    from .ops._build import load

    out = {}
    for source in ("packed_attention", "packed_attention_bwd"):
        fn = load(source).tensor_map_cache_counts
        fn.argtypes, fn.restype = [ctypes.c_void_p], None
        counts = (ctypes.c_longlong * 2)()
        fn(counts)
        out[source] = (counts[0], counts[1])
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_attention: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for row in measure():
        print(json.dumps({**row, "card": card}))


if __name__ == "__main__":
    main()
