#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``polyffusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card. It builds the port's CUDA
kernels from the sources in the checkout, holds every kernel against its plain
PyTorch version on the card, holds the full-width fp32 UNet on the card against
the CPU, then drives the main path through the user's entry points: the
full-width ``sdf_chd8bar`` preset in bf16 with seeded random weights, chord
one-hots -> chord encoder -> ``InferenceSession.generate`` at DDIM-50, CFG 5,
for requests of batch 1, 16, 64 and 64. Every phase raises on failure and the
script then exits non-zero without a result. It imports nothing of JAX or of
the JAX package.

Output: progress lines; the card's name and power limit; a ``{"kernels": [...]}``
JSON line (per kernel: launches on the main path, max error, kernel, plain,
library and bound times); and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Kernel against plain version: |got - want| <= atol + rtol |want|, elementwise.
# bf16: both round the output to bf16, so they may differ by an output ulp,
# at most 2^-7 |want|; rtol allows two. atol covers outputs near zero, where the
# kernel's rounding of P before the normalisation (the plain version rounds
# after it) moves the fp32 value by about 1e-4.
BF16_ATOL, BF16_RTOL = 2e-3, 2**-6
FP32_ATOL, FP32_RTOL = 1e-5, 0.0  # reassociation of the online softmax
UNET_ATOL, UNET_RTOL = 2e-4, 1e-4  # the UNet tolerance of tests/test_unet_parity.py:68
MAIN_BATCHES = (1, 16, 64, 64)
LAUNCHES_PER_REQUEST = 550  # 11 self-attention sites x 50 DDIM steps, CFG in one double batch


def log(msg: str) -> None:
    print(msg, flush=True)


def time_in_turns(fns: dict, rounds: int = 7, inner: int = 3) -> dict:
    """Median ms per call of each function, timed with CUDA events, the
    functions taking turns within every round (order reversed every other round).
    A device-side sleep ahead of each timed window lets the host queue all of
    its launches first, so that a kernel shorter than its launch cost is timed
    by the device and not by the host."""
    import torch

    samples = {name: [] for name in fns}
    names = list(fns)
    for name in names:  # warm up
        fns[name]()
    torch.cuda.synchronize()
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(10_000_000)  # some 5 ms at the H100's clock
            start.record()
            for _ in range(inner):
                fns[name]()
            end.record()
            torch.cuda.synchronize()
            samples[name].append(start.elapsed_time(end) / inner)
    return {name: statistics.median(v) for name, v in samples.items()}


def attention_bound(b, t, h, d, dtype_name, itemsize):
    ops = 4 * b * h * t * t * d
    nbytes = 4 * b * t * h * d * itemsize
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def limit_ratio(got, want, atol, rtol) -> float:
    """max of |got - want| / (atol + rtol |want|): at most 1 within the limit."""
    want = want.float()
    return ((got.float() - want).abs() / (atol + rtol * want.abs())).max().item()


def check_packed_attention():
    """Kernel against plain version (and SDPA as a yardstick) at the main path's
    shapes. At each shape the limit is also shown to catch a planted fault: the
    plain version with the last key tile dropped, which is what the kernel
    would return if its key loop stopped one tile short."""
    import torch
    import torch.nn.functional as F

    from polyffusion_tpu_torch.ops.fused_attention import (
        TILE,
        packed_attention_reference,
        packed_self_attention,
    )

    cases = [  # (B, T, H, D, dtype, atol, rtol)
        (128, 1024, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        (128, 256, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        (16, 1024, 4, 64, torch.float32, FP32_ATOL, FP32_RTOL),
        (16, 256, 4, 64, torch.float32, FP32_ATOL, FP32_RTOL),
    ]
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, t, h, d, dtype, atol, rtol in cases:
        q, k, v = (torch.randn(b, t, h * d, device="cuda", generator=g).to(dtype) for _ in range(3))
        scale = d**-0.5
        got = packed_self_attention(q, k, v, scale, h)
        torch.cuda.synchronize()
        want = packed_attention_reference(q, k, v, scale, h)
        err = (got.float() - want.float()).abs().max().item()
        ratio = limit_ratio(got, want, atol, rtol)
        fault = packed_attention_reference(q, k[:, :-TILE], v[:, :-TILE], scale, h)
        fault_ratio = limit_ratio(fault, want, atol, rtol)
        del fault
        if not ratio <= 1.0:
            raise AssertionError(f"packed_attention B={b} T={t} {dtype}: max_abs_err {err}, "
                                 f"{ratio:.3g} x the limit (atol {atol}, rtol {rtol})")
        if not fault_ratio > 1.0:
            raise AssertionError(f"the limit at B={b} T={t} {dtype} does not catch a dropped "
                                 f"key tile ({fault_ratio:.3g} x the limit)")
        views = [x.view(b, t, h, d).transpose(1, 2) for x in (q, k, v)]
        ms = time_in_turns({
            "kernel": lambda: packed_self_attention(q, k, v, scale, h),
            "plain": lambda: packed_attention_reference(q, k, v, scale, h),
            "library": lambda: F.scaled_dot_product_attention(*views, scale=scale),
        })
        dname = str(dtype).split(".")[1]
        bound, bound_by = attention_bound(b, t, h, d, dname, q.element_size())
        row = dict(shape=f"B={b} T={t} H={h} D={d} {dname}", max_abs_err=err, atol=atol,
                   rtol=rtol, limit_ratio=ratio, fault_limit_ratio=fault_ratio,
                   ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
                   bound_ms=bound, bound_by=bound_by)
        log(f"[kernel] packed_attention {row['shape']}: max_abs_err {err:.3g}, "
            f"{ratio:.3g} x the limit (atol {atol}, rtol {rtol:.3g}; one dropped key tile: "
            f"{fault_ratio:.3g} x)  "
            f"kernel {ms['kernel']:.4f} ms  plain {ms['plain']:.4f} ms  "
            f"sdpa {ms['library']:.4f} ms  bound {bound:.4f} ms ({bound_by})")
        rows.append(row)
        del q, k, v, got, want, views
    return rows


def full_cfg(bf16: bool):
    from polyffusion_tpu_torch.config import load_params

    cfg = load_params("sdf_chd8bar")
    cfg.bf16 = bf16
    return cfg


def make_task(cfg, device, seed):
    import torch

    from polyffusion_tpu_torch.models import ChordEncoder
    from polyffusion_tpu_torch.tasks import SDFTask

    enc = ChordEncoder(cfg.chd_input_dim, cfg.chd_hidden_dim, cfg.chd_z_dim)
    return SDFTask(cfg, enc, device=device, generator=torch.Generator().manual_seed(seed))


def check_unet_against_cpu():
    """One full-width fp32 UNet eval at batch 2 doubled by CFG: the card (with
    the kernel) against the CPU (with the plain version)."""
    import torch

    cfg = full_cfg(bf16=False)
    gpu = make_task(cfg, "cuda", seed=1)
    cpu = make_task(cfg, "cpu", seed=1)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 2, 128, 128)).astype(np.float32))
    t = torch.tensor([981, 401], dtype=torch.int32)
    cond = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_cond)).astype(np.float32))
    x2, t2 = torch.cat([x, x]), torch.cat([t, t])
    c2 = torch.cat([-torch.ones_like(cond), cond])
    with torch.inference_mode():
        t0 = time.perf_counter()
        got = gpu.apply_eps(x2.cuda(), t2.cuda(), c2.cuda()).cpu()
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = cpu.apply_eps(x2, t2, c2)
        t_cpu = time.perf_counter() - t0
    err = (got - want).abs()
    ok = bool((err <= UNET_ATOL + UNET_RTOL * want.abs()).all())
    log(f"[unet] full-width fp32 (B=4) card vs CPU: max_abs_err {err.max().item():.3g} "
        f"(atol {UNET_ATOL}, rtol {UNET_RTOL}), |out| max {want.abs().max().item():.3g}, "
        f"card {t_gpu:.2f} s (first call), CPU {t_cpu:.2f} s")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError("full-width UNet on the card disagrees with the CPU")


def random_chords(rng, b):
    """(B, 32, 36) chord one-hots: root one-hot | chroma multi-hot | bass one-hot."""
    chords = np.zeros((b, 32, 36), np.float32)
    rows = np.arange(32)
    for i in range(b):
        chords[i, rows, rng.integers(0, 12, 32)] = 1.0
        chords[i, :, 12:24] = rng.integers(0, 2, (32, 12))
        chords[i, rows, 24 + rng.integers(0, 12, 32)] = 1.0
    return chords


def drive_main_path(packed_self_attention):
    """DDIM-50 CFG-5 requests at full width in bf16; returns the total launches."""
    import torch

    from polyffusion_tpu_torch.inference import InferenceSession

    cfg = full_cfg(bf16=True)
    task = make_task(cfg, None, seed=0)
    session = InferenceSession(task, ddim_steps=50, seed=0)
    rng = np.random.default_rng(0)
    total = 0
    with tempfile.TemporaryDirectory() as out_dir:
        for i, b in enumerate(MAIN_BATCHES):
            chords = torch.from_numpy(random_chords(rng, b))
            # the first request also writes its .mid (host time: random weights
            # give dense rolls, and a 64-piece file takes seconds to write)
            write = i == 0
            packed_self_attention.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cond = task.encode_chord(chords)
            gen = session.generate(cond, uncond_scale=5.0, output_dir=out_dir if write else None)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n = packed_self_attention.launches
            total += n
            log(f"[main] request {i}: batch {b}: {secs:.3f} s, {b / secs:.3f} samples/s, "
                f"packed_attention launches {n}{', .mid written' if write else ''}")
            if n != LAUNCHES_PER_REQUEST:
                raise AssertionError(f"expected {LAUNCHES_PER_REQUEST} launches, got {n}")
            if gen.shape != (b, 2, 128, 128) or not np.isfinite(gen).all():
                raise AssertionError(f"bad output: shape {gen.shape}, finite {np.isfinite(gen).all()}")
        mids = [f for f in os.listdir(out_dir) if f.endswith(".mid")]
        if len(mids) != 1 or os.path.getsize(os.path.join(out_dir, mids[0])) == 0:
            raise AssertionError(f"expected one non-empty .mid, found {mids}")
        log(f"[main] wrote {mids[0]}")
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from polyffusion_tpu_torch.device import tf32
    from polyffusion_tpu_torch.ops import _build
    from polyffusion_tpu_torch.ops.fused_attention import packed_self_attention

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    tf32(False)

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} source(s) in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    rows = check_packed_attention()
    check_unet_against_cpu()

    packed_self_attention.launches = 0
    launches = drive_main_path(packed_self_attention)
    if launches == 0:
        raise AssertionError("the main path never launched packed_attention")

    main_row = rows[0]  # B=128 T=1024 bf16: the main path's dominant shape
    kernels = [{
        "name": "packed_attention",
        "route": "cuda",
        "source": "polyffusion_tpu_torch/ops/csrc/packed_attention.cu",
        "replaces": "polyffusion_tpu/ops/fused_attention.py:53",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows[:2]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "at": main_row["shape"],
        "shapes": rows,
    }]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
