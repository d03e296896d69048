#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``polyffusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card. It builds the port's CUDA
kernels from the sources in the checkout (one ``nvcc`` per source, in
parallel), holds every kernel against its plain PyTorch version on the card
(with a planted fault that must fail each limit; kernels 3 and 4's gradients
through their autograd functions too; kernel 1's row log-sum-exp, the
forward's second output, against its plain version; kernel 2 given that lse,
as the train step gives it), logs the host microseconds per launch of
kernels 1-3 (``profile_attention``) and the tensor-map cache's hits and
misses on each main path, holds the full-width fp32 UNet eval (with the
GroupNorm-SiLU-conv sites unfused and fused), one full-width fp32 train step
and a full-width fp32 DDPM RePaint run on the card against the CPU, and the
full-width bf16 UNet's int8 eps against its fused eps, then drives the main paths through the user's entry points, each with the
kernels' launch counts set to 0 just before it and read just after:

- sampling: the full-width ``sdf_chd8bar`` preset in bf16 with seeded random
  weights, chord one-hots -> chord encoder -> ``InferenceSession.generate`` at
  DDIM-50, CFG 5, for requests of batch 1, 16, 64 and 64; then two requests
  at batch 64 with ``gn_conv="fused"`` (kernel 4 at all 44 sites of every UNet
  eval) and two with ``gn_conv="int8"`` (kernel 5);
- training: ``polyffusion_tpu_torch.main`` on synthetic songs with a seeded
  random ``chd8bar.pt``, the same preset in bf16 at its batch 16, 30 steps with
  one validation and one checkpoint, then ``--resume`` for 6 more;
- the inference CLI, ``polyffusion_tpu_torch.inference.main``, on the run
  directory the training wrote: (A) the default DDPM-1000 RePaint inpainting
  of a song's lower voices (``--inpaint_type below``, 2 segments, CFG 5), then
  (B) piece-batched long-form generation at DDIM-50 (``--autoreg --ddim``,
  3 segments, 2 pieces, CFG 5), then (C) ``--gn_conv int8 --ddim`` over 2
  segments; and a profiled window of request A's steps;
- the head-major attention (kernel 3, on no model path as in the JAX
  package): its public op called directly at (512, 1024 / 256, 64) bf16;
- the texture and PianoTree conditions, with seeded random ``polydis.pt`` and
  ``pnotree.pt`` beside the training's ``chd8bar.pt``: the five presets'
  conditions and an ``sdf_chd8bar_txt`` UNet eval on the card against the
  CPU, a DDIM-50 CFG-5 request of ``sdf_chd8bar_txt`` at batch 64 and of
  ``sdf_txtvnl`` at batch 16, ``sdf_chd8bar_txt_mix2`` trained for 12 steps
  through ``polyffusion_tpu_torch.main`` and sampled through the CLI.

Every phase raises on failure and the script then exits non-zero without a
result. It imports nothing of JAX or of the JAX package.

Output: progress lines (``nvcc -Xptxas -v``'s registers and spills of every
kernel among them); the card's name and power limit; a ``{"kernels": [...]}``
JSON line (per kernel: launches on the main paths, max error, kernel, plain,
library and bound times; for kernels 1-3 the host microseconds per launch);
and last ``{"ok": true, "device": {...}}``.
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
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# Kernel against plain version: |got - want| <= atol + rtol |want|, elementwise.
# bf16: both round the output to bf16, so they may differ by an output ulp,
# at most 2^-7 |want|; rtol allows two. atol covers outputs near zero, where the
# kernel's rounding of P before the normalisation (the plain version rounds
# after it) moves the fp32 value by about 1e-4.
BF16_ATOL, BF16_RTOL = 2e-3, 2**-6
FP32_ATOL, FP32_RTOL = 1e-5, 0.0  # reassociation of the online softmax
# The bf16 forward's row log-sum-exp (fp32) against the plain one: the order of
# the fp32 sums and exp2 of a scaled difference against exp; the planted fault
# is the plain lse without the last key tile.
LSE_ATOL, LSE_RTOL = 1e-5, 0.0
UNET_ATOL, UNET_RTOL = 2e-4, 1e-4  # the UNet tolerance of tests/test_unet_parity.py:68
# Attention backward against its plain version, elementwise on dq, dk, dv.
# bf16: both round Pc and dS to bf16 before their products and the outputs to
# bf16, so they may differ by an output ulp (<= 2^-7 |want|), rtol allows two;
# atol covers outputs near zero, where a dS element whose fp32 value lies near
# a rounding boundary and rounds the other way moves a sum of T products (the
# worst such reading on the card: 0.00195 at |want| ~ 0.06, T = 256).
# fp32: the order of the fp32 sums only.
BWD_BF16_ATOL, BWD_BF16_RTOL = 2e-3, 2**-6
BWD_FP32_ATOL, BWD_FP32_RTOL = 1e-6, 0.0
# GroupNorm backward against its plain version: dx elementwise (bf16: two
# output ulps and a little near zero; fp32: the order of the group sums);
# dgamma and dbeta are fp32 sums over B*H*W elements taken in another order.
GN_BF16_ATOL, GN_BF16_RTOL = 1e-4, 2**-6
GN_FP32_ATOL, GN_FP32_RTOL = 1e-6, 1e-6
GN_PARAM_ATOL, GN_PARAM_RTOL = 1e-3, 1e-5
# One fp32 train step, card against CPU: the loss and the gradients' norm to
# fp32 reassociation over the whole UNet; each parameter's gradient in
# relative norm (cuDNN's and the CPU's convolutions sum in other orders); the
# parameters after one Adam step of lr 5e-5, which moves an element by
# lr g / (|g| + 1e-8): where a gradient is within a few 1e-8 of zero, rounding
# decides the update, anywhere in (-lr, lr), so the parameters agree within
# 2 lr everywhere and within 1e-7 in all but 0.1 % of the elements.
STEP_LOSS_RTOL, STEP_NORM_RTOL, STEP_GRAD_RTOL = 1e-5, 1e-4, 1e-4
STEP_PARAM_TIGHT, STEP_PARAM_SHARE = 1e-7, 1e-3
# RePaint epilogue (kernel 7) against its plain version, elementwise. Both
# take the same fp32 products; the kernel may contract a product and a sum into
# one FMA, which moves a result by an ulp of the intermediates (x0 = a x - b eps
# reaches some 60 at step 999, where a = sqrt_recip_alpha_bar ~ 14.6). The
# sound kernel's worst reading on an H100 was 9.5e-7, 0.019 x this limit; the
# planted fault (the blend ignoring the mask) reads 3.4e5 x it.
EPI_ATOL, EPI_RTOL = 1e-5, 1e-5
EPI_STEPS = (999, 500, 0)
# A full-width fp32 DDPM RePaint run, card against CPU: the tolerance of the
# port's sampler parity tests (tests/test_torch_slice.py, test_torch_ddpm.py)
PAINT_ATOL, PAINT_RTOL = 2e-3, 1e-3
PAINT_T_START, PAINT_REPAINT_N = 2, 2
MAIN_BATCHES = (1, 16, 64, 64)
LAUNCHES_PER_REQUEST = 550  # 11 self-attention sites x 50 DDIM steps, CFG in one double batch
# the training path: the full-width preset in bf16 at its batch 16
TRAIN_SONGS, TRAIN_STEPS, RESUME_STEPS, LOG_EVERY = 40, 30, 6, 10
# per step: 11 self-attention sites forward (kernel 1) and backward (kernel 2);
# 56 GroupNorm32 backwards (kernel 6): 22 ResBlocks x 2, 11 SpatialTransformer
# norms and the output norm (counted from the modules by count_sites)
ATTENTION_SITES, GROUPNORM_SITES = 11, 56
# the inference CLI's requests: (A) DDPM over all 1000 steps at repaint_n 1,
# one epilogue and one UNet eval per step; (B) 2 x 3 - 1 = 5 windows of DDIM-50
CLI_SONG, CLI_A_SEGMENTS, CLI_B_SEGMENTS, CLI_B_PIECES = "song000.npz", 2, 3, 2
CLI_DDPM_STEPS, CLI_DDIM_STEPS = 1000, 50
PROFILE_STEPS = 50
# Kernel 4 (fused GroupNorm-SiLU-conv3x3) against its plain version, elementwise.
# bf16: both round the SiLU output and w to bf16 (products exact in fp32) and
# differ in the order of the fp32 sums, then round the output once: an output
# ulp (2^-8 |want|), rtol allows two; atol covers outputs near zero. fp32:
# the order of the sums only.
GNC_BF16_ATOL, GNC_BF16_RTOL = 1e-3, 2**-6
GNC_FP32_ATOL, GNC_FP32_RTOL = 1e-5, 1e-5
# kernel 4's gradient (a backward through the plain version) against the plain
# version's autograd, per input in norm: the train step's gradient tolerance
GNC_GRAD_RTOL = 1e-4
# Kernel 5 (int8) against its plain version: the same quantized operands, an
# exact int32 sum against an fp32 sum of integers (exact here), and a rescale
# in another order: fp32 the JAX package's emulation tolerance
# (tests/test_int8_gn_conv.py:50), bf16 as kernel 4.
GNQ_FP32_ATOL, GNQ_FP32_RTOL = 1e-3, 1e-5
# int8 eps against fused eps of the full-width bf16 UNet: the bound of the JAX
# package's tests/test_int8_gn_conv.py:190
INT8_EPS_REL = 0.05
# Kernel 3 (head-major attention) against its plain version: kernel 1's limits.
# Shapes (BH, T, D): the JAX package's tests', ragged T (the kernel takes any
# T >= 1), each in fp32 and bf16; then a batch-128 level-2 / level-3
# self-attention (4 heads) in head-major form, bf16.
HEAD_MAJOR_SHAPES = [(8, 256, 64), (4, 1024, 64), (6, 128, 128), (7, 256, 64), (4, 200, 64),
                     (3, 1000, 128)]
HEAD_MAJOR_MODEL = [(512, 1024, 64), (512, 256, 64)]
# the texture and PianoTree conditions: the encoders card against CPU within the
# encoder tolerance of tests/test_torch_encoders.py:25-26
COND_ATOL = 2e-5
COND_PRESETS = ("sdf_txt", "sdf_txtvnl", "sdf_chd8bar_txt", "sdf_chd8bar_txt_mix2", "sdf_pnotree")
COND_REQUESTS = (("sdf_chd8bar_txt", 64), ("sdf_txtvnl", 16))  # (preset, batch), DDIM-50 CFG 5
MIX2_STEPS = 12
GN_CONV_SITES, GN_CONV_TWO_INPUT = 44, 12  # per UNet eval: 22 ResBlocks x 2; decoder in_layers
GN_CONV_BATCH = 64
# the batch-128 sites of one UNet eval (C1, C2, O, H = W, residual, sites):
# 32 one-input (in_layers without a residual, out_layers with the block's),
# 12 two-input (the decoder's in_layers)
GN_CONV_PATH = [
    (64, 0, 64, 128, False, 2), (64, 0, 64, 128, True, 5), (64, 0, 128, 64, False, 1),
    (128, 0, 128, 64, False, 1), (128, 0, 128, 64, True, 5), (128, 0, 256, 32, False, 1),
    (256, 0, 256, 32, False, 1), (256, 0, 256, 32, True, 5), (256, 0, 256, 16, False, 4),
    (256, 0, 256, 16, True, 7),
    (256, 256, 256, 16, False, 3), (256, 256, 256, 32, False, 2), (256, 128, 256, 32, False, 1),
    (256, 128, 128, 64, False, 1), (128, 128, 128, 64, False, 1), (128, 64, 128, 64, False, 1),
    (128, 64, 64, 128, False, 1), (64, 64, 64, 128, False, 2),
]


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


def attention_bwd_bound(b, t, h, d, dtype_name, itemsize):
    """Five T x T x D products per (batch, head); q, k, v, dO read once and
    dq, dk, dv written once."""
    ops = 5 * 2 * b * h * t * t * d
    nbytes = 7 * b * t * h * d * itemsize
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
        _forward,
        packed_attention_lse_reference,
        packed_attention_reference,
        packed_self_attention,
    )

    cases = [  # (B, T, H, D, dtype, atol, rtol): DDIM sampling's at batch 64, the
        # inference CLI's (UNet batch 4), then the train step's
        (128, 1024, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        (128, 256, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        (4, 1024, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        (4, 256, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        (16, 1024, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        (16, 256, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
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
        # the row log-sum-exp the bf16 forward writes when a gradient will be taken
        lse_err = lse_ratio = lse_fault = None
        if dtype == torch.bfloat16:
            got_out, lse = _forward(q, k, v, scale, h, True, count=False)
            torch.cuda.synchronize()
            lse_want = packed_attention_lse_reference(q, k, scale, h)
            lse_err = (lse - lse_want).abs().max().item()
            lse_ratio = limit_ratio(lse, lse_want, LSE_ATOL, LSE_RTOL)
            lse_fault = limit_ratio(packed_attention_lse_reference(q, k[:, :-TILE], scale, h),
                                    lse_want, LSE_ATOL, LSE_RTOL)
            if not (lse_ratio <= 1.0 and limit_ratio(got_out, want, atol, rtol) <= 1.0):
                raise AssertionError(f"packed_attention lse B={b} T={t} {dtype}: max_abs_err "
                                     f"{lse_err}, {lse_ratio:.3g} x the limit (atol {LSE_ATOL})")
            if not lse_fault > 1.0:
                raise AssertionError(f"the lse limit at B={b} T={t} {dtype} does not catch a "
                                     f"dropped key tile ({lse_fault:.3g} x the limit)")
            del got_out, lse, lse_want
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
                   lse_max_abs_err=lse_err, lse_limit_ratio=lse_ratio,
                   lse_fault_limit_ratio=lse_fault,
                   ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
                   bound_ms=bound, bound_by=bound_by)
        log(f"[kernel] packed_attention {row['shape']}: max_abs_err {err:.3g}, "
            f"{ratio:.3g} x the limit (atol {atol}, rtol {rtol:.3g}; one dropped key tile: "
            f"{fault_ratio:.3g} x)"
            + (f"; lse max_abs_err {lse_err:.3g}, {lse_ratio:.3g} x its limit (atol {LSE_ATOL}; "
               f"dropped key tile {lse_fault:.3g} x)" if lse_err is not None else "")
            + f"  kernel {ms['kernel']:.4f} ms  plain {ms['plain']:.4f} ms  "
            f"sdpa {ms['library']:.4f} ms  bound {bound:.4f} ms ({bound_by})")
        rows.append(row)
        del q, k, v, got, want, views
    return rows


def check_attention_bwd():
    """Backward kernel against its plain version (and SDPA's backward as a
    yardstick) at the train step's shapes. At each shape the limit is also
    shown to catch a planted fault: the plain backward with the last key tile
    dropped (dk and dv of the dropped keys zero)."""
    import torch
    import torch.nn.functional as F

    from polyffusion_tpu_torch.ops.fused_attention import (
        TILE,
        _forward,
        packed_attention_bwd,
        packed_attention_bwd_reference,
    )

    cases = [  # (B, T, H, D, dtype, atol, rtol)
        (16, 1024, 4, 64, torch.bfloat16, BWD_BF16_ATOL, BWD_BF16_RTOL),
        (16, 256, 4, 64, torch.bfloat16, BWD_BF16_ATOL, BWD_BF16_RTOL),
        (4, 1024, 4, 64, torch.float32, BWD_FP32_ATOL, BWD_FP32_RTOL),
        (4, 256, 4, 64, torch.float32, BWD_FP32_ATOL, BWD_FP32_RTOL),
    ]
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for b, t, h, d, dtype, atol, rtol in cases:
        q, k, v, do = (torch.randn(b, t, h * d, device="cuda", generator=g).to(dtype)
                       for _ in range(4))
        scale = d**-0.5
        # the bf16 forward's lse, as the train step's backward gets it; a direct
        # call without one computes it first (the fp32 backward reads none)
        lse = _forward(q, k, v, scale, h, True, count=False)[1] if dtype == torch.bfloat16 else None
        got = packed_attention_bwd(q, k, v, do, scale, h, lse=lse)
        got_direct = packed_attention_bwd(q, k, v, do, scale, h)
        torch.cuda.synchronize()
        want = packed_attention_bwd_reference(q, k, v, do, scale, h)
        err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, want))
        ratio = max(limit_ratio(x, y, atol, rtol) for x, y in (*zip(got, want),
                                                               *zip(got_direct, want)))
        del got_direct
        fq, fk, fv = packed_attention_bwd_reference(q, k[:, :-TILE], v[:, :-TILE], do, scale, h)
        pad = torch.zeros_like(k[:, -TILE:])
        fault = (fq, torch.cat([fk, pad], 1), torch.cat([fv, pad], 1))
        fault_ratio = max(limit_ratio(x, y, atol, rtol) for x, y in zip(fault, want))
        del fault, fq, fk, fv
        if not ratio <= 1.0:
            raise AssertionError(f"packed_attention_bwd B={b} T={t} {dtype}: max_abs_err {err}, "
                                 f"{ratio:.3g} x the limit (atol {atol}, rtol {rtol})")
        if not fault_ratio > 1.0:
            raise AssertionError(f"the limit at B={b} T={t} {dtype} does not catch a dropped "
                                 f"key tile ({fault_ratio:.3g} x the limit)")
        leaves = [x.view(b, t, h, d).transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        dov = do.view(b, t, h, d).transpose(1, 2)
        ms = time_in_turns({  # with the forward's lse, as SDPA's backward reuses its forward's
            "kernel": lambda: packed_attention_bwd(q, k, v, do, scale, h, lse=lse),
            "plain": lambda: packed_attention_bwd_reference(q, k, v, do, scale, h),
            "library": lambda: torch.autograd.grad(out, leaves, dov, retain_graph=True),
        })
        dname = str(dtype).split(".")[1]
        bound, bound_by = attention_bwd_bound(b, t, h, d, dname, q.element_size())
        row = dict(shape=f"B={b} T={t} H={h} D={d} {dname}", max_abs_err=err, atol=atol,
                   rtol=rtol, limit_ratio=ratio, fault_limit_ratio=fault_ratio,
                   want_abs_max=max(y.float().abs().max().item() for y in want),
                   ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
                   bound_ms=bound, bound_by=bound_by,
                   timed_with="the forward's lse computed beforehand")
        log(f"[kernel] packed_attention_bwd {row['shape']}: max_abs_err {err:.3g} "
            f"(|want| max {row['want_abs_max']:.3g}), {ratio:.3g} x the limit (atol {atol}, "
            f"rtol {rtol:.3g}; one dropped key tile: {fault_ratio:.3g} x)  "
            f"kernel {ms['kernel']:.4f} ms  plain {ms['plain']:.4f} ms  "
            f"sdpa bwd {ms['library']:.4f} ms  bound {bound:.4f} ms ({bound_by})")
        rows.append(row)
        del q, k, v, do, got, want, leaves, out, dov, lse
    return rows


def check_head_major_attention():
    """Kernel 3 against its plain version (and SDPA on the same head-major
    tensors as a yardstick) at HEAD_MAJOR_SHAPES in fp32 and bf16 and at
    HEAD_MAJOR_MODEL in bf16, each with a planted fault that must fail the
    limit (the plain version without its last key tile, ragged or not); then
    the gradient through its autograd function (the kernel forward, a backward
    that recomputes through the plain version) against the plain version's
    autograd on the CPU, per input in norm."""
    import torch
    import torch.nn.functional as F

    from polyffusion_tpu_torch.ops.fused_attention import (
        TILE,
        fused_self_attention,
        head_major_attention_reference,
    )

    cases = [(bh, t, d, dtype) for bh, t, d in HEAD_MAJOR_SHAPES
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(bh, t, d, torch.bfloat16) for bh, t, d in HEAD_MAJOR_MODEL]
    g = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for bh, t, d, dtype in cases:
        atol, rtol = (BF16_ATOL, BF16_RTOL) if dtype == torch.bfloat16 else (FP32_ATOL, FP32_RTOL)
        q, k, v = (torch.randn(bh, t, d, device="cuda", generator=g).to(dtype) for _ in range(3))
        scale = d**-0.5
        got = fused_self_attention(q, k, v, scale)
        torch.cuda.synchronize()
        want = head_major_attention_reference(q, k, v, scale)
        err = (got.float() - want.float()).abs().max().item()
        ratio = limit_ratio(got, want, atol, rtol)
        last = t % TILE or TILE
        fault = head_major_attention_reference(q, k[:, :-last], v[:, :-last], scale)
        fault_ratio = limit_ratio(fault, want, atol, rtol)
        del fault
        if not (ratio <= 1.0 and torch.isfinite(got).all()):
            raise AssertionError(f"head_major_attention BH={bh} T={t} D={d} {dtype}: max_abs_err "
                                 f"{err}, {ratio:.3g} x the limit (atol {atol}, rtol {rtol})")
        if not fault_ratio > 1.0:
            raise AssertionError(f"the limit at BH={bh} T={t} D={d} {dtype} does not catch a "
                                 f"dropped key tile ({fault_ratio:.3g} x the limit)")
        views = [x[:, None] for x in (q, k, v)]
        ms = time_in_turns({
            "kernel": lambda: fused_self_attention(q, k, v, scale),
            "plain": lambda: head_major_attention_reference(q, k, v, scale),
            "library": lambda: F.scaled_dot_product_attention(*views, scale=scale),
        })
        dname = str(dtype).split(".")[1]
        bound, bound_by = attention_bound(bh, t, 1, d, dname, q.element_size())
        row = dict(shape=f"BH={bh} T={t} D={d} {dname}", max_abs_err=err, atol=atol, rtol=rtol,
                   limit_ratio=ratio, fault_limit_ratio=fault_ratio, ms=ms["kernel"],
                   plain_ms=ms["plain"], library_ms=ms["library"], bound_ms=bound,
                   bound_by=bound_by)
        log(f"[kernel] head_major_attention {row['shape']}: max_abs_err {err:.3g}, {ratio:.3g} x "
            f"the limit (atol {atol}, rtol {rtol:.3g}; last key tile dropped: {fault_ratio:.3g} "
            f"x)  kernel {ms['kernel']:.4f} ms  plain {ms['plain']:.4f} ms  sdpa "
            f"{ms['library']:.4f} ms  bound {bound:.4f} ms ({bound_by})")
        rows.append(row)
        del q, k, v, got, want, views

    bh, t, d = 4, 200, 64
    qkv = [torch.randn(bh, t, d, device="cuda", generator=g) for _ in range(3)]
    co = torch.randn(bh, t, d, device="cuda", generator=g)
    leaves = [x.clone().requires_grad_() for x in qkv]
    before = fused_self_attention.launches
    out = fused_self_attention(*leaves, d**-0.5)
    if (fused_self_attention.launches != before + 1
            or "HeadMajorAttention" not in type(out.grad_fn).__name__):
        raise AssertionError("the head-major function's forward is not the kernel")
    got = torch.autograd.grad(out, leaves, co)
    cpu = [x.cpu().requires_grad_() for x in qkv]
    want = torch.autograd.grad(head_major_attention_reference(*cpu, d**-0.5), cpu, co.cpu())
    worst = max(((a.cpu() - w).norm() / (GNC_GRAD_RTOL * w.norm())).item()
                for a, w in zip(got, want))
    log(f"[kernel] head_major_attention gradient through its function at BH={bh} T={t} D={d} "
        f"float32, card against the plain version's autograd on the CPU: {worst:.3g} x the "
        f"limit (rel {GNC_GRAD_RTOL} in norm per input)")
    if not worst <= 1.0:
        raise AssertionError("kernel 3's gradient disagrees with the plain version's")
    return rows


def drive_head_major(counters):
    """Kernel 3 is on no model path (the JAX package's dispatcher sends every
    UNet attention to the packed kernel): drive its public op directly, as a
    caller would, at HEAD_MAJOR_MODEL in bf16, a forward and a forward with
    its backward at each, with the launch counts set to 0 just before and read
    just after. Returns its launches."""
    import torch

    from polyffusion_tpu_torch.ops.fused_attention import fused_self_attention

    g = torch.Generator(device="cuda").manual_seed(13)
    zero_counts(counters)
    for bh, t, d in HEAD_MAJOR_MODEL:
        q, k, v = (torch.randn(bh, t, d, device="cuda", generator=g, dtype=torch.bfloat16)
                   for _ in range(3))
        with torch.no_grad():
            out = fused_self_attention(q, k, v, d**-0.5)
        leaves = [x.requires_grad_() for x in (q, k, v)]
        grads = torch.autograd.grad(fused_self_attention(*leaves, d**-0.5).float().square().sum(),
                                    leaves)
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and all(torch.isfinite(x).all() for x in grads)):
            raise AssertionError(f"head-major attention at BH={bh} T={t}: non-finite output")
    got = {name: fn.launches for name, fn in counters.items()}
    want = dict({name: 0 for name in counters}, head_major_attention=2 * len(HEAD_MAJOR_MODEL))
    log(f"[head_major] direct calls at {HEAD_MAJOR_MODEL} bf16: launches {got}")
    if got != want:
        raise AssertionError(f"expected launches {want}, got {got}")
    return got["head_major_attention"]


def host_launch_costs():
    """Host microseconds per call of kernels 1-3's public ops (a host clock
    around 200 queued calls, ``profile_attention``) at the inference CLI's and
    the train step's shapes: what a host-bound request pays per launch."""
    from polyffusion_tpu_torch.profile_attention import measure

    rows = measure()
    for r in rows:
        log(f"[host] {r['kernel']} {r['shape']}: {r['host_us_per_call']:.2f} us per call on the "
            f"host, {r['device_ms_per_call']:.4f} ms on the device")
    return rows


def map_cache_delta(before, label):
    """The bf16 attention kernels' tensor-map cache hits and misses since
    ``before`` (``profile_attention.map_cache_counts``), logged under ``label``:
    how often a launch on a real path encoded its maps anew."""
    from polyffusion_tpu_torch.profile_attention import map_cache_counts

    now = map_cache_counts()
    out = {s: {"hits": now[s][0] - before[s][0], "misses": now[s][1] - before[s][1]}
           for s in now}
    log(f"[host] tensor-map cache over {label}: " + "; ".join(
        f"{s} {c['hits']} hits, {c['misses']} misses" for s, c in out.items()))
    return out


def check_gn_bwd():
    """GroupNorm backward kernel against its plain version (and the backward of
    ``F.group_norm`` as a yardstick) at shapes of the train step. At each shape
    the limit is also shown to catch a planted fault: the plain dx with the
    S2 term left out."""
    import torch
    import torch.nn.functional as F

    from polyffusion_tpu_torch.ops.gn_bwd import gn_bwd_reference, gn_primal, group_norm_bwd

    cases = [  # (B, C, H, W, dtype, atol, rtol)
        (16, 64, 128, 128, torch.bfloat16, GN_BF16_ATOL, GN_BF16_RTOL),
        (16, 192, 128, 128, torch.bfloat16, GN_BF16_ATOL, GN_BF16_RTOL),
        (16, 256, 32, 32, torch.bfloat16, GN_BF16_ATOL, GN_BF16_RTOL),
        (16, 512, 16, 16, torch.bfloat16, GN_BF16_ATOL, GN_BF16_RTOL),
        (4, 128, 64, 64, torch.float32, GN_FP32_ATOL, GN_FP32_RTOL),
    ]
    groups, eps = 32, 1e-5
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for b, c, hh, ww, dtype, atol, rtol in cases:
        x = (torch.randn(b, c, hh, ww, device="cuda", generator=g) * 2 + 0.5).to(dtype)
        dy = torch.randn(b, c, hh, ww, device="cuda", generator=g).to(dtype)
        gamma = torch.randn(c, device="cuda", generator=g) * 0.5 + 1.0
        beta = torch.randn(c, device="cuda", generator=g) * 0.1
        _, mean_c, inv_c = gn_primal(x, gamma, beta, groups, eps)
        got = group_norm_bwd(x, dy, mean_c, inv_c, gamma, groups)
        torch.cuda.synchronize()
        want = gn_bwd_reference(x, dy, mean_c, inv_c, gamma, groups)
        err = (got[0].float() - want[0].float()).abs().max().item()
        ratio = limit_ratio(got[0], want[0], atol, rtol)
        param_err = max((x_ - y).abs().max().item() for x_, y in zip(got[1:], want[1:]))
        param_ratio = max(limit_ratio(x_, y, GN_PARAM_ATOL, GN_PARAM_RTOL)
                          for x_, y in zip(got[1:], want[1:]))
        fault_ratio = limit_ratio(gn_dx_without_s2(x, dy, mean_c, inv_c, gamma, groups),
                                  want[0], atol, rtol)
        if not (ratio <= 1.0 and param_ratio <= 1.0):
            raise AssertionError(f"gn_bwd B={b} C={c} H={hh} W={ww} {dtype}: dx max_abs_err "
                                 f"{err}, {ratio:.3g} x the limit; dgamma/dbeta {param_ratio:.3g} x")
        if not fault_ratio > 1.0:
            raise AssertionError(f"the limit at C={c} H={hh} {dtype} does not catch a dx without "
                                 f"S2 ({fault_ratio:.3g} x the limit)")
        xl = x.detach().requires_grad_()
        wl = gamma.to(dtype).requires_grad_()
        bl = beta.to(dtype).requires_grad_()
        y = F.group_norm(xl, groups, wl, bl, eps)
        ms = time_in_turns({
            "kernel": lambda: group_norm_bwd(x, dy, mean_c, inv_c, gamma, groups),
            "plain": lambda: gn_bwd_reference(x, dy, mean_c, inv_c, gamma, groups),
            "library": lambda: torch.autograd.grad(y, (xl, wl, bl), dy, retain_graph=True),
        })
        dname = str(dtype).split(".")[1]
        bound = 3 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        row = dict(shape=f"B={b} C={c} H={hh} W={ww} {dname}", max_abs_err=err, atol=atol,
                   rtol=rtol, limit_ratio=ratio, fault_limit_ratio=fault_ratio,
                   param_max_abs_err=param_err, param_limit_ratio=param_ratio,
                   want_abs_max=want[0].float().abs().max().item(),
                   ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
                   bound_ms=bound, bound_by="bytes")
        log(f"[kernel] gn_bwd {row['shape']}: dx max_abs_err {err:.3g} (|want| max "
            f"{row['want_abs_max']:.3g}), {ratio:.3g} x the limit (atol {atol}, rtol {rtol:.3g}; "
            f"without S2: {fault_ratio:.3g} x); dgamma/dbeta max_abs_err {param_err:.3g}, "
            f"{param_ratio:.3g} x (atol {GN_PARAM_ATOL}, rtol {GN_PARAM_RTOL})  "
            f"kernel {ms['kernel']:.4f} ms  plain {ms['plain']:.4f} ms  "
            f"F.group_norm bwd {ms['library']:.4f} ms  bound {bound:.4f} ms (bytes)")
        rows.append(row)
        del x, dy, got, want, xl, y
    return rows


def gn_dx_without_s2(x, dy, mean_c, inv_c, gamma, groups):
    """The plain dx with its S2 term dropped: the planted fault of ``check_gn_bwd``."""
    b, c = x.shape[:2]
    cg = c // groups
    inv4 = inv_c[:, :, None, None]
    dyg = dy.float() * gamma[None, :, None, None]
    s1 = dyg.sum(dim=(2, 3)).view(b, groups, cg).sum(-1, keepdim=True) / (x[0, 0].numel() * cg)
    s1 = s1.expand(b, groups, cg).reshape(b, c)[:, :, None, None]
    return (inv4 * (dyg - s1)).to(x.dtype)


def check_repaint_epilogue():
    """The RePaint epilogue kernel against its plain version at request A's
    shape (batch 2), batch 4 and a full batch of 64, with the scalars of the
    first, a middle and the last of the preset's 1000 steps. At each the limit
    is also shown to catch a planted fault: the blend ignoring the mask (the
    unknown region's update everywhere). No single PyTorch call computes this
    function, so the plain composition is the only yardstick."""
    import torch

    from polyffusion_tpu_torch.diffusion.sampler import _epilogue_scalars
    from polyffusion_tpu_torch.diffusion.schedule import make_schedule
    from polyffusion_tpu_torch.ops.repaint_epilogue import (
        fused_repaint_epilogue,
        repaint_epilogue_reference,
    )

    cfg = full_cfg(bf16=False)
    sched = make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end)
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for b in (2, 4, 64):
        shape = (b, 2, 128, 128)
        x, eps, p_noise, q_noise = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
        orig = (torch.rand(shape, device="cuda", generator=g) < 0.05).float()
        mask = (torch.rand(shape, device="cuda", generator=g) < 0.5).float()
        tensors = (x, eps, p_noise, orig, q_noise, mask)
        err, ratio, fault_ratio = 0.0, 0.0, float("inf")
        for step in EPI_STEPS:
            scalars = _epilogue_scalars(sched, step)
            got = fused_repaint_epilogue(*tensors, scalars)
            torch.cuda.synchronize()
            want = repaint_epilogue_reference(*tensors, scalars)
            fault = repaint_epilogue_reference(*tensors[:5], torch.zeros_like(mask), scalars)
            err = max(err, (got - want).abs().max().item())
            ratio = max(ratio, limit_ratio(got, want, EPI_ATOL, EPI_RTOL))
            fault_ratio = min(fault_ratio, limit_ratio(fault, want, EPI_ATOL, EPI_RTOL))
        if not ratio <= 1.0:
            raise AssertionError(f"repaint_epilogue B={b}: max_abs_err {err}, {ratio:.3g} x the "
                                 f"limit (atol {EPI_ATOL}, rtol {EPI_RTOL})")
        if not fault_ratio > 1.0:
            raise AssertionError(f"the limit at B={b} does not catch a blend that ignores the "
                                 f"mask ({fault_ratio:.3g} x the limit)")
        scalars = _epilogue_scalars(sched, 500)
        ms = time_in_turns({
            "kernel": lambda: fused_repaint_epilogue(*tensors, scalars),
            "plain": lambda: repaint_epilogue_reference(*tensors, scalars),
        })
        # six fp32 tensors read once, one written once
        bound = 7 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        row = dict(shape=f"B={b} C=2 H=128 W=128 float32", max_abs_err=err, atol=EPI_ATOL,
                   rtol=EPI_RTOL, limit_ratio=ratio, fault_limit_ratio=fault_ratio,
                   ms=ms["kernel"], plain_ms=ms["plain"], library_ms=None,
                   bound_ms=bound, bound_by="bytes")
        log(f"[kernel] repaint_epilogue {row['shape']}, steps {EPI_STEPS}: max_abs_err {err:.3g}, "
            f"{ratio:.3g} x the limit (atol {EPI_ATOL}, rtol {EPI_RTOL}; blend ignoring the mask: "
            f"{fault_ratio:.3g} x)  kernel {ms['kernel']:.4f} ms  plain {ms['plain']:.4f} ms  "
            f"bound {bound:.4f} ms (bytes)")
        rows.append(row)
        del tensors, x, eps, p_noise, q_noise, orig, mask, got, want, fault
    return rows


def gn_conv_inputs(g, b, c1, c2, o, hw, dtype, residual):
    """Random inputs of one fused GroupNorm-SiLU-conv site on the card: x (and
    x2), their fp32 affine, w (O, C1 + C2, 3, 3) as a UNet's, the bias, the
    residual; and a GroupNorm's scale and shift for the unfused composition."""
    import torch

    f = lambda *s: torch.randn(*s, device="cuda", generator=g)  # noqa: E731
    c = c1 + c2
    d = dict(x=f(b, c1, hw, hw).to(dtype), a=f(b, c1) * 0.5 + 1, off=f(b, c1) * 0.3, x2=None,
             a2=None, off2=None, w=(f(o, c, 3, 3) * (9 * c) ** -0.5).to(dtype),
             b=(f(o) * 0.1).to(dtype), res=f(b, o, hw, hw).to(dtype) if residual else None,
             gamma=f(c) * 0.2 + 1, beta=f(c) * 0.1)
    if c2:  # the second input a little wider, so that it holds the larger |SiLU| of most
        # items and the planted fault "scale of the first input alone" shows
        d.update(x2=f(b, c2, hw, hw).to(dtype), a2=f(b, c2) * 0.5 + 1.5, off2=f(b, c2) * 0.3)
    return d


def pad_with_silu_off(t, off):
    """(B, C, H, W) SiLU output padded by SiLU(off) on every side, where the
    kernels pad with 0: the halo of the planted fault of ``check_gn_conv``."""
    import torch.nn.functional as F

    b, c, h, w = t.shape
    y = F.silu(off)[:, :, None, None].expand(b, c, h + 2, w + 2).clone()
    y[:, :, 1:-1, 1:-1] = t
    return y


def silu_halo_fault(d, dtype):
    """Kernel 4's plain version with the SiLU'd input padded by SiLU(off), not
    0: the planted fault of ``check_gn_conv``."""
    import torch
    import torch.nn.functional as F

    ys = []
    for x, a, off in ((d["x"], d["a"], d["off"]), (d["x2"], d["a2"], d["off2"])):
        if x is None:
            continue
        t = F.silu(x.float() * a[:, :, None, None] + off[:, :, None, None])
        ys.append(pad_with_silu_off(t, off).to(dtype).float())
    out = F.conv2d(torch.cat(ys, 1), d["w"].float()) + d["b"].float()[:, None, None]
    if d["res"] is not None:
        out = out + d["res"].float()
    return out.to(dtype)


def gn_conv_bound(d, quantized):
    """(ms, bound_by): the larger of the bytes (x, x2, a, off, w, b, residual
    read once, out written once) over the memory rate and the operations over
    the peak for the operands' type."""
    x, w = d["x"], d["w"]
    b, c1, h, wd = x.shape
    c = c1 + (d["x2"].shape[1] if d["x2"] is not None else 0)
    o = w.shape[0]
    item = x.element_size()
    nbytes = (b * c * h * wd + b * o * h * wd * (2 if d["res"] is not None else 1)) * item
    nbytes += b * c * 2 * 4 + o * c * 9 * (1 if quantized else item) + o * 4
    ops = 2 * b * h * wd * 9 * c * o
    peak = PEAK_OPS_PER_S["int8" if quantized else str(x.dtype).split(".")[1]]
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gn_conv_cases():
    """(B, C1, C2, O, H = W, dtype, residual): every distinct batch-128 bf16
    site of one UNet eval at a batch-64 request (GN_CONV_PATH), then fp32 at
    batch 8, one and two inputs, with and without a residual."""
    import torch

    cases = [(128, c1, c2, o, hw, torch.bfloat16, res) for c1, c2, o, hw, res, _ in GN_CONV_PATH]
    cases += [(8, 64, 0, 64, 128, torch.float32, True), (8, 64, 0, 64, 128, torch.float32, False),
              (8, 128, 64, 64, 128, torch.float32, False),
              (8, 256, 256, 256, 16, torch.float32, True)]
    return cases


def unfused_composition(d):
    """What the unfused route runs for one site: the concat (two inputs), the
    UNet's GroupNorm32 (fp32 statistics, affine applied in the activations'
    dtype), SiLU, cuDNN's conv, the residual add."""
    import torch
    import torch.nn.functional as F

    from polyffusion_tpu_torch.ops.gn_bwd import gn_primal

    x = d["x"] if d["x2"] is None else torch.cat([d["x"], d["x2"]], 1)
    y = F.conv2d(F.silu(gn_primal(x, d["gamma"], d["beta"], 32, 1e-5)[0]), d["w"], d["b"],
                 padding=1)
    return y if d["res"] is None else y + d["res"]


def check_gn_conv_gradient():
    """Autograd through kernel 4's function at one two-input site shape in
    fp32 (the kernel forward; a backward that recomputes through the plain
    version, as JAX's custom VJP does) against autograd of the plain version:
    each input's gradient within GNC_GRAD_RTOL of it in norm (cuDNN sums the
    backward's convolutions in its own order), and every input reached."""
    import torch

    from polyffusion_tpu_torch.ops import fused_gn_conv as K

    g = torch.Generator(device="cuda").manual_seed(11)
    d = gn_conv_inputs(g, 8, 128, 64, 64, 64, torch.float32, True)
    names = ["x", "a", "off", "x2", "a2", "off2", "w", "b", "res"]
    co = torch.randn(8, 64, 64, 64, device="cuda", generator=g)
    grads = {}
    for how in ("kernel", "plain"):
        leaves = {n: d[n].detach().clone().requires_grad_() for n in names}
        args = [leaves[n] for n in ("x", "a", "off", "x2", "a2", "off2", "w", "b", "res")]
        if how == "kernel":
            before = K.gn_silu_conv3x3.launches
            out = K.gn_silu_conv3x3_concat(*args)
            if K.gn_silu_conv3x3.launches != before + 1 or "GNSiLUConv" not in type(out.grad_fn).__name__:
                raise AssertionError("the fused function's forward is not the kernel")
        else:
            x, a, off, x2, a2, off2, w, b, res = args
            out = K.gn_silu_conv3x3_reference(x, a, off, w, b, res, x2, a2, off2)
        grads[how] = torch.autograd.grad(out, args, co)
    worst, name = -1.0, ""
    for n, got, want in zip(names, grads["kernel"], grads["plain"]):
        r = ((got - want).norm() / (GNC_GRAD_RTOL * want.norm())).item()
        if not (want.norm() > 0 and r == r):
            raise AssertionError(f"no gradient reached {n}")
        if r > worst:
            worst, name = r, n
    log(f"[kernel] gn_silu_conv gradient through its function at B=8 C=128+64->64 H=W=64 "
        f"float32 + residual, against the plain version's autograd: {worst:.3g} x the limit "
        f"(rel {GNC_GRAD_RTOL} in norm per input; worst {name})")
    if not worst <= 1.0:
        raise AssertionError("kernel 4's gradient disagrees with the plain version's")


def check_gn_conv(quantized: bool):
    """Kernel 4 (or, ``quantized``, kernel 5: its amax pass and int8
    convolution) against its plain version at every batch-128 bf16 site shape
    of the UNet and at fp32 shapes. At each the limit is also shown to catch a
    planted fault: a halo of SiLU(off) in place of 0, and for kernel 5's
    two-input sites the activation scale of the first input alone. Timed in
    turns with the plain version, cuDNN's conv alone on the already-SiLU'd
    input (the library call) and the unfused composition."""
    import torch
    import torch.nn.functional as F

    from polyffusion_tpu_torch.ops import fused_gn_conv as K

    g = torch.Generator(device="cuda").manual_seed(8 + quantized)
    rows = []
    for b, c1, c2, o, hw, dtype, res in gn_conv_cases():
        d = gn_conv_inputs(g, b, c1, c2, o, hw, dtype, res)
        parts = (d["x"], d["a"], d["off"], d["x2"], d["a2"], d["off2"])
        if quantized:
            w_q, w_scale = K.quantize_conv_kernel(d["w"])

            def kernel():
                if d["x2"] is None:
                    return K.gn_silu_conv3x3_q(d["x"], d["a"], d["off"], w_q, w_scale, d["b"],
                                               d["res"])
                return K.gn_silu_conv3x3_concat_q(*parts, w_q, w_scale, d["b"], d["res"])

            def plain():
                return K.gn_silu_conv3x3_q_reference(d["x"], d["a"], d["off"], w_q, w_scale,
                                                     d["b"], d["res"], *parts[3:])

            atol, rtol = ((GNQ_FP32_ATOL, GNQ_FP32_RTOL) if dtype == torch.float32
                          else (GNC_BF16_ATOL, GNC_BF16_RTOL))
        else:
            def kernel():
                if d["x2"] is None:
                    return K.gn_silu_conv3x3(d["x"], d["a"], d["off"], d["w"], d["b"], d["res"])
                return K.gn_silu_conv3x3_concat(*parts, d["w"], d["b"], d["res"])

            def plain():
                return K.gn_silu_conv3x3_reference(d["x"], d["a"], d["off"], d["w"], d["b"],
                                                   d["res"], *parts[3:])

            atol, rtol = ((GNC_FP32_ATOL, GNC_FP32_RTOL) if dtype == torch.float32
                          else (GNC_BF16_ATOL, GNC_BF16_RTOL))
        with torch.no_grad():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            err = (got.float() - want.float()).abs().max().item()
            ratio = limit_ratio(got, want, atol, rtol)
            fault = plain_q_fault(d, w_q, w_scale, halo=True) if quantized else silu_halo_fault(
                d, dtype)
            faults = {"silu_halo": limit_ratio(fault, want, atol, rtol)}
            if quantized and d["x2"] is not None:
                faults["first_input_amax"] = limit_ratio(plain_q_fault(d, w_q, w_scale), want,
                                                         atol, rtol)
            del fault
        name = "gn_silu_conv_q" if quantized else "gn_silu_conv"
        shape = (f"B={b} C={c1}{f'+{c2}' if c2 else ''}->{o} H=W={hw} "
                 f"{str(dtype).split('.')[1]}{' residual' if res else ''}")
        if not ratio <= 1.0:
            raise AssertionError(f"{name} {shape}: max_abs_err {err}, {ratio:.3g} x the limit "
                                 f"(atol {atol}, rtol {rtol})")
        for fault, fr in faults.items():
            if not fr > 1.0:
                raise AssertionError(f"the limit at {shape} does not catch the fault {fault} "
                                     f"({fr:.3g} x the limit)")
        y = F.silu(d["x"].float() * d["a"][:, :, None, None] + d["off"][:, :, None, None]).to(dtype)
        if d["x2"] is not None:
            y = torch.cat([y, F.silu(d["x2"].float() * d["a2"][:, :, None, None]
                                     + d["off2"][:, :, None, None]).to(dtype)], 1)
        fns = {"kernel": kernel, "plain": plain,
               "library": lambda: F.conv2d(y, d["w"], d["b"], padding=1),
               "unfused": lambda: unfused_composition(d)}
        if quantized:
            fns["amax_pass"] = lambda: K.gn_silu_amax(*parts)
        with torch.no_grad():
            ms = time_in_turns(fns)
        bound, bound_by = gn_conv_bound(d, quantized)
        row = dict(shape=shape, max_abs_err=err, atol=atol, rtol=rtol, limit_ratio=ratio,
                   fault_limit_ratio=min(faults.values()), faults=faults,
                   want_abs_max=want.float().abs().max().item(), ms=ms["kernel"],
                   plain_ms=ms["plain"], library_ms=ms["library"], unfused_ms=ms["unfused"],
                   bound_ms=bound, bound_by=bound_by)
        if quantized:
            row["amax_pass_ms"] = ms["amax_pass"]
        log(f"[kernel] {name} {shape}: max_abs_err {err:.3g} (|want| max "
            f"{row['want_abs_max']:.3g}), {ratio:.3g} x the limit (atol {atol}, rtol {rtol:.3g}; "
            + ", ".join(f"{k}: {v:.3g} x" for k, v in faults.items()) + ")  "
            f"kernel {ms['kernel']:.4f} ms"
            + (f" (amax pass {ms['amax_pass']:.4f})" if quantized else "")
            + f"  plain {ms['plain']:.4f} ms  cuDNN conv {ms['library']:.4f} ms  unfused "
            f"{ms['unfused']:.4f} ms  bound {bound:.4f} ms ({bound_by})")
        rows.append(row)
        del d, got, want, y, fns
    return rows


def plain_q_fault(d, w_q, w_scale, halo=False):
    """Kernel 5's plain version with one of two planted faults: ``halo``, the
    padding SiLU(off) in place of 0; else the activation scale taken from the
    first input alone."""
    import torch
    import torch.nn.functional as F

    ins = [(d["x"], d["a"], d["off"])] + ([(d["x2"], d["a2"], d["off2"])] if d["x2"] is not None
                                          else [])
    ts = [F.silu(x.float() * a[:, :, None, None] + off[:, :, None, None]) for x, a, off in ins]
    amaxes = [t.abs().amax(dim=(1, 2, 3)) for t in ts]
    amax = torch.clamp(torch.stack(amaxes).amax(0) if halo else amaxes[0], min=1e-6)
    inv = (torch.full_like(amax, 127.0) / amax)[:, None, None, None]
    dtype = d["x"].dtype
    qs = []
    for t, (x, a, off) in zip(ts, ins):
        if halo:
            t = pad_with_silu_off(t, off)
        qs.append(torch.clamp(torch.round(t.to(dtype).float() * inv), -127, 127))
    acc = F.conv2d(torch.cat(qs, 1), w_q.float(), padding=0 if halo else 1)
    out = acc * (amax[:, None, None, None] / 127.0) * w_scale[None, :, None, None]
    out = out + d["b"].float()[:, None, None]
    if d["res"] is not None:
        out = out + d["res"].float()
    return out.to(dtype)


def full_cfg(bf16: bool):
    from polyffusion_tpu_torch.config import load_params

    cfg = load_params("sdf_chd8bar")
    cfg.bf16 = bf16
    return cfg


def random_chord_encoder(cfg, seed):
    import torch

    from polyffusion_tpu_torch.models import ChordEncoder, init_weights_

    enc = ChordEncoder(cfg.chd_input_dim, cfg.chd_hidden_dim, cfg.chd_z_dim)
    return init_weights_(enc, torch.Generator().manual_seed(seed + 1000))


def make_task(cfg, device, seed, training=False, gn_conv="unfused"):
    import torch

    from polyffusion_tpu_torch.tasks import SDFTask

    return SDFTask(cfg, random_chord_encoder(cfg, seed), device=device,
                   generator=torch.Generator().manual_seed(seed), training=training,
                   gn_conv=gn_conv)


def check_unet_against_cpu(gn_conv="unfused"):
    """One full-width fp32 UNet eval at batch 2 doubled by CFG: the card (with
    the kernels) against the CPU (with their plain versions)."""
    cfg = full_cfg(bf16=False)
    unet_card_vs_cpu(make_task(cfg, "cuda", seed=1, gn_conv=gn_conv),
                     make_task(cfg, "cpu", seed=1, gn_conv=gn_conv), None, f"gn_conv {gn_conv}")


def unet_card_vs_cpu(gpu, cpu, cond, label):
    """``gpu.apply_eps`` against ``cpu.apply_eps`` (the same fp32 weights) at
    batch 2 doubled by CFG, for ``cond`` (random when None)."""
    import torch

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 2, 128, 128)).astype(np.float32))
    t = torch.tensor([981, 401], dtype=torch.int32)
    if cond is None:
        cond = torch.from_numpy(rng.standard_normal((2, 1, gpu.cfg.d_cond)).astype(np.float32))
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
    log(f"[unet] full-width fp32 (B=4, {label}) card vs CPU: max_abs_err "
        f"{err.max().item():.3g} "
        f"(atol {UNET_ATOL}, rtol {UNET_RTOL}), |out| max {want.abs().max().item():.3g}, "
        f"card {t_gpu:.2f} s (first call), CPU {t_cpu:.2f} s")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"full-width UNet ({label}) on the card disagrees with the CPU")


def check_int8_against_fused():
    """The full-width bf16 UNet's eps with int8 sites (kernel 5) against its
    eps with fused bf16 sites (kernel 4), same weights, at batch 4 on the card:
    mean |int8 - fused| / mean |fused| under INT8_EPS_REL."""
    import torch

    cfg = full_cfg(bf16=True)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((4, 2, 128, 128)).astype(np.float32)).cuda()
    t = torch.tensor([981, 600, 250, 12], device="cuda")
    cond = torch.from_numpy(rng.standard_normal((4, 1, cfg.d_cond)).astype(np.float32)).cuda()
    eps = {}
    for mode in ("fused", "int8"):
        task = make_task(cfg, "cuda", seed=2, gn_conv=mode)
        with torch.inference_mode():
            eps[mode] = task.apply_eps(x, t, cond).float()
        del task
    err = (eps["int8"] - eps["fused"]).abs()
    rel = (err.mean() / eps["fused"].abs().mean()).item()
    log(f"[unet] full-width bf16 (B=4) int8 eps vs fused eps on the card: mean rel err {rel:.4g} "
        f"(limit {INT8_EPS_REL}), max_abs_err {err.max().item():.3g}, |fused| mean "
        f"{eps['fused'].abs().mean().item():.3g}")
    if not (rel < INT8_EPS_REL and torch.isfinite(eps["int8"]).all()):
        raise AssertionError("the int8 UNet's eps is too far from the fused one")
    return rel



def check_train_step_against_cpu():
    """One full-width fp32 train step at batch 2 on the card (with the kernels)
    against the CPU (with their plain versions): same weights, batch, t and
    noise; the loss, the gradients and their norm, and the updated parameters."""
    import torch

    from polyffusion_tpu_torch.tasks.sdf import StepNoise
    from polyffusion_tpu_torch.train import create_state, make_train_step

    cfg = full_cfg(bf16=False)
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy((rng.random((2, 2, 128, 128)) > 0.97).astype(np.uint8))
    chords = torch.from_numpy(random_chords(rng, 2))
    t = torch.tensor([37, 802])
    noise = torch.from_numpy(rng.standard_normal((2, 2, 128, 128)).astype(np.float32))
    out = {}
    for device in ("cuda", "cpu"):
        task = make_task(cfg, device, seed=3, training=True)
        state = create_state(task.unet, cfg.learning_rate, cfg.max_grad_norm)
        batch = (x0.to(device), None, chords.to(device), None)
        t0 = time.perf_counter()
        metrics = make_train_step(task)(state, batch, seed=0, noise=StepNoise(
            t.to(device), noise.to(device), torch.tensor(False, device=device)))
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        params = {k: v.detach().cpu() for k, v in state.params().items()}
        grads = {k: v.grad.cpu() for k, v in state.params().items()}  # clipped: norm < max here
        out[device] = (loss, norm, params, grads, time.perf_counter() - t0)
        del task, state
    (loss, norm, got, got_g, t_gpu), (want_loss, want_norm, want, want_g, t_cpu) = out["cuda"], out["cpu"]
    lr = cfg.learning_rate
    loss_err, norm_err = abs(loss - want_loss) / abs(want_loss), abs(norm - want_norm) / want_norm
    grad_ratio, worst = 0.0, ""
    for k, w in want_g.items():  # per tensor: |dg| <= rtol |g| + 1e-9 (exact zeros stay zero)
        r = ((got_g[k] - w).norm() / (STEP_GRAD_RTOL * w.norm() + 1e-9)).item()
        if r > grad_ratio:
            grad_ratio, worst = r, k
    err = torch.cat([(got[k] - w).abs().flatten() for k, w in want.items()])
    share = (err > STEP_PARAM_TIGHT).float().mean().item()
    log(f"[train] full-width fp32 step (B=2) card vs CPU: loss {loss:.7g} vs {want_loss:.7g} "
        f"(rel {loss_err:.3g}, limit {STEP_LOSS_RTOL}), grad_norm {norm:.7g} vs {want_norm:.7g} "
        f"(rel {norm_err:.3g}, limit {STEP_NORM_RTOL}); gradients per tensor {grad_ratio:.3g} x "
        f"the limit (rel {STEP_GRAD_RTOL} in norm; worst {worst}); params max_abs_err "
        f"{err.max().item():.3g} (limit {2 * lr:.3g} = 2 lr), share above {STEP_PARAM_TIGHT}: "
        f"{share:.3g} (limit {STEP_PARAM_SHARE}); card {t_gpu:.2f} s (first call), CPU {t_cpu:.2f} s")
    if not (loss_err <= STEP_LOSS_RTOL and norm_err <= STEP_NORM_RTOL and grad_ratio <= 1.0
            and err.max().item() <= 2 * lr and share <= STEP_PARAM_SHARE):
        raise AssertionError("the full-width fp32 train step on the card disagrees with the CPU")


def nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


def check_ddpm_paint_against_cpu():
    """DDPM RePaint at full width in fp32, batch 1 doubled by CFG 5, a "below"
    mask, repaint_n 2, from step PAINT_T_START down: the card (kernels 1 and 7)
    against the CPU (their plain versions), under the same replayed noises."""
    import torch

    from polyffusion_tpu_torch.diffusion import sampler as S
    from polyffusion_tpu_torch.inference import get_mask
    from polyffusion_tpu_torch.ops.repaint_epilogue import fused_repaint_epilogue

    cfg = full_cfg(bf16=False)
    rng = np.random.default_rng(5)
    orig = (rng.random((1, 2, 128, 128)) > 0.97).astype(np.float32)
    arrays = dict(
        x=rng.standard_normal((1, 128, 128, 2)).astype(np.float32),
        cond=rng.standard_normal((1, 1, cfg.d_cond)).astype(np.float32),
        orig=nhwc(orig),
        mask=nhwc(get_mask(orig, "below")),
        noise=rng.standard_normal((PAINT_T_START + 1, PAINT_REPAINT_N, 3, 1, 128, 128, 2))
        .astype(np.float32),
    )
    out = {}
    for device in ("cuda", "cpu"):
        task = make_task(cfg, device, seed=6)
        a = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        before = fused_repaint_epilogue.launches
        t0 = time.perf_counter()
        got = S.ddpm_paint(task.apply_eps, task.schedule, a["x"], a["cond"], PAINT_T_START,
                           orig=a["orig"], mask=a["mask"], uncond_scale=5.0,
                           uncond_cond=-torch.ones_like(a["cond"]), repaint_n=PAINT_REPAINT_N,
                           noise_override=a["noise"]).cpu()
        out[device] = (got, fused_repaint_epilogue.launches - before, time.perf_counter() - t0)
        del task, a
    (got, launches, t_gpu), (want, _, t_cpu) = out["cuda"], out["cpu"]
    err = (got - want).abs()
    ok = bool((err <= PAINT_ATOL + PAINT_RTOL * want.abs()).all()) and bool(torch.isfinite(got).all())
    log(f"[ddpm] full-width fp32 RePaint (B=1, CFG 5, below, repaint_n {PAINT_REPAINT_N}, steps "
        f"{PAINT_T_START}..0) card vs CPU: max_abs_err {err.max().item():.3g} (atol {PAINT_ATOL}, "
        f"rtol {PAINT_RTOL}), |out| max {want.abs().max().item():.3g}, epilogue launches "
        f"{launches}; card {t_gpu:.2f} s (first call), CPU {t_cpu:.2f} s")
    if launches != (PAINT_T_START + 1) * PAINT_REPAINT_N:
        raise AssertionError(f"the card's RePaint run launched the epilogue {launches} times")
    if not ok:
        raise AssertionError("the full-width DDPM RePaint run on the card disagrees with the CPU")


def count_sites(unet):
    """(self-attention sites, GroupNorm32 sites) of a UNet, from its modules."""
    from polyffusion_tpu_torch.models.unet import GroupNorm32, SpatialTransformer

    mods = list(unet.modules())
    attn = sum(len(m.transformer_blocks) for m in mods if isinstance(m, SpatialTransformer))
    return attn, sum(isinstance(m, GroupNorm32) for m in mods)


def write_songs(data_dir, n, seed):
    """Synthetic three-track 24-bar songs with chords and a downbeat every bar
    (the idea of the JAX package's tests/synth.py), written with the port's
    ``write_song_npz``."""
    from polyffusion_tpu_torch.data import write_song_npz

    os.makedirs(data_dir)
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        n_beats = 24 * 4
        n_bins = n_beats * 4
        tracks = []
        for t in range(3):
            m = int(rng.integers(40, 80))
            onsets = np.sort(rng.integers(0, n_bins - 8, m))
            tracks.append(np.stack([onsets, rng.integers(36 + 12 * t, 72 + 12 * t, m),
                                    rng.integers(1, 8, m), rng.integers(60, 100, m),
                                    np.zeros(m, np.int64)], 1))
        chord = np.zeros((n_beats, 14), np.int32)
        chord[:, 0] = rng.integers(0, 12, n_beats)
        chord[:, 1:13] = rng.integers(0, 2, (n_beats, 12))
        chord[:, 13] = chord[:, 0]
        db_pos = np.arange(0, n_bins, 16)
        write_song_npz(os.path.join(data_dir, f"song{i:03d}.npz"), tracks, chord, db_pos,
                       db_pos + 128 <= n_bins, n_beats=n_beats)


def drive_training_path(counters, work):
    """``python -m polyffusion_tpu_torch.main`` for the full-width bf16
    ``sdf_chd8bar`` preset at its batch 16: TRAIN_STEPS steps, one validation
    and one checkpoint, then ``--resume`` for RESUME_STEPS more. Writes its
    encoder, songs and run directory under ``work`` (``pretrained``, ``songs``,
    ``run``). Returns the launches of each kernel over both runs."""
    import json as json_

    import torch

    from polyffusion_tpu_torch.data import BatchLoader, SegmentDataset
    from polyffusion_tpu_torch.main import main as train_main

    cfg = full_cfg(bf16=True)
    pretrained, data, run = (os.path.join(work, d) for d in ("pretrained", "songs", "run"))
    os.makedirs(pretrained)
    enc = random_chord_encoder(cfg, seed=5)
    # the reference chord VAE's layout: a learner checkpoint, encoder under chord_enc.
    torch.save({"model": {f"chord_enc.{k}": v for k, v in enc.state_dict().items()}},
               os.path.join(pretrained, "chd8bar.pt"))
    write_songs(data, TRAIN_SONGS, seed=100)
    _, val_ds = SegmentDataset.train_val_from_dir(data, 0.9)
    val_batches = len(BatchLoader(val_ds, cfg.batch_size))
    args = ["--model", "sdf_chd8bar", "--output_dir", run, "--data_dir", data,
            "--pretrained_dir", pretrained, "--log_every", str(LOG_EVERY), "--seed", "0"]
    totals = {name: 0 for name in counters}
    for steps, extra in ((TRAIN_STEPS, []), (RESUME_STEPS, ["--resume"])):
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = train_main(args + ["--max_steps", str(TRAIN_STEPS + (steps if extra else 0))] + extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {name: fn.launches for name, fn in counters.items()}
        want = dict({name: 0 for name in counters},
                    packed_attention=ATTENTION_SITES * (steps + val_batches),
                    packed_attention_bwd=ATTENTION_SITES * steps, gn_bwd=GROUPNORM_SITES * steps)
        log(f"[train] {'resumed ' if extra else ''}run: {steps} steps and {val_batches} val "
            f"batches in {secs:.3f} s (with setup), launches {got}")
        if got != want:
            raise AssertionError(f"expected launches {want}, got {got}")
        if state.step != TRAIN_STEPS + (steps if extra else 0):
            raise AssertionError(f"run ended at step {state.step}")
        for name in totals:
            totals[name] += got[name]
    records = [json_.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    train = [r for r in records if "train/loss" in r]
    val = [r for r in records if "val/loss" in r]
    losses = [r["train/loss"] for r in train] + [r["val/loss"] for r in val]
    if not (train and len(val) == 2 and np.isfinite(losses).all()):
        raise AssertionError(f"bad metrics: {records}")
    if [r["step"] for r in val] != [TRAIN_STEPS, TRAIN_STEPS + RESUME_STEPS]:
        raise AssertionError(f"validation steps {[r['step'] for r in val]}: the resumed run "
                             f"did not start at step {TRAIN_STEPS}")
    if not os.path.getsize(os.path.join(run, "chkpts", "last.pt")):
        raise AssertionError("no checkpoint written")
    warm = train[-1]["steps_per_sec"]
    log(f"[train] losses {[round(x, 5) for x in losses]}; warm window (steps "
        f"{train[-1]['step'] - LOG_EVERY + 1}-{train[-1]['step']}): {1e3 / warm:.3f} ms/step, "
        f"{warm:.3f} steps/s (host clock, metrics.jsonl); checkpoint "
        f"{os.path.getsize(os.path.join(run, 'chkpts', 'last.pt')) / 2**20:.1f} MiB")
    return totals


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
    session = InferenceSession(task, sampler="ddim", ddim_steps=50, seed=0)
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


def zero_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "two_input_launches"):
            fn.two_input_launches = 0


def drive_gn_conv_requests(counters):
    """DDIM-50 CFG-5 requests at batch GN_CONV_BATCH of the full-width bf16
    preset with the UNet's GroupNorm-SiLU-conv sites fused (kernel 4) and then
    int8 (kernel 5), two requests each, each with the launch counts set to 0
    just before it and read just after. Returns each mode's launches by kernel
    (both requests) and the second request's seconds."""
    import torch

    from polyffusion_tpu_torch.inference import InferenceSession
    from polyffusion_tpu_torch.ops.fused_gn_conv import gn_silu_conv3x3, gn_silu_conv3x3_q

    cfg = full_cfg(bf16=True)
    rng = np.random.default_rng(10)
    per_request = GN_CONV_SITES * 50
    zero = {name: 0 for name in counters}
    want = {
        "fused": dict(zero, packed_attention=LAUNCHES_PER_REQUEST, gn_silu_conv=per_request),
        "int8": dict(zero, packed_attention=LAUNCHES_PER_REQUEST, gn_silu_conv_q=per_request,
                     gn_silu_amax=per_request),
    }
    totals, secs = {}, {}
    for mode, two_input in (("fused", gn_silu_conv3x3), ("int8", gn_silu_conv3x3_q)):
        task = make_task(cfg, None, seed=0, gn_conv=mode)
        session = InferenceSession(task, sampler="ddim", ddim_steps=50, seed=0)
        totals[mode] = dict(zero)
        for i in range(2):
            chords = torch.from_numpy(random_chords(rng, GN_CONV_BATCH))
            zero_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = session.generate(task.encode_chord(chords), uncond_scale=5.0)
            torch.cuda.synchronize()
            secs[mode] = time.perf_counter() - t0
            got = {name: fn.launches for name, fn in counters.items()}
            n_two = two_input.two_input_launches
            log(f"[main] gn_conv {mode} request {i}: batch {GN_CONV_BATCH}: {secs[mode]:.3f} s, "
                f"{GN_CONV_BATCH / secs[mode]:.3f} samples/s, launches {got}, two-input {n_two}")
            if got != want[mode] or n_two != GN_CONV_TWO_INPUT * 50:
                raise AssertionError(f"expected launches {want[mode]} with "
                                     f"{GN_CONV_TWO_INPUT * 50} two-input, got {got}, {n_two}")
            if gen.shape != (GN_CONV_BATCH, 2, 128, 128) or not np.isfinite(gen).all():
                raise AssertionError(f"bad output: shape {gen.shape}")
            for name in totals[mode]:
                totals[mode][name] += got[name]
        del task, session
    return totals, secs


def midi_instruments(path: str) -> int:
    """The instrument tracks of a .mid written by the port's ``save_midi``: a
    format-1 file of one meta track and one track per instrument."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] != b"MThd":
        raise AssertionError(f"{path} is not a MIDI file")
    return int.from_bytes(head[10:12], "big") - 1


def drive_inference_cli(counters, work):
    """The inference CLI on the training path's run directory under ``work``
    (full width, bf16: its ``params.yaml`` and ``chkpts/last.pt``, with the
    same ``chd8bar.pt``), conditioned on one of the songs it trained on, as
    two requests, each with the launch counts set to 0 just before it and read
    just after: (A) the default DDPM-1000 RePaint inpainting, (B) piece-batched
    DDIM-50 long-form generation. Returns each request's launches by kernel,
    request A's seconds and its mask."""
    import torch

    from polyffusion_tpu_torch.data import SongNpz
    from polyffusion_tpu_torch.diffusion.schedule import make_schedule
    from polyffusion_tpu_torch.inference import main as infer_main

    run, data, pretrained = (os.path.join(work, d) for d in ("run", "songs", "pretrained"))
    base = ["--chkpt_path", run, "--data_dir", data, "--song_fn", CLI_SONG,
            "--pretrained_dir", pretrained, "--uncond_scale", "5"]
    requests = {
        "inpainting": ["--inpaint_type", "below", "--length", str(CLI_A_SEGMENTS)],
        "autoreg": ["--autoreg", "--ddim", "--length", str(CLI_B_SEGMENTS),
                    "--num_generate", str(CLI_B_PIECES)],
        "int8": ["--gn_conv", "int8", "--ddim", "--length", str(CLI_A_SEGMENTS)],
    }
    windows = 2 * CLI_B_SEGMENTS - 1
    zero = {name: 0 for name in counters}
    want = {
        "inpainting": dict(zero, packed_attention=ATTENTION_SITES * CLI_DDPM_STEPS,
                           repaint_epilogue=CLI_DDPM_STEPS),
        "autoreg": dict(zero, packed_attention=ATTENTION_SITES * CLI_DDIM_STEPS * windows),
        "int8": dict(zero, packed_attention=ATTENTION_SITES * CLI_DDIM_STEPS,
                     gn_silu_conv_q=GN_CONV_SITES * CLI_DDIM_STEPS,
                     gn_silu_amax=GN_CONV_SITES * CLI_DDIM_STEPS),
    }
    want_mids = {"inpainting": 1, "autoreg": CLI_B_PIECES, "int8": 1}
    launches, secs, outputs = {}, {}, {}
    for path, extra in requests.items():
        out_dir = os.path.join(work, path)
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs[path] = infer_main(base + extra + ["--output_dir", out_dir])
        torch.cuda.synchronize()
        secs[path] = time.perf_counter() - t0
        launches[path] = {name: fn.launches for name, fn in counters.items()}
        mids = sorted(f for f in os.listdir(out_dir) if f.endswith(".mid"))
        log(f"[cli] request {path} ({' '.join(extra)} --uncond_scale 5): {secs[path]:.3f} s, "
            f"launches {launches[path]}, wrote {mids}")
        if launches[path] != want[path]:
            raise AssertionError(f"expected launches {want[path]}, got {launches[path]}")
        if len(mids) != want_mids[path]:
            raise AssertionError(f"expected {want_mids[path]} .mid file(s), found {mids}")

    ((gen, mask),) = outputs["inpainting"]
    cfg = full_cfg(bf16=True)
    sqrt_ab0 = np.float32(make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end).sqrt_alpha_bar[0])
    orig = SongNpz(CLI_SONG, data).get_whole_song_data()[0][:CLI_A_SEGMENTS]
    keep = mask == 1
    known_err = float(np.abs(gen[keep] - sqrt_ab0 * orig[keep]).max())
    (mid,) = os.listdir(os.path.join(work, "inpainting"))
    tracks = midi_instruments(os.path.join(work, "inpainting", mid))
    log(f"[cli] request inpainting: output {gen.shape}, kept share {keep.mean():.3f}, known "
        f"region vs sqrt_alpha_bar[0] * orig: max_abs_err {known_err:.3g} (limit 1e-6); "
        f"{tracks} instrument tracks")
    if gen.shape != (CLI_A_SEGMENTS, 2, 128, 128) or not np.isfinite(gen).all():
        raise AssertionError(f"bad inpainting output: shape {gen.shape}")
    if not (0 < keep.mean() < 1 and known_err <= 1e-6 and tracks == 2):
        raise AssertionError("the inpainting request did not keep the known region in a "
                             "two-track .mid")
    (long_form,) = outputs["autoreg"]
    if (long_form.shape != (CLI_B_PIECES, 2 * CLI_B_SEGMENTS, 2, 64, 128)
            or not np.isfinite(long_form).all()):
        raise AssertionError(f"bad long-form output: shape {long_form.shape}")
    (int8_gen,) = outputs["int8"]
    if int8_gen.shape != (CLI_A_SEGMENTS, 2, 128, 128) or not np.isfinite(int8_gen).all():
        raise AssertionError(f"bad int8 output: shape {int8_gen.shape}")
    return launches, secs["inpainting"], mask


def profile_inpainting(work, mask, request_secs):
    """``torch.profiler`` over PROFILE_STEPS DDPM RePaint steps at request A's
    batch and CFG, on the weights the CLI loaded: the device's busy time per
    step by kernel class, and from it the card's idle share in request A
    (1 - 1000 x busy per step / request A's unprofiled seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from polyffusion_tpu_torch.config import load_params
    from polyffusion_tpu_torch.diffusion import sampler as S
    from polyffusion_tpu_torch.inference import build_task_for_inference, load_unet_params
    from polyffusion_tpu_torch.profile_unet import breakdown

    run = os.path.join(work, "run")
    task = build_task_for_inference(load_params(os.path.join(run, "params.yaml")),
                                    os.path.join(work, "pretrained"))
    task.load_unet_state(load_unet_params(run))
    g = torch.Generator(device=task.device).manual_seed(7)
    m = torch.from_numpy(nhwc(mask)).to(task.device)
    x = torch.randn(m.shape, device=task.device, generator=g)
    orig = (torch.rand(m.shape, device=task.device, generator=g) < 0.05).float()
    cond = torch.randn((m.shape[0], 1, task.cfg.d_cond), device=task.device, generator=g)

    def paint(steps):
        S.ddpm_paint(task.apply_eps, task.schedule, x, cond, steps - 1, g, orig=orig, mask=m,
                     uncond_scale=5.0, uncond_cond=-torch.ones_like(cond))
        torch.cuda.synchronize()

    paint(5)  # warm up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        paint(PROFILE_STEPS)
        wall_ms = (time.perf_counter() - t0) * 1e3
    log(f"[profile] {PROFILE_STEPS} DDPM RePaint steps at batch {m.shape[0]}, CFG 5 "
        f"(UNet batch {2 * m.shape[0]}), {'bf16' if task.cfg.bf16 else 'fp32'}, under "
        f"torch.profiler:")
    busy_ms = breakdown(prof, wall_ms, PROFILE_STEPS, "step")
    sys.stdout.flush()
    if busy_ms:
        step_ms = busy_ms / PROFILE_STEPS
        log(f"[profile] device busy {step_ms:.3f} ms per step; request A: "
            f"{CLI_DDPM_STEPS} x {step_ms:.3f} ms busy of {request_secs:.3f} s, idle share "
            f"{1 - CLI_DDPM_STEPS * step_ms / (request_secs * 1e3):.4f}")


def write_condition_encoders(pretrained, seed):
    """Seeded random full-width texture and PianoTree encoders in the
    reference's layouts, beside the training path's ``chd8bar.pt``:
    ``polydis.pt`` (a PolyDis learner checkpoint, the encoder under
    ``rhy_encoder.``) and ``pnotree.pt`` (the PianoTree VAE's state dict)."""
    import torch

    from polyffusion_tpu_torch.models import PianoTreeEncoder, TextureEncoder, init_weights_

    g = torch.Generator().manual_seed(seed)
    txt = init_weights_(TextureEncoder(), g)
    torch.save({"model": {f"rhy_encoder.{k}": v for k, v in txt.state_dict().items()}},
               os.path.join(pretrained, "polydis.pt"))
    torch.save(init_weights_(PianoTreeEncoder(), g).state_dict(),
               os.path.join(pretrained, "pnotree.pt"))


def cond_task(name, device, pretrained, seed=0, bf16=None, tiny=False):
    """The task of a condition preset with the frozen encoders from
    ``pretrained`` and UNet weights from ``seed``; ``tiny`` cuts the UNet to
    one level without attention (for checks that never run it)."""
    import torch

    from polyffusion_tpu_torch.config import load_params
    from polyffusion_tpu_torch.models.encoders import build_frozen_encoders
    from polyffusion_tpu_torch.tasks import SDFTask

    cfg = load_params(name)
    if bf16 is not None:
        cfg.bf16 = bf16
    if tiny:
        cfg.update(channels=32, channel_multipliers=[1], attention_levels=[], n_res_blocks=1)
    return SDFTask(cfg, **build_frozen_encoders(cfg, pretrained), device=device,
                   generator=torch.Generator().manual_seed(seed))


def song_batch(data, b):
    """The first batch of ``b`` segments of the songs in ``data`` (unshuffled,
    not augmented), as tensors (prmat2c, pnotree, chord, prmat)."""
    import torch

    from polyffusion_tpu_torch.data import BatchLoader, SegmentDataset

    batch = next(iter(BatchLoader(SegmentDataset.from_dir(data), b)))
    return tuple(torch.from_numpy(a) for a in batch)


def check_conditions_against_cpu(work):
    """The five condition presets in fp32, card against CPU, on 8 segments of
    the synthetic songs: ``encode_cond`` (the frozen chord, texture and
    PianoTree encoders, full width) within COND_ATOL; then one full-width
    ``sdf_chd8bar_txt`` UNet eval on that condition within the UNet
    tolerance."""
    import torch

    pretrained, data = os.path.join(work, "pretrained"), os.path.join(work, "songs")
    batch = song_batch(data, 8)
    for name in COND_PRESETS:
        conds = {}
        for device in ("cuda", "cpu"):
            task = cond_task(name, device, pretrained, bf16=False, tiny=True)
            t0 = time.perf_counter()
            conds[device] = (task.encode_cond(batch).cpu(), time.perf_counter() - t0)
        (got, t_gpu), (want, t_cpu) = conds["cuda"], conds["cpu"]
        err = (got - want).abs().max().item()
        log(f"[cond] {name} encode_cond {tuple(want.shape)} card vs CPU: max_abs_err {err:.3g} "
            f"(atol {COND_ATOL}), |cond| max {want.abs().max().item():.3g}; card {t_gpu:.2f} s "
            f"(first call), CPU {t_cpu:.2f} s")
        if not (err <= COND_ATOL and torch.isfinite(got).all()):
            raise AssertionError(f"{name}: the condition on the card disagrees with the CPU")
        if name == "sdf_chd8bar_txt":
            chd_txt = want[:2]
    unet_card_vs_cpu(cond_task("sdf_chd8bar_txt", "cuda", pretrained, seed=4, bf16=False),
                     cond_task("sdf_chd8bar_txt", "cpu", pretrained, seed=4, bf16=False),
                     chd_txt, "sdf_chd8bar_txt, d_cond 1536")


def drive_condition_requests(counters, work):
    """A warm DDIM-50 CFG-5 request of each of COND_REQUESTS at full width in
    bf16 (its conditions from the songs' segments: chord + texture means, or
    the raw 128-token prmat), with the launch counts set to 0 just before it
    and read just after: 550 kernel-1 launches each (the 128-token
    cross-attention takes the plain route). Returns launches and samples/s
    by preset."""
    import torch

    from polyffusion_tpu_torch.inference import InferenceSession

    pretrained, data = os.path.join(work, "pretrained"), os.path.join(work, "songs")
    zero = {name: 0 for name in counters}
    launches, rates = {}, {}
    for name, b in COND_REQUESTS:
        task = cond_task(name, None, pretrained)
        batch = song_batch(data, b)
        # warm: the same batch through a 2-step session
        InferenceSession(task, sampler="ddim", ddim_steps=2, seed=1).generate(
            task.encode_cond(batch), uncond_scale=5.0)
        session = InferenceSession(task, sampler="ddim", ddim_steps=50, seed=0)
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cond = task.encode_cond(batch)
        gen = session.generate(cond, uncond_scale=5.0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        rates[name] = b / secs
        log(f"[cond] {name} request: batch {b}, condition {tuple(cond.shape)}: {secs:.3f} s, "
            f"{rates[name]:.3f} samples/s, launches {launches[name]}")
        want = dict(zero, packed_attention=LAUNCHES_PER_REQUEST)
        if launches[name] != want:
            raise AssertionError(f"expected launches {want}, got {launches[name]}")
        if gen.shape != (b, 2, 128, 128) or not np.isfinite(gen).all():
            raise AssertionError(f"bad output: shape {gen.shape}")
        del task, session
    return launches, rates


def drive_mix2_paths(counters, work):
    """``polyffusion_tpu_torch.main`` for the full-width bf16
    ``sdf_chd8bar_txt_mix2`` at its batch 16 on the training path's songs and
    encoders, MIX2_STEPS steps, one validation and one checkpoint; then the
    inference CLI on that run directory, ``--ddim --length 2 --uncond_scale
    5``. Each with the launch counts set to 0 just before it and read just
    after; returns both runs' launches."""
    import torch

    from polyffusion_tpu_torch.data import BatchLoader, SegmentDataset
    from polyffusion_tpu_torch.inference import main as infer_main
    from polyffusion_tpu_torch.main import main as train_main

    pretrained, data = os.path.join(work, "pretrained"), os.path.join(work, "songs")
    run, out = os.path.join(work, "run_mix2"), os.path.join(work, "gen_mix2")
    _, val_ds = SegmentDataset.train_val_from_dir(data, 0.9)
    val_batches = len(BatchLoader(val_ds, 16))
    zero = {name: 0 for name in counters}

    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train_main(["--model", "sdf_chd8bar_txt_mix2", "--output_dir", run, "--data_dir", data,
                        "--pretrained_dir", pretrained, "--log_every", "4", "--seed", "0",
                        "--max_steps", str(MIX2_STEPS)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    training = {name: fn.launches for name, fn in counters.items()}
    want = dict(zero, packed_attention=ATTENTION_SITES * (MIX2_STEPS + val_batches),
                packed_attention_bwd=ATTENTION_SITES * MIX2_STEPS,
                gn_bwd=GROUPNORM_SITES * MIX2_STEPS)
    records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    losses = [r[k] for r in records for k in ("train/loss", "val/loss") if k in r]
    log(f"[cond] sdf_chd8bar_txt_mix2 training: {MIX2_STEPS} steps and {val_batches} val batches "
        f"in {secs:.3f} s (with setup), losses {[round(x, 5) for x in losses]}, launches "
        f"{training}")
    if training != want:
        raise AssertionError(f"expected launches {want}, got {training}")
    if not (state.step == MIX2_STEPS and losses and np.isfinite(losses).all()
            and os.path.getsize(os.path.join(run, "chkpts", "last.pt"))):
        raise AssertionError(f"the mix2 run ended at step {state.step} with losses {losses}")

    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (gen,) = infer_main(["--chkpt_path", run, "--data_dir", data, "--song_fn", CLI_SONG,
                         "--pretrained_dir", pretrained, "--ddim", "--length", "2",
                         "--uncond_scale", "5", "--output_dir", out])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cli = {name: fn.launches for name, fn in counters.items()}
    mids = sorted(f for f in os.listdir(out) if f.endswith(".mid"))
    log(f"[cond] sdf_chd8bar_txt_mix2 CLI request (--ddim --length 2 --uncond_scale 5): "
        f"{secs:.3f} s, launches {cli}, wrote {mids}")
    if cli != dict(zero, packed_attention=ATTENTION_SITES * CLI_DDIM_STEPS):
        raise AssertionError(f"expected {ATTENTION_SITES * CLI_DDIM_STEPS} kernel-1 launches, "
                             f"got {cli}")
    if len(mids) != 1 or gen.shape != (2, 2, 128, 128) or not np.isfinite(gen).all():
        raise AssertionError(f"bad CLI output: {mids}, shape {gen.shape}")
    return training, cli


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from polyffusion_tpu_torch.device import tf32
    from polyffusion_tpu_torch.ops import _build
    from polyffusion_tpu_torch.ops.fused_attention import (
        fused_self_attention,
        packed_attention_bwd,
        packed_self_attention,
    )
    from polyffusion_tpu_torch.ops.fused_gn_conv import (
        gn_silu_amax,
        gn_silu_conv3x3,
        gn_silu_conv3x3_q,
    )
    from polyffusion_tpu_torch.ops.gn_bwd import group_norm_bwd
    from polyffusion_tpu_torch.ops.repaint_epilogue import fused_repaint_epilogue
    from polyffusion_tpu_torch.profile_attention import map_cache_counts

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
    bwd_rows = check_attention_bwd()
    host_rows = host_launch_costs()
    hm_rows = check_head_major_attention()
    gn_rows = check_gn_bwd()
    epi_rows = check_repaint_epilogue()
    gnc_rows = check_gn_conv(quantized=False)
    gnq_rows = check_gn_conv(quantized=True)
    check_gn_conv_gradient()
    check_unet_against_cpu()
    check_unet_against_cpu(gn_conv="fused")
    check_int8_against_fused()
    check_train_step_against_cpu()
    check_ddpm_paint_against_cpu()
    sites = count_sites(make_task(full_cfg(bf16=True), "cpu", seed=0).unet)
    if sites != (ATTENTION_SITES, GROUPNORM_SITES):
        raise AssertionError(f"the full-width UNet has {sites} (attention, GroupNorm) sites")

    # the main paths: DDIM sampling, training, then the inference CLI on the
    # run directory the training wrote
    cache = {}  # the tensor-map cache's hits and misses on each path
    before = map_cache_counts()
    packed_self_attention.launches = 0
    sampling = drive_main_path(packed_self_attention)
    cache["ddim_requests"] = map_cache_delta(before, "the DDIM-50 requests")
    if sampling == 0:
        raise AssertionError("the main path never launched packed_attention")
    counters = {"packed_attention": packed_self_attention,
                "packed_attention_bwd": packed_attention_bwd,
                "head_major_attention": fused_self_attention, "gn_bwd": group_norm_bwd,
                "repaint_epilogue": fused_repaint_epilogue, "gn_silu_conv": gn_silu_conv3x3,
                "gn_silu_conv_q": gn_silu_conv3x3_q, "gn_silu_amax": gn_silu_amax}
    head_major = drive_head_major(counters)
    gn_conv_paths, _ = drive_gn_conv_requests(counters)
    with tempfile.TemporaryDirectory() as work:
        before = map_cache_counts()
        training = drive_training_path(counters, work)
        cache["training"] = map_cache_delta(before, "the training runs")
        if min(training[k] for k in ("packed_attention", "packed_attention_bwd", "gn_bwd")) == 0:
            raise AssertionError(f"the training path did not launch every kernel: {training}")
        before = map_cache_counts()
        cli, request_secs, mask = drive_inference_cli(counters, work)
        cache["inference_cli"] = map_cache_delta(before, "the inference CLI's requests A and B")
        profile_inpainting(work, mask, request_secs)
        # the texture and PianoTree conditions, on the same songs and chd8bar.pt
        write_condition_encoders(os.path.join(work, "pretrained"), seed=6)
        check_conditions_against_cpu(work)
        cond_requests, _ = drive_condition_requests(counters, work)
        mix2_training, mix2_cli = drive_mix2_paths(counters, work)

    def entry(name, source, replaces, launches, rows, main_row, errs_of):
        extra = {}
        host = {r["shape"]: r["host_us_per_call"] for r in host_rows if r["kernel"] == name}
        if host:
            extra["host_us_per_launch"] = host
        if name in ("packed_attention", "packed_attention_bwd"):
            extra["tensor_map_cache_by_path"] = {path: c[name] for path, c in cache.items()}
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in errs_of),
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "at": main_row["shape"],
            **extra,
            "shapes": rows,
        }

    fwd_bf16 = [r for r in rows if r["shape"].endswith("bfloat16")]
    bf16 = [r for r in bwd_rows if r["shape"].endswith("bfloat16")]
    hm_bf16 = [r for r in hm_rows if r["shape"].endswith("bfloat16")]
    gn_bf16 = [r for r in gn_rows if r["shape"].endswith("bfloat16")]
    kernels = [
        # B=128 T=1024 bf16: the sampling path's dominant shape
        entry("packed_attention", "polyffusion_tpu_torch/ops/csrc/packed_attention.cu",
              "polyffusion_tpu/ops/fused_attention.py:53",
              {"sampling": sampling, "training": training["packed_attention"],
               "inpainting": cli["inpainting"]["packed_attention"],
               "autoreg": cli["autoreg"]["packed_attention"],
               **{f"sampling_{name}": n["packed_attention"] for name, n in cond_requests.items()},
               "training_mix2": mix2_training["packed_attention"],
               "cli_mix2": mix2_cli["packed_attention"]},
              rows, rows[0], fwd_bf16),
        # B=16 T=1024 bf16: the train step's dominant shape
        entry("packed_attention_bwd", "polyffusion_tpu_torch/ops/csrc/packed_attention_bwd.cu",
              "polyffusion_tpu/ops/fused_attention.py:111",
              {"training": training["packed_attention_bwd"],
               "training_mix2": mix2_training["packed_attention_bwd"]}, bwd_rows, bf16[0], bf16),
        # BH=512 T=1024 D=64 bf16: a batch-128 level-2 self-attention in head-major
        # form; on no model path, driven directly
        entry("head_major_attention", "polyffusion_tpu_torch/ops/csrc/packed_attention.cu",
              "polyffusion_tpu/ops/fused_attention.py:29", {"direct": head_major}, hm_rows,
              [r for r in hm_bf16 if r["shape"].startswith("BH=512 T=1024")][0], hm_bf16),
        # B=16 C=64 128x128 bf16: the largest GroupNorm of the train step
        entry("gn_bwd", "polyffusion_tpu_torch/ops/csrc/gn_bwd.cu",
              "polyffusion_tpu/ops/gn_bwd.py:66",
              {"training": training["gn_bwd"], "training_mix2": mix2_training["gn_bwd"]},
              gn_rows, gn_bf16[0], gn_bf16),
        # B=2 2x128x128 fp32: request A's sampler batch
        entry("repaint_epilogue", "polyffusion_tpu_torch/ops/csrc/repaint_epilogue.cu",
              "polyffusion_tpu/ops/pallas_sampler.py:33",
              {"inpainting": cli["inpainting"]["repaint_epilogue"]}, epi_rows, epi_rows[0],
              epi_rows),
        # B=128 C=64->64 128x128 bf16 with the residual: the costliest site shape
        entry("gn_silu_conv", "polyffusion_tpu_torch/ops/csrc/gn_silu_conv.cu",
              "polyffusion_tpu/ops/fused_gn_conv.py:36",
              {"sampling_fused": gn_conv_paths["fused"]["gn_silu_conv"]}, gnc_rows, gnc_rows[1],
              [r for r in gnc_rows if "bfloat16" in r["shape"]]),
        entry("gn_silu_conv_q", "polyffusion_tpu_torch/ops/csrc/gn_silu_conv.cu",
              "polyffusion_tpu/ops/fused_gn_conv.py:36",
              {"sampling_int8": gn_conv_paths["int8"]["gn_silu_conv_q"],
               "cli_int8": cli["int8"]["gn_silu_conv_q"]}, gnq_rows, gnq_rows[1],
              [r for r in gnq_rows if "bfloat16" in r["shape"]]),
    ]
    # kernel 5's amax pass runs once before each of its convolutions
    kernels[-1]["amax_pass_launches_by_path"] = {
        "sampling_int8": gn_conv_paths["int8"]["gn_silu_amax"],
        "cli_int8": cli["int8"]["gn_silu_amax"]}
    kernels[-1]["amax_pass_ms"] = gnq_rows[1]["amax_pass_ms"]
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
