#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``polyffusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card. It builds the port's CUDA
kernels from the sources in the checkout (one ``nvcc`` per source, in
parallel), holds every kernel against its plain PyTorch version on the card
(with a planted fault that must fail each limit; kernels 3 and 4's gradients
through their autograd functions too; kernel 1's row log-sum-exp, the
forward's second output, against its plain version; kernel 2 given that lse,
as the train step gives it; kernel 6 at every GroupNorm shape of the train
step, warm and cold, and with a second planted fault where a span takes a
cluster; kernels 1 and 8 also at sdxl_base's shapes at its CFG batch of 8; kernel 7 also behind the queued CFG combine that writes its eps,
and behind a predecessor that lets it start early, where a planted copy
that reads eps before its wait must fail),
times an empty kernel (the launch floor), logs the host microseconds per
launch of kernels 1-3 (``profile_attention``) and 7 and the tensor-map
cache's hits and misses on each main path, holds the full-width fp32 UNet
eval (with the GroupNorm-SiLU-conv sites unfused and fused), one full-width
fp32 train step
and a full-width fp32 DDPM RePaint run on the card against the CPU, and the
full-width bf16 UNet's int8 eps against its fused eps (the train step also with the
GroupNorm-SiLU-conv sites fused: kernel 4 forward, a backward through its
plain version), then drives the main paths through the user's entry points,
each with the kernels' launch counts set to 0 just before it and read just
after:

- sampling: the full-width ``sdf_chd8bar`` preset in bf16 with seeded random
  weights, chord one-hots -> chord encoder -> ``InferenceSession.generate`` at
  DDIM-50, CFG 5, for requests of batch 1, 16, 64 and 64; then two requests
  at batch 64 with ``gn_conv="fused"`` (kernel 4 at all 44 sites of every UNet
  eval) and two with ``gn_conv="int8"`` (kernel 5);
- training through kernel 4: three full-width bf16 train steps at batch 16
  with ``gn_conv="fused"``, 44 kernel-4 launches a step (12 two-input);
- the XLA int8 route and the CFG fork (``[routes]``): ``int8_conv`` at a
  (16, 256 -> 256, 16^2) site and ``int8_concat_conv`` at a (16, 64 + 64 ->
  64, 128^2) decoder site card vs CPU on the same fp32 inputs (codes, scales
  and int32 sums equal, the output to two fp32 ulps; faults: one amax over the
  batch, one weight scale over the concat's kernel), the full-width bf16
  ``gn_conv="int8_xla"`` eps at batch 16 against the fused eps (fault: the
  decoder concats' skip half dropped) and beside kernel 5's, the fork against
  the double batch in fp32 at B = 4 and bf16 at B = 64 (fault: the
  condition's halves swapped) with each form's eval time and peak memory,
  then a DDIM-50 CFG-5 request with ``cfg_fork`` at batch 64 and one with
  ``gn_conv="int8_xla"`` at batch 16 (550 kernel-1 launches each, no kernel
  4 or 5);
- the space-to-depth level 0 (``[s2d]``, ``gn_conv="s2d"``): the full-width
  fp32 UNet at B = 4 card vs CPU and folded vs unfolded on the card, its fork
  at B = 2 vs the double batch (atol 2e-4, rtol 1e-4; faults: ``from_s2d``
  with its parities swapped, the condition's halves swapped), an fp32 train
  step card vs CPU at the [train] limits (same fault) with 11 / 11 / 45
  launches of kernels 1 / 2 / 6 (the 11 folded norms' backward is
  autograd's), the bf16 eval at B = 64 folded and unfolded in turns (ms, peak
  memory and their mean relative difference, a reading), and a DDIM-50 CFG-5
  request at batch 16 (550 kernel-1 launches);
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
  through ``polyffusion_tpu_torch.main`` and sampled through the CLI;
- the pretraining of the frozen encoders, fp32 at the presets' widths (plain
  PyTorch: no kernel of the port runs there, and none may launch): one train
  step of ``chd_8bar`` (batch 128) and of ``pnotree_vae`` (4 segments) on the
  card against the CPU; ``chd_8bar`` through ``polyffusion_tpu_torch.main``
  for 30 steps, one validation and one checkpoint, then ``--resume`` for 6;
  ``pnotree_vae`` at batch 32 (128 segments) for 3 steps and 2 resumed; each
  task's ms per step (host clock, CUDA events), device busy and idle share
  (``torch.profiler``) and device kernels per step; then both run directories
  as frozen encoders (``<pretrained>/chd8bar/``, ``<pretrained>/pnotree/``):
  ``sdf_chd8bar`` and ``sdf_pnotree`` trained 4 steps each from them, and
  each task's ``encode_cond`` on the card against the trained encoder on the
  CPU;
- serving and evaluation (``[serve]``, ``[expr]``), on those run
  directories: the generation worker as ``python -m
  polyffusion_tpu_torch.serve`` builds it (DDIM-50, batch 8, warmed at
  scales 1 and 5, a 25 ms coalescing queue) behind its HTTP server on
  127.0.0.1, answering a chord request, four concurrent requests in one
  device pass, a long-form request of 3 windows and 2 pieces, a seeded
  request twice (the same MIDI), a malformed one (400) and one more, each
  with its kernel-1 launches counted (550 a pass) and its seconds and
  device ms; then ``polyffusion_tpu_torch.expr.main`` at ``--ddim
  --batch_size 16``: uncond, inp_below, inp_bars and chd on the training
  run, chd_acc at scales 0 and 5 over 2 batches, fd and txt_acc on the
  chord+txt run, pnt_acc on the PianoTree one (550 launches a batch and a
  scale, tables finite); and the inference CLI with ``--dump_images`` (11
  PNGs) and ``--bf16_params``;
- distillation (``polyffusion_tpu_torch.distill``) of the training path's run
  directory, full width, bf16, batch 16: stage A and the halving phases 8 ->
  4 -> 2, then chain mode 2 -> 1 from its output (per step kernel 1 at the
  teacher's and the student's forwards, 22 guided and 33 halving, kernel 2
  at 11 and kernel 6 at 56 backwards); the inference CLI on both students
  (``--ddim --uncond_scale 1``), which pin their grids; warm guided and
  halving steps timed (host clock, CUDA events) and profiled (idle share);
  warm batch-16 requests of the 2-step and 1-step students beside the
  teacher's DDIM-50 CFG-5 request;
- the blurry-image condition, ``sdf_concat`` in bf16 at its batch 16: 4 steps
  through ``polyffusion_tpu_torch.main``, the inference CLI's "below"
  inpainting on its run directory at DDIM-50 and at DDPM-1000 (kernels 1 and
  7), and a DDIM-50 request at batch 16;
- MIDI in and PolyDis out (``[midi]``, after the mix2 paths): four seeded
  64-bar MIDI songs (one with a tempo change) through ``song_from_midi``
  (host seconds; the share of beats whose recognized root is the written
  one) and ``prepare_data`` (its songs exact against ``song_from_midi``'s),
  then the inference CLI's MIDI requests at DDIM-50 over 2 segments, 550
  kernel-1 launches each: (D) ``--from_midi`` with no ``--data_dir``, (D')
  the same song prepared (the same condition, and card vs CPU), (E)
  ``--inpaint_from_midi`` (its kept region against the DDIM q_sample of the
  second song), (F) ``--from_midi2`` on the chord+txt run directory (chord
  part from the first song, texture from the second, vs the CPU), (G)
  ``--polydis_recon`` with a seeded PolyDis checkpoint in the reference
  layout; the warm PolyDis aftertouch timed alone; and PolyDis fp32 at its
  widths card vs CPU (encoder, a teacher-forced loss and its gradients, its
  logits, the greedy grid by its share of equal cells; planted fault: the
  z_chd | z_rhy halves swapped);
- the trainer's and converter's leftovers and the tools (``[maintenance]``,
  after the inference CLI): synthetic songs from ``python -m
  polyffusion_tpu_torch.tools synth_corpus``, the training CLI on them (full
  width, bf16, batch 16) with ``remat`` (kernel 1 twice per attention site a
  step: 22, 11 kernel-2, 56 kernel-6), the legacy ``weights.pt`` mirror and a
  ``--profile_steps`` window whose Chrome trace must name kernels 1, 2 and 6 at
  2 x (22, 11, 56) launches; a remat step against a plain one on the card
  (planted fault: the bf16 working copy changed before the backward), fused
  plain and remat steps (44 and 88 kernel-4 launches), both steps timed with
  their peak memory and idle share; ``python -m polyffusion_tpu_torch.convert``
  (``--kind unet --reverse`` of the run directory, ``--kind unet`` of
  ``weights.pt``), one seeded DDIM-50 request each from the run directory, the
  reversed ``.pt`` and ``weights.pt`` (550 kernel-1 launches each, the same
  bytes); ``pop909_import``, ``remove_from_split`` and ``cleanup_checkpoints``;
- the plain DDPM family and the KL autoencoder (``[ddpm]``,
  ``[autoencoder]``, last), fp32 at the presets' widths: the DDPM UNet eval
  and one DDPM train step card vs CPU (fault: the final norm at 32 groups),
  one autoencoder train step with disc_start 0 (fault: the discriminator's
  batch norms on running statistics) and the distances of a seeded random
  LPIPS checkpoint in the reference's layout (fault: the ScalingLayer left
  out) card vs CPU; ``polyffusion_tpu_torch.main``
  for ``ddpm`` and ``autoencoder`` at batch 16 (10 steps, one validation and
  one checkpoint, then 2 resumed; the autoencoder once more with disc_start 0
  and the LPIPS file), kernel 6 at every GroupNorm backward (45 and 52 a
  step); the inference CLI on the DDPM run directory (DDPM-1000 at --length
  1, --ddim at --length 2; no kernel of the port); warm steps of each timed
  and profiled.

Before the main paths it also holds, card against CPU in fp32 at full width
with a planted fault each: ``sdf_concat``'s ``blurry_image``, UNet eval and a
DDPM RePaint run with the blurry channels (fault: the channels zeroed);
DPM-Solver++ order 2 with a mask (fault: order 1); one guided and one halving
distillation loss with the student's gradients (faults: the teacher at scale
1; its second step at the student's level).

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
# kernel 6's shapes: every GroupNorm backward of the bf16 train step at batch
# 16, (C, H, W, sites per step), 56 in all; then fp32 (B, C, H, W) spans that
# take a cluster of 2, of 4 and of 8 (the largest, 768 KB of x and dy)
GN_TRAIN_SHAPES = [
    (64, 128, 128, 8), (128, 128, 128, 2), (192, 128, 128, 1), (64, 64, 64, 1), (128, 64, 64, 6),
    (192, 64, 64, 1), (256, 64, 64, 1), (384, 64, 64, 1), (128, 32, 32, 1), (256, 32, 32, 11),
    (384, 32, 32, 1), (512, 32, 32, 2), (256, 16, 16, 17), (512, 16, 16, 3),
]
GN_FP32_SHAPES = [(4, 128, 64, 64), (4, 256, 64, 64), (2, 192, 128, 128)]
# kernel 6 on the fp32 train steps of the plain DDPM UNet and the autoencoder at
# batch 16: (C, H, W, groups, sites per DDPM step, sites per autoencoder step),
# 45 and 52 in all (counted by a forward hook, tests/test_torch_gn_bwd_families.py);
# the DDPM UNet's final norm has 8 groups and its widest concat 64 channels a group
GN_FAMILY_SHAPES = [
    (64, 128, 128, 32, 7, 10), (128, 128, 128, 32, 3, 1), (64, 128, 128, 8, 1, 0),
    (64, 64, 64, 32, 2, 1), (128, 64, 64, 32, 5, 8), (192, 64, 64, 32, 1, 0),
    (256, 64, 64, 32, 2, 1), (128, 32, 32, 32, 2, 1), (256, 32, 32, 32, 5, 9),
    (384, 32, 32, 32, 1, 0), (512, 32, 32, 32, 2, 0), (256, 16, 16, 32, 2, 21),
    (1024, 16, 16, 32, 9, 0), (1280, 16, 16, 32, 1, 0), (2048, 16, 16, 32, 2, 0),
]
L2_BYTES = 50 * 2**20  # the H100's L2: cold timings rotate through more than this
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
# Kernel 7 behind a predecessor that lets it start early and writes its eps
# EARLY_TRIGGER_NS later (1 ms, far longer than a launch from the host;
# csrc/repaint_epilogue.cu:early_trigger_copy); the planted fault is a copy of
# the kernel's source that loads its inputs before griddepcontrol.wait
# (EPI_WAIT moved to after EPI_LOADS)
EARLY_TRIGGER_NS = 1_000_000
EPI_WAIT = ("  grid_dependency_wait();  // the previous kernel's output (eps) is complete from "
            "here on\n")
EPI_LOADS = "               vm = mask[i];\n"
CLI_CFG_SCALE = 5.0  # the CFG scale of the CLI's requests: e_u + s (e_c - e_u) feeds kernel 7
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
PROFILE_STEPS = 20
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
# [routes]: the XLA int8 route and the CFG fork. int8_conv's sites (B, C1, C2,
# O, H = W; C2 > 0 a decoder concat) card vs CPU: equal codes and int32 sums,
# the output the same fp32 rescale of them (two ulps); the int8_xla eps and a
# DDIM-50 request at ROUTES_INT8_BATCH, the fork's bf16 eval and request at
# ROUTES_FORK_BATCH
INT8_ROUTE_SITES = [(16, 256, 0, 256, 16), (16, 64, 64, 64, 128)]
INT8_OUT_ATOL, INT8_OUT_RTOL = 1e-30, 2**-22  # the atol only keeps 0 / 0 out
ROUTES_INT8_BATCH, ROUTES_FORK_BATCH = 16, 64
# [s2d]: the space-to-depth level 0 (gn_conv="s2d"). The fp32 UNet's batch,
# the bf16 eval's (CFG batch twice it) and the DDIM-50 request's; the level-0
# GroupNorms that fold (4 input and 6 output ResBlock norms, the head), whose
# backward is autograd's, not kernel 6
S2D_FP32_BATCH, S2D_EVAL_BATCH, S2D_REQUEST_BATCH = 4, 64, 16
S2D_FOLDED_NORMS = 11
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
# The pretraining of the frozen encoders at their presets' widths, fp32 (no
# kernel of the port on these paths): chd_8bar (hidden 512, z 512) at its batch
# 128, CHD_VAL_SONGS of the training songs held out so that one val batch
# fills; pnotree_vae at batch 32 (128 segments of the decoder); the card vs
# CPU step of pnotree_vae at PNO_CHECK_BATCH (4 segments). Then sdf_chd8bar and
# sdf_pnotree, full width, bf16, trained SDF_FROM_RUN_STEPS steps from their
# run directories.
CHD_STEPS, CHD_RESUME_STEPS, CHD_VAL_SONGS = 30, 6, 8
PNO_BATCH, PNO_STEPS, PNO_RESUME_STEPS, PNO_CHECK_BATCH = 32, 3, 2, 1
SDF_FROM_RUN_STEPS = 4
VAE_PROFILE = {"chd_8bar": (5, 3), "pnotree_vae": (2, 1)}  # (timed, profiled) warm steps
# The blurry-image condition (sdf_concat, fp32 full width) card vs CPU: the UNet
# eval with the blurry channels at the UNet tolerance, a DDPM RePaint run at the
# sampler tolerance (PAINT_*), and blurry_image itself (an antialiased bicubic
# downsample and a nearest upsample; the CPU and the card sum the same 16 taps
# in other orders). Planted fault: the card's blurry channels zeroed.
BLUR_ATOL = 1e-6
# DPM-Solver++ (order 2) on a DPMPP_STEPS-step tau grid from its top, full width,
# fp32, CFG 5, a "below" mask, card vs CPU at the sampler tolerance; planted
# fault: the card at order 1 (no second-order correction)
DPMPP_STEPS = 4
# Distillation card vs CPU, fp32 full width, batch 2: one guided step
# (eps_guided teacher at DISTILL_GUIDE) and one halve step (v teacher, the
# 8 -> 4 phase), at the train step's limits (STEP_LOSS_RTOL, STEP_GRAD_RTOL);
# planted faults: the card's teacher at scale 1, and its second teacher step at
# the student's level instead of the intermediate one
DISTILL_GUIDE = 5.0
DISTILL_CHECK_BATCH = 2
# The distill CLI on the training path's run directory (full width, bf16, batch
# 16): stage A and the phases 8 -> 4 -> 2, then chain mode 2 -> 1. Per step:
# kernel 1 at the teacher's passes and the student's forward (guided: one
# double-batched teacher call, 11 + 11; halve: two teacher calls, 22 + 11),
# kernel 2 at the student's 11 attention backwards, kernel 6 at its 56
# GroupNorm backwards; a validation batch runs the forwards only
DISTILL_BASE, DISTILL_END, DISTILL_CHAIN_END = 8, 2, 1
DISTILL_STAGE_A_STEPS, DISTILL_PHASE_STEPS = 4, 3
GUIDED_FWD, HALVE_FWD = 2 * ATTENTION_SITES, 3 * ATTENTION_SITES
DISTILL_PROFILE = (5, 3)  # (timed, profiled) warm distillation steps per mode
STUDENT_BATCH = 16
# sdf_concat end to end, bf16 at its batch 16: CONCAT_STEPS steps through the
# training CLI, then the inference CLI's "below" inpainting at DDIM-50 and at
# DDPM-1000 (kernels 1 and 7), 2 segments at scale 1, and one DDIM-50 request
# at batch 16
CONCAT_STEPS = 4
# The plain DDPM family ([ddpm]) and the KL autoencoder ([autoencoder]), fp32 at
# their presets' widths (TF32 off, as for every fp32 path here). Card vs CPU at
# batch FAMILY_CHECK_BATCH with a planted fault each: the DDPM UNet eval at the
# UNet tolerance and one DDPM train step at the step's limits (fault: the final
# norm at 32 groups, not 8); one autoencoder train step with disc_start 0 (the
# discriminator's terms and the adaptive weight live; fault: the
# discriminator's batch norms on running statistics, an nn.BatchNorm2d in eval
# mode) and the distances of a seeded random LPIPS checkpoint in the
# reference's layout (fault: the ScalingLayer left out). Then the training CLI
# at the presets' batch 16: FAMILY_STEPS steps with one validation and one
# checkpoint, then --resume for FAMILY_RESUME_STEPS; the autoencoder again with
# disc_start 0 and the LPIPS file. Kernel 6 runs every GroupNorm backward,
# DDPM_GN_SITES / AE_GN_SITES a step (a validation batch runs none; the
# adaptive weight's two gradients stop at the decoder's last conv). Then the
# inference CLI on the DDPM run: the default DDPM-1000 and --ddim (DDIM-50),
# which launch no kernel of the port (the unmasked sampler has no RePaint
# epilogue, and the DDPM attention is a plain product, as in the JAX package).
FAMILY_CHECK_BATCH = 2
DDPM_GN_SITES, AE_GN_SITES = 45, 52
FAMILY_STEPS, FAMILY_RESUME_STEPS = 10, 2
FAMILY_PROFILE = (5, 3)  # (timed, profiled) warm train steps
DDPM_REQUESTS = (("ddpm1000", [], 1), ("ddim50", ["--ddim"], 2))  # (name, flags, --length)
# The MIDI input path and PolyDis ([midi]): MIDI_SONGS seeded songs of MIDI_BARS
# bars of 4/4 at 120 bpm (2 min 8 s, 8 segments each) written with the port's
# writer, three tracks each (a melody, block triads of a progression drawn with
# random_chords, drums on channel 10); song MIDI_TEMPO_SONG changes to 100 bpm
# at its middle bar (a conductor track of raw SMF bytes). The chord recognizer
# must name the written root on at least MIDI_ROOT_SHARE_MIN of the beats at
# 120 bpm (the CPU run of these songs: 1.0 on each). Request E's kept region against
# the DDIM q_sample of its source at the grid's last index: the same fp32
# expression on the same device, MIDI_KEEP_ATOL.
MIDI_SONGS, MIDI_BARS, MIDI_TEMPO_SONG = 4, 64, 1
MIDI_ROOT_SHARE_MIN = 0.95
MIDI_KEEP_ATOL = 1e-6
# PolyDis card vs CPU, fp32 at its widths: encoder (mu, sigma) at COND_ATOL; a
# teacher-forced loss (every coin true) at batch POLYDIS_BATCH at the step's
# limits, its logits at the JAX package's decoder parity
# (tests/test_pianotree_dec_parity.py:66); the greedy grid by its share of equal
# cells, whose limit comes from the first card run (share 1.0 on an H100 80GB
# HBM3 at 700 W; the planted fault, z_chd | z_rhy swapped, 0.80158 there).
POLYDIS_BATCH = 16
POLYDIS_LOGIT_ATOL = 1e-4
POLYDIS_GRID_SHARE_MIN = 0.99
GN_CONV_SITES, GN_CONV_TWO_INPUT = 44, 12  # per UNet eval: 22 ResBlocks x 2; decoder in_layers
GN_CONV_BATCH = 64
FUSED_TRAIN_STEPS = 3  # bf16 train steps through kernel 4 (counted per step)
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
# [serve]: the worker as its CLI builds it on the training run directory, at
# DDIM-50; [expr]: the evaluation harness on the run directories the earlier
# phases wrote, each experiment 550 kernel-1 launches per batch per scale pass
SERVE_BATCH, SERVE_SCALES, SERVE_COALESCE_MS = 8, "1,5", 25
SERVE_CONCURRENT, SERVE_CONCURRENT_NUM = 4, 2  # four clients of 2 samples: one padded pass
SERVE_LONG_LENGTH, SERVE_LONG_PIECES = 3, 2
HTTP_TIMEOUT_S = 600  # every socket, join and wait of the [serve] phase
EXPR_BATCH = 16
# (experiment, run directory, its frozen encoders, extra flags, batches, scale passes)
EXPR_RUNS = [
    ("uncond", "run", "pretrained", [], 1, 1),
    ("inp_below", "run", "pretrained", [], 1, 1),
    ("inp_bars", "run", "pretrained", [], 1, 1),
    ("chd", "run", "pretrained", [], 1, 1),
    ("chd_acc", "run", "pretrained", ["--scales", "0,5"], 2, 2),
    ("fd", "run_mix2", "pretrained", ["--scales", "0,5"], 1, 2),
    ("txt_acc", "run_mix2", "pretrained", ["--scales", "0,5"], 1, 2),
    ("pnt_acc", "run_sdf_pnotree_from_run", "pretrained_runs", ["--scales", "0,5"], 1, 2),
]
DUMP_IMAGES = 11  # q0.png and one every n_steps // 10 of the 1000 steps
# [parallel]: the full-width bf16 sdf_chd8bar train step at batch 16 through
# each route of a one-rank NCCL group against the plain one-process step from
# the same weights, batch and noise. bf16 rounds at 2^-8: tp's row-parallel
# sites add their bias after the sum, not inside the conv, which moves some
# activations by an ulp, so the gradients are held in relative norm over all
# of them; the planted fault (the gradient of the first half of the batch
# rows only, as a reduction that dropped a rank would leave it) must miss.
PARALLEL_ROUTES = ("dp", "fsdp", "tp1")
PARALLEL_LOSS_RTOL, PARALLEL_NORM_RTOL, PARALLEL_GRAD_RTOL = 1e-3, 1e-2, 2e-2
PARALLEL_TIMED = 5  # warm steps timed per route
PARALLEL_CLI_STEPS, PARALLEL_RESUME_STEPS = 4, 2
PARALLEL_SAMPLE_BATCH = 16  # the InferenceSession request, DDIM-50 CFG 5
# [maintenance]: the trainer's and converter's leftovers and the tools, on the
# full-width sdf_chd8bar in bf16 at its batch 16 with the training path's
# chd8bar.pt. MAINT_SONGS synthetic songs of MAINT_BARS bars written by
# ``python -m polyffusion_tpu_torch.tools synth_corpus`` (25 segments each, one
# song held out for validation); the training CLI with remat and the legacy
# mirror for MAINT_STEPS steps, one validation and one save, profiled over
# steps MAINT_PROFILE[0] to MAINT_PROFILE[1] - 1 (log_every 1: each step's
# metrics are read, so no step's kernels run into the next). Per remat step
# kernel 1 runs twice at each attention site (the forward, then the recompute
# in the backward), kernel 2 once, kernel 6 at every GroupNorm backward; with
# the GroupNorm-SiLU-conv sites fused, kernel 4 twice at each site and kernel
# 6 at the 12 GroupNorms outside them. A remat step against a plain one on the
# card, same batch and noise: the step's limits (STEP_LOSS_RTOL, STEP_GRAD_RTOL
# per tensor); planted fault: the bf16 working copy scaled by 1 + 2^-6 between
# the forward and the backward, so the recompute reads other weights. Warm
# steps of each timed in turns (MAINT_TIMED: warm-up, timed per round, rounds,
# profiled), with their peak device memory.
MAINT_SONGS, MAINT_BARS, MAINT_STEPS, MAINT_PROFILE = 10, 32, 6, (2, 4)
MAINT_SONG = "synth_000.npz"
REMAT_FWD = 2 * ATTENTION_SITES
MAINT_TIMED = (2, 5, 2, 2)
REMAT_FAULT_SCALE = 1 + 2**-6
# kernel names in a profiler trace, by kernel: (fragment, device kernels a launch)
# the device kernels of a launch in a profiler trace, by name fragment: kernel
# 2's bf16 launch runs a query-major and a key-major kernel
TRACE_KERNELS = {"packed_attention": ("attention_fwd",),
                 "packed_attention_bwd": ("attention_bwd_dq", "attention_bwd_dkdv"),
                 "gn_bwd": ("gn_bwd",)}


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
        # the distillation teacher's CFG double batch at batch 16 (and a batch-16
        # request at CFG 5), then an sdf_concat request of 2 segments at scale 1
        (32, 1024, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        (32, 256, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        (2, 1024, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        (2, 256, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        # the generation worker's padded batch of 8 at scale 1 (its CFG double
        # batch is the batch-16 row above)
        (8, 1024, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        (8, 256, 4, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        # sdxl_base's self-attentions at its CFG batch of 8: 10 heads at
        # 128^2 / 2 (row stride 640), 20 at 128^2 / 4 (row stride 1280)
        (8, 4096, 10, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
        (8, 1024, 20, 64, torch.bfloat16, BF16_ATOL, BF16_RTOL),
    ]
    # shapes only a sampler runs, where the forward never writes the row
    # log-sum-exp (it does so only where a gradient will be taken): its
    # check, whose absolute limit was set at the train step's T <= 1024,
    # is left out there
    sampled_only = {(8, 4096, 10), (8, 1024, 20)}
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
        if dtype == torch.bfloat16 and (b, t, h) not in sampled_only:
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


def launch_floor():
    """One launch of an empty kernel (``csrc/repaint_epilogue.cu:launch_floor``),
    the way the port's kernels launch: ms per launch, timed in turns as every
    kernel is. No kernel of the port can go below it."""
    import ctypes

    import torch

    from polyffusion_tpu_torch.ops._build import load

    fn = load("repaint_epilogue").launch_floor
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def empty():
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the empty kernel did not launch")

    ms = time_in_turns({"empty": empty})["empty"]
    log(f"[kernel] launch floor (an empty kernel): {ms:.4f} ms per launch")
    return ms


def gn_bwd_inputs(g, b, c, hh, ww, dtype, groups=32, eps=1e-5):
    """x, dy, the forward's statistics, and a bf16-representable gamma (its fp32
    and bf16 forms hold the same values) with a beta."""
    import torch

    from polyffusion_tpu_torch.ops.gn_bwd import gn_primal

    x = (torch.randn(b, c, hh, ww, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn(b, c, hh, ww, device="cuda", generator=g).to(dtype)
    gamma = (torch.randn(c, device="cuda", generator=g) * 0.5 + 1.0).bfloat16().float()
    beta = torch.randn(c, device="cuda", generator=g) * 0.1
    _, mean_c, inv_c = gn_primal(x, gamma, beta, groups, eps)
    return x, dy, mean_c, inv_c, gamma, beta


def gn_bwd_bound(x, params_bytes):
    """x and dy read once and dx written once, with the (B, C) statistics and
    the (C,) parameters: ms at 3.35 TB/s."""
    b, c = x.shape[:2]
    nbytes = 3 * x.numel() * x.element_size() + 2 * b * c * 4 + 3 * c * params_bytes
    return nbytes / HBM_BYTES_PER_S * 1e3


def cold_sets(x, dy, mean_c, inv_c, gamma):
    """Distinct copies of x and dy (with dx, one call's traffic) whose total
    exceeds the 50 MB L2 by a copy: taken in turn, every call finds its x and
    dy cold, as a backward finds what its forward saved."""
    per = 3 * x.numel() * x.element_size()
    n = max(2, -(-L2_BYTES // per) + 1)
    return [(x.clone(), dy.clone(), mean_c, inv_c, gamma) for _ in range(n)]


def gn_bwd_resident_clusters():
    """{(cluster size, dtype): clusters the card holds at once} for kernel 6 at
    the most shared memory it takes (``gn_bwd_max_active_clusters``); raises
    where one would not launch."""
    import ctypes

    from polyffusion_tpu_torch.ops._build import load

    fn = load("gn_bwd").gn_bwd_max_active_clusters
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = {}
    for k in (2, 4, 8):
        for code, name in ((0, "float32"), (1, "bfloat16")):
            n = ctypes.c_int(0)
            err = fn(k, code, ctypes.byref(n))
            if err != 0 or n.value <= 0:
                raise AssertionError(f"gn_bwd: clusters of {k} CTAs ({name}, most shared memory) "
                                     f"cannot be scheduled: cudaError {err}, {n.value} at once")
            out[f"{k} {name}"] = n.value
    log("[kernel] gn_bwd clusters resident at once (most shared memory): "
        + ", ".join(f"{k} CTAs {v}" for k, v in out.items()))
    return out


def check_gn_bwd():
    """GroupNorm backward kernel (kernel 6) against its plain version (and the
    backward of ``F.group_norm`` as a yardstick) at every GroupNorm shape of
    the bf16 train step (batch 16), at fp32 shapes that take one CTA and
    clusters of 2 and 4, and at every GroupNorm shape of the fp32 DDPM and
    autoencoder train steps at batch 16 (GN_FAMILY_SHAPES: 8 groups, and 64
    channels a group, among them). Each shape is run as the train step runs it (bf16
    gamma, dgamma and dbeta in bf16) and with fp32 parameters: dx within the
    dtype's limit, the fp32 dgamma / dbeta within theirs, and the bf16 call
    giving the same dx and exactly the fp32 dgamma / dbeta cast with ``.to``.
    At each shape the limit is also shown to catch a planted fault: the plain
    dx with the S2 term left out; where the span takes a cluster, a second:
    the plain dx with S1 and S2 taken over only the first half of the span (a
    cluster that lost its other CTAs' partials). Times warm (the same inputs
    again) and cold (``cold_sets``)."""
    import itertools

    import torch
    import torch.nn.functional as F

    from polyffusion_tpu_torch.ops.gn_bwd import gn_bwd_plan, gn_bwd_reference, group_norm_bwd

    gn_bwd_resident_clusters()
    cases = [(16, c, hh, ww, torch.bfloat16, 32, {"sdf": sites})
             for c, hh, ww, sites in GN_TRAIN_SHAPES]
    cases += [(b, c, hh, ww, torch.float32, 32, {}) for b, c, hh, ww in GN_FP32_SHAPES]
    cases += [(16, c, hh, ww, torch.float32, groups, {"ddpm": n_ddpm, "autoencoder": n_ae})
              for c, hh, ww, groups, n_ddpm, n_ae in GN_FAMILY_SHAPES]
    limits = {torch.bfloat16: (GN_BF16_ATOL, GN_BF16_RTOL), torch.float32: (GN_FP32_ATOL,
                                                                           GN_FP32_RTOL)}
    eps = 1e-5
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for b, c, hh, ww, dtype, groups, sites in cases:
        atol, rtol = limits[dtype]
        x, dy, mean_c, inv_c, gamma, beta = gn_bwd_inputs(g, b, c, hh, ww, dtype, groups, eps)
        plan = gn_bwd_plan(b, c, hh, ww, dtype, groups)
        gamma_p = gamma.to(dtype)  # the weight as the step holds it: bf16 in a bf16 step
        got = group_norm_bwd(x, dy, mean_c, inv_c, gamma, groups)
        got_p = group_norm_bwd(x, dy, mean_c, inv_c, gamma_p, groups, param_dtype=dtype)
        torch.cuda.synchronize()
        want = gn_bwd_reference(x, dy, mean_c, inv_c, gamma, groups)
        err = (got[0].float() - want[0].float()).abs().max().item()
        ratio = limit_ratio(got[0], want[0], atol, rtol)
        param_err = max((x_ - y).abs().max().item() for x_, y in zip(got[1:], want[1:]))
        param_ratio = max(limit_ratio(x_, y, GN_PARAM_ATOL, GN_PARAM_RTOL)
                          for x_, y in zip(got[1:], want[1:]))
        same_cast = torch.equal(got_p[0], got[0]) and all(
            x_.dtype == dtype and torch.equal(x_, y.to(dtype)) for x_, y in zip(got_p[1:], got[1:]))
        faults = {"without S2": gn_dx_without_s2(x, dy, mean_c, inv_c, gamma, groups)}
        if plan.cluster > 1:
            faults["half-span S1, S2"] = gn_dx_half_span(x, dy, mean_c, inv_c, gamma, groups)
        fault_ratios = {k: limit_ratio(f, want[0], atol, rtol) for k, f in faults.items()}
        shape = (f"B={b} C={c} H={hh} W={ww} {str(dtype).split('.')[1]}"
                 + (f" groups={groups}" if groups != 32 else ""))
        if not (ratio <= 1.0 and param_ratio <= 1.0):
            raise AssertionError(f"gn_bwd {shape}: dx max_abs_err {err}, {ratio:.3g} x the limit; "
                                 f"dgamma/dbeta {param_ratio:.3g} x")
        if not same_cast:
            raise AssertionError(f"gn_bwd {shape}: with {dtype} parameters dx or dgamma/dbeta "
                                 f"differ from the fp32 call's (cast with .to)")
        for k, fr in fault_ratios.items():
            if not fr > 1.0:
                raise AssertionError(f"the limit at {shape} does not catch a dx {k} ({fr:.3g} x "
                                     f"the limit)")
        xl = x.detach().requires_grad_()
        wl = gamma.to(dtype).requires_grad_()
        bl = beta.to(dtype).requires_grad_()
        y = F.group_norm(xl, groups, wl, bl, eps)
        ms = time_in_turns({
            "kernel": lambda: group_norm_bwd(x, dy, mean_c, inv_c, gamma_p, groups,
                                             param_dtype=dtype),
            "plain": lambda: gn_bwd_reference(x, dy, mean_c, inv_c, gamma, groups),
            "library": lambda: torch.autograd.grad(y, (xl, wl, bl), dy, retain_graph=True),
        })
        sets = cold_sets(x, dy, mean_c, inv_c, gamma_p)
        turn = itertools.cycle(sets)
        cold_ms = time_in_turns({
            "cold": lambda: group_norm_bwd(*next(turn), groups, param_dtype=dtype)})["cold"]
        bound = gn_bwd_bound(x, x.element_size())
        row = dict(shape=shape, groups=groups, sites_per_step=sites, cluster=plan.cluster,
                   share=plan.share,
                   max_abs_err=err, atol=atol, rtol=rtol, limit_ratio=ratio,
                   fault_limit_ratio=min(fault_ratios.values()), fault_limit_ratios=fault_ratios,
                   param_max_abs_err=param_err, param_limit_ratio=param_ratio,
                   want_abs_max=want[0].float().abs().max().item(),
                   ms=ms["kernel"], cold_ms=cold_ms, cold_sets=len(sets), plain_ms=ms["plain"],
                   library_ms=ms["library"], bound_ms=bound, bound_by="bytes")
        per_step = ", ".join(f"{n} per {k} step" for k, n in sites.items() if n) or "a check"
        log(f"[kernel] gn_bwd {shape} ({per_step}; cluster {plan.cluster}): dx max_abs_err "
            f"{err:.3g} (|want| max {row['want_abs_max']:.3g}), {ratio:.3g} x the limit (atol "
            f"{atol}, rtol {rtol:.3g}; "
            + ", ".join(f"{k}: {v:.3g} x" for k, v in fault_ratios.items())
            + f"); dgamma/dbeta max_abs_err {param_err:.3g}, {param_ratio:.3g} x (atol "
            f"{GN_PARAM_ATOL}, rtol {GN_PARAM_RTOL}); {dtype} parameters the fp32 ones cast  "
            f"kernel {ms['kernel']:.4f} ms (cold {cold_ms:.4f})  plain {ms['plain']:.4f} ms  "
            f"F.group_norm bwd {ms['library']:.4f} ms  bound {bound:.4f} ms (bytes)")
        rows.append(row)
        del x, dy, got, got_p, want, xl, y, sets, faults
    for model, n in (("sdf", GROUPNORM_SITES), ("ddpm", DDPM_GN_SITES),
                     ("autoencoder", AE_GN_SITES)):
        step = {k: sum(r["sites_per_step"].get(model, 0) * r[k] for r in rows)
                for k in ("ms", "cold_ms", "plain_ms", "library_ms", "bound_ms")}
        if sum(r["sites_per_step"].get(model, 0) for r in rows) != n:
            raise AssertionError(f"gn_bwd: the {model} shapes do not add up to its {n} sites")
        log(f"[kernel] gn_bwd over the {model} train step's {n} GroupNorm backwards (summed over "
            "the sites): " + ", ".join(f"{k} {v:.4f}" for k, v in step.items()))
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


def gn_dx_half_span(x, dy, mean_c, inv_c, gamma, groups):
    """The plain dx with S1 and S2 summed over only the first half of each
    (item, group) span: the second planted fault of ``check_gn_bwd``, what a
    cluster would give that kept its first CTA's partials and lost the rest."""
    b, c = x.shape[:2]
    hw = x[0, 0].numel()
    n = hw * (c // groups)
    dyg = dy.float() * gamma[None, :, None, None]
    xh = (x.float() - mean_c[:, :, None, None]) * inv_c[:, :, None, None]

    def first_half(v):  # (B, C, H, W) -> its sum over each span's first half / N, per channel
        s = v.reshape(b, groups, n)[:, :, : n // 2].sum(-1) / n
        return s.repeat_interleave(c // groups, dim=1)[:, :, None, None]

    s1, s2 = first_half(dyg), first_half(dyg * xh)
    return (inv_c[:, :, None, None] * (dyg - (s1 + xh * s2))).to(x.dtype)


# kernel 8 (GroupNorm forward with its SiLU): the decoder's largest site, a
# level-2 site in NCHW and, as the model holds it after a SpatialTransformer,
# channels-last: (B, C, H, W, channels-last, SiLU). Limit: within GN_FWD_ULPS
# of the affine's largest operand (``gn_fwd_ulps``: a bf16 a that rounds the
# other way, the statistics summed in another order, moves x * a by up to 2
# ulps of it, off by one, and z's rounding one more) and at least
# GN_FWD_EQUAL of the elements bit-equal
GN_FWD_SHAPES = [(128, 192, 128, 128, False, True), (128, 256, 32, 32, False, True),
                 (128, 256, 32, 32, True, False)]
GN_FWD_ULPS, GN_FWD_EQUAL = 4, 0.999
# sdxl_base's twelve GroupNorm shapes at its CFG batch of 8, NCHW (as its
# UNet holds them: the linear projections keep the residual's layout), with
# the SiLU: 30 channels a group at 128^2 on eight CTAs of 120 KB, and the
# decoder's 2560-channel inputs at 80 a group
SDXL_GN_FWD_SHAPES = [(8, c, hh, hh, False, True) for c, hh in (
    (320, 128), (320, 64), (640, 128), (640, 64), (640, 32), (960, 128), (960, 64),
    (1280, 64), (1280, 32), (1920, 64), (1920, 32), (2560, 32))]


def gn_fwd_ulps(got, want, x, weight, bias, groups, eps):
    """|got - want| in ulps, in x's dtype, of the largest of |x * a|,
    |beta|, |mean * a| and |want| at each element: what a 1-ulp change of a
    or off moves, however far the affine cancels."""
    import torch

    from polyffusion_tpu_torch.ops.gn_bwd import gn_affine

    a, off = gn_affine(x, weight, bias, groups, eps)
    per_channel = torch.maximum(bias.float().abs().expand_as(off), (bias.float() - off).abs())
    scale = torch.maximum((x.float() * a[:, :, None, None]).abs(),
                          per_channel[:, :, None, None].expand_as(x))
    scale = torch.maximum(scale, want.float().abs()).clamp_min(2.0**-100)
    bits = 7 if x.dtype == torch.bfloat16 else 23
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 1 - bits)
    return (got.float() - want.float()).abs() / ulp


def gn_fwd_without_mean_sq(x, weight, bias, groups, eps):
    """The plain GroupNorm with E[x^2] for the variance: the planted fault of
    ``check_gn_fwd``."""
    import torch

    b, c = x.shape[:2]
    xg = x.float().reshape(b, groups, -1)
    mean = xg.mean(-1).repeat_interleave(c // groups, 1)
    inv = torch.rsqrt((xg * xg).mean(-1) + eps).repeat_interleave(c // groups, 1)
    a, off = (inv * weight).to(x.dtype), (bias - mean * inv * weight).to(x.dtype)
    return x * a[:, :, None, None] + off[:, :, None, None]


def check_gn_fwd():
    """GroupNorm forward kernel (kernel 8) against its plain version
    (``gn_primal``, then ``F.silu``) at GN_FWD_SHAPES and
    SDXL_GN_FWD_SHAPES, bf16, one launch a call: within
    GN_FWD_ULPS and GN_FWD_EQUAL bit-equal; planted fault: the variance as
    E[x^2], the mean's square left out (``gn_fwd_without_mean_sq``), which
    must fail the limit. Times kernel, plain version and ``F.group_norm`` +
    ``F.silu`` (the yardstick) in turns, against the bound (x read and y
    written once at 3.35 TB/s). Returns a row per shape."""
    import torch
    import torch.nn.functional as F

    from polyffusion_tpu_torch.ops.gn_bwd import gn_primal
    from polyffusion_tpu_torch.ops.gn_fwd import gn_fwd_plan, group_norm_silu

    g = torch.Generator(device="cuda").manual_seed(8)
    groups, eps, rows = 32, 1e-5, []
    for b, c, hh, ww, cl, silu in GN_FWD_SHAPES + SDXL_GN_FWD_SHAPES:
        x = (torch.randn(b, c, hh, ww, device="cuda", generator=g) * 2 + 0.5).bfloat16()
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        weight = torch.randn(c, device="cuda", generator=g) * 0.5 + 1.0
        bias = torch.randn(c, device="cuda", generator=g) * 0.1
        act = F.silu if silu else (lambda t: t)
        plan = gn_fwd_plan(c, hh, ww, x.dtype, groups, cl)
        before = group_norm_silu.launches
        got = group_norm_silu(x, weight, bias, groups, eps, silu)
        torch.cuda.synchronize()
        if group_norm_silu.launches != before + 1:
            raise AssertionError("gn_fwd: one call did not count one launch")
        want = act(gn_primal(x, weight, bias, groups, eps)[0])
        fault = act(gn_fwd_without_mean_sq(x, weight, bias, groups, eps))
        ulps = gn_fwd_ulps(got, want, x, weight, bias, groups, eps).max().item()
        equal = (got == want).float().mean().item()
        fault_ulps = gn_fwd_ulps(fault, want, x, weight, bias, groups, eps).max().item()
        shape = f"B={b} C={c} H={hh} W={ww} bf16{' channels-last' if cl else ''}" + (
            " +SiLU" if silu else "")
        if not (ulps <= GN_FWD_ULPS and equal >= GN_FWD_EQUAL and got.stride() == x.stride()):
            raise AssertionError(f"gn_fwd {shape}: {ulps:.3g} ulps, {equal:.6f} bit-equal")
        if not fault_ulps > GN_FWD_ULPS:
            raise AssertionError(f"the limit at gn_fwd {shape} does not catch the variance "
                                 f"without the mean's square ({fault_ulps:.3g} ulps)")
        ms = time_in_turns({
            "kernel": lambda: group_norm_silu(x, weight, bias, groups, eps, silu),
            "plain": lambda: act(gn_primal(x, weight, bias, groups, eps)[0]),
            "library": lambda: act(F.group_norm(x, groups, weight.bfloat16(), bias.bfloat16(),
                                                eps)),
        })
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        log(f"[kernel] gn_fwd {shape} (cluster {plan.cluster}, {plan.smem} B a CTA): "
            f"{ulps:.3g} ulps (limit {GN_FWD_ULPS}), {100 * equal:.4f} % bit-equal (limit "
            f"{100 * GN_FWD_EQUAL:.1f}); planted fault (variance without the mean's square) "
            f"{fault_ulps:.3g} ulps (must exceed {GN_FWD_ULPS})  kernel {ms['kernel']:.4f} ms  plain {ms['plain']:.4f} ms  "
            f"F.group_norm+silu {ms['library']:.4f} ms  bound {bound:.4f} ms (bytes)")
        rows.append(dict(shape=shape, cluster=plan.cluster, ulps=ulps, bit_equal=equal,
                         fault_ulps=fault_ulps, ms=ms["kernel"], plain_ms=ms["plain"],
                         library_ms=ms["library"], bound_ms=bound, bound_by="bytes"))
        del x, got, want, fault
    return rows


def build_copy(name: str, text: str):
    """A copy of a ``csrc/`` source, changed, compiled as the package's
    sources are (into the package's build directory) and loaded."""
    import ctypes

    from polyffusion_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    lib = cu[:-3] + ".so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", lib,
                          cu], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(lib)


def epilogue_reading_eps_early():
    """Kernel 7's source with its loads moved ahead of griddepcontrol.wait:
    the planted fault that ``epilogue_behind_early_trigger`` must catch."""
    import ctypes

    from polyffusion_tpu_torch.ops._build import CSRC_DIR

    text = open(os.path.join(CSRC_DIR, "repaint_epilogue.cu")).read()
    if EPI_WAIT not in text or EPI_LOADS not in text:
        raise AssertionError("repaint_epilogue.cu no longer has the wait and loads the planted "
                             "copy moves")
    text = text.replace(EPI_WAIT, "").replace(EPI_LOADS, EPI_LOADS + "  grid_dependency_wait();\n")
    lib = build_copy("repaint_epilogue_eps_early", text)
    fn = lib.repaint_epilogue
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_float] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def epilogue_behind_early_trigger(planted, x, eps, p_noise, orig, q_noise, mask, scalars):
    """Limit ratios of kernel 7 (``"kernel"``) and of ``planted`` (the copy
    that loads eps before its wait) against the plain version, each launched
    right behind ``early_trigger_copy``: a predecessor that lets it start at
    once and writes its eps (into a buffer of zeros) EARLY_TRIGGER_NS later.
    The kernel must meet the limit and the copy fail it: a check behind
    PyTorch's kernels, which never let their dependents start early, could
    not tell the two apart."""
    import ctypes

    import torch

    from polyffusion_tpu_torch.ops._build import load
    from polyffusion_tpu_torch.ops.repaint_epilogue import (
        fused_repaint_epilogue,
        repaint_epilogue_reference,
    )

    copy = load("repaint_epilogue").early_trigger_copy
    copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                     ctypes.c_void_p]
    copy.restype = ctypes.c_int
    want = repaint_epilogue_reference(x, eps, p_noise, orig, q_noise, mask, scalars)

    def planted_call(e):
        out = torch.empty_like(x)
        err = planted(x.data_ptr(), e.data_ptr(), p_noise.data_ptr(), orig.data_ptr(),
                      q_noise.data_ptr(), mask.data_ptr(), out.data_ptr(), x.numel(), *scalars,
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the planted epilogue did not launch: cudaError {err}")
        return out

    planted_call(eps)  # the first launch loads the copy's module: not behind the predecessor
    ratios = {}
    for name, fn in (("kernel", lambda e: fused_repaint_epilogue(x, e, p_noise, orig, q_noise,
                                                                 mask, scalars)),
                     ("planted", planted_call)):
        late = torch.zeros_like(eps)
        torch.cuda.synchronize()
        err = copy(eps.data_ptr(), late.data_ptr(), eps.numel(), EARLY_TRIGGER_NS,
                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"early_trigger_copy did not launch: cudaError {err}")
        got = fn(late)
        torch.cuda.synchronize()
        ratios[name] = limit_ratio(got, want, EPI_ATOL, EPI_RTOL)
    return ratios


def check_repaint_epilogue():
    """The RePaint epilogue kernel against its plain version at request A's
    shape (batch 2), batch 4 and a full batch of 64, with the scalars of the
    first, a middle and the last of the preset's 1000 steps. At each the limit
    is also shown to catch a planted fault: the blend ignoring the mask (the
    unknown region's update everywhere). Then, as the sampler runs it, behind
    the CFG combine that writes its eps, queued while the card is still busy:
    the kernel starts before eps is complete (programmatic dependent launch)
    and must wait for it; and behind a predecessor that lets it start early
    (``epilogue_behind_early_trigger``), where a planted copy that reads eps
    before its wait must fail the limit. No single PyTorch call computes this function, so
    the plain composition is the only yardstick. Also times the pair (the
    combine, then the kernel) and the wrapper's host microseconds per call."""
    import torch

    from polyffusion_tpu_torch.diffusion.sampler import _epilogue_scalars
    from polyffusion_tpu_torch.diffusion.schedule import make_schedule
    from polyffusion_tpu_torch.ops.repaint_epilogue import (
        fused_repaint_epilogue,
        repaint_epilogue_reference,
    )
    from polyffusion_tpu_torch.profile_attention import _host_and_device

    cfg = full_cfg(bf16=False)
    sched = make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end)
    g = torch.Generator(device="cuda").manual_seed(4)
    planted = epilogue_reading_eps_early()
    rows = []
    for b in (2, 4, 64):
        shape = (b, 2, 128, 128)
        x, eps, p_noise, q_noise, e_u, e_c = (torch.randn(shape, device="cuda", generator=g)
                                              for _ in range(6))
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
        # behind its predecessor: the combine's kernels queued behind 5 ms of
        # device work, the epilogue right after the one that writes eps
        scalars = _epilogue_scalars(sched, 500)
        torch.cuda.synchronize()
        torch.cuda._sleep(10_000_000)
        eps_q = e_u + CLI_CFG_SCALE * (e_c - e_u)
        got = fused_repaint_epilogue(x, eps_q, p_noise, orig, q_noise, mask, scalars)
        torch.cuda.synchronize()
        want = repaint_epilogue_reference(x, eps_q, p_noise, orig, q_noise, mask, scalars)
        queued_err = (got - want).abs().max().item()
        queued_ratio = limit_ratio(got, want, EPI_ATOL, EPI_RTOL)
        early = epilogue_behind_early_trigger(planted, x, eps_q, p_noise, orig, q_noise, mask,
                                              scalars)
        if not max(ratio, queued_ratio, early["kernel"]) <= 1.0:
            raise AssertionError(f"repaint_epilogue B={b}: max_abs_err {err}, {ratio:.3g} x the "
                                 f"limit; behind its predecessor {queued_ratio:.3g} x, behind "
                                 f"one that lets it start early {early['kernel']:.3g} x (atol "
                                 f"{EPI_ATOL}, rtol {EPI_RTOL})")
        if not early["planted"] > 1.0:
            raise AssertionError(f"the check behind an early-triggering predecessor at B={b} does "
                                 f"not catch a copy that reads eps before its wait "
                                 f"({early['planted']:.3g} x the limit)")
        if not fault_ratio > 1.0:
            raise AssertionError(f"the limit at B={b} does not catch a blend that ignores the "
                                 f"mask ({fault_ratio:.3g} x the limit)")
        ms = time_in_turns({
            "kernel": lambda: fused_repaint_epilogue(*tensors, scalars),
            "plain": lambda: repaint_epilogue_reference(*tensors, scalars),
            "pair": lambda: fused_repaint_epilogue(x, e_u + CLI_CFG_SCALE * (e_c - e_u), p_noise,
                                                   orig, q_noise, mask, scalars),
            "combine": lambda: e_u + CLI_CFG_SCALE * (e_c - e_u),
        })
        host_us, _ = _host_and_device(lambda: fused_repaint_epilogue(*tensors, scalars))
        # six fp32 tensors read once, one written once
        bound = 7 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        row = dict(shape=f"B={b} C=2 H=128 W=128 float32", max_abs_err=max(err, queued_err),
                   atol=EPI_ATOL, rtol=EPI_RTOL, limit_ratio=ratio,
                   queued_limit_ratio=queued_ratio, early_limit_ratio=early["kernel"],
                   early_fault_limit_ratio=early["planted"], fault_limit_ratio=fault_ratio,
                   ms=ms["kernel"], plain_ms=ms["plain"], pair_ms=ms["pair"],
                   combine_ms=ms["combine"], host_us_per_call=host_us, library_ms=None,
                   bound_ms=bound, bound_by="bytes")
        log(f"[kernel] repaint_epilogue {row['shape']}, steps {EPI_STEPS}: max_abs_err {err:.3g}, "
            f"{ratio:.3g} x the limit (atol {EPI_ATOL}, rtol {EPI_RTOL}; behind the queued CFG "
            f"combine {queued_ratio:.3g} x; behind an early trigger {early['kernel']:.3g} x, "
            f"a copy reading eps before its wait {early['planted']:.3g} x; blend ignoring the "
            f"mask: {fault_ratio:.3g} x)  "
            f"kernel {ms['kernel']:.4f} ms  plain {ms['plain']:.4f} ms  combine + kernel "
            f"{ms['pair']:.4f} ms (combine alone {ms['combine']:.4f})  host {host_us:.2f} us per "
            f"call  bound {bound:.4f} ms (bytes)")
        rows.append(row)
        del tensors, x, eps, p_noise, q_noise, orig, mask, got, want, fault, e_u, e_c, eps_q
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



def step_inputs():
    """The fp32 train step checks' batch of 2: piano rolls, chords, t and
    noise (a CPU tensor each)."""
    import torch

    rng = np.random.default_rng(2)
    x0 = torch.from_numpy((rng.random((2, 2, 128, 128)) > 0.97).astype(np.uint8))
    chords = torch.from_numpy(random_chords(rng, 2))
    t = torch.tensor([37, 802])
    noise = torch.from_numpy(rng.standard_normal((2, 2, 128, 128)).astype(np.float32))
    return x0, chords, t, noise


def one_train_step(device, gn_conv, inputs, counters=None):
    """One full-width fp32 train step of a new task (seed 3) on ``device``:
    (loss, grad norm, params, grads, seconds), all on the CPU; with
    ``counters``, the launches of the step (set to 0 just before it)."""
    import torch

    from polyffusion_tpu_torch.tasks.sdf import StepNoise
    from polyffusion_tpu_torch.train import create_state, make_train_step

    cfg = full_cfg(bf16=False)
    x0, chords, t, noise = inputs
    task = make_task(cfg, device, seed=3, training=True, gn_conv=gn_conv)
    state = create_state(task.unet, cfg.learning_rate, cfg.max_grad_norm)
    batch = (x0.to(device), None, chords.to(device), None)
    step = make_train_step(task)
    if counters is not None:
        zero_counts(counters)
    t0 = time.perf_counter()
    metrics = step(state, batch, seed=0, noise=StepNoise(
        t.to(device), noise.to(device), torch.tensor(False, device=device)))
    loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
    secs = time.perf_counter() - t0
    launches = None if counters is None else {n: fn.launches for n, fn in counters.items()}
    params = {k: v.detach().cpu() for k, v in state.params().items()}
    grads = {k: v.grad.cpu() for k, v in state.params().items()}  # clipped: norm < max here
    return (loss, norm, params, grads, secs), launches


def compare_steps(got_step, want_step, lr):
    """The [train] limits' readings of a step against another: (loss rel,
    grad norm rel, the worst gradient's ratio to its limit and its name, the
    params' max abs error, their share above STEP_PARAM_TIGHT, pass)."""
    import torch

    (loss, norm, got, got_g, _), (want_loss, want_norm, want, want_g, _) = got_step, want_step
    loss_err, norm_err = abs(loss - want_loss) / abs(want_loss), abs(norm - want_norm) / want_norm
    grad_ratio, worst = 0.0, ""
    for k, w in want_g.items():  # per tensor: |dg| <= rtol |g| + 1e-9 (exact zeros stay zero)
        r = ((got_g[k] - w).norm() / (STEP_GRAD_RTOL * w.norm() + 1e-9)).item()
        if r > grad_ratio:
            grad_ratio, worst = r, k
    err = torch.cat([(got[k] - w).abs().flatten() for k, w in want.items()])
    share = (err > STEP_PARAM_TIGHT).float().mean().item()
    ok = (loss_err <= STEP_LOSS_RTOL and norm_err <= STEP_NORM_RTOL and grad_ratio <= 1.0
          and err.max().item() <= 2 * lr and share <= STEP_PARAM_SHARE)
    return loss_err, norm_err, grad_ratio, worst, err.max().item(), share, ok


def check_train_step_against_cpu(gn_conv="unfused"):
    """One full-width fp32 train step at batch 2 on the card (with the kernels)
    against the CPU (with their plain versions): same weights, batch, t and
    noise; the loss, the gradients and their norm, and the updated parameters.
    With ``gn_conv="fused"`` the forward runs kernel 4 at every ResBlock site on
    the card (its backward recomputes through the plain version)."""
    cfg = full_cfg(bf16=False)
    inputs = step_inputs()
    gpu, _ = one_train_step("cuda", gn_conv, inputs)
    cpu, _ = one_train_step("cpu", gn_conv, inputs)
    lr = cfg.learning_rate
    loss_err, norm_err, grad_ratio, worst, max_err, share, ok = compare_steps(gpu, cpu, lr)
    log(f"[train] full-width fp32 step (B=2, gn_conv {gn_conv}) card vs CPU: loss {gpu[0]:.7g} vs "
        f"{cpu[0]:.7g} "
        f"(rel {loss_err:.3g}, limit {STEP_LOSS_RTOL}), grad_norm {gpu[1]:.7g} vs {cpu[1]:.7g} "
        f"(rel {norm_err:.3g}, limit {STEP_NORM_RTOL}); gradients per tensor {grad_ratio:.3g} x "
        f"the limit (rel {STEP_GRAD_RTOL} in norm; worst {worst}); params max_abs_err "
        f"{max_err:.3g} (limit {2 * lr:.3g} = 2 lr), share above {STEP_PARAM_TIGHT}: "
        f"{share:.3g} (limit {STEP_PARAM_SHARE}); card {gpu[4]:.2f} s (first call), CPU {cpu[4]:.2f} s")
    if not ok:
        raise AssertionError(f"the full-width fp32 train step (gn_conv {gn_conv}) on the card "
                             "disagrees with the CPU")


def drive_fused_train_steps(counters):
    """FUSED_TRAIN_STEPS full-width bf16 train steps at the preset's batch 16
    with ``gn_conv="fused"`` (bf16 compute over fp32 masters), each with the
    launch counts set to 0 just before it and read just after: kernel 4 at all
    44 ResBlock sites of the forward (12 of them two-input; its backward
    recomputes through the plain version), kernels 1 and 2 at the 11
    self-attention sites, kernel 6 at the 12 GroupNorms outside the fused sites
    (11 transformer norms, the output norm). The weights change every step, so
    every step packs the kernel's weights anew. Returns the launches by kernel
    over all steps."""
    import torch

    from polyffusion_tpu_torch.tasks.sdf import StepNoise
    from polyffusion_tpu_torch.train import create_state, make_train_step

    cfg = full_cfg(bf16=True)
    task = make_task(cfg, "cuda", seed=4, training=True, gn_conv="fused")
    state = create_state(task.unet, cfg.learning_rate, cfg.max_grad_norm, bf16=True)
    step = make_train_step(task)
    rng = np.random.default_rng(4)
    b = cfg.batch_size
    want = dict({name: 0 for name in counters}, gn_silu_conv=GN_CONV_SITES,
                packed_attention=ATTENTION_SITES, packed_attention_bwd=ATTENTION_SITES,
                gn_bwd=GROUPNORM_SITES - GN_CONV_SITES)
    totals = {name: 0 for name in counters}
    for i in range(FUSED_TRAIN_STEPS):
        x0 = torch.from_numpy((rng.random((b, 2, 128, 128)) > 0.97).astype(np.uint8)).cuda()
        chords = torch.from_numpy(random_chords(rng, b)).cuda()
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, (x0, None, chords, None), seed=i)
        loss = metrics["loss"].item()
        secs = time.perf_counter() - t0
        got = {name: fn.launches for name, fn in counters.items()}
        n_two = counters["gn_silu_conv"].two_input_launches
        log(f"[train] fused bf16 step {i} (B={b}): loss {loss:.6g}, {1e3 * secs:.3f} ms (host "
            f"clock, first includes warm-up), launches {got}, two-input {n_two}")
        if got != want or n_two != GN_CONV_TWO_INPUT or not np.isfinite(loss):
            raise AssertionError(f"expected launches {want} with {GN_CONV_TWO_INPUT} two-input "
                                 f"and a finite loss, got {got}, {n_two}, {loss}")
        for name in totals:
            totals[name] += got[name]
    del task, state
    return totals


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


def int8_site(g, b, c1, c2, o, hw):
    """Seeded fp32 inputs of an int8 site: a SiLU'd activation (item 0 three
    times larger, so that the items' amax differ), a weight of the 3 x 3
    conv's init scale and a bias."""
    import torch

    y = torch.randn((b, c1 + c2, hw, hw), generator=g)
    y = y * torch.sigmoid(y)
    y[0] *= 3.0
    w = torch.randn((o, c1 + c2, 3, 3), generator=g) / np.sqrt(9 * (c1 + c2))
    return y, w, torch.randn((o,), generator=g) * 0.1


def int8_route(y, w, bias, c1, fault=False):
    """The int8_xla route's pieces at one site: each part's activation codes
    and scales and weight codes and scales, each part's exact int32 sums, and
    the output (``int8_conv``, or ``int8_concat_conv`` where the site has a
    second part). ``fault``: a single site quantizes its activation with one
    amax over the whole batch, a concat site takes one weight scale over its
    whole kernel."""
    import torch

    from polyffusion_tpu_torch.ops.quant import (
        int8_concat_conv,
        int8_conv,
        int8_conv_sums,
        quantize_act,
        quantize_weight,
    )

    ys = [y] if c1 == y.shape[1] else [y[:, :c1], y[:, c1:]]
    if len(ys) == 1:
        parts = [quantize_weight(w)]
    elif fault:
        wq, ws = quantize_weight(w)
        parts = [(wq[:, :c1], ws), (wq[:, c1:], ws)]
    else:
        parts = [quantize_weight(w[:, :c1]), quantize_weight(w[:, c1:])]
    codes = [quantize_act(part) for part in ys]
    if fault and len(ys) == 1:
        amax = y.abs().amax().clamp(min=1e-6)
        q = torch.clamp(torch.round(y * (127.0 / amax)), -127, 127).to(torch.int8)
        codes = [(q, (amax / 127.0).expand(y.shape[0]))]
    sums = [int8_conv_sums(q, wq) for (q, _), (wq, _) in zip(codes, parts)]
    if fault and len(ys) == 1:
        out = (sums[0].float() * codes[0][1][:, None, None, None] * parts[0][1] + bias)
        out = out.permute(0, 3, 1, 2)
    elif len(ys) == 1:
        out = int8_conv(y, *parts[0], bias)
    else:
        out = int8_concat_conv(ys[0], ys[1], parts, bias)
    return codes + parts, sums, out


def check_int8_conv_card_vs_cpu():
    """``int8_conv`` and ``int8_concat_conv`` on the card against the CPU on
    the same fp32 inputs, at a (16, 256 -> 256, 16^2) site and a (16, 64 + 64
    -> 64, 128^2) decoder concat site: the codes and the int32 sums equal, the
    output within INT8_OUT_RTOL (the same fp32 rescale of the same sums);
    each with a planted fault (``int8_route``'s) that must fail the output's
    limit. Times the card's route against cuDNN's bf16 conv of the site.
    Returns a row per site."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(17)
    rows = []
    for b, c1, c2, o, hw in INT8_ROUTE_SITES:
        y, w, bias = int8_site(g, b, c1, c2, o, hw)
        with torch.inference_mode():
            want_codes, want_sums, want = int8_route(y, w, bias, c1)
            got_codes, got_sums, got = int8_route(y.cuda(), w.cuda(), bias.cuda(), c1)
            _, _, fault = int8_route(y.cuda(), w.cuda(), bias.cuda(), c1, fault=True)
        code_diff = sum(int((a.cpu() != q).sum()) + int((s.cpu() != ws).sum())
                        for (a, s), (q, ws) in zip(got_codes, want_codes))  # activations, weights
        sum_diff = max(int((a.cpu().long() - e.long()).abs().max()) for a, e in
                       zip(got_sums, want_sums))
        ratio = limit_ratio(got.cpu(), want, INT8_OUT_ATOL, INT8_OUT_RTOL)
        fault_ratio = limit_ratio(fault.cpu(), want, INT8_OUT_ATOL, INT8_OUT_RTOL)
        shape = f"B={b} C={c1}{'+' + str(c2) if c2 else ''}->{o} {hw}x{hw}"
        fault_name = "one weight scale over the kernel" if c2 else "one amax over the batch"
        yc, wc, bc = y.cuda(), w.cuda(), bias.cuda()
        yb, wb = yc.bfloat16(), wc.bfloat16()
        with torch.inference_mode():
            times = time_in_turns({
                "int8": lambda: int8_route(yc, wc, bc, c1),
                "cudnn_bf16": lambda: F.conv2d(yb, wb, padding=1),
            }, rounds=5, inner=2)
        log(f"[routes] int8_conv {shape} card vs CPU: codes and scales differing {code_diff} "
            f"(activations and weights; limit 0), int32 sums max |diff| {sum_diff} (limit 0), "
            f"output max ratio to "
            f"{INT8_OUT_ATOL:.3g} + {INT8_OUT_RTOL:.3g} |want| {ratio:.3g} (limit 1), "
            f"planted fault ({fault_name}) "
            f"{fault_ratio:.3g} (must exceed 1); |sums| max "
            f"{max(int(a.abs().max()) for a in want_sums)}; ms: int8 route {times['int8']:.4f}, "
            f"cuDNN bf16 conv {times['cudnn_bf16']:.4f}")
        if code_diff or sum_diff or not ratio <= 1.0 or not fault_ratio > 1.0:
            raise AssertionError(f"int8_conv {shape} on the card disagrees with the CPU, or its "
                                 "planted fault passed")
        rows.append(dict(shape=shape, max_abs_err=(got.cpu() - want).abs().max().item(),
                         ms=times["int8"], cudnn_bf16_ms=times["cudnn_bf16"]))
    return rows


def check_int8_xla_eps():
    """The full-width bf16 UNet's eps at batch ROUTES_INT8_BATCH on the
    int8_xla route against its eps through kernel 4 (``gn_conv="fused"``) at
    ``check_int8_against_fused``'s limit, and against kernel 5's (``"int8"``,
    printed only: the two int8 routes quantize the decoder's concat
    differently); planted fault: the skip half of every decoder concat
    dropped. Returns the relative errors."""
    import torch

    from polyffusion_tpu_torch.models import unet as unet_mod

    cfg = full_cfg(bf16=True)
    rng = np.random.default_rng(19)
    b = ROUTES_INT8_BATCH
    x = torch.from_numpy(rng.standard_normal((b, 2, 128, 128)).astype(np.float32)).cuda()
    t = torch.from_numpy(rng.integers(0, cfg.n_steps, b)).cuda()
    cond = torch.from_numpy(rng.standard_normal((b, 1, cfg.d_cond)).astype(np.float32)).cuda()
    eps = {}
    for mode in ("fused", "int8", "int8_xla"):
        task = make_task(cfg, "cuda", seed=2, gn_conv=mode)
        with torch.inference_mode():
            eps[mode] = task.apply_eps(x, t, cond).float()
            if mode == "int8_xla":
                real = unet_mod.int8_concat_conv
                unet_mod.int8_concat_conv = lambda y, y2, parts, bias: real(
                    y, torch.zeros_like(y2), parts, bias)
                try:
                    eps["fault"] = task.apply_eps(x, t, cond).float()
                finally:
                    unet_mod.int8_concat_conv = real
        del task

    def rel(a, ref):
        return ((a - ref).abs().mean() / ref.abs().mean()).item()

    out = dict(vs_fused=rel(eps["int8_xla"], eps["fused"]),
               vs_kernel5=rel(eps["int8_xla"], eps["int8"]),
               kernel5_vs_fused=rel(eps["int8"], eps["fused"]),
               fault_vs_fused=rel(eps["fault"], eps["fused"]))
    log(f"[routes] full-width bf16 (B={b}) int8_xla eps vs fused eps: mean rel err "
        f"{out['vs_fused']:.4g} (limit {INT8_EPS_REL}); planted fault (decoder concats' skip "
        f"half dropped) {out['fault_vs_fused']:.4g} (must exceed it); vs kernel 5's eps "
        f"{out['vs_kernel5']:.4g} (not asserted; kernel 5 vs fused {out['kernel5_vs_fused']:.4g})")
    if not (out["vs_fused"] < INT8_EPS_REL <= out["fault_vs_fused"]
            and torch.isfinite(eps["int8_xla"]).all()):
        raise AssertionError("the int8_xla UNet's eps is too far from the fused one, or its "
                             "planted fault passed")
    return out


def check_cfg_fork():
    """The UNet's CFG fork against the double batch on the card: the
    full-width fp32 UNet (TF32 off) at B = 4 at UNET_ATOL / UNET_RTOL, and the
    bf16 one at B = ROUTES_FORK_BATCH at the bf16 limits (BF16_ATOL,
    BF16_RTOL); planted fault for both: the fork handed the condition's
    halves swapped. Times one bf16 eval of each form (in turns) and takes
    each form's peak device memory above what is resident. Returns the
    numbers."""
    import torch

    out = {}
    for bf16, b, atol, rtol in ((False, 4, UNET_ATOL, UNET_RTOL),
                                (True, ROUTES_FORK_BATCH, BF16_ATOL, BF16_RTOL)):
        cfg = full_cfg(bf16=bf16)
        task = make_task(cfg, "cuda", seed=3)
        rng = np.random.default_rng(23)
        x = torch.from_numpy(rng.standard_normal((b, 2, 128, 128)).astype(np.float32)).cuda()
        t = torch.from_numpy(rng.integers(0, cfg.n_steps, b)).cuda()
        cond = torch.from_numpy(rng.standard_normal((b, 1, cfg.d_cond)).astype(np.float32)).cuda()
        c_in = torch.cat([-torch.ones_like(cond), cond])
        swapped = torch.cat([cond, -torch.ones_like(cond)])
        x2, t2 = torch.cat([x, x]), torch.cat([t, t])
        with torch.inference_mode():
            double = task.apply_eps(x2, t2, c_in)
            fork = task.apply_eps(x, t, c_in, cfg_fork=True)
            fault = task.apply_eps(x, t, swapped, cfg_fork=True)
            ratio = limit_ratio(fork, double, atol, rtol)
            fault_ratio = limit_ratio(fault, double, atol, rtol)
            label = f"{'bf16' if bf16 else 'fp32'} B={b}"
            log(f"[routes] cfg_fork {label}: fork vs double batch max ratio to the limit "
                f"{ratio:.3g} (atol {atol:.3g}, rtol {rtol:.3g}; limit 1), max_abs_err "
                f"{(fork - double).abs().max().item():.3g}, |double| max "
                f"{double.abs().max().item():.3g}; planted fault (halves swapped) "
                f"{fault_ratio:.3g} (must exceed 1)")
            if not (ratio <= 1.0 < fault_ratio and torch.isfinite(fork).all()):
                raise AssertionError(f"cfg_fork ({label}) disagrees with the double batch, or "
                                     "its planted fault passed")
            out[label] = dict(ratio=ratio, max_abs_err=(fork - double).abs().max().item())
            if bf16:
                forms = {"double": lambda: task.apply_eps(x2, t2, c_in),
                         "fork": lambda: task.apply_eps(x, t, c_in, cfg_fork=True)}
                ms = time_in_turns(forms, rounds=5, inner=2)
                peak = {}
                for name, fn in forms.items():
                    torch.cuda.synchronize()
                    resident = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    fn()
                    torch.cuda.synchronize()
                    peak[name] = (torch.cuda.max_memory_allocated() - resident) / 2**30
                log(f"[routes] cfg_fork bf16 eval at B={b} (CFG double batch {2 * b}): ms "
                    f"double {ms['double']:.3f}, fork {ms['fork']:.3f}; peak device memory "
                    f"above the resident GiB: double {peak['double']:.3f}, fork "
                    f"{peak['fork']:.3f}")
                out["eval_ms"], out["peak_gib"] = ms, peak
        del task
    return out


def drive_route_requests(counters):
    """One DDIM-50 CFG-5 request each through ``InferenceSession``: with
    ``cfg_fork`` at batch ROUTES_FORK_BATCH and with ``gn_conv="int8_xla"``
    at batch ROUTES_INT8_BATCH, the launch counts set to 0 just before each
    and read just after (kernel 1 only: 550; no kernel 4 or 5). Returns the
    launches and the seconds of each."""
    import torch

    from polyffusion_tpu_torch.inference import InferenceSession

    cfg = full_cfg(bf16=True)
    rng = np.random.default_rng(29)
    zero = {name: 0 for name in counters}
    want = dict(zero, packed_attention=LAUNCHES_PER_REQUEST)
    launches, secs = {}, {}
    for name, gn_conv, fork, b in (("cfg_fork", "unfused", True, ROUTES_FORK_BATCH),
                                   ("int8_xla", "int8_xla", False, ROUTES_INT8_BATCH)):
        task = make_task(cfg, None, seed=0, gn_conv=gn_conv)
        session = InferenceSession(task, sampler="ddim", ddim_steps=50, seed=0, cfg_fork=fork)
        chords = torch.from_numpy(random_chords(rng, b))
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = session.generate(task.encode_chord(chords), uncond_scale=5.0)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        log(f"[routes] {name} request: batch {b}, DDIM-50 CFG 5: {secs[name]:.3f} s, "
            f"{b / secs[name]:.3f} samples/s, launches {launches[name]}")
        if launches[name] != want:
            raise AssertionError(f"[routes] {name}: expected launches {want}, got {launches[name]}")
        if gen.shape != (b, 2, 128, 128) or not np.isfinite(gen).all():
            raise AssertionError(f"[routes] {name}: bad output, shape {gen.shape}")
        del task, session
    return launches, secs


def drive_routes(counters, smi):
    """``[routes]``: the XLA int8 route and the CFG fork (``check_int8_conv_
    card_vs_cpu``, ``check_int8_xla_eps``, ``check_cfg_fork``, then
    ``drive_route_requests``). Returns each request's launches."""
    t0 = time.perf_counter()
    sites = check_int8_conv_card_vs_cpu()
    eps = check_int8_xla_eps()
    fork = check_cfg_fork()
    launches, secs = drive_route_requests(counters)
    phase = time.perf_counter() - t0
    summary = dict(card=smi, int8_sites=sites, int8_xla_eps=eps, cfg_fork=fork,
                   request_secs=secs, phase_s=phase)
    log(f"[routes] summary {json.dumps(summary)}")
    log(f"[routes] phase {phase:.3f} s")
    return launches


def swapped_parities(from_s2d):
    """The planted fault of the [s2d] checks: ``from_s2d`` with the two
    W-parities of its input swapped (every output column pair reversed)."""
    def fault(h):
        c = h.shape[1] // 2
        return from_s2d(h[:, list(range(c, 2 * c)) + list(range(c))])
    return fault


class PlantedUnfold:
    """Within the block, the UNet's head unfolds with ``swapped_parities``."""

    def __enter__(self):
        from polyffusion_tpu_torch.models import unet as unet_mod

        self.real = unet_mod.from_s2d
        unet_mod.from_s2d = swapped_parities(self.real)

    def __exit__(self, *exc):
        from polyffusion_tpu_torch.models import unet as unet_mod

        unet_mod.from_s2d = self.real


def check_s2d_unet():
    """The full-width fp32 UNet (TF32 off) with ``gn_conv="s2d"`` at B =
    S2D_FP32_BATCH: on the card against the CPU and against the unfolded
    (unfused) UNet on the card, both at UNET_ATOL / UNET_RTOL (fault:
    ``swapped_parities``); the forked UNet at B = 2 (condition 2B) against its
    double batch at the same limit (fault: the condition's halves swapped).
    Returns the ratios to the limits."""
    import torch

    cfg = full_cfg(bf16=False)
    rng = np.random.default_rng(31)
    b = S2D_FP32_BATCH
    x = torch.from_numpy(rng.standard_normal((b, 2, 128, 128)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, cfg.n_steps, b))
    cond = torch.from_numpy(rng.standard_normal((b, 1, cfg.d_cond)).astype(np.float32))
    card = make_task(cfg, "cuda", seed=1, gn_conv="s2d")
    xc, tc, cc = x.cuda(), t.cuda(), cond.cuda()
    out = {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        got = card.apply_eps(xc, tc, cc)
        t_gpu = time.perf_counter() - t0
        with PlantedUnfold():
            fault = card.apply_eps(xc, tc, cc)
        unfolded = make_task(cfg, "cuda", seed=1).apply_eps(xc, tc, cc)
        t0 = time.perf_counter()
        want = make_task(cfg, "cpu", seed=1, gn_conv="s2d").apply_eps(x, t, cond).cuda()
        t_cpu = time.perf_counter() - t0
        for name, ref in (("card_vs_cpu", want), ("folded_vs_unfolded", unfolded)):
            out[name] = limit_ratio(got, ref, UNET_ATOL, UNET_RTOL)
            out[f"{name}_fault"] = limit_ratio(fault, ref, UNET_ATOL, UNET_RTOL)
        # the fork: x and t at B = 2, the condition [uncond | cond] at 2B
        x2, t2, c_in = xc[:2], tc[:2], torch.cat([-torch.ones_like(cc[:2]), cc[:2]])
        swapped = torch.cat([cc[:2], -torch.ones_like(cc[:2])])
        double = card.apply_eps(torch.cat([x2, x2]), torch.cat([t2, t2]), c_in)
        out["fork"] = limit_ratio(card.apply_eps(x2, t2, c_in, cfg_fork=True), double,
                                  UNET_ATOL, UNET_RTOL)
        out["fork_fault"] = limit_ratio(card.apply_eps(x2, t2, swapped, cfg_fork=True), double,
                                        UNET_ATOL, UNET_RTOL)
    log(f"[s2d] full-width fp32 UNet (B={b}, gn_conv s2d), ratio to the limit (atol "
        f"{UNET_ATOL}, rtol {UNET_RTOL}; limit 1): card vs CPU {out['card_vs_cpu']:.3g}, folded "
        f"vs unfolded on the card {out['folded_vs_unfolded']:.3g}; planted fault (from_s2d "
        f"parities swapped) {out['card_vs_cpu_fault']:.3g} / {out['folded_vs_unfolded_fault']:.3g} "
        f"(must exceed 1); max_abs_err vs CPU {(got - want).abs().max().item():.3g}, |out| max "
        f"{want.abs().max().item():.3g}; card {t_gpu:.2f} s (first call), CPU {t_cpu:.2f} s")
    log(f"[s2d] fp32 fork (B=2, condition 2B) vs double batch: ratio {out['fork']:.3g}; planted "
        f"fault (halves swapped) {out['fork_fault']:.3g} (must exceed 1)")
    if not (max(out["card_vs_cpu"], out["folded_vs_unfolded"], out["fork"]) <= 1.0
            < min(out["card_vs_cpu_fault"], out["folded_vs_unfolded_fault"], out["fork_fault"])
            and torch.isfinite(got).all()):
        raise AssertionError("the s2d UNet disagrees with the CPU, the unfolded UNet or its "
                             "double batch, or a planted fault passed")
    return out


def check_s2d_train_step(counters):
    """One full-width fp32 train step with ``gn_conv="s2d"`` at batch 2,
    card (cuDNN's convolutions, TF32 off) against CPU at the [train] limits,
    with the card step's launches: kernels 1 / 2 / 6 at 11 / 11 / 45 (the 11
    folded norms' backward is autograd's). Planted fault:
    ``swapped_parities`` on the card. Returns the launches and the
    readings."""
    cfg = full_cfg(bf16=False)
    inputs = step_inputs()
    cpu, _ = one_train_step("cpu", "s2d", inputs)
    gpu, launches = one_train_step("cuda", "s2d", inputs, counters)
    with PlantedUnfold():
        fault, _ = one_train_step("cuda", "s2d", inputs)
    readings = compare_steps(gpu, cpu, cfg.learning_rate)
    fault_readings = compare_steps(fault, cpu, cfg.learning_rate)
    out = dict(loss_rel=readings[0], norm_rel=readings[1], grad_ratio=readings[2],
               worst=readings[3], param_max_abs_err=readings[4], param_share=readings[5],
               fault_loss_rel=fault_readings[0], fault_grad_ratio=fault_readings[2],
               card_s=gpu[4], cpu_s=cpu[4], launches=launches)
    want = dict({name: 0 for name in counters}, packed_attention=ATTENTION_SITES,
                packed_attention_bwd=ATTENTION_SITES, gn_bwd=GROUPNORM_SITES - S2D_FOLDED_NORMS)
    log(f"[s2d] full-width fp32 step (B=2, gn_conv s2d) "
        f"card vs CPU: loss {gpu[0]:.7g} vs {cpu[0]:.7g} (rel {out['loss_rel']:.3g}, limit "
        f"{STEP_LOSS_RTOL}), grad_norm rel {out['norm_rel']:.3g} (limit {STEP_NORM_RTOL}); "
        f"gradients per tensor {out['grad_ratio']:.3g} x the limit (worst {out['worst']}); "
        f"params max_abs_err {out['param_max_abs_err']:.3g}, share above {STEP_PARAM_TIGHT}: "
        f"{out['param_share']:.3g}; planted fault (from_s2d parities swapped): loss rel "
        f"{out['fault_loss_rel']:.3g}, gradients {out['fault_grad_ratio']:.3g} x the limit "
        f"(must fail); "
        f"card {gpu[4]:.2f} s (first call), CPU {cpu[4]:.2f} s; launches {launches}")
    if not readings[-1] or fault_readings[-1]:
        raise AssertionError("the s2d train step on the card disagrees with the CPU, or its "
                             "planted fault passed")
    if launches != want:
        raise AssertionError(f"[s2d] train step: expected launches {want}, got {launches}")
    return launches, out


def time_s2d_eval():
    """The full-width bf16 UNet eval at B = S2D_EVAL_BATCH (CFG batch 2B),
    folded against unfolded on the same weights: ms by CUDA events (5 rounds
    in turns), peak device memory above the resident, and the outputs' mean
    relative difference (a reading: bf16 through some 25 layers in another
    order has no published limit). Returns the readings and the s2d task."""
    import torch

    cfg = full_cfg(bf16=True)
    rng = np.random.default_rng(37)
    b = S2D_EVAL_BATCH
    x = torch.from_numpy(rng.standard_normal((b, 2, 128, 128)).astype(np.float32)).cuda()
    t = torch.from_numpy(rng.integers(0, cfg.n_steps, b)).cuda()
    cond = torch.from_numpy(rng.standard_normal((b, 1, cfg.d_cond)).astype(np.float32)).cuda()
    x2, t2, c_in = torch.cat([x, x]), torch.cat([t, t]), torch.cat([-torch.ones_like(cond), cond])
    tasks = {mode: make_task(cfg, "cuda", seed=3, gn_conv=mode) for mode in ("unfused", "s2d")}
    out = {}
    with torch.inference_mode():
        eps = {mode: task.apply_eps(x2, t2, c_in).float() for mode, task in tasks.items()}
        out["mean_rel_diff"] = ((eps["s2d"] - eps["unfused"]).abs().mean()
                                / eps["unfused"].abs().mean()).item()
        forms = {mode: (lambda task=task: task.apply_eps(x2, t2, c_in))
                 for mode, task in tasks.items()}
        out["ms"] = time_in_turns(forms, rounds=5, inner=2)
        out["peak_gib"] = {}
        for name, fn in forms.items():
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            out["peak_gib"][name] = (torch.cuda.max_memory_allocated() - resident) / 2**30
    log(f"[s2d] bf16 eval at B={b} (CFG batch {2 * b}): ms unfused {out['ms']['unfused']:.3f}, "
        f"s2d {out['ms']['s2d']:.3f} (CUDA events, 5 rounds in turns; s2d / unfused "
        f"{out['ms']['s2d'] / out['ms']['unfused']:.4f}); peak device memory above the resident "
        f"GiB: unfused {out['peak_gib']['unfused']:.3f}, s2d {out['peak_gib']['s2d']:.3f}; eps "
        f"mean |s2d - unfused| / mean |unfused| {out['mean_rel_diff']:.4g} (a reading, not "
        f"gated)")
    if not torch.isfinite(eps["s2d"]).all():
        raise AssertionError("the bf16 s2d UNet's eps is not finite")
    return out, tasks["s2d"]


def drive_s2d_request(counters, task):
    """One DDIM-50 CFG-5 request at batch S2D_REQUEST_BATCH through
    ``InferenceSession`` on ``task`` (the full-width bf16 preset with
    ``gn_conv="s2d"``), the launch counts set to 0 just before it and read
    just after (kernel 1 only: 550). Returns the launches and the seconds."""
    import torch

    from polyffusion_tpu_torch.inference import InferenceSession

    b = S2D_REQUEST_BATCH
    session = InferenceSession(task, sampler="ddim", ddim_steps=50, seed=0)
    chords = torch.from_numpy(random_chords(np.random.default_rng(41), b))
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = session.generate(task.encode_chord(chords), uncond_scale=5.0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    want = dict({name: 0 for name in counters}, packed_attention=LAUNCHES_PER_REQUEST)
    log(f"[s2d] request: batch {b}, DDIM-50 CFG 5: {secs:.3f} s, {b / secs:.3f} samples/s, "
        f"launches {launches}")
    if launches != want:
        raise AssertionError(f"[s2d] request: expected launches {want}, got {launches}")
    if gen.shape != (b, 2, 128, 128) or not np.isfinite(gen).all():
        raise AssertionError(f"[s2d] request: bad output, shape {gen.shape}")
    return launches, secs


def drive_s2d(counters, smi):
    """``[s2d]``: the space-to-depth level 0 (``check_s2d_unet``,
    ``check_s2d_train_step``, ``time_s2d_eval``, ``drive_s2d_request``).
    Returns the launches of the train step and of the request."""
    t0 = time.perf_counter()
    unet = check_s2d_unet()
    step_launches, step = check_s2d_train_step(counters)
    evals, task = time_s2d_eval()
    request_launches, secs = drive_s2d_request(counters, task)
    phase = time.perf_counter() - t0
    summary = dict(card=smi, unet=unet, step=step, eval=evals, request_s=secs,
                   request_batch=S2D_REQUEST_BATCH, phase_s=phase)
    log(f"[s2d] summary {json.dumps(summary)}")
    log(f"[s2d] phase {phase:.3f} s")
    return {"training_s2d": step_launches, "sampling_s2d": request_launches}


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


def write_midi_songs(midi_dir, seed):
    """MIDI_SONGS seeded songs ``song<i>.mid`` (see MIDI_BARS) with the port's
    ``save_midi``; returns each file's written root per bar."""
    from polyffusion_tpu_torch.utils import midi as M

    os.makedirs(midi_dir)
    roots = {}
    for i in range(MIDI_SONGS):
        rng = np.random.default_rng(seed + i)
        first = random_chords(rng, MIDI_BARS // 8)[:, ::4].reshape(MIDI_BARS, 36)  # bar starts
        bar_roots = first[:, :12].argmax(1)
        minor = first[np.arange(MIDI_BARS), 12 + (bar_roots + 3) % 12] > 0
        melody, piano, drums = (M.Instrument(program=0), M.Instrument(program=0),
                                M.Instrument(program=0, is_drum=True))
        for bar in range(MIDI_BARS):
            t0, r = bar * 2.0, int(bar_roots[bar])
            for pitch in (48 + r, 52 + r - int(minor[bar]), 55 + r):
                piano.notes.append(M.Note(t0, t0 + 2.0, pitch, 70))
            for k in range(8):
                melody.notes.append(M.Note(t0 + k * 0.25, t0 + (k + 1) * 0.25,
                                           72 + int(rng.integers(0, 12)), 90))
            for k in range(4):
                drums.notes.append(M.Note(t0 + k * 0.5, t0 + k * 0.5 + 0.1, (36, 38)[k % 2], 100))
        path = os.path.join(midi_dir, f"song{i}.mid")
        M.save_midi(M.MidiFile(instruments=[melody, piano, drums],
                               time_signatures=[M.TimeSignature(4, 4, 0.0)]), path)
        if i == MIDI_TEMPO_SONG:
            with open(path, "rb") as f:
                data = f.read()
            first_len = int.from_bytes(data[18:22], "big")
            body = (b"\x00\xff\x51\x03" + (500000).to_bytes(3, "big")
                    + b"\x00\xff\x58\x04\x04\x02\x18\x08"
                    + M._varlen(MIDI_BARS // 2 * 4 * M.DEFAULT_TICKS_PER_BEAT)
                    + b"\xff\x51\x03" + (600000).to_bytes(3, "big") + b"\x00\xff\x2f\x00")
            with open(path, "wb") as f:
                f.write(data[:14] + b"MTrk" + len(body).to_bytes(4, "big") + body
                        + data[22 + first_len:])
        roots[f"song{i}.mid"] = bar_roots
    return roots


def drive_midi_ingestion(midi_dir, roots, smi):
    """``song_from_midi`` on each file (host seconds) and the share of beats
    whose recognized root is the written one. Returns the songs."""
    from polyffusion_tpu_torch.data.midi_to_data import song_from_midi

    songs, secs = {}, {}
    for name, bar_roots in roots.items():
        t0 = time.perf_counter()
        songs[name] = song = song_from_midi(os.path.join(midi_dir, name))
        secs[name] = time.perf_counter() - t0
        written = np.repeat(bar_roots, 4)
        n = min(len(written), len(song.chord))
        whole = float((song.chord[:n, 0] == written[:n]).mean())
        # the chord matrix counts beats of 0.5 s, as the reference's does
        # (chord_matrix_from_chordlab): after a tempo change it drifts off the bars
        n = MIDI_BARS // 2 * 4 if name == f"song{MIDI_TEMPO_SONG}.mid" else n
        share = float((song.chord[:n, 0] == written[:n]).mean())
        segments = song.get_whole_song_data()[0].shape[0]
        log(f"[midi] ingest {name}: {secs[name]:.3f} s on the host, {len(song)} downbeats, "
            f"{segments} segments, {len(song.chord)} chord beats, root share {share:.4f} over "
            f"the {n} beats at 120 bpm (limit {MIDI_ROOT_SHARE_MIN}), {whole:.4f} over the song "
            f"({smi})")
        if segments != MIDI_BARS // 8 or not share >= MIDI_ROOT_SHARE_MIN:
            raise AssertionError(f"{name}: {segments} segments, root share {share}")
    return songs, secs


def check_prepared_songs(midi_dir, npz_dir, songs):
    """``prepare_data`` on the MIDI directory: every file an .npz that
    ``SegmentDataset.from_dir`` reads, whose whole song is ``song_from_midi``'s,
    exactly."""
    from polyffusion_tpu_torch.data import SegmentDataset, SongNpz
    from polyffusion_tpu_torch.prepare_data import prepare_npz

    t0 = time.perf_counter()
    counts = prepare_npz(midi_dir, npz_dir)
    secs = time.perf_counter() - t0
    ds = SegmentDataset.from_dir(npz_dir)
    log(f"[midi] prepare_data: {counts} in {secs:.3f} s on the host; SegmentDataset of "
        f"{len(ds)} segments")
    if counts["ok"] != MIDI_SONGS or not len(ds):
        raise AssertionError(f"prepare_data wrote {counts}")
    for name, song in songs.items():
        got = SongNpz(name.replace(".mid", ".npz"), npz_dir).get_whole_song_data()
        for a, b in zip(got, song.get_whole_song_data()):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"{name}: the prepared song differs from song_from_midi's")


class RecordedConditions:
    """Records what the inference CLI's ``song_conditions`` returns while
    active (the CLI reads it from its module)."""

    def __enter__(self):
        import polyffusion_tpu_torch.inference as inference

        self.module, self.real, self.calls = inference, inference.song_conditions, []

        def record(*args, **kwargs):
            out = self.real(*args, **kwargs)
            self.calls.append(out)
            return out

        inference.song_conditions = record
        return self.calls

    def __exit__(self, *exc):
        self.module.song_conditions = self.real


def drive_midi_cli(counters, work, midi_dir, npz_dir, songs, smi):
    """The inference CLI's MIDI requests, each with the launch counts set to 0
    just before it and read just after: (D) ``--from_midi`` with no
    ``--data_dir``, (D') the same song prepared, (E) inpainting of a second
    MIDI, on the training path's run directory; (F) ``--from_midi2`` on the
    chord+txt run directory of ``drive_mix2_paths``; (G) ``--polydis_recon``
    with a seeded PolyDis checkpoint in the reference layout. DDIM-50, 2
    segments: 550 kernel-1 launches each. Returns launches and seconds."""
    import torch

    from polyffusion_tpu_torch.config import load_params
    from polyffusion_tpu_torch.diffusion.sampler import ddim_q_sample
    from polyffusion_tpu_torch.diffusion.schedule import make_ddim_schedule, make_schedule
    from polyffusion_tpu_torch.inference import (
        build_task_for_inference,
        polydis_recon,
        song_conditions,
    )
    from polyffusion_tpu_torch.inference import main as infer_main
    from polyffusion_tpu_torch.models.polydis import PolyDis, PolydisAftertouch
    from polyffusion_tpu_torch.utils.midi import load_midi

    run, run_mix2, pretrained = (os.path.join(work, d) for d in ("run", "run_mix2", "pretrained"))
    song = {i: os.path.join(midi_dir, f"song{i}.mid") for i in range(3)}
    pd_path = os.path.join(work, "polydis_vae", "model_master_final.pt")
    os.makedirs(os.path.dirname(pd_path))
    polydis = PolyDis(device="cpu", generator=torch.Generator().manual_seed(33))
    torch.save({f"module.{k}": v for k, v in polydis.state_dict().items()}, pd_path)
    ddim = ["--ddim", "--length", "2"]
    requests = {
        "D": (run, ["--from_midi", song[0], "--uncond_scale", "5"] + ddim, 1),
        "D_prepared": (run, ["--data_dir", npz_dir, "--song_fn", "song0.npz",
                             "--uncond_scale", "5"] + ddim, 1),
        "E": (run, ["--from_midi", song[0], "--inpaint_from_midi", song[1], "--inpaint_type",
                    "below"] + ddim, 1),
        "F": (run_mix2, ["--from_midi", song[0], "--from_midi2", song[2], "--uncond_scale", "5"]
              + ddim, 1),
        "G": (run, ["--from_midi", song[0], "--polydis_recon", "--polydis_path", pd_path,
                    "--uncond_scale", "5"] + ddim, 2),
    }
    want = dict({name: 0 for name in counters},
                packed_attention=ATTENTION_SITES * CLI_DDIM_STEPS)
    launches, secs, outputs, conds = {}, {}, {}, {}
    for name, (run_dir, extra, n_mids) in requests.items():
        out_dir = os.path.join(work, f"midi_{name}")
        args = ["--chkpt_path", run_dir, "--pretrained_dir", pretrained, "--output_dir", out_dir]
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RecordedConditions() as calls:
            outputs[name] = infer_main(args + extra)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        (conds[name],) = calls
        mids = sorted(f for f in os.listdir(out_dir) if f.endswith(".mid"))
        log(f"[midi] request {name} ({' '.join(os.path.basename(a) for a in extra)}): "
            f"{secs[name]:.3f} s, launches {launches[name]}, wrote {mids} ({smi})")
        if launches[name] != want:
            raise AssertionError(f"expected launches {want}, got {launches[name]}")
        if len(mids) != n_mids:
            raise AssertionError(f"expected {n_mids} .mid file(s), found {mids}")

    # D and D': the same condition from the MIDI and from its prepared .npz,
    # and that condition on the card against the CPU
    cfg = load_params(os.path.join(run, "params.yaml"))
    cpu_task = build_task_for_inference(cfg, pretrained, device="cpu")
    song0 = songs["song0.mid"].get_whole_song_data()
    want_cond = song_conditions(cpu_task, song0, 2)[0]
    same_err = float(np.abs(conds["D"][0] - conds["D_prepared"][0]).max())
    cpu_err = float(np.abs(conds["D_prepared"][0] - want_cond).max())
    (gen_d,), (gen_dp,) = outputs["D"], outputs["D_prepared"]
    log(f"[midi] D vs D': condition max_abs_err {same_err:.3g}, output max_abs_diff "
        f"{float(np.abs(gen_d - gen_dp).max()):.3g}; condition card vs CPU max_abs_err "
        f"{cpu_err:.3g} (atol {COND_ATOL})")
    if not (same_err <= COND_ATOL and cpu_err <= COND_ATOL and gen_d.shape == (2, 2, 128, 128)
            and np.isfinite(gen_d).all()):
        raise AssertionError("requests D and D' disagree on the song's condition")

    # E: the kept region is song 1's roll at the DDIM grid's last index, under
    # the session's first draw (its starting noise, seed 0)
    ((gen_e, mask),) = outputs["E"]
    dd = make_ddim_schedule(make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end), 50,
                            "uniform", 0.0)
    g = torch.Generator(device="cuda").manual_seed(0)
    noise = torch.randn((2, cfg.img_h, cfg.img_w, cfg.out_channels), generator=g,
                        device="cuda").permute(0, 3, 1, 2)
    orig = torch.as_tensor(songs["song1.mid"].get_whole_song_data()[0][:2], device="cuda")
    kept = ddim_q_sample(dd, orig, 0, noise).cpu().numpy()
    keep = mask == 1
    keep_err = float(np.abs(gen_e[keep] - kept[keep]).max())
    log(f"[midi] E: output {gen_e.shape}, kept share {keep.mean():.3f}, kept region vs the DDIM "
        f"q_sample of song 1 at index 0: max_abs_err {keep_err:.3g} (limit {MIDI_KEEP_ATOL})")
    if not (gen_e.shape == (2, 2, 128, 128) and 0 < keep.mean() < 1
            and keep_err <= MIDI_KEEP_ATOL):
        raise AssertionError("request E did not keep song 1's region")

    # F: the chord part from song 0, the texture part from song 2
    mix2 = build_task_for_inference(load_params(os.path.join(run_mix2, "params.yaml")),
                                    pretrained, device="cpu")
    zc = mix2.cfg.chd_z_dim
    chd_err = float(np.abs(conds["F"][0][..., :zc] - song_conditions(mix2, song0, 2)[0][..., :zc])
                    .max())
    txt_want = song_conditions(mix2, songs["song2.mid"].get_whole_song_data(), 2)[0][..., zc:]
    txt_err = float(np.abs(conds["F"][0][..., zc:] - txt_want).max())
    log(f"[midi] F: condition {conds['F'][0].shape}: chord part vs song 0 on the CPU "
        f"max_abs_err {chd_err:.3g}, texture part vs song 2 on the CPU {txt_err:.3g} (atol "
        f"{COND_ATOL})")
    if not (chd_err <= COND_ATOL and txt_err <= COND_ATOL):
        raise AssertionError("request F's condition is not song 0's chords with song 2's texture")

    # G: the re-rendering reads back; then the aftertouch alone, warm
    out_g = os.path.join(work, "midi_G")
    recon = load_midi(os.path.join(out_g, "polydis_recon_0.mid"))
    (gen_g,) = outputs["G"]
    aftertouch = PolydisAftertouch(model_path=pd_path)
    after_secs = []
    for k in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = polydis_recon(aftertouch, gen_g, song0[2], os.path.join(out_g, f"again_{k}.mid"))
        torch.cuda.synchronize()
        after_secs.append(time.perf_counter() - t0)
    notes = sum(len(i.notes) for i in recon.instruments)
    log(f"[midi] G: polydis_recon_0.mid reads back with {notes} notes; PolyDis aftertouch of "
        f"{est.shape[0]} windows: {after_secs[0]:.3f} s cold, "
        f"{statistics.median(after_secs[1:]):.3f} s warm ({smi})")
    if est.shape != (8, 32, 31, 6):
        raise AssertionError(f"bad aftertouch grid {est.shape}")
    return launches, dict(secs, aftertouch_warm=statistics.median(after_secs[1:]))


def polydis_tf_logits(model, x, c, pr, noise, swap=False):
    """Teacher-forced decoder logits of ``run`` (every coin true) from explicit
    z; ``swap`` decodes z_rhy | z_chd (the planted fault)."""
    import torch

    (mu_c, std_c), (mu_r, std_r) = model.encode(pr, c)
    z_c = mu_c + std_c * noise.z_chd.to(model.device)
    z_r = mu_r + std_r * noise.z_rhy.to(model.device)
    z = torch.cat([z_r, z_c] if swap else [z_c, z_r], dim=-1)
    emb, lengths = model.decoder.emb_x(torch.as_tensor(x, device=model.device))
    return model.decoder(z, emb, lengths, noise.tf1.to(model.device), noise.tf2.to(model.device))


def check_polydis_against_cpu(songs):
    """PolyDis fp32 at its widths, card against CPU on POLYDIS_BATCH 2-bar
    windows of the ingested songs (the PianoTree padded to its 32 note
    slots): the encoder; the teacher-forced loss, every term, and the
    gradients; its logits; the greedy grid. Planted fault: z halves swapped."""
    import torch

    from polyffusion_tpu_torch.models.polydis import PolyDis

    _, pt, chd, pr = (np.concatenate(a) for a in zip(*(s.get_whole_song_data()
                                                      for s in songs.values())))
    b = POLYDIS_BATCH
    x = np.concatenate([pt.reshape(-1, 32, 20, 6)[:b],
                        np.tile(np.array([130, 2, 2, 2, 2, 2]), (b, 32, 12, 1))], axis=2)
    c, prw = chd.reshape(-1, 8, 36)[:b], pr.reshape(-1, 32, 128)[:b]
    cpu = PolyDis(device="cpu", generator=torch.Generator().manual_seed(31))
    gpu = PolyDis(device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    noise = cpu.draw_noise(b, torch.Generator().manual_seed(32), 1.0, 1.0, 1.0)
    out = {}
    for name, m in (("cuda", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        with torch.no_grad():
            enc = [t.cpu() for dist in m.encode(prw, c) for t in dist]
            logits = [t.cpu() for t in polydis_tf_logits(m, x, c, prw, noise)]
            grid = m.inference(prw, c)
        m.zero_grad()
        total, terms = m.loss(x, c, prw, noise)
        total.backward()
        grads = {k: p.grad.cpu() for k, p in m.named_parameters()}
        out[name] = (enc, logits, grid, {k: v.item() for k, v in terms.items()}, grads,
                     time.perf_counter() - t0)
    (enc_g, log_g, grid_g, terms_g, grads_g, t_gpu), (enc_c, log_c, grid_c, terms_c, grads_c,
                                                      t_cpu) = out["cuda"], out["cpu"]
    enc_err = max((a - w).abs().max().item() for a, w in zip(enc_g, enc_c))
    logit_err = max((a - w).abs().max().item() for a, w in zip(log_g, log_c))
    term_err = max(abs(terms_g[k] - w) / abs(w) for k, w in terms_c.items())
    grad_ratio = max(((grads_g[k] - w).norm() / (STEP_GRAD_RTOL * w.norm() + 1e-9)).item()
                     for k, w in grads_c.items())
    share = float((grid_g == grid_c).mean())
    with torch.no_grad():  # the planted fault: z_chd | z_rhy swapped
        fault_logits = [t.cpu() for t in polydis_tf_logits(gpu, x, c, prw, noise, swap=True)]
        (mu_c, _), (mu_r, _) = gpu.encode(prw, c)
        fault_grid = gpu.decode(mu_r, mu_c)
    fault_err = max((a - w).abs().max().item() for a, w in zip(fault_logits, log_c))
    fault_share = float((fault_grid == grid_c).mean())
    log(f"[midi] PolyDis fp32 card vs CPU (batch {b}): encoder max_abs_err {enc_err:.3g} (atol "
        f"{COND_ATOL}); teacher-forced loss {terms_g['loss']:.7g} vs {terms_c['loss']:.7g}, "
        f"worst term rel {term_err:.3g} (limit {STEP_LOSS_RTOL}); gradients {grad_ratio:.3g} x "
        f"the limit (rel {STEP_GRAD_RTOL} in norm); logits max_abs_err {logit_err:.3g} (atol "
        f"{POLYDIS_LOGIT_ATOL}); greedy grid {grid_g.shape} equal share {share:.5f} (limit "
        f"{POLYDIS_GRID_SHARE_MIN}); planted fault (z halves swapped): logits {fault_err:.3g}, "
        f"grid share {fault_share:.5f}; card {t_gpu:.2f} s, CPU {t_cpu:.2f} s")
    if not (enc_err <= COND_ATOL and term_err <= STEP_LOSS_RTOL and grad_ratio <= 1.0
            and logit_err <= POLYDIS_LOGIT_ATOL and share >= POLYDIS_GRID_SHARE_MIN):
        raise AssertionError("PolyDis on the card disagrees with the CPU")
    if fault_err <= POLYDIS_LOGIT_ATOL or fault_share >= POLYDIS_GRID_SHARE_MIN:
        raise AssertionError("the planted PolyDis fault passed the check")


def drive_midi_path(counters, work, smi):
    """The [midi] phase: MIDI songs written, ingested and prepared; the
    inference CLI's MIDI requests D to G; PolyDis card against CPU. Returns
    the requests' launches."""
    midi_dir, npz_dir = os.path.join(work, "midi"), os.path.join(work, "midi_npz")
    roots = write_midi_songs(midi_dir, seed=200)
    songs, ingest_secs = drive_midi_ingestion(midi_dir, roots, smi)
    check_prepared_songs(midi_dir, npz_dir, songs)
    launches, request_secs = drive_midi_cli(counters, work, midi_dir, npz_dir, songs, smi)
    check_polydis_against_cpu(songs)
    summary = dict(ingest_secs=ingest_secs, request_secs=request_secs, card=smi)
    log(f"[midi] summary {json.dumps(summary)}")
    return launches


def vae_task(name, device, seed, **over):
    """The training CLI's task of a VAE preset, weights from ``seed``."""
    from polyffusion_tpu_torch.config import load_params
    from polyffusion_tpu_torch.main import build_task

    cfg = load_params(name)
    cfg.update(over)
    return cfg, build_task(cfg, device=device, seed=seed)


def vae_batch(data, name, b, device):
    """``b`` segments of the songs, as the feeder sends them to ``device``:
    the task's fields only, chord as uint8, pnotree as int16."""
    import torch

    prmat2c, pnotree, chord, prmat = song_batch(data, b)
    empty = torch.zeros((b, 1))
    if name == "chd_8bar":
        return (empty.to(device), empty.to(device), chord.to(device, torch.uint8),
                empty.to(device))
    return empty.to(device), pnotree.to(device, torch.int16), empty.to(device), empty.to(device)


def on_device(values, device):
    """A batch or noise tuple with its tensors moved to ``device`` (other
    fields, e.g. a global step, as they are)."""
    import torch

    moved = [v.to(device) if torch.is_tensor(v) else v for v in values]
    return type(values)(*moved) if hasattr(values, "_fields") else tuple(moved)


def step_card_vs_cpu(label, name, batch, noise, seed, over=None, exact_zero=(), fault=None,
                     cudnn=True, gate=True):
    """One fp32 train step of the preset ``name`` (with the overrides
    ``over``) on the card against the CPU: the same weights (from ``seed``),
    batch and noise (given on the CPU); the loss and every metric, the
    gradients per tensor and their norm, and the updated parameters, within
    the limits of the sdf step check. A gradient named in ``exact_zero`` is
    zero in exact arithmetic: both sides' must lie under STEP_GRAD_RTOL times
    the norm of its module's weight's. ``fault(task)`` plants a fault in a
    fresh card task, whose loss and metrics must then miss the limit. With
    ``cudnn`` false the card's step runs PyTorch's own convolution kernels.
    Logs one line; raises where a check fails, unless ``gate`` is false (a
    reading only). Returns the card step's kernel-6 launches."""
    import torch

    from polyffusion_tpu_torch.ops.gn_bwd import group_norm_bwd
    from polyffusion_tpu_torch.train import create_state, make_train_step

    over = over or {}
    out = {}
    for device in ("cuda", "cpu"):
        cfg, task = vae_task(name, device, seed=seed, **over)
        state = create_state(task.model, cfg.learning_rate, cfg.max_grad_norm)
        group_norm_bwd.launches = 0
        torch.backends.cudnn.enabled = cudnn or device == "cpu"
        t0 = time.perf_counter()
        metrics = make_train_step(task)(state, on_device(batch, device), seed=0,
                                        noise=on_device(noise, device))
        torch.backends.cudnn.enabled = True
        metrics = {k: v.item() for k, v in metrics.items()}
        params = {k: v.detach().cpu() for k, v in state.params().items()}
        grads = {k: v.grad.cpu() for k, v in state.params().items()}
        out[device] = (metrics, params, grads, time.perf_counter() - t0, group_norm_bwd.launches)
        del task, state
    (got_m, got, got_g, t_gpu, launches), (want_m, want, want_g, t_cpu, _) = out["cuda"], out["cpu"]

    def rel_errors(metrics):
        return {k: abs(metrics[k] - w) / max(abs(w), 1e-30) for k, w in want_m.items()
                if k != "grad_norm" or "grad_norm" in metrics}

    errs = rel_errors(got_m)
    grad_ratio, worst = 0.0, ""
    for k, w in want_g.items():
        if k in exact_zero:
            scale = want_g[k[:-len("bias")] + "weight"].norm()
            r = (max(got_g[k].norm(), w.norm()) / (STEP_GRAD_RTOL * scale)).item()
        else:
            r = ((got_g[k] - w).norm() / (STEP_GRAD_RTOL * w.norm() + 1e-9)).item()
        if r > grad_ratio:
            grad_ratio, worst = r, k
    err = torch.cat([(got[k] - w).abs().flatten() for k, w in want.items()])
    share = (err > STEP_PARAM_TIGHT).float().mean().item()
    lr = cfg.learning_rate
    fault_note = ""
    if fault is not None:
        _, task = vae_task(name, "cuda", seed=seed, **over)
        fault(task)
        _, fault_m = task.loss_fn(on_device(batch, "cuda"), on_device(noise, "cuda"))
        fault_err = max(v for k, v in rel_errors({k: v.item() for k, v in fault_m.items()}).items()
                        if k != "grad_norm")
        fault_note = f"; planted fault: worst metric rel {fault_err:.3g}"
        del task
    label += "" if cudnn else " (the card without cuDNN)"
    label += "" if gate else " (a reading, not gated)"
    log(f"{label} card vs CPU: loss {got_m['loss']:.7g} vs {want_m['loss']:.7g}; rel errors "
        f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (limits: metrics "
        f"{STEP_LOSS_RTOL}, grad_norm {STEP_NORM_RTOL}){fault_note}; gradients per tensor "
        f"{grad_ratio:.3g} x the limit (rel {STEP_GRAD_RTOL} in norm; worst {worst}); params "
        f"max_abs_err {err.max().item():.3g} (limit {2 * lr:.3g}), share above "
        f"{STEP_PARAM_TIGHT}: {share:.3g} (limit {STEP_PARAM_SHARE}); kernel-6 launches {launches}; "
        f"card {t_gpu:.2f} s (first call), CPU {t_cpu:.2f} s")
    if gate and not (all(v <= (STEP_NORM_RTOL if k == "grad_norm" else STEP_LOSS_RTOL)
                         for k, v in errs.items())
                     and grad_ratio <= 1.0 and err.max().item() <= 2 * lr
                     and share <= STEP_PARAM_SHARE):
        raise AssertionError(f"{label}: the card disagrees with the CPU")
    if fault is not None and not fault_err > STEP_LOSS_RTOL:
        raise AssertionError(f"{label}: the limits do not catch the planted fault")
    return launches


def check_vae_steps_against_cpu(work):
    """One fp32 train step of ``chd_8bar`` (full width, its batch 128) and of
    ``pnotree_vae`` (full width, PNO_CHECK_BATCH items = 4 segments) on the card
    against the CPU (``step_card_vs_cpu``): same weights, batch, noise and
    teacher-forcing coins (drawn on the CPU at the presets' step-0 rates)."""
    import torch

    from polyffusion_tpu_torch.train.schedulers import make_param_scheduler

    data = os.path.join(work, "songs")
    for name, b in (("chd_8bar", None), ("pnotree_vae", PNO_CHECK_BATCH)):
        cfg, cpu_task = vae_task(name, "cpu", seed=21)
        b = b or cfg.batch_size
        batch = vae_batch(data, name, b, "cpu")
        sched = make_param_scheduler(cfg).step(0)
        noise = cpu_task.draw_noise(batch, torch.Generator().manual_seed(22), sched)
        del cpu_task
        step_card_vs_cpu(f"[pretrain] {name} fp32 step (batch {b}, coins at {sched})", name,
                         batch, noise, seed=21)


def run_training_cli(counters, args, label):
    """``polyffusion_tpu_torch.main`` with the launch counts set to 0 just
    before and read just after; returns (final state, seconds, launches)."""
    from polyffusion_tpu_torch.main import main as train_main

    state, secs, got, _ = run_with_counts(counters, train_main, args)
    log(f"[pretrain] {label}: ended at step {state.step} in {secs:.3f} s (with setup), "
        f"launches {got}")
    return state, secs, got


def drive_vae_training(counters, work):
    """``polyffusion_tpu_torch.main`` for ``chd_8bar`` (its batch 128, the
    training songs with CHD_VAL_SONGS held out by a split file) and
    ``pnotree_vae`` (batch PNO_BATCH): some steps with one validation and one
    checkpoint, then ``--resume`` for a few more, each run with the launch
    counts set to 0 just before it and read just after (these paths run none
    of the port's kernels). Writes ``run_chd8bar`` and ``run_pnotree`` under
    ``work``; returns each run's launches and the warm host ms per step."""
    import pickle

    data = os.path.join(work, "songs")
    songs = sorted(f for f in os.listdir(data) if f.endswith(".npz"))
    split = os.path.join(work, "chd_split.pkl")
    with open(split, "wb") as f:
        pickle.dump((songs[:-CHD_VAL_SONGS], songs[-CHD_VAL_SONGS:]), f)
    zero = {name: 0 for name in counters}
    plans = {
        "chd_8bar": (["--split_file", split, "--log_every", "10"], CHD_STEPS, CHD_RESUME_STEPS),
        "pnotree_vae": (["--batch_size", str(PNO_BATCH), "--log_every", "1"], PNO_STEPS,
                        PNO_RESUME_STEPS),
    }
    launches, host_ms = {}, {}
    for name, (extra, steps, more) in plans.items():
        run = os.path.join(work, f"run_{name}")
        args = ["--model", name, "--output_dir", run, "--data_dir", data, "--seed", "0",
                "--save_every", "1000"] + extra
        for n, resume in ((steps, []), (steps + more, ["--resume"])):
            state, _, got = run_training_cli(counters, args + ["--max_steps", str(n)] + resume,
                                             f"{name} {'resumed ' if resume else ''}run")
            if got != zero:
                raise AssertionError(f"{name} launched a kernel: {got}")
            if state.step != n:
                raise AssertionError(f"{name} run ended at step {state.step}, not {n}")
        launches[name] = zero
        records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
        train = [r for r in records if "train/loss" in r]
        val = [r for r in records if "val/loss" in r]
        values = [v for r in train + val for k, v in r.items() if k.startswith(("train/", "val/"))]
        if not (train and values and np.isfinite(values).all()):
            raise AssertionError(f"{name}: bad metrics {records}")
        if [r["step"] for r in val] != [steps, steps + more]:
            raise AssertionError(f"{name}: validation at steps {[r['step'] for r in val]}: the "
                                 f"resumed run did not start at step {steps}")
        if not os.path.getsize(os.path.join(run, "chkpts", "last.pt")):
            raise AssertionError(f"{name}: no checkpoint written")
        host_ms[name] = 1e3 / train[-1]["steps_per_sec"]
        log(f"[pretrain] {name}: losses {[round(r['train/loss'], 5) for r in train]}, val "
            f"{[{k[4:]: round(v, 5) for k, v in r.items() if k.startswith('val/')} for r in val]}; "
            f"last window {host_ms[name]:.3f} ms/step (host clock, metrics.jsonl)")
    return launches, host_ms


def profile_vae_steps(name, work):
    """Warm fp32 train steps of a VAE preset at full width and its batch on
    the card (``profile_steps``, at the preset's step-0 teacher forcing)."""
    from polyffusion_tpu_torch.train.schedulers import make_param_scheduler

    cfg, task = vae_task(name, "cuda", seed=23, **({"batch_size": PNO_BATCH}
                                                    if name == "pnotree_vae" else {}))
    batch = vae_batch(os.path.join(work, "songs"), name, cfg.batch_size, "cuda")
    return profile_steps(f"[pretrain] {name}", cfg, task, batch, VAE_PROFILE[name],
                         make_param_scheduler(cfg).step(0))


def profile_steps(tag, cfg, task, batch, counts, sched=None):
    """``counts`` = (timed, profiled) warm train steps of ``task`` on
    ``batch`` on the card: ms per step on the host clock and from CUDA events
    over the timed steps, then ``torch.profiler`` over the profiled ones:
    device busy ms and idle share, device kernels per step. Returns those
    numbers."""
    import types

    import torch
    from torch.profiler import ProfilerActivity, profile

    from polyffusion_tpu_torch.profile_train import kernel_launches
    from polyffusion_tpu_torch.profile_unet import breakdown
    from polyffusion_tpu_torch.train import create_state, make_train_step

    timed, profiled = counts
    state = create_state(task.model, cfg.learning_rate, cfg.max_grad_norm)
    step = make_train_step(task)

    def run(n):
        for _ in range(n):
            step(state, batch, seed=0, sched=sched)
        torch.cuda.synchronize()

    run(1)  # warm up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run(timed)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / timed
    event_ms = start.elapsed_time(end) / timed
    # the device's activity only: a pnotree_vae step launches some 200 000
    # kernels, and the host operators' events would multiply the trace
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(profiled)
        wall_ms = (time.perf_counter() - t0) * 1e3
    log(f"{tag} fp32 train step at batch {cfg.batch_size}, under torch.profiler "
        f"({profiled} warm steps):")
    averages = prof.key_averages()  # once: both readers take the same table
    prof = types.SimpleNamespace(key_averages=lambda: averages)
    busy_ms = breakdown(prof, wall_ms, profiled, "step")
    kernels = kernel_launches(prof, profiled)["kernels_per_step"]
    busy = f"{busy_ms / profiled:.3f} ms/step" if busy_ms else "not measured"
    out = dict(batch=cfg.batch_size, host_ms_per_step=host_ms, event_ms_per_step=event_ms,
               busy_ms_per_step=busy_ms / profiled if busy_ms else None,
               idle_share=1 - busy_ms / wall_ms if busy_ms else None, kernels_per_step=kernels)
    log(f"{tag}: {host_ms:.3f} ms/step host clock, {event_ms:.3f} ms/step CUDA "
        f"events (mean of {timed}); device busy {busy}, idle share "
        f"{out['idle_share'] if busy_ms else 'not measured'} of the profiled window; "
        f"{kernels:.0f} device kernels/step")
    return out


def drive_sdf_from_runs(counters, work):
    """The VAE run directories as frozen encoders: ``run_chd_8bar`` linked as
    ``<pretrained>/chd8bar/`` and ``run_pnotree_vae`` as ``pnotree/``, then
    ``sdf_chd8bar`` and ``sdf_pnotree`` (full width, bf16, batch 16) trained
    SDF_FROM_RUN_STEPS steps each through ``polyffusion_tpu_torch.main``, with
    the launch counts set to 0 just before and read just after. Then, on the
    card, each task's ``encode_cond`` against the trained encoder's output on
    the CPU (COND_ATOL), and against a random encoder's (it must differ).
    Returns the launches of both runs."""
    import torch

    from polyffusion_tpu_torch.config import load_params
    from polyffusion_tpu_torch.data import BatchLoader, SegmentDataset
    from polyffusion_tpu_torch.models import ChordEncoder, PianoTreeEncoder, init_weights_
    from polyffusion_tpu_torch.models.encoders import build_frozen_encoders, run_encoder_state
    from polyffusion_tpu_torch.tasks import SDFTask

    data = os.path.join(work, "songs")
    pretrained = os.path.join(work, "pretrained_runs")
    os.makedirs(pretrained)
    os.symlink(os.path.join(work, "run_chd_8bar"), os.path.join(pretrained, "chd8bar"))
    os.symlink(os.path.join(work, "run_pnotree_vae"), os.path.join(pretrained, "pnotree"))
    _, val_ds = SegmentDataset.train_val_from_dir(data, 0.9)
    val_batches = len(BatchLoader(val_ds, 16))
    want = dict({name: 0 for name in counters},
                packed_attention=ATTENTION_SITES * (SDF_FROM_RUN_STEPS + val_batches),
                packed_attention_bwd=ATTENTION_SITES * SDF_FROM_RUN_STEPS,
                gn_bwd=GROUPNORM_SITES * SDF_FROM_RUN_STEPS)
    batch = song_batch(data, 8)
    launches = {}
    for name, run_name, prefix, make_enc in (
            ("sdf_chd8bar", "chd_8bar", "chord_enc", lambda: ChordEncoder()),
            ("sdf_pnotree", "pnotree_vae", "pnotree_enc", lambda: PianoTreeEncoder())):
        run = os.path.join(work, f"run_{name}_from_run")
        state, _, got = run_training_cli(
            counters, ["--model", name, "--output_dir", run, "--data_dir", data,
                       "--pretrained_dir", pretrained, "--log_every", "2", "--seed", "0",
                       "--max_steps", str(SDF_FROM_RUN_STEPS)], f"{name} from the {run_name} run")
        records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
        losses = [r[k] for r in records for k in ("train/loss", "val/loss") if k in r]
        if got != want:
            raise AssertionError(f"expected launches {want}, got {got}")
        if not (state.step == SDF_FROM_RUN_STEPS and losses and np.isfinite(losses).all()):
            raise AssertionError(f"{name} ended at step {state.step} with losses {losses}")
        launches[name] = got

        cfg = load_params(name)
        task = SDFTask(cfg, **build_frozen_encoders(cfg, pretrained), device="cuda",
                       generator=torch.Generator().manual_seed(0))
        got_cond = task.encode_cond(batch).cpu()
        del task
        trained = make_enc()
        trained.load_state_dict(run_encoder_state(os.path.join(work, f"run_{run_name}"),
                                                  run_name, prefix), strict=True)
        random_enc = init_weights_(make_enc(), torch.Generator().manual_seed(24))
        with torch.no_grad():
            if name == "sdf_chd8bar":
                ref, other = (enc(batch[2].float())[0][:, None] for enc in (trained, random_enc))
            else:
                ref, other = (torch.cat([enc(seg)[0] for seg in batch[1].split(32, dim=1)],
                                         dim=-1)[:, None] for enc in (trained, random_enc))
        err = (got_cond - ref).abs().max().item()
        apart = (got_cond - other).abs().max().item()
        log(f"[pretrain] {name} encode_cond {tuple(ref.shape)} on the card vs the trained "
            f"{run_name} encoder on the CPU: max_abs_err {err:.3g} (atol {COND_ATOL}); vs a "
            f"random encoder: max_abs_diff {apart:.3g}; losses {[round(x, 5) for x in losses]}")
        if not (err <= COND_ATOL and apart > 100 * COND_ATOL):
            raise AssertionError(f"{name}: the condition is not the trained {run_name} encoder's")
    return launches


def concat_cfg(bf16: bool):
    from polyffusion_tpu_torch.config import load_params

    cfg = load_params("sdf_concat")
    cfg.bf16 = bf16
    return cfg


def concat_task(device, seed, training=False):
    """A full-width ``sdf_concat`` task (no encoder: the raw chord, uncond)."""
    import torch

    from polyffusion_tpu_torch.tasks import SDFTask

    return SDFTask(concat_cfg(bf16=False), device=device,
                   generator=torch.Generator().manual_seed(seed), training=training)


def check_concat_against_cpu():
    """``sdf_concat`` (4 input channels) in fp32 at full width, card vs CPU:
    ``blurry_image`` of a 3 % roll (BLUR_ATOL); one UNet eval at batch 2 on
    x_t and those blurry channels (UNet tolerance); a DDPM RePaint run from
    PAINT_T_START at repaint_n PAINT_REPAINT_N with the blurry channels
    (kernels 1 and 7; sampler tolerance), under the same replayed noises. The
    planted fault: the card's blurry channels zeroed, which each limit must
    catch."""
    import torch

    from polyffusion_tpu_torch.diffusion import sampler as S
    from polyffusion_tpu_torch.inference import get_mask
    from polyffusion_tpu_torch.ops.repaint_epilogue import fused_repaint_epilogue
    from polyffusion_tpu_torch.tasks.sdf import blurry_image

    cfg = concat_cfg(bf16=False)
    rng = np.random.default_rng(11)
    orig = (rng.random((2, 2, 128, 128)) > 0.97).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((2, 2, 128, 128)).astype(np.float32))
    t = torch.tensor([981, 401], dtype=torch.int32)
    cond = -torch.ones((2, 1, cfg.d_cond))  # cond_mode uncond
    noise = torch.from_numpy(rng.standard_normal(
        (PAINT_T_START + 1, PAINT_REPAINT_N, 3, 2, 128, 128, 2)).astype(np.float32))
    mask = torch.from_numpy(nhwc(get_mask(orig, "below")))
    orig_t = torch.from_numpy(orig)
    out = {}
    for device in ("cuda", "cpu"):
        task = concat_task(device, seed=12)
        blur = blurry_image(orig_t.to(device), cfg.concat_ratio)
        runs = {"sound": blur}
        if device == "cuda":
            runs["fault"] = torch.zeros_like(blur)
        res = {}
        for name, cc in runs.items():
            with torch.inference_mode():
                eps = task.apply_eps(torch.cat([x.to(device), cc], dim=1), t.to(device),
                                     cond.to(device)).cpu()
            before = fused_repaint_epilogue.launches
            t0 = time.perf_counter()
            paint = S.ddpm_paint(task.apply_eps, task.schedule, x.permute(0, 2, 3, 1).to(device),
                                 cond.to(device), PAINT_T_START, orig=nhwc_t(orig_t).to(device),
                                 mask=mask.to(device), cond_concat=nhwc_t(cc),
                                 repaint_n=PAINT_REPAINT_N, noise_override=noise.to(device)).cpu()
            res[name] = (eps, paint, fused_repaint_epilogue.launches - before,
                         time.perf_counter() - t0)
        out[device] = (blur.cpu(), res)
        del task
    (blur_gpu, got), (blur_cpu, want) = out["cuda"], out["cpu"]
    blur_err = (blur_gpu - blur_cpu).abs().max().item()
    blur_fault = blur_cpu.abs().max().item() / BLUR_ATOL
    eps_ratio = limit_ratio(got["sound"][0], want["sound"][0], UNET_ATOL, UNET_RTOL)
    eps_fault = limit_ratio(got["fault"][0], want["sound"][0], UNET_ATOL, UNET_RTOL)
    paint_ratio = limit_ratio(got["sound"][1], want["sound"][1], PAINT_ATOL, PAINT_RTOL)
    paint_fault = limit_ratio(got["fault"][1], want["sound"][1], PAINT_ATOL, PAINT_RTOL)
    launches = got["sound"][2]
    log(f"[concat] blurry_image (2, 2, 128, 128) at ratio {cfg.concat_ratio} card vs CPU: "
        f"max_abs_err {blur_err:.3g} (atol {BLUR_ATOL}; zeroed: {blur_fault:.3g} x the limit)")
    log(f"[concat] full-width fp32 sdf_concat UNet eval (B=2, 4 input channels) card vs CPU: "
        f"{eps_ratio:.3g} x the limit (atol {UNET_ATOL}, rtol {UNET_RTOL}); blurry channels "
        f"zeroed on the card: {eps_fault:.3g} x")
    log(f"[concat] full-width fp32 RePaint with the blurry channels (B=2, scale 1, below, "
        f"repaint_n {PAINT_REPAINT_N}, steps {PAINT_T_START}..0) card vs CPU: {paint_ratio:.3g} x "
        f"the limit (atol {PAINT_ATOL}, rtol {PAINT_RTOL}); zeroed on the card: "
        f"{paint_fault:.3g} x; epilogue launches {launches}; card {got['sound'][3]:.2f} s, CPU "
        f"{want['sound'][3]:.2f} s")
    if not (blur_err <= BLUR_ATOL and eps_ratio <= 1.0 and paint_ratio <= 1.0
            and bool(torch.isfinite(got["sound"][1]).all())):
        raise AssertionError("sdf_concat on the card disagrees with the CPU")
    if not (blur_fault > 1.0 and eps_fault > 1.0 and paint_fault > 1.0):
        raise AssertionError("a limit of the sdf_concat check does not catch zeroed blurry "
                             "channels")
    if launches != (PAINT_T_START + 1) * PAINT_REPAINT_N:
        raise AssertionError(f"the card's RePaint run launched the epilogue {launches} times")


def nhwc_t(x):
    return x.permute(0, 2, 3, 1).contiguous()


def check_dpmpp_against_cpu():
    """DPM-Solver++ (order 2) at full width in fp32, batch 1 doubled by CFG 5, a
    "below" mask under a fixed orig noise, over a DPMPP_STEPS-step tau grid
    from its top: the card (kernel 1) against the CPU (its plain version). The
    planted fault: the card at order 1, which each later transition's
    second-order correction must tell apart."""
    import torch

    from polyffusion_tpu_torch.diffusion import sampler as S
    from polyffusion_tpu_torch.diffusion.schedule import make_ddim_schedule
    from polyffusion_tpu_torch.inference import get_mask

    cfg = full_cfg(bf16=False)
    rng = np.random.default_rng(13)
    orig = (rng.random((1, 2, 128, 128)) > 0.97).astype(np.float32)
    arrays = dict(
        x=rng.standard_normal((1, 128, 128, 2)).astype(np.float32),
        cond=rng.standard_normal((1, 1, cfg.d_cond)).astype(np.float32),
        orig=nhwc(orig), mask=nhwc(get_mask(orig, "below")),
        orig_noise=rng.standard_normal((1, 128, 128, 2)).astype(np.float32),
    )
    out = {}
    for device in ("cuda", "cpu"):
        task = make_task(cfg, device, seed=14)
        dd = make_ddim_schedule(task.schedule, DPMPP_STEPS)
        a = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        res = {}
        for name, order in (("sound", 2), ("fault", 1)) if device == "cuda" else (("sound", 2),):
            t0 = time.perf_counter()
            res[name] = (S.dpmpp_paint(task.apply_eps, dd, a["x"], a["cond"], DPMPP_STEPS - 1,
                                       orig=a["orig"], mask=a["mask"],
                                       orig_noise=a["orig_noise"], uncond_scale=5.0,
                                       uncond_cond=-torch.ones_like(a["cond"]),
                                       order=order).cpu(), time.perf_counter() - t0)
        out[device] = res
        del task, a
    got, want = out["cuda"], out["cpu"]["sound"][0]
    ratio = limit_ratio(got["sound"][0], want, PAINT_ATOL, PAINT_RTOL)
    fault = limit_ratio(got["fault"][0], want, PAINT_ATOL, PAINT_RTOL)
    log(f"[dpmpp] full-width fp32 DPM-Solver++ order 2 (B=1, CFG 5, below, {DPMPP_STEPS} steps) "
        f"card vs CPU: {ratio:.3g} x the limit (atol {PAINT_ATOL}, rtol {PAINT_RTOL}), |out| max "
        f"{want.abs().max().item():.3g}; order 1 on the card: {fault:.3g} x; card "
        f"{got['sound'][1]:.2f} s (first call), CPU {out['cpu']['sound'][1]:.2f} s")
    if not (ratio <= 1.0 and bool(torch.isfinite(got["sound"][0]).all())):
        raise AssertionError("the full-width DPM-Solver++ run on the card disagrees with the CPU")
    if not fault > 1.0:
        raise AssertionError("the DPM-Solver++ limit does not catch order 1")


def check_distill_against_cpu():
    """One fp32 distillation loss and the student's gradients at full width,
    batch DISTILL_CHECK_BATCH, card (kernels 1, 2, 6) against CPU (their plain
    versions): a guided step (the eps teacher's CFG at DISTILL_GUIDE in one
    double batch) and a halve step (a v teacher, the 8 -> 4 phase); the same
    student and teacher weights, batch and draws; the loss within
    STEP_LOSS_RTOL, each gradient within STEP_GRAD_RTOL in norm. Planted
    faults, each of which the loss limit must catch: the card's teacher at
    scale 1 (guided), its second teacher step at the student's level (halve)."""
    import torch

    from polyffusion_tpu_torch.diffusion.progressive import halving_grids, phase_tables
    from polyffusion_tpu_torch.diffusion.schedule import make_schedule
    from polyffusion_tpu_torch.tasks.distill import DistillTask

    cfg = full_cfg(bf16=False)
    rng = np.random.default_rng(15)
    b = DISTILL_CHECK_BATCH
    x0 = torch.from_numpy((rng.random((b, 2, 128, 128)) > 0.97).astype(np.uint8))
    chords = torch.from_numpy(random_chords(rng, b))
    teacher = make_task(cfg, "cpu", seed=16).unet.state_dict()
    tables = phase_tables(make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end),
                          halving_grids(cfg.n_steps, DISTILL_BASE, DISTILL_END)[0])
    faults = {"guided": dict(guide_scale=1.0),
              "halve": dict(tables=tables._replace(tau_mid=tables.tau))}
    for mode, kind in (("guided", "eps_guided"), ("halve", "v")):
        kw = dict(guide_scale=DISTILL_GUIDE, tables=tables if mode == "halve" else None)
        noise = None
        out = {}
        for device in ("cuda", "cpu"):
            base = make_task(cfg, device, seed=17, training=True)
            task = DistillTask(base, teacher, kw["guide_scale"], mode, kind, tables=kw["tables"])
            if noise is None:
                noise = task.draw_noise((x0,), torch.Generator().manual_seed(18))
            batch = (x0.to(device), None, chords.to(device), None)
            dn = type(noise)(*(v.to(device) for v in noise))
            t0 = time.perf_counter()
            loss, _ = task.loss_fn(batch, dn)
            loss.backward()
            grads = {k: p.grad.cpu() for k, p in task.model.named_parameters()}
            secs = time.perf_counter() - t0
            fault = None
            if device == "cuda":
                fkw = dict(kw, **faults[mode])
                planted = DistillTask(base, teacher, fkw["guide_scale"], mode, kind,
                                      tables=fkw["tables"])
                with torch.no_grad():
                    fault = planted.loss_fn(batch, dn)[0].item()
                del planted
            out[device] = (loss.item(), grads, secs, fault)
            del base, task
        (got, got_g, t_gpu, fault), (want, want_g, t_cpu, _) = out["cuda"], out["cpu"]
        loss_err, fault_err = abs(got - want) / abs(want), abs(fault - want) / abs(want)
        grad_ratio, worst = 0.0, ""
        for k, w in want_g.items():
            r = ((got_g[k] - w).norm() / (STEP_GRAD_RTOL * w.norm() + 1e-9)).item()
            if r > grad_ratio:
                grad_ratio, worst = r, k
        log(f"[distill] full-width fp32 {mode} step ({kind} teacher, B={b}) card vs CPU: loss "
            f"{got:.7g} vs {want:.7g} (rel {loss_err:.3g}, limit {STEP_LOSS_RTOL}); gradients "
            f"per tensor {grad_ratio:.3g} x the limit (rel {STEP_GRAD_RTOL} in norm; worst "
            f"{worst}); planted fault ({', '.join(faults[mode])}): loss rel {fault_err:.3g}; "
            f"card {t_gpu:.2f} s (first call), CPU {t_cpu:.2f} s")
        if not (loss_err <= STEP_LOSS_RTOL and grad_ratio <= 1.0 and np.isfinite(got)):
            raise AssertionError(f"the distillation {mode} step on the card disagrees with the CPU")
        if not fault_err > STEP_LOSS_RTOL:
            raise AssertionError(f"the distillation {mode} loss limit does not catch its fault")


def run_with_counts(counters, fn, *args):
    """``fn(*args)`` with the launch counts set to 0 just before and read just
    after, its stdout echoed; returns (result, seconds, launches, stdout)."""
    import contextlib
    import io

    import torch

    zero_counts(counters)
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sys.stdout.write(buf.getvalue())
    return result, secs, {name: c.launches for name, c in counters.items()}, buf.getvalue()


def distill_want(counters, stages, val_batches):
    """Expected launches of a distill CLI run of ``stages`` ((mode, steps)
    each), each stage validating once on ``val_batches`` batches."""
    k1 = k2 = 0
    for mode, steps in stages:
        k1 += (GUIDED_FWD if mode == "guided" else HALVE_FWD) * (steps + val_batches)
        k2 += ATTENTION_SITES * steps
    return dict({name: 0 for name in counters}, packed_attention=k1, packed_attention_bwd=k2,
                gn_bwd=GROUPNORM_SITES * k2 // ATTENTION_SITES)


def stage_ms(run_dir):
    """The last logged step's ms (host clock, ``metrics.jsonl``) of a
    distillation stage's run directory, and its losses."""
    records = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    train = [r for r in records if "train/loss" in r]
    losses = [r[k] for r in records for k in ("train/loss", "val/loss") if k in r]
    if not (train and np.isfinite(losses).all()):
        raise AssertionError(f"{run_dir}: bad metrics {records}")
    return 1e3 / train[-1]["steps_per_sec"], losses


def drive_distill_cli(counters, work):
    """``python -m polyffusion_tpu_torch.distill`` on the training path's run
    directory (full width, bf16, batch 16): stage A (DISTILL_STAGE_A_STEPS
    steps) and the halving phases 8 -> 4 -> 2 (DISTILL_PHASE_STEPS each), then
    chain mode 2 -> 1 from its output; then the inference CLI on each output
    directory (``--ddim --uncond_scale 1``, 2 segments), which must pin the
    stored grid. Each run with the launch counts set to 0 just before it and
    read just after. Returns the launches by run and each stage's ms per step."""
    from polyffusion_tpu_torch.config import load_params
    from polyffusion_tpu_torch.data import BatchLoader, SegmentDataset
    from polyffusion_tpu_torch.diffusion.progressive import halving_grids
    from polyffusion_tpu_torch.distill import main as distill_main
    from polyffusion_tpu_torch.inference import main as infer_main

    run, data, pretrained = (os.path.join(work, d) for d in ("run", "songs", "pretrained"))
    out, chained = os.path.join(work, "distilled"), os.path.join(work, "distilled_1")
    _, val_ds = SegmentDataset.train_val_from_dir(data, 0.9)
    val_batches = len(BatchLoader(val_ds, 16))
    common = ["--data_dir", data, "--pretrained_dir", pretrained, "--log_every", "1", "--seed",
              "0", "--phase_steps", str(DISTILL_PHASE_STEPS), "--guide_scale", str(DISTILL_GUIDE)]
    a, p = DISTILL_STAGE_A_STEPS, DISTILL_PHASE_STEPS
    runs = {
        "cli": (["--teacher", run, "--output_dir", out, "--base_steps", str(DISTILL_BASE),
                     "--end_steps", str(DISTILL_END), "--stage_a_steps", str(a)],
                    [("guided", a), ("halve", p), ("halve", p)]),
        "cli_chain": (["--teacher", out, "--output_dir", chained, "--end_steps",
                   str(DISTILL_CHAIN_END)], [("halve", p)]),
    }
    launches = {}
    for name, (extra, stages) in runs.items():
        cfg, secs, got, _ = run_with_counts(counters, distill_main, common + extra)
        want = distill_want(counters, stages, val_batches)
        log(f"[distill] CLI {name} ({' '.join(extra[2:])}): {sum(n for _, n in stages)} steps in "
            f"{len(stages)} stage(s), {val_batches} val batches each, {secs:.3f} s (with setup), "
            f"grid {cfg.get('distill_grid')}, launches {got}")
        if got != want:
            raise AssertionError(f"expected launches {want}, got {got}")
        launches[name] = got
    grid = load_params(os.path.join(out, "params.yaml"))["distill_grid"]
    grid1 = load_params(os.path.join(chained, "params.yaml"))["distill_grid"]
    want_grid = [int(t) for t in halving_grids(1000, DISTILL_BASE, DISTILL_END)[-1]]
    if grid != want_grid or grid1 != grid[1::2]:
        raise AssertionError(f"stored grids {grid}, {grid1}; expected {want_grid} and its half")
    stage_dirs = {"stage_a": os.path.join(out, "stage_a"),
                  "phase_4": os.path.join(out, "phase_4"), "phase_2": os.path.join(out, "phase_2"),
                  "chain phase_1": os.path.join(chained, "phase_1")}
    ms = {}
    for stage, d in stage_dirs.items():
        ms[stage], losses = stage_ms(d)
        log(f"[distill] {stage}: last step {ms[stage]:.3f} ms (host clock, metrics.jsonl), "
            f"losses {[round(x, 5) for x in losses]}")

    zero = {name: 0 for name in counters}
    for label, d, n in (("student_2", out, DISTILL_END), ("student_1", chained, DISTILL_CHAIN_END)):
        gen_dir = os.path.join(work, f"gen_{label}")
        args = ["--chkpt_path", d, "--data_dir", data, "--song_fn", CLI_SONG, "--pretrained_dir",
                pretrained, "--ddim", "--uncond_scale", "1", "--length", "2", "--output_dir",
                gen_dir]
        (gen,), secs, got, text = run_with_counts(counters, infer_main, args)
        mids = sorted(os.listdir(gen_dir))
        log(f"[distill] inference CLI on the {label} student (--ddim --uncond_scale 1 --length "
            f"2): {secs:.3f} s, launches {got}, wrote {mids}")
        if f"using its {n}-step grid" not in text:
            raise AssertionError(f"the {label} student's session did not pin its grid")
        if got != dict(zero, packed_attention=ATTENTION_SITES * n):
            raise AssertionError(f"expected {ATTENTION_SITES * n} kernel-1 launches, got {got}")
        if not (len(mids) == 1 and f"ddim{n}_eta0.0_distilled]" in mids[0]
                and gen.shape == (2, 2, 128, 128) and np.isfinite(gen).all()):
            raise AssertionError(f"bad student output: {mids}, shape {gen.shape}")
        launches[f"cli_{label}"] = got
    return launches, ms


def profile_distill_steps(work):
    """Warm distillation steps at full width, bf16, batch 16 on the card, from
    the training path's run directory as the teacher: a guided step
    (eps_guided) and a halve step (v, the 8 -> 4 phase), each mode's ms per
    step on the host clock and from CUDA events over DISTILL_PROFILE[0] steps,
    then ``torch.profiler`` over DISTILL_PROFILE[1]: device busy ms and idle
    share. Returns those numbers by mode."""
    import types

    import torch
    from torch.profiler import ProfilerActivity, profile

    from polyffusion_tpu_torch.config import load_params
    from polyffusion_tpu_torch.diffusion.progressive import halving_grids, phase_tables
    from polyffusion_tpu_torch.inference import load_unet_params
    from polyffusion_tpu_torch.main import build_task
    from polyffusion_tpu_torch.profile_train import kernel_launches
    from polyffusion_tpu_torch.profile_unet import breakdown
    from polyffusion_tpu_torch.tasks.distill import DistillTask
    from polyffusion_tpu_torch.train import create_state, make_train_step

    run, data, pretrained = (os.path.join(work, d) for d in ("run", "songs", "pretrained"))
    cfg = load_params(os.path.join(run, "params.yaml"))
    teacher = load_unet_params(run)
    batch = tuple(t.cuda() for t in song_batch(data, cfg.batch_size))
    timed, profiled = DISTILL_PROFILE
    rows = {}
    for mode, kind in (("guided", "eps_guided"), ("halve", "v")):
        base = build_task(cfg, pretrained, device="cuda", seed=0)
        tables = None
        if mode == "halve":
            tables = phase_tables(base.schedule,
                                  halving_grids(cfg.n_steps, DISTILL_BASE, DISTILL_END)[0])
        task = DistillTask(base, teacher, DISTILL_GUIDE, mode, kind, tables=tables)
        state = create_state(task.model, cfg.learning_rate, cfg.max_grad_norm, bf16=task.bf16)
        step = make_train_step(task)

        def steps(n):
            for _ in range(n):
                step(state, batch, seed=0)
            torch.cuda.synchronize()

        steps(1)  # warm up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        steps(timed)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / timed
        event_ms = start.elapsed_time(end) / timed
        # the device's activity only: the host operators' events would slow the
        # steps and multiply the trace
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps(profiled)
            wall_ms = (time.perf_counter() - t0) * 1e3
        log(f"[distill] {mode} step ({kind} teacher) at batch {cfg.batch_size}, bf16, under "
            f"torch.profiler ({profiled} warm steps):")
        averages = prof.key_averages()
        prof = types.SimpleNamespace(key_averages=lambda: averages)
        busy_ms = breakdown(prof, wall_ms, profiled, "step")
        kernels = kernel_launches(prof, profiled)["kernels_per_step"]
        sys.stdout.flush()
        rows[mode] = dict(batch=cfg.batch_size, host_ms_per_step=host_ms,
                          event_ms_per_step=event_ms,
                          busy_ms_per_step=busy_ms / profiled if busy_ms else None,
                          idle_share=1 - busy_ms / wall_ms if busy_ms else None,
                          kernels_per_step=kernels)
        log(f"[distill] {mode} step: {host_ms:.3f} ms/step host clock, {event_ms:.3f} ms/step "
            f"CUDA events (mean of {timed}); device busy "
            f"{f'{busy_ms / profiled:.3f} ms/step' if busy_ms else 'not measured'}, idle share "
            f"{rows[mode]['idle_share'] if busy_ms else 'not measured'} of the profiled window; "
            f"{kernels:.0f} device kernels/step")
        del base, task, state, step
    return rows


def drive_student_requests(counters, work):
    """Warm requests at batch STUDENT_BATCH through ``InferenceSession`` on the
    same card: the 2-step and the 1-step student on their grids at scale 1
    (11 kernel-1 launches per step), and the teacher at DDIM-50 CFG 5 (550).
    Each with the launch counts set to 0 just before it and read just after.
    Returns (launches, seconds) by request."""
    import torch

    from polyffusion_tpu_torch.config import load_params
    from polyffusion_tpu_torch.inference import (
        InferenceSession,
        build_task_for_inference,
        load_unet_params,
    )

    pretrained = os.path.join(work, "pretrained")
    rng = np.random.default_rng(19)
    chords = torch.from_numpy(random_chords(rng, STUDENT_BATCH))
    zero = {name: 0 for name in counters}
    launches, secs = {}, {}
    for label, d, steps, scale in (("student_2", "distilled", DISTILL_END, 1.0),
                                   ("student_1", "distilled_1", DISTILL_CHAIN_END, 1.0),
                                   ("teacher_ddim50_cfg5", "run", 50, CLI_CFG_SCALE)):
        run_dir = os.path.join(work, d)
        task = build_task_for_inference(load_params(os.path.join(run_dir, "params.yaml")),
                                        pretrained)
        task.load_unet_state(load_unet_params(run_dir))
        session = InferenceSession(task, use_ddim=True, ddim_steps=None if d != "run" else 50,
                                   seed=0)
        cond = task.encode_chord(chords)
        session.generate(cond, uncond_scale=scale)  # warm: the same shapes
        gen, secs[label], launches[label], _ = run_with_counts(
            counters, lambda: session.generate(task.encode_chord(chords), uncond_scale=scale))
        log(f"[distill] request {label} ({session.ddim_label}, scale {scale}): batch "
            f"{STUDENT_BATCH}: {secs[label]:.3f} s, {STUDENT_BATCH / secs[label]:.3f} samples/s, "
            f"launches {launches[label]}")
        if launches[label] != dict(zero, packed_attention=ATTENTION_SITES * steps):
            raise AssertionError(f"expected {ATTENTION_SITES * steps} kernel-1 launches, got "
                                 f"{launches[label]}")
        if gen.shape != (STUDENT_BATCH, 2, 128, 128) or not np.isfinite(gen).all():
            raise AssertionError(f"bad output: shape {gen.shape}")
        del task, session
    return launches, secs


def drive_concat_path(counters, work):
    """``sdf_concat`` end to end, full width, bf16 at its batch 16: the
    training CLI for CONCAT_STEPS steps with one validation, then the
    inference CLI's "below" inpainting on its run directory (2 segments,
    scale 1) at DDIM-50 and at the default DDPM-1000 (kernels 1 and 7), then
    one warm DDIM-50 request at batch 16 through ``InferenceSession``. Each
    with the launch counts set to 0 just before it and read just after.
    Returns the launches and seconds by run."""
    from polyffusion_tpu_torch.config import load_params
    from polyffusion_tpu_torch.data import BatchLoader, SegmentDataset, SongNpz
    from polyffusion_tpu_torch.diffusion.schedule import make_schedule
    from polyffusion_tpu_torch.inference import (
        InferenceSession,
        build_task_for_inference,
        load_unet_params,
    )
    from polyffusion_tpu_torch.inference import main as infer_main
    from polyffusion_tpu_torch.main import main as train_main

    data, run = os.path.join(work, "songs"), os.path.join(work, "run_concat")
    _, val_ds = SegmentDataset.train_val_from_dir(data, 0.9)
    val_batches = len(BatchLoader(val_ds, 16))
    zero = {name: 0 for name in counters}
    launches, secs = {}, {}
    state, secs["training"], launches["training"], _ = run_with_counts(
        counters, train_main, ["--model", "sdf_concat", "--output_dir", run, "--data_dir", data,
                               "--log_every", "2", "--seed", "0", "--max_steps",
                               str(CONCAT_STEPS)])
    _, losses = stage_ms(run)
    want = dict(zero, packed_attention=ATTENTION_SITES * (CONCAT_STEPS + val_batches),
                packed_attention_bwd=ATTENTION_SITES * CONCAT_STEPS,
                gn_bwd=GROUPNORM_SITES * CONCAT_STEPS)
    log(f"[concat] training: {CONCAT_STEPS} steps and {val_batches} val batches in "
        f"{secs['training']:.3f} s (with setup), losses {[round(x, 5) for x in losses]}, "
        f"launches {launches['training']}")
    if launches["training"] != want or state.step != CONCAT_STEPS:
        raise AssertionError(f"expected launches {want} and step {CONCAT_STEPS}, got "
                             f"{launches['training']} at step {state.step}")

    cfg = load_params("sdf_concat")
    sqrt_ab0 = np.float32(make_schedule(cfg.n_steps, cfg.linear_start,
                                        cfg.linear_end).sqrt_alpha_bar[0])
    orig = SongNpz(CLI_SONG, data).get_whole_song_data()[0][:CLI_A_SEGMENTS]
    for name, extra, want in (
            ("cli_ddim", ["--ddim"], dict(zero, packed_attention=ATTENTION_SITES * CLI_DDIM_STEPS)),
            ("cli_ddpm", [], dict(zero, packed_attention=ATTENTION_SITES * CLI_DDPM_STEPS,
                                  repaint_epilogue=CLI_DDPM_STEPS))):
        out = os.path.join(work, f"gen_concat_{name}")
        ((gen, mask),), secs[name], launches[name], _ = run_with_counts(
            counters, infer_main, ["--chkpt_path", run, "--data_dir", data, "--song_fn", CLI_SONG,
                                   "--inpaint_type", "below", "--length", str(CLI_A_SEGMENTS),
                                   "--output_dir", out] + extra)
        keep = mask == 1
        known_err = float(np.abs(gen[keep] - sqrt_ab0 * orig[keep]).max())
        mids = sorted(os.listdir(out))
        log(f"[concat] inference CLI {name} ({' '.join(['--inpaint_type below'] + extra)} "
            f"--length {CLI_A_SEGMENTS}): {secs[name]:.3f} s, launches {launches[name]}, wrote {mids}; "
            f"known region vs sqrt_alpha_bar[0] * orig: max_abs_err {known_err:.3g}")
        if launches[name] != want:
            raise AssertionError(f"expected launches {want}, got {launches[name]}")
        if not (gen.shape == (CLI_A_SEGMENTS, 2, 128, 128) and np.isfinite(gen).all()
                and len(mids) == 1 and 0 < keep.mean() < 1):
            raise AssertionError(f"bad sdf_concat inpainting: {mids}, shape {gen.shape}")
        if name == "cli_ddpm" and known_err > 1e-6:
            raise AssertionError("the DDPM inpainting did not keep the known region")

    task = build_task_for_inference(load_params(os.path.join(run, "params.yaml")))
    task.load_unet_state(load_unet_params(run))
    batch = song_batch(data, STUDENT_BATCH)
    InferenceSession(task, sampler="ddim", ddim_steps=2, seed=1).generate(task.encode_cond(batch))
    session = InferenceSession(task, sampler="ddim", ddim_steps=50, seed=0)
    gen, secs["request"], launches["request"], _ = run_with_counts(
        counters, lambda: session.generate(task.encode_cond(batch)))
    log(f"[concat] DDIM-50 request at batch {STUDENT_BATCH}, scale 1: {secs['request']:.3f} s, "
        f"{STUDENT_BATCH / secs['request']:.3f} samples/s, launches {launches['request']}")
    if launches["request"] != dict(zero, packed_attention=LAUNCHES_PER_REQUEST):
        raise AssertionError(f"expected {LAUNCHES_PER_REQUEST} kernel-1 launches, got "
                             f"{launches['request']}")
    if gen.shape != (STUDENT_BATCH, 2, 128, 128) or not np.isfinite(gen).all():
        raise AssertionError(f"bad output: shape {gen.shape}")
    return launches, secs


def write_random_lpips(path, seed):
    """A seeded random LPIPS checkpoint in the reference's layout: the VGG16
    trunk as ``net.slice<s>.<idx>``, nonnegative ``lin<k>.model.1`` heads and
    the ScalingLayer's buffers."""
    import torch

    from polyffusion_tpu_torch.models import init_weights_
    from polyffusion_tpu_torch.models.lpips import LPIPS, SCALE, SHIFT

    model = init_weights_(LPIPS(), torch.Generator().manual_seed(seed))
    sd = {k: (v.abs() if k.startswith("lin") else v) for k, v in model.state_dict().items()}
    sd["scaling_layer.shift"] = torch.tensor(SHIFT)[None, :, None, None]
    sd["scaling_layer.scale"] = torch.tensor(SCALE)[None, :, None, None]
    torch.save(sd, path)


def check_ddpm_against_cpu():
    """The full-width fp32 DDPM UNet card vs CPU at FAMILY_CHECK_BATCH: one
    eval at the UNet tolerance, then one train step (``step_card_vs_cpu``,
    DDPM_GN_SITES kernel-6 launches on the card); the planted fault of both,
    the final norm at 32 groups, must miss its limit."""
    import torch

    from polyffusion_tpu_torch.tasks.ddpm import DDPMNoise

    b = FAMILY_CHECK_BATCH
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((b, 2, 128, 128)).astype(np.float32))
    t = torch.tensor([37, 802])
    out = {}
    for device in ("cuda", "cpu"):
        _, task = vae_task("ddpm", device, seed=31)
        with torch.no_grad():
            out[device] = task.apply_eps(x.to(device), t.to(device)).cpu()
            if device == "cuda":
                task.unet.norm.groups = 32
                fault = task.apply_eps(x.to(device), t.to(device)).cpu()
        del task
    ratio = limit_ratio(out["cuda"], out["cpu"], UNET_ATOL, UNET_RTOL)
    fault_ratio = limit_ratio(fault, out["cpu"], UNET_ATOL, UNET_RTOL)
    log(f"[ddpm] full-width fp32 UNet eval (B={b}) card vs CPU: max_abs_err "
        f"{(out['cuda'] - out['cpu']).abs().max().item():.3g}, {ratio:.3g} x the limit (atol "
        f"{UNET_ATOL}, rtol {UNET_RTOL}); planted fault (final norm at 32 groups): "
        f"{fault_ratio:.3g} x")
    if not (ratio <= 1.0 and fault_ratio > 1.0):
        raise AssertionError("the full-width DDPM UNet on the card disagrees with the CPU, or "
                             "the limit misses the planted fault")
    x0 = torch.from_numpy((rng.random((b, 2, 128, 128)) > 0.97).astype(np.uint8))
    noise = DDPMNoise(t, torch.from_numpy(rng.standard_normal((b, 2, 128, 128)).astype(np.float32)))

    def fault32(task):
        task.unet.norm.groups = 32

    launches = step_card_vs_cpu(f"[ddpm] full-width fp32 train step (B={b})", "ddpm",
                                (x0, None, None, None), noise, seed=31, fault=fault32)
    if launches != DDPM_GN_SITES:
        raise AssertionError(f"the DDPM step launched kernel 6 {launches} times, not "
                             f"{DDPM_GN_SITES}")


def running_stats_fault(task):
    """The planted fault of the autoencoder check: each of the discriminator's
    batch norms on running statistics (mean 0, variance 1), as an
    ``nn.BatchNorm2d`` computes in eval mode."""
    import types

    import torch.nn.functional as F

    from polyffusion_tpu_torch.models.losses import TrainModeBatchNorm

    def forward(self, x):
        c = x.shape[1]
        return F.batch_norm(x, x.new_zeros(c), x.new_ones(c), self.weight, self.bias,
                            training=False, eps=self.eps)

    for m in task.model.disc.modules():
        if isinstance(m, TrainModeBatchNorm):
            m.forward = types.MethodType(forward, m)


def check_autoencoder_against_cpu(lpips_path):
    """One full-width fp32 autoencoder train step at FAMILY_CHECK_BATCH card vs
    CPU (``step_card_vs_cpu``) with disc_start 0, AE_GN_SITES kernel-6
    launches on the card (planted fault: ``running_stats_fault``); then the
    LPIPS distances of the checkpoint at ``lpips_path`` card vs CPU at the
    step's metric limit (planted fault: the ScalingLayer left out). The step
    runs without LPIPS: its gradient through the unit normalisation of
    near-zero feature vectors is ill-conditioned (the CPU with 1 and 8
    threads differs by 6.6e-5 in relative norm, against 8e-6 without it).
    The held step runs the card's convolutions without cuDNN: cuDNN's fp32
    algorithms for the discriminator's kernel-4 convolutions move its first
    layer's gradients, and through the generator's term (the adaptive
    weight at its clip, 1e4 x 0.5) every autoencoder gradient, by some 1.6e-3
    in relative norm, 16 x the limit (without cuDNN 1.5e-5); the same step
    with cuDNN follows as a reading."""
    import torch

    from polyffusion_tpu_torch.convert import reference_state
    from polyffusion_tpu_torch.models.lpips import LPIPS, lpips_state_from_torch
    from polyffusion_tpu_torch.tasks.autoencoder import AENoise

    b = FAMILY_CHECK_BATCH
    rng = np.random.default_rng(41)
    x0 = torch.from_numpy((rng.random((b, 2, 128, 128)) > 0.97).astype(np.uint8))
    noise = AENoise(torch.from_numpy(rng.standard_normal((b, 4, 16, 16)).astype(np.float32)), 0)
    # the attention's key bias: the softmax over the keys does not see a shift
    # that is the same for every key
    zero = tuple(f"ae.{half}.mid.attn_1.k.bias" for half in ("encoder", "decoder"))
    args = (f"[autoencoder] full-width fp32 train step (B={b}, disc_start 0)", "autoencoder",
            (x0, None, None, None), noise)
    launches = step_card_vs_cpu(*args, seed=41, over=dict(disc_start=0), exact_zero=zero,
                                fault=running_stats_fault, cudnn=False)
    if launches != AE_GN_SITES:
        raise AssertionError(f"the autoencoder step launched kernel 6 {launches} times, not "
                             f"{AE_GN_SITES}")
    step_card_vs_cpu(*args, seed=41, over=dict(disc_start=0), exact_zero=zero, gate=False)

    x = torch.cat([x0.float(), torch.zeros(b, 1, 128, 128)], dim=1)  # the padded roll
    y = torch.from_numpy(rng.standard_normal((b, 3, 128, 128)).astype(np.float32)) * 0.5
    sd = lpips_state_from_torch(reference_state(lpips_path))
    dist = {}
    for device in ("cuda", "cpu"):
        model = LPIPS()
        model.load_state_dict(sd, strict=True)
        model.to(device).eval()
        with torch.no_grad():
            dist[device] = model(x.to(device), y.to(device)).cpu()
            if device == "cuda":
                model.shift.zero_()
                model.scale.fill_(1.0)
                fault = model(x.to(device), y.to(device)).cpu()
    err = ((dist["cuda"] - dist["cpu"]).abs() / dist["cpu"].abs()).max().item()
    fault_err = ((fault - dist["cpu"]).abs() / dist["cpu"].abs()).max().item()
    log(f"[autoencoder] LPIPS (full VGG16, seeded random weights in the reference's layout) at "
        f"B={b}, 128 x 128, card vs CPU: distances {dist['cpu'].tolist()}, max rel err {err:.3g} "
        f"(limit {STEP_LOSS_RTOL}); planted fault (ScalingLayer left out): {fault_err:.3g}")
    if not (err <= STEP_LOSS_RTOL and fault_err > STEP_LOSS_RTOL):
        raise AssertionError("LPIPS on the card disagrees with the CPU, or the limit misses the "
                             "planted fault")


def drive_family_training(counters, work, name, run_name, sets, sites):
    """``polyffusion_tpu_torch.main --model <name>`` (with the ``--set``s
    ``sets``) at the preset's batch 16: FAMILY_STEPS steps with one
    validation and one checkpoint, then ``--resume`` for FAMILY_RESUME_STEPS,
    each with the launch counts set to 0 just before and read just after:
    kernel 6 ``sites`` times a step, no other kernel. Returns (launches over
    both runs, seconds of each, the train records)."""
    from polyffusion_tpu_torch.main import main as train_main

    data, run = os.path.join(work, "songs"), os.path.join(work, run_name)
    args = ["--model", name, "--output_dir", run, "--data_dir", data, "--seed", "0",
            "--log_every", "1", "--save_every", "1000"]
    for kv in sets:
        args += ["--set", kv]
    totals = {k: 0 for k in counters}
    secs = []
    for n, resume in ((FAMILY_STEPS, []), (FAMILY_STEPS + FAMILY_RESUME_STEPS, ["--resume"])):
        state, sec, got, _ = run_with_counts(counters, train_main,
                                             args + ["--max_steps", str(n)] + resume)
        steps = n - (FAMILY_STEPS if resume else 0)
        want = dict({k: 0 for k in counters}, gn_bwd=sites * steps)
        log(f"[{name}] {run_name} {'resumed ' if resume else ''}run: {steps} steps and one "
            f"validation in {sec:.3f} s (with setup), launches {got}")
        if got != want or state.step != n:
            raise AssertionError(f"expected launches {want} and step {n}, got {got} at step "
                                 f"{state.step}")
        secs.append(sec)
        for k in totals:
            totals[k] += got[k]
    records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    train = [r for r in records if "train/loss" in r]
    val = [r for r in records if "val/loss" in r]
    values = [v for r in train + val for k, v in r.items() if k.startswith(("train/", "val/"))]
    if not (len(train) == FAMILY_STEPS + FAMILY_RESUME_STEPS and np.isfinite(values).all()):
        raise AssertionError(f"{run_name}: bad metrics {records}")
    if [r["step"] for r in val] != [FAMILY_STEPS, FAMILY_STEPS + FAMILY_RESUME_STEPS]:
        raise AssertionError(f"{run_name}: validation at steps {[r['step'] for r in val]}")
    if not os.path.getsize(os.path.join(run, "chkpts", "last.pt")):
        raise AssertionError(f"{run_name}: no checkpoint written")
    log(f"[{name}] {run_name}: losses {[round(r['train/loss'], 5) for r in train]}, val "
        f"{[round(r['val/loss'], 5) for r in val]}; last step {1e3 / train[-1]['steps_per_sec']:.3f} "
        f"ms (host clock, metrics.jsonl)")
    return totals, secs, train


def drive_ddpm_requests(counters, work):
    """The inference CLI on the DDPM run directory: each of DDPM_REQUESTS
    (the default DDPM-1000 at --length 1, --ddim at --length 2), with the
    launch counts set to 0 just before and read just after (none may
    launch). Returns the seconds of each."""
    from polyffusion_tpu_torch.inference import main as infer_main
    from polyffusion_tpu_torch.utils.midi import load_midi

    zero = {k: 0 for k in counters}
    secs = {}
    for name, flags, length in DDPM_REQUESTS:
        out = os.path.join(work, f"gen_{name}")
        gens, secs[name], got, _ = run_with_counts(
            counters, infer_main, ["--chkpt_path", os.path.join(work, "run_ddpm"), "--length",
                                   str(length), "--output_dir", out] + flags)
        mids = sorted(os.listdir(out))
        notes = sum(len(i.notes) for f in mids for i in load_midi(os.path.join(out, f)).instruments)
        log(f"[ddpm] inference CLI {name} ({' '.join(flags + ['--length', str(length)])}): "
            f"{secs[name]:.3f} s with setup, launches {got}, wrote {mids} ({notes} notes)")
        if got != zero:
            raise AssertionError(f"the DDPM request {name} launched a kernel: {got}")
        if not (len(gens) == 1 and gens[0].shape == (length, 2, 128, 128)
                and np.isfinite(gens[0]).all() and len(mids) == 1 and mids[0].startswith("ddpm_")):
            raise AssertionError(f"bad DDPM request {name}: {mids}")
    return secs


def family_batch(work, name):
    """The preset's batch 16 of song segments on the card, as the feeder sends
    it to these tasks (prmat2c as uint8, the other fields unread)."""
    import torch

    prmat2c = song_batch(os.path.join(work, "songs"), 16)[0]
    return (prmat2c.to("cuda", torch.uint8), None, None, None)


def drive_family_paths(counters, work):
    """The plain DDPM family ([ddpm]) and the KL autoencoder
    ([autoencoder]): the card-vs-CPU checks, the training CLI runs, the DDPM
    requests and warm steps profiled (``profile_steps``). Returns kernel 6's
    launches by path; logs a summary JSON line."""
    lpips_path = os.path.join(work, "lpips_vgg.pth")
    write_random_lpips(lpips_path, seed=7)
    summary = {}
    t0 = time.perf_counter()
    check_ddpm_against_cpu()
    launches, secs, _ = drive_family_training(counters, work, "ddpm", "run_ddpm", [],
                                              DDPM_GN_SITES)
    paths = {"ddpm_cli": launches["gn_bwd"]}
    summary["ddpm"] = dict(cli_secs=secs, request_secs=drive_ddpm_requests(counters, work))
    cfg, task = vae_task("ddpm", "cuda", seed=51)
    summary["ddpm"]["step"] = profile_steps("[ddpm]", cfg, task, family_batch(work, "ddpm"),
                                            FAMILY_PROFILE)
    del task
    summary["ddpm"]["phase_secs"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    check_autoencoder_against_cpu(lpips_path)
    summary["autoencoder"] = {}
    for run_name, sets in (("run_ae", []),
                           ("run_ae_disc0", ["disc_start=0", f"lpips_path={lpips_path}"])):
        launches, secs, train = drive_family_training(counters, work, "autoencoder", run_name,
                                                      sets, AE_GN_SITES)
        factors = {r["train/disc_factor"] for r in train}
        lpips_on = all("train/p_loss" in r for r in train)
        if factors != ({1.0} if sets else {0.0}) or lpips_on != bool(sets):
            raise AssertionError(f"{run_name}: disc_factor {factors}, LPIPS term {lpips_on}")
        paths[f"autoencoder_cli{'_disc0' if sets else ''}"] = launches["gn_bwd"]
        summary["autoencoder"][f"{run_name}_cli_secs"] = secs
    cfg, task = vae_task("autoencoder", "cuda", seed=52, disc_start=0, lpips_path=lpips_path)
    summary["autoencoder"]["step"] = profile_steps("[autoencoder] (disc_start 0, LPIPS)", cfg,
                                                   task, family_batch(work, "autoencoder"),
                                                   FAMILY_PROFILE)
    del task
    summary["autoencoder"]["phase_secs"] = time.perf_counter() - t0
    log(f"[family] summary {json.dumps(summary)}")
    return paths


def read_png(path):
    """(H, W, channels) uint8 of a PNG with 8-bit samples, no interlace and
    filter 0 on every row (what ``utils/image.py`` writes), each chunk's CRC
    checked: the card's machine has no image package."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"{path}: bad CRC in {kind}")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = head[:4]
    channels = {2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    if depth != 8 or rows[:, 0].any():
        raise AssertionError(f"{path}: depth {depth} or a row filter this reader does not undo")
    return rows[:, 1:].reshape(h, w, channels)


class Client:
    """``http.client`` calls to the worker, each with a timeout; any status
    but the one expected fails the phase."""

    def __init__(self, port):
        self.port = port

    def call(self, method, path, body=None, expect=200):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=HTTP_TIMEOUT_S)
        try:
            conn.request(method, path, body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read())
        finally:
            conn.close()
        if resp.status != expect:
            raise AssertionError(f"{method} {path} {body if body is None else list(body)}: "
                                 f"status {resp.status} (expected {expect}): {out}")
        return out


def drive_serve(counters, work):
    """``[serve]``: the generation worker as ``python -m
    polyffusion_tpu_torch.serve`` builds it (``serve.start``) on the training
    path's run directory: DDIM-50, batch SERVE_BATCH, warmup at scales 1 and
    5, a SERVE_COALESCE_MS queue; its ThreadingHTTPServer on 127.0.0.1:0 in a
    thread. Each request with the launch counts set to 0 just before it and
    read just after: a chord request of one sample, four concurrent unseeded
    requests (one device pass), a long-form request of 3 windows and 2
    pieces, a seeded request twice (the same MIDI), a malformed one (400),
    then one more. Returns the launches summed over the requests, and each
    request's seconds (host clock) and device ms."""
    import base64
    import threading

    import torch

    from polyffusion_tpu_torch import serve

    args = serve.parse_args([
        "--chkpt_path", os.path.join(work, "run"), "--pretrained_dir",
        os.path.join(work, "pretrained"), "--ddim", "--batch_size", str(SERVE_BATCH),
        "--warmup_scales", SERVE_SCALES, "--coalesce_ms", str(SERVE_COALESCE_MS), "--port", "0"])
    t0 = time.perf_counter()
    srv = serve.start(args)
    thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    thread.start()
    client = Client(srv.httpd.server_address[1])
    zero = {name: 0 for name in counters}
    totals, timing = dict(zero), {}

    def request(label, fn, passes, windows=1):
        zero_counts(counters)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        got = {name: c.launches for name, c in counters.items()}
        want = dict(zero, packed_attention=LAUNCHES_PER_REQUEST * passes * windows)
        replies = out if isinstance(out, list) else [out]
        timing[label] = dict(secs=secs, device_ms=[r.get("device_ms") for r in replies])
        log(f"[serve] {label}: {secs:.3f} s (host clock), device_ms "
            f"{timing[label]['device_ms']}, launches {got}")
        if got != want:
            raise AssertionError(f"[serve] {label}: expected launches {want}, got {got}")
        for name in totals:
            totals[name] += got[name]
        return out

    try:
        srv.warmup.join(HTTP_TIMEOUT_S)
        if srv.warmup.is_alive() or srv.worker.warm_error is not None:
            raise AssertionError(f"warmup did not finish: {srv.worker.warm_error}")
        log(f"[serve] bound and warmed at scales {SERVE_SCALES} in {time.perf_counter() - t0:.3f}"
            f" s (checkpoint load, kernel builds, cuDNN plans)")
        health = client.call("GET", "/healthz")
        if not (health["ok"] and health["warm"]):
            raise AssertionError(f"/healthz {health}")
        rng = np.random.default_rng(8)
        chord = random_chords(rng, 1).tolist()
        one = request("chord request, num 1",
                      lambda: client.call("POST", "/generate", {"num": 1, "chord": chord}), 1)
        gate = threading.Barrier(SERVE_CONCURRENT, timeout=HTTP_TIMEOUT_S)
        group = [None] * SERVE_CONCURRENT

        def concurrent(i):
            gate.wait()
            group[i] = client.call("POST", "/generate",
                                   {"num": SERVE_CONCURRENT_NUM, "uncond_scale": 5.0})

        def four():
            threads = [threading.Thread(target=concurrent, args=(i,))
                       for i in range(SERVE_CONCURRENT)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(HTTP_TIMEOUT_S)
            if any(t.is_alive() for t in threads) or None in group:
                raise AssertionError(f"a concurrent request failed or hung: {group}")
            return group

        request(f"{SERVE_CONCURRENT} concurrent requests, num {SERVE_CONCURRENT_NUM}, scale 5",
                four, 1)
        if any(r["batched_with"] != SERVE_CONCURRENT - 1 or r["num"] != SERVE_CONCURRENT_NUM
               for r in group):
            raise AssertionError(f"the concurrent requests were not served together: {group}")
        long_form = request(
            f"long form, length {SERVE_LONG_LENGTH}, {SERVE_LONG_PIECES} pieces",
            lambda: client.call("POST", "/generate_long",
                                {"length": SERVE_LONG_LENGTH, "num": SERVE_LONG_PIECES,
                                 "uncond_scale": 5.0}), 1, windows=2 * SERVE_LONG_LENGTH - 1)
        seeded = [request(f"seeded request {i}",
                          lambda: client.call("POST", "/generate",
                                              {"num": 2, "uncond_scale": 5.0, "seed": 1234}), 1)
                  for i in (1, 2)]
        if seeded[0]["midi_b64"] != seeded[1]["midi_b64"]:
            raise AssertionError("the seeded request did not reproduce its MIDI")
        request("malformed request (num 99)",
                lambda: client.call("POST", "/generate", {"num": 99}, expect=400), 0)
        request("the request after it", lambda: client.call("POST", "/generate", {"num": 1}), 1)
        stats = client.call("GET", "/stats")
        want = dict(requests=1 + SERVE_CONCURRENT + 1 + 2 + 1,
                    samples=1 + SERVE_CONCURRENT * SERVE_CONCURRENT_NUM + SERVE_LONG_PIECES + 4 + 1,
                    batch_size=SERVE_BATCH, coalesced_batches=1,
                    warmed_scales=[float(s) for s in SERVE_SCALES.split(",")])
        log(f"[serve] /stats {stats}")
        if {k: stats[k] for k in want} != want:
            raise AssertionError(f"/stats {stats}, expected {want}")
        for reply in [one, *group, *long_form["pieces"], *seeded]:
            midi = base64.b64decode(reply["midi_b64"])
            if not (midi.startswith(b"MThd") and 0 <= reply["integrity_err"] <= 1):
                raise AssertionError(f"bad reply {dict(reply, midi_b64='...')}")
    finally:
        srv.httpd.shutdown()
        srv.httpd.server_close()
        srv.queue.close(HTTP_TIMEOUT_S)
        thread.join(HTTP_TIMEOUT_S)
    if thread.is_alive() or srv.queue._thread.is_alive():
        raise AssertionError("the server or its queue did not stop")
    log(f"[serve] summary {json.dumps(timing)}")
    return totals


def drive_expr(counters, work):
    """``[expr]``: ``polyffusion_tpu_torch.expr.main`` at ``--ddim
    --batch_size 16`` on the run directories the earlier phases wrote
    (EXPR_RUNS), each with the launch counts set to 0 just before and read
    just after: 550 kernel-1 launches per batch per scale pass, its table
    written and finite. Then the inference CLI once with ``--dump_images``
    (DUMP_IMAGES non-empty 128 x 128 PNGs) and once with ``--bf16_params``.
    Returns the launches by path and each run's seconds."""
    from polyffusion_tpu_torch import expr
    from polyffusion_tpu_torch.inference import main as infer_main

    data = os.path.join(work, "songs")
    zero = {name: 0 for name in counters}
    launches, secs = {}, {}
    for kind, run, pretrained, extra, batches, passes in EXPR_RUNS:
        out_dir = os.path.join(work, f"expr_{kind}")
        argv = ["--chkpt_path", os.path.join(work, run), "--data_dir", data, "--pretrained_dir",
                os.path.join(work, pretrained), "--type", kind, "--ddim", "--batch_size",
                str(EXPR_BATCH), "--batch_num", str(batches), "--output_dir", out_dir, *extra]
        result, secs[kind], got, _ = run_with_counts(counters, expr.main, argv)
        want = dict(zero, packed_attention=LAUNCHES_PER_REQUEST * batches * passes)
        files = sorted(os.listdir(out_dir))
        log(f"[expr] {kind} on {run} ({batches} batch(es) of {EXPR_BATCH}, {passes} scale "
            f"pass(es)): {secs[kind]:.3f} s, launches {got}, wrote {files}")
        if got != want:
            raise AssertionError(f"[expr] {kind}: expected launches {want}, got {got}")
        if isinstance(result, dict):  # a sweep: its table, <kind>.json
            with open(os.path.join(out_dir, f"{kind}.json")) as f:
                table = json.load(f)
            rows = table["scales" if "scales" in table else "table"]
            values = [v for row in rows.values() for v in row.values()]
            log(f"[expr] {kind} table {json.dumps(table)}")
            if table["n_samples"] != EXPR_BATCH * batches or not np.isfinite(values).all():
                raise AssertionError(f"[expr] {kind}: bad table {table}")
        elif result.shape[0] != EXPR_BATCH * batches or not np.isfinite(result).all():
            raise AssertionError(f"[expr] {kind}: bad output {result.shape}")
        if not any(f.endswith((".json", ".mid")) for f in files):
            raise AssertionError(f"[expr] {kind} wrote nothing")
        launches[f"expr_{kind}"] = got

    base = ["--chkpt_path", os.path.join(work, "run"), "--data_dir", data, "--song_fn", CLI_SONG,
            "--pretrained_dir", os.path.join(work, "pretrained"), "--ddim", "--length", "1"]
    for flag in ("--dump_images", "--bf16_params"):
        out_dir = os.path.join(work, f"cli_{flag[2:]}")
        (gen,), secs[flag], got, _ = run_with_counts(counters, infer_main,
                                                      base + [flag, "--output_dir", out_dir])
        log(f"[expr] inference CLI {flag} --ddim --length 1: {secs[flag]:.3f} s, launches {got}")
        if got != dict(zero, packed_attention=LAUNCHES_PER_REQUEST):
            raise AssertionError(f"{flag}: expected {LAUNCHES_PER_REQUEST} kernel-1 launches")
        if gen.shape != (1, 2, 128, 128) or not np.isfinite(gen).all():
            raise AssertionError(f"{flag}: bad output {gen.shape}")
        launches[f"cli_{flag[2:]}"] = got
    img_dir = os.path.join(work, "cli_dump_images", "img")
    pngs = sorted(os.listdir(img_dir))
    shapes = {p: read_png(os.path.join(img_dir, p)).shape for p in pngs}
    log(f"[expr] --dump_images wrote {len(pngs)} PNGs: {shapes}")
    if len(pngs) != DUMP_IMAGES or set(shapes.values()) != {(128, 128, 4)}:
        raise AssertionError(f"--dump_images: expected {DUMP_IMAGES} 128 x 128 PNGs, got {shapes}")
    log(f"[expr] summary {json.dumps(secs)}")
    return launches


def drive_parallel(counters, work, smi):
    """``[parallel]``: the port's parallelism on the card, in process groups
    of one rank (NCCL forbids two ranks on one card).

    - The full-width bf16 ``sdf_chd8bar`` train step at batch 16 through
      each of PARALLEL_ROUTES (dp; fsdp, FSDP2 one-way shards; tp=1, the tp
      modules on a (1, 1) mesh) against the plain one-process step from the
      same weights, batch and noise: loss, grad norm and gradients within
      PARALLEL_*_RTOL; the planted fault (the first half of the rows only)
      must miss. Kernels 1 / 2 / 6 at 11 / 11 / 56 launches a step on every
      route, and each route's warm ms per step.
    - An InferenceSession request (DDIM-50 CFG 5, batch PARALLEL_SAMPLE_BATCH)
      on the dp mesh with ``fsdp_params=True``: the same bytes as the
      unsharded session's, 550 kernel-1 launches.
    - ``polyffusion_tpu_torch.main --fsdp`` (its own one-rank group) for
      PARALLEL_CLI_STEPS steps, a checkpoint, ``--resume`` for
      PARALLEL_RESUME_STEPS, then one inference-CLI DDIM-50 request from that
      run directory (550 kernel-1 launches).

    Returns the launches by path."""
    import torch
    import torch.distributed as dist

    from polyffusion_tpu_torch.data import BatchLoader, SegmentDataset
    from polyffusion_tpu_torch.inference import InferenceSession
    from polyffusion_tpu_torch.inference import main as infer_main
    from polyffusion_tpu_torch.main import main as train_main
    from polyffusion_tpu_torch.parallel import init_process_group, make_mesh, make_tp_mesh
    from polyffusion_tpu_torch.parallel.mesh import full
    from polyffusion_tpu_torch.train import create_state, make_train_step

    cfg = full_cfg(bf16=True)
    zero = {name: 0 for name in counters}
    per_step = dict(zero, packed_attention=ATTENTION_SITES, packed_attention_bwd=ATTENTION_SITES,
                    gn_bwd=GROUPNORM_SITES)
    batch = maintenance_batch(np.random.default_rng(15), cfg.batch_size)
    task = make_task(cfg, "cuda", seed=15, training=True)
    noise = task.draw_noise(batch, torch.Generator(device="cuda").manual_seed(15))
    del task
    init_process_group()
    meshes = {"plain": None, "dp": make_mesh(), "fsdp": make_mesh(), "tp1": make_tp_mesh(1, 1)}
    launches, ms = {}, {}

    def step_of(route, rows=slice(None)):
        """One step from seed-15 weights on ``rows`` of the batch; returns the
        loss, the norm, the (clipped) master gradients whole, the launches,
        and the state and step to time."""
        task = make_task(cfg, "cuda", seed=15, training=True)
        mesh, fsdp = meshes[route], route == "fsdp"
        state = create_state(task.unet, cfg.learning_rate, cfg.max_grad_norm, bf16=True,
                             mesh=mesh, fsdp=fsdp)
        step = make_train_step(task, mesh=mesh, fsdp=fsdp)
        part = tuple(None if v is None else v[rows] for v in batch)
        zero_counts(counters)
        metrics = step(state, part, seed=0,
                       noise=noise._replace(t=noise.t[rows], noise=noise.noise[rows]))
        torch.cuda.synchronize()
        got = {name: c.launches for name, c in counters.items()}
        names = [n for n, _ in task.unet.named_parameters()]
        grads = {n: full(m.grad).float() for n, m in zip(names, state.weights.masters)}
        return float(metrics["loss"]), float(metrics["grad_norm"]), grads, got, state, step

    def grad_err(got, want):
        num = sum(float((got[k] - w).square().sum()) for k, w in want.items())
        return (num / sum(float(w.square().sum()) for w in want.values())) ** 0.5

    def timed(route, state, step):
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PARALLEL_TIMED):
            step(state, batch, seed=0)
        torch.cuda.synchronize()
        ms[route] = (time.perf_counter() - t0) * 1e3 / PARALLEL_TIMED
        got = {name: c.launches for name, c in counters.items()}
        want = {name: n * PARALLEL_TIMED for name, n in per_step.items()}
        if got != want:
            raise AssertionError(f"[parallel] {route}: {PARALLEL_TIMED} steps launched {got}, "
                                 f"expected {want}")
        return got

    loss, norm, grads, _, state, step = step_of("plain")
    timed("plain", state, step)
    del state, step
    fault_loss, _, fault_grads, _, _, _ = step_of("plain", slice(0, cfg.batch_size // 2))
    fault = grad_err(fault_grads, grads)
    for route in PARALLEL_ROUTES:
        r_loss, r_norm, r_grads, got, state, step = step_of(route)
        loss_err, norm_err = abs(r_loss - loss) / abs(loss), abs(r_norm - norm) / abs(norm)
        err = grad_err(r_grads, grads)
        timed_got = timed(route, state, step)
        del state, step
        launches[f"parallel_{route}_steps"] = {name: got[name] + timed_got[name]
                                               for name in counters}
        log(f"[parallel] {route} bf16 step (B={cfg.batch_size}) vs the plain step on the card: "
            f"loss {r_loss:.7g} vs {loss:.7g} (rel {loss_err:.3g}, limit {PARALLEL_LOSS_RTOL}), "
            f"grad_norm {r_norm:.7g} vs {norm:.7g} (rel {norm_err:.3g}, limit "
            f"{PARALLEL_NORM_RTOL}), gradients rel {err:.3g} in norm (limit "
            f"{PARALLEL_GRAD_RTOL}); planted fault (the first {cfg.batch_size // 2} rows' "
            f"gradient, loss {fault_loss:.7g}) rel {fault:.3g}; launches a step {got}; "
            f"{ms[route]:.3f} ms/step warm vs plain {ms['plain']:.3f} (host clock, "
            f"{PARALLEL_TIMED} steps; {smi})")
        if got != per_step:
            raise AssertionError(f"[parallel] {route}: expected launches {per_step}, got {got}")
        if not (loss_err <= PARALLEL_LOSS_RTOL and norm_err <= PARALLEL_NORM_RTOL
                and err <= PARALLEL_GRAD_RTOL):
            raise AssertionError(f"[parallel] {route}: the step differs from the plain step's")
    if not fault > PARALLEL_GRAD_RTOL:
        raise AssertionError("[parallel] the check does not catch a gradient of half the rows")

    # sampling: the unsharded session, then the same task's weights FSDP2-sharded
    sample_task = make_task(cfg, "cuda", seed=16)
    rng = np.random.default_rng(16)
    cond = sample_task.encode_chord(torch.from_numpy(random_chords(rng, PARALLEL_SAMPLE_BATCH)))
    start = rng.standard_normal((PARALLEL_SAMPLE_BATCH, 128, 128, 2)).astype(np.float32)
    outs, secs = {}, {}
    for kind, kwargs in (("plain", {}), ("fsdp_params", dict(mesh=meshes["dp"], fsdp_params=True))):
        session = InferenceSession(sample_task, sampler="ddim", ddim_steps=50, seed=0, **kwargs)
        outs[kind], secs[kind], got, _ = run_with_counts(
            counters, session.predict, cond, None, CLI_CFG_SCALE, False, None, None, start)
        if got != dict(zero, packed_attention=LAUNCHES_PER_REQUEST):
            raise AssertionError(f"[parallel] {kind} session: launches {got}")
    launches["parallel_session_fsdp_params"] = got
    same = np.array_equal(outs["plain"], outs["fsdp_params"])
    log(f"[parallel] InferenceSession DDIM-50 CFG {CLI_CFG_SCALE} (batch "
        f"{PARALLEL_SAMPLE_BATCH}) with a 1-rank mesh and fsdp_params: same bytes as "
        f"unsharded {same}, max_abs_err {np.abs(outs['plain'] - outs['fsdp_params']).max():.3g}; "
        f"{secs['fsdp_params']:.3f} s vs {secs['plain']:.3f} s ({smi})")
    if not same or not np.isfinite(outs["plain"]).all():
        raise AssertionError("[parallel] the fsdp_params session's output differs")
    del sample_task
    dist.destroy_process_group()

    # the training CLI with --fsdp, then the inference CLI on its run directory
    pretrained, data = os.path.join(work, "pretrained"), os.path.join(work, "songs")
    run = os.path.join(work, "run_fsdp")
    _, val_ds = SegmentDataset.train_val_from_dir(data, 0.9)
    val_batches = len(BatchLoader(val_ds, cfg.batch_size))
    args = ["--model", "sdf_chd8bar", "--output_dir", run, "--data_dir", data,
            "--pretrained_dir", pretrained, "--log_every", "1", "--seed", "0", "--fsdp"]
    total = PARALLEL_CLI_STEPS
    for steps, extra in ((PARALLEL_CLI_STEPS, []), (PARALLEL_RESUME_STEPS, ["--resume"])):
        total += steps if extra else 0
        label = "cli_fsdp" + ("_resume" if extra else "")
        state, secs[label], got, out = run_with_counts(
            counters, train_main, args + ["--max_steps", str(total)] + extra)
        want = dict(zero, packed_attention=ATTENTION_SITES * (steps + val_batches),
                    packed_attention_bwd=ATTENTION_SITES * steps, gn_bwd=GROUPNORM_SITES * steps)
        launches[f"parallel_{label}"] = got
        log(f"[parallel] main --fsdp{' --resume' if extra else ''}: {steps} steps and "
            f"{val_batches} val batches in {secs[label]:.3f} s (with setup; {smi}), "
            f"launches {got}")
        if got != want or state.step != total or "devices=1" not in out or "fsdp=True" not in out:
            raise AssertionError(f"[parallel] main --fsdp: launches {got} (want {want}), step "
                                 f"{state.step}, output {out[-400:]}")
        if extra and f"[resume] restored checkpoint at step {PARALLEL_CLI_STEPS}" not in out:
            raise AssertionError("[parallel] main --fsdp --resume did not restore")
    if dist.is_initialized():
        raise AssertionError("[parallel] main --fsdp left its process group behind")
    records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    step_ms = [1e3 / r["steps_per_sec"] for r in records if "train/loss" in r]
    layout = {}
    for r in (run, os.path.join(work, "run")):
        ckpt = torch.load(os.path.join(r, "chkpts", "last.pt"), map_location="cpu",
                          weights_only=True)
        layout[r] = {k: tuple(v.shape) for k, v in ckpt["params"].items()}
    if layout[run] != layout[os.path.join(work, "run")]:
        raise AssertionError("[parallel] the --fsdp checkpoint's tensors differ from a "
                             "one-process run's")
    (gen,), secs["cli_request"], got, _ = run_with_counts(counters, infer_main, [
        "--chkpt_path", run, "--data_dir", data, "--song_fn", CLI_SONG, "--pretrained_dir",
        pretrained, "--ddim", "--length", "1", "--output_dir", os.path.join(work, "cli_fsdp")])
    launches["parallel_cli_request"] = got
    log(f"[parallel] inference CLI on the --fsdp run --ddim --length 1: "
        f"{secs['cli_request']:.3f} s, launches {got}; the run's host ms per logged step "
        f"{[round(x, 3) for x in step_ms]} ({smi})")
    if got != dict(zero, packed_attention=LAUNCHES_PER_REQUEST):
        raise AssertionError(f"[parallel] CLI request: expected {LAUNCHES_PER_REQUEST} kernel-1 "
                             f"launches, got {got}")
    if gen.shape != (1, 2, 128, 128) or not np.isfinite(gen).all():
        raise AssertionError(f"[parallel] CLI request: bad output {gen.shape}")
    log(f"[parallel] summary {json.dumps({'ms_per_step': ms, 'secs': secs, 'card': smi})}")
    return launches


def maintenance_batch(rng, b):
    """A bf16 train batch as the feeder sends it (a uint8 roll, chords), on the card."""
    import torch

    x0 = torch.from_numpy((rng.random((b, 2, 128, 128)) > 0.97).astype(np.uint8)).cuda()
    return (x0, None, torch.from_numpy(random_chords(rng, b)).cuda(), None)


def check_remat_step(counters):
    """One full-width bf16 train step at batch 16 with ``remat`` against one
    without, on the card: the same task, weights, batch and noise (the
    task's ``cfg["remat"]`` switched between them); the loss within
    STEP_LOSS_RTOL and every gradient within STEP_GRAD_RTOL in relative norm.
    Kernel launches: 22 / 11 / 56 of kernels 1 / 2 / 6 with remat, 11 / 11 /
    56 without. A second plain step gives the card's own repeatability. The
    planted fault changes the bf16 working copy between the forward and the
    backward (scaled by REMAT_FAULT_SCALE): the recompute reads other
    weights, and the gradients must miss the limit. Returns the launches of
    the remat step."""
    import torch

    from polyffusion_tpu_torch.train import create_state

    cfg = full_cfg(bf16=True)
    task = make_task(cfg, "cuda", seed=7, training=True)
    state = create_state(task.unet, cfg.learning_rate, cfg.max_grad_norm, bf16=True)
    batch = maintenance_batch(np.random.default_rng(7), cfg.batch_size)
    noise = task.draw_noise(batch, torch.Generator(device="cuda").manual_seed(7))

    def grads(remat, fault=False):
        task.cfg["remat"] = remat
        state.weights.zero_grad()
        zero_counts(counters)
        loss, _ = task.loss_fn(batch, noise)
        if fault:
            with torch.no_grad():
                torch._foreach_mul_(state.weights.working, REMAT_FAULT_SCALE)
        loss.backward()
        torch.cuda.synchronize()
        got = {name: c.launches for name, c in counters.items()}
        g = {n: p.grad.float() for n, p in task.unet.named_parameters()}
        if fault:
            state.weights.refresh()  # the working copy from the masters again
        return loss.item(), g, got

    def worst(got, want):
        ratios = {k: ((got[k] - w).norm() / (STEP_GRAD_RTOL * w.norm() + 1e-9)).item()
                  for k, w in want.items()}
        k = max(ratios, key=ratios.get)
        return ratios[k], k

    loss, g, plain_got = grads(False)
    loss_again, g_again, _ = grads(False)
    r_loss, r_g, remat_got = grads(True)
    _, g_fault, _ = grads(True, fault=True)
    zero = {name: 0 for name in counters}
    want_plain = dict(zero, packed_attention=ATTENTION_SITES,
                      packed_attention_bwd=ATTENTION_SITES, gn_bwd=GROUPNORM_SITES)
    want_remat = dict(want_plain, packed_attention=REMAT_FWD)
    loss_err = abs(r_loss - loss) / abs(loss)
    ratio, name = worst(r_g, g)
    floor, floor_name = worst(g_again, g)
    fault, fault_name = worst(g_fault, g)
    log(f"[maintenance] remat vs plain bf16 step (B={cfg.batch_size}) on the card: loss "
        f"{r_loss:.7g} vs {loss:.7g} (rel {loss_err:.3g}, limit {STEP_LOSS_RTOL}); gradients "
        f"per tensor {ratio:.3g} x the limit (rel {STEP_GRAD_RTOL} in norm; worst {name}); a "
        f"second plain step {floor:.3g} x (worst {floor_name}, loss {loss_again:.7g}); planted "
        f"fault (working copy x {REMAT_FAULT_SCALE} between forward and backward) {fault:.3g} x "
        f"(worst {fault_name}); launches remat {remat_got}, plain {plain_got}")
    if not (loss_err <= STEP_LOSS_RTOL and ratio <= 1.0):
        raise AssertionError("the remat step's loss or gradients differ from the plain step's")
    if not fault > 1.0:
        raise AssertionError("the remat check does not catch weights changed before the backward")
    if remat_got != want_remat or plain_got != want_plain:
        raise AssertionError(f"expected launches {want_remat} (remat) and {want_plain} (plain), "
                             f"got {remat_got} and {plain_got}")
    del task, state
    return remat_got


def time_remat_steps():
    """Warm full-width bf16 train steps at batch 16 with and without remat on
    one task and state, in turns (MAINT_TIMED = warm-up steps, steps per
    round, rounds, profiled steps): ms per step from CUDA events (median of
    the rounds) and on the host clock, the peak device memory of a step
    (``torch.cuda.max_memory_allocated`` from a reset just before it, and
    the part above what was allocated before it), and under
    ``torch.profiler`` the device's busy ms and idle share. Returns them by
    mode."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from polyffusion_tpu_torch.profile_unet import breakdown
    from polyffusion_tpu_torch.train import create_state, make_train_step

    warm, per_round, rounds, profiled = MAINT_TIMED
    cfg = full_cfg(bf16=True)
    task = make_task(cfg, "cuda", seed=9, training=True)
    state = create_state(task.unet, cfg.learning_rate, cfg.max_grad_norm, bf16=True)
    step = make_train_step(task)
    batch = maintenance_batch(np.random.default_rng(9), cfg.batch_size)
    modes = {"plain": False, "remat": True}
    out = {m: {"event_ms": [], "host_ms": [], "peak_bytes": 0, "peak_above_bytes": 0}
           for m in modes}

    def run(n):
        for _ in range(n):
            step(state, batch, seed=0)

    for mode, remat in modes.items():
        task.cfg["remat"] = remat
        run(warm)
    for _ in range(rounds):
        for mode, remat in modes.items():
            task.cfg["remat"] = remat
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            run(per_round)
            end.record()
            torch.cuda.synchronize()
            row = out[mode]
            row["host_ms"].append((time.perf_counter() - t0) * 1e3 / per_round)
            row["event_ms"].append(start.elapsed_time(end) / per_round)
            peak = torch.cuda.max_memory_allocated()
            row["peak_bytes"] = max(row["peak_bytes"], peak)
            row["peak_above_bytes"] = max(row["peak_above_bytes"], peak - before)
    for mode, remat in modes.items():
        task.cfg["remat"] = remat
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(profiled)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        log(f"[maintenance] {mode} bf16 train step (B={cfg.batch_size}), torch.profiler over "
            f"{profiled} warm steps:")
        busy_ms = breakdown(prof, wall_ms, profiled, "step")
        row = out[mode]
        row["busy_ms_per_step"] = busy_ms / profiled if busy_ms else None
        row["idle_share"] = 1 - busy_ms / wall_ms if busy_ms else None
        row["ms"] = statistics.median(row["event_ms"])
        log(f"[maintenance] {mode} step: {row['ms']:.3f} ms (CUDA events, median of {rounds} "
            f"rounds of {per_round}: {[round(x, 3) for x in row['event_ms']]}), host "
            f"{[round(x, 3) for x in row['host_ms']]} ms; peak memory "
            f"{row['peak_bytes'] / 2**30:.3f} GiB ({row['peak_above_bytes'] / 2**30:.3f} GiB "
            f"above the state); device busy {row['busy_ms_per_step']} ms/step, idle share "
            f"{row['idle_share']}")
    ratio = out["remat"]["ms"] / out["plain"]["ms"]
    log(f"[maintenance] remat / plain: {ratio:.3f} x the step's ms (CUDA events), peak memory "
        f"{out['remat']['peak_bytes'] / out['plain']['peak_bytes']:.3f} x")
    del task, state
    return out


def drive_fused_remat_steps(counters):
    """One full-width bf16 train step at batch 16 with the GroupNorm-SiLU-conv
    sites fused, without and then with remat, each with the launch counts set
    to 0 just before it and read just after: plain 44 kernel-4 launches (12
    two-input), 11 / 11 / 12 of kernels 1 / 2 / 6; remat twice the forward
    kernels (88 kernel-4, 24 two-input; 22 kernel-1), the same 11 kernel-2
    and 12 kernel-6 (the fused sites' backward recomputes through the plain
    version). Returns the launches of each step."""
    import torch

    from polyffusion_tpu_torch.train import create_state, make_train_step

    cfg = full_cfg(bf16=True)
    task = make_task(cfg, "cuda", seed=10, training=True, gn_conv="fused")
    state = create_state(task.unet, cfg.learning_rate, cfg.max_grad_norm, bf16=True)
    step = make_train_step(task)
    batch = maintenance_batch(np.random.default_rng(10), cfg.batch_size)
    zero = {name: 0 for name in counters}
    launches = {}
    for mode, n in (("plain", 1), ("remat", 2)):
        task.cfg["remat"] = mode == "remat"
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(state, batch, seed=0)["loss"].item()
        secs = time.perf_counter() - t0
        got = {name: c.launches for name, c in counters.items()}
        n_two = counters["gn_silu_conv"].two_input_launches
        want = dict(zero, gn_silu_conv=n * GN_CONV_SITES, packed_attention=n * ATTENTION_SITES,
                    packed_attention_bwd=ATTENTION_SITES, gn_bwd=GROUPNORM_SITES - GN_CONV_SITES)
        log(f"[maintenance] fused {mode} bf16 step (B={cfg.batch_size}): loss {loss:.6g}, "
            f"{1e3 * secs:.3f} ms (host clock, first of its mode), launches {got}, two-input "
            f"{n_two}")
        if got != want or n_two != n * GN_CONV_TWO_INPUT or not np.isfinite(loss):
            raise AssertionError(f"expected launches {want} with {n * GN_CONV_TWO_INPUT} "
                                 f"two-input and a finite loss, got {got}, {n_two}, {loss}")
        launches[mode] = got
    del task, state
    return launches


def trace_kernel_counts(path):
    """Device kernel events in a Chrome trace of ``torch.profiler``, by kernel
    of the port (TRACE_KERNELS' name fragments), and all kernels."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    counts = {frag: sum(frag in n for n in names)
              for frags in TRACE_KERNELS.values() for frag in frags}
    return counts, len(names)


def write_pop909_release(origin, rng):
    """Two pieces in POP909's piano-roll release layout (per track: onset
    beat, bin, 4, offset beat, bin, 4, pitch, velocity; a beat table whose
    fourth column is the position in the bar; a chord table)."""
    os.makedirs(origin)
    n_beats = 64
    beat = np.zeros((n_beats, 6), np.int64)
    beat[:, 3] = np.arange(n_beats) % 4

    def track(n):
        ob = rng.integers(0, n_beats - 2, n)
        rows = np.stack([ob, rng.integers(0, 4, n), np.full(n, 4), ob + 1, rng.integers(0, 4, n),
                         np.full(n, 4), rng.integers(40, 90, n), np.full(n, 80)], 1)
        return rows[np.lexsort((rows[:, 1], rows[:, 0]))]

    for i in range(2):
        np.savez(os.path.join(origin, f"{i + 1:03d}.npz"), melody=track(30), bridge=track(20),
                 piano=track(50), beat=beat, chord=np.zeros((n_beats, 14), np.int64))


def drive_maintenance(counters, work):
    """The ``[maintenance]`` phase, on the training path's ``chd8bar.pt``
    under ``work``:

    1. the songs of ``python -m polyffusion_tpu_torch.tools synth_corpus`` (its
       ``main``, in this process, as every CLI here);
    2. the training CLI on them, full width, bf16, batch 16, with ``--set
       remat=true --set legacy_checkpoints=true --profile_steps 2,4``:
       MAINT_STEPS steps (22 / 11 / 56 launches of kernels 1 / 2 / 6 a step,
       11 of kernel 1 a validation batch), ``weights.pt``,
       ``weights_best.pt``, ``info.txt``, and a trace naming kernels 1, 2 and
       6 at 2 x (22, 11, 56) launches;
    3. a remat step against a plain one (``check_remat_step``), then fused
       plain and remat steps (``drive_fused_remat_steps``);
    4. both steps timed, with peak memory and idle share (``time_remat_steps``);
    5. ``python -m polyffusion_tpu_torch.convert --kind unet --reverse`` of the
       run directory, ``--kind unet`` of ``weights.pt`` to ``.npz`` (equal to
       the run's UNet tree), then one seeded DDIM-50 CFG-5 request each through
       the inference CLI from the run directory, the reversed ``.pt`` and
       ``weights.pt``: 550 kernel-1 launches each, rolls and MIDI files
       byte-identical;
    6. the other tools on the host: ``pop909_import`` on a seeded release,
       ``remove_from_split``, ``cleanup_checkpoints`` on the phase's result
       directory (removes a run without checkpoints, keeps the trained one).

    Returns the launches by path and the phase's numbers."""
    import pickle

    import torch

    from polyffusion_tpu_torch import tools
    from polyffusion_tpu_torch.convert.__main__ import (
        flatten_tree,
        load_params_npz,
        unet_tree_of_run,
    )
    from polyffusion_tpu_torch.convert.__main__ import main as convert_main
    from polyffusion_tpu_torch.data import BatchLoader, SegmentDataset
    from polyffusion_tpu_torch.inference import main as infer_main
    from polyffusion_tpu_torch.main import main as train_main

    t_phase = time.perf_counter()
    songs, result = os.path.join(work, "maint_songs"), os.path.join(work, "maint_result")
    run, pretrained = os.path.join(result, "sdf_chd8bar", "run"), os.path.join(work, "pretrained")
    zero = {name: 0 for name in counters}
    launches, numbers = {}, {}

    t0 = time.perf_counter()
    tools.main(["synth_corpus", "--out", songs, "--n_songs", str(MAINT_SONGS), "--n_bars",
                str(MAINT_BARS), "--seed", "0"])
    numbers["synth_corpus_s"] = time.perf_counter() - t0
    _, val_ds = SegmentDataset.train_val_from_dir(songs, 0.9)
    val_batches = len(BatchLoader(val_ds, full_cfg(bf16=True).batch_size))
    start, stop = MAINT_PROFILE
    args = ["--model", "sdf_chd8bar", "--output_dir", run, "--data_dir", songs,
            "--pretrained_dir", pretrained, "--seed", "0", "--log_every", "1", "--max_steps",
            str(MAINT_STEPS), "--profile_steps", f"{start},{stop}", "--set", "remat=true",
            "--set", "legacy_checkpoints=true"]
    state, secs, got, out = run_with_counts(counters, train_main, args)
    want = dict(zero, packed_attention=REMAT_FWD * MAINT_STEPS + ATTENTION_SITES * val_batches,
                packed_attention_bwd=ATTENTION_SITES * MAINT_STEPS,
                gn_bwd=GROUPNORM_SITES * MAINT_STEPS)
    log(f"[maintenance] training CLI (remat, legacy mirror, profiled steps {start}-{stop - 1}): "
        f"{MAINT_STEPS} steps and {val_batches} val batch(es) in {secs:.3f} s (with setup), "
        f"launches {got}")
    if got != want or state.step != MAINT_STEPS:
        raise AssertionError(f"expected launches {want} and step {MAINT_STEPS}, got {got} at "
                             f"step {state.step}")
    launches["maintenance_training"] = got
    numbers["training_cli_s"] = secs
    chk = os.path.join(run, "chkpts")
    trace = os.path.join(run, "profile", f"trace_steps_{start}_{stop}.json")
    for path in [os.path.join(chk, f) for f in ("weights.pt", "weights_best.pt", "info.txt")] + [
            trace]:
        if not os.path.exists(path):
            raise AssertionError(f"the training CLI did not write {path}")
    if f"[profile] trace written to {os.path.join(run, 'profile')}" not in out:
        raise AssertionError("no [profile] line")
    records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    losses = [r[k] for r in records for k in ("train/loss", "val/loss") if k in r]
    if not (len(losses) == MAINT_STEPS + 1 and np.isfinite(losses).all()):
        raise AssertionError(f"bad metrics {records}")
    ck = torch.load(os.path.join(chk, "weights.pt"), map_location="cpu", weights_only=True)
    n_unet = len(state.params())
    if not (ck["step"] == MAINT_STEPS and len(ck["optimizer"]["state"]) == n_unet
            and ck["optimizer"]["param_groups"][0]["params"] == list(range(3 + n_unet))):
        raise AssertionError("weights.pt does not hold the run's step and Adam state")
    counts, n_kernels = trace_kernel_counts(trace)
    steps = stop - start
    per_step = {"packed_attention": REMAT_FWD, "packed_attention_bwd": ATTENTION_SITES,
                "gn_bwd": GROUPNORM_SITES}
    want_trace = {frag: steps * per_step[k] for k, frags in TRACE_KERNELS.items() for frag in frags}
    log(f"[maintenance] trace {os.path.basename(trace)} ({os.path.getsize(trace) / 2**20:.1f} "
        f"MiB): {n_kernels} device kernels in {steps} steps, of the port's {counts} (expected "
        f"{want_trace}); weights.pt {os.path.getsize(os.path.join(chk, 'weights.pt')) / 2**20:.1f}"
        f" MiB; info.txt {open(os.path.join(chk, 'info.txt')).read()!r}")
    if counts != want_trace:
        raise AssertionError(f"the trace names {counts}, expected {want_trace}")
    numbers["trace_kernels_per_step"] = n_kernels / steps

    launches["maintenance_remat_step"] = check_remat_step(counters)
    fused = drive_fused_remat_steps(counters)
    launches["maintenance_fused_plain_step"] = fused["plain"]
    launches["maintenance_fused_remat_step"] = fused["remat"]
    numbers["steps"] = time_remat_steps()

    # the converter: the run directory -> a reference .pt; weights.pt -> a .npz
    t0 = time.perf_counter()
    reversed_pt = os.path.join(work, "maint_reversed.pt")
    convert_main(["--kind", "unet", "--reverse", "--input", run, "--output", reversed_pt])
    legacy_npz = os.path.join(work, "maint_legacy.npz")
    convert_main(["--kind", "unet", "--input", os.path.join(chk, "weights.pt"), "--output",
                  legacy_npz])
    numbers["convert_s"] = time.perf_counter() - t0
    got_tree, want_tree = (flatten_tree(load_params_npz(legacy_npz)),
                           flatten_tree(unet_tree_of_run(run)))
    if list(got_tree) != list(want_tree) or not all(
            np.array_equal(got_tree[k], w) for k, w in want_tree.items()):
        raise AssertionError("weights.pt's .npz is not the run's UNet tree")
    run_cfg = os.path.join(run, "params.yaml")  # a .pt carries no config: the run's
    sources = {"run": [run], "reversed": [reversed_pt, "--model", run_cfg],
               "legacy": [os.path.join(chk, "weights.pt"), "--model", run_cfg]}
    rolls, mids, numbers["request_s"] = {}, {}, {}
    for name, source in sources.items():
        out_dir = os.path.join(work, f"maint_cli_{name}")
        (gen,), secs, got, _ = run_with_counts(counters, infer_main, [
            "--chkpt_path", *source, "--data_dir", songs, "--song_fn", MAINT_SONG,
            "--pretrained_dir", pretrained, "--ddim", "--length", "1", "--uncond_scale", "5",
            "--seed", "0", "--output_dir", out_dir])
        (mid,) = [f for f in os.listdir(out_dir) if f.endswith(".mid")]
        rolls[name] = np.ascontiguousarray(gen).tobytes()
        mids[name] = open(os.path.join(out_dir, mid), "rb").read()
        log(f"[maintenance] inference CLI from the {name} weights: {secs:.3f} s, launches "
            f"{got}, {mid} ({len(mids[name])} bytes)")
        if got != dict(zero, packed_attention=LAUNCHES_PER_REQUEST):
            raise AssertionError(f"expected {LAUNCHES_PER_REQUEST} kernel-1 launches, got {got}")
        if gen.shape != (1, 2, 128, 128) or not np.isfinite(gen).all():
            raise AssertionError(f"bad output: shape {gen.shape}")
        launches[f"maintenance_cli_{name}"] = got
        numbers["request_s"][name] = secs
    if len(set(rolls.values())) != 1 or len(set(mids.values())) != 1:
        raise AssertionError("the three weight sources sampled different rolls or MIDI files")

    # the other tools, on the host
    t0 = time.perf_counter()
    rng = np.random.default_rng(14)
    write_pop909_release(os.path.join(work, "pop909_origin"), rng)
    tools.main(["pop909_import", "--origin", os.path.join(work, "pop909_origin"), "--out",
                os.path.join(work, "pop909_npz")])
    imported = SegmentDataset.from_dir(os.path.join(work, "pop909_npz"))
    split = os.path.join(work, "maint_split.pkl")
    names = sorted(f for f in os.listdir(songs) if f.endswith(".npz"))
    with open(split, "wb") as f:
        pickle.dump((names[:-1], names[-1:]), f)
    tools.main(["remove_from_split", "--split", split, "--song", names[0]])
    with open(split, "rb") as f:
        left = pickle.load(f)
    crashed = os.path.join(result, "sdf_chd8bar", "crashed")
    os.makedirs(os.path.join(crashed, "chkpts"))
    tools.main(["cleanup_checkpoints", "--result_dir", result, "--yes"])
    kept = sorted(os.listdir(os.path.join(result, "sdf_chd8bar")))
    numbers["other_tools_s"] = time.perf_counter() - t0
    log(f"[maintenance] pop909_import: {len(imported)} segments; remove_from_split: "
        f"{len(left[0])} + {len(left[1])} songs left; cleanup_checkpoints kept {kept}")
    if not (len(imported) > 0 and left == (names[1:-1], names[-1:]) and kept == ["run"]):
        raise AssertionError("a maintenance tool did not do its work")
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"[maintenance] phase {numbers['phase_s']:.3f} s; summary {json.dumps(numbers)}")
    return launches, numbers


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
    check_gn_fwd()
    epi_rows = check_repaint_epilogue()
    floor_ms = launch_floor()
    gnc_rows = check_gn_conv(quantized=False)
    gnq_rows = check_gn_conv(quantized=True)
    check_gn_conv_gradient()
    check_unet_against_cpu()
    check_unet_against_cpu(gn_conv="fused")
    check_int8_against_fused()
    check_train_step_against_cpu()
    check_train_step_against_cpu(gn_conv="fused")
    check_ddpm_paint_against_cpu()
    check_concat_against_cpu()
    check_dpmpp_against_cpu()
    check_distill_against_cpu()
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
    fused_training = drive_fused_train_steps(counters)
    # the XLA int8 route and the CFG fork
    routes = drive_routes(counters, smi)
    # the space-to-depth level 0
    s2d = drive_s2d(counters, smi)
    with tempfile.TemporaryDirectory() as work:
        before = map_cache_counts()
        training = drive_training_path(counters, work)
        cache["training"] = map_cache_delta(before, "the training runs")
        if min(training[k] for k in ("packed_attention", "packed_attention_bwd", "gn_bwd")) == 0:
            raise AssertionError(f"the training path did not launch every kernel: {training}")
        before = map_cache_counts()
        cli, request_secs, mask = drive_inference_cli(counters, work)
        cache["inference_cli"] = map_cache_delta(before, "the inference CLI's requests A and B")
        t0 = time.perf_counter()
        profile_inpainting(work, mask, request_secs)
        log(f"[profile] phase {time.perf_counter() - t0:.3f} s")
        # the trainer's and converter's leftovers and the tools
        maintenance, _ = drive_maintenance(counters, work)
        # parallelism: dp, fsdp and tp in one-rank groups, the CLI with --fsdp
        t0 = time.perf_counter()
        parallel = drive_parallel(counters, work, smi)
        log(f"[parallel] phase {time.perf_counter() - t0:.3f} s")
        # the texture and PianoTree conditions, on the same songs and chd8bar.pt
        write_condition_encoders(os.path.join(work, "pretrained"), seed=6)
        check_conditions_against_cpu(work)
        cond_requests, _ = drive_condition_requests(counters, work)
        mix2_training, mix2_cli = drive_mix2_paths(counters, work)
        # MIDI in (ingestion, prepare_data, the CLI's MIDI flags) and PolyDis out
        midi_cli = drive_midi_path(counters, work, smi)
        # the pretraining of the frozen encoders, then their run directories as
        # the frozen encoders of sdf_chd8bar and sdf_pnotree
        check_vae_steps_against_cpu(work)
        _, vae_host_ms = drive_vae_training(counters, work)
        vae_profiles = {name: profile_vae_steps(name, work) for name in VAE_PROFILE}
        for name, row in vae_profiles.items():
            row["cli_host_ms_per_step"] = vae_host_ms[name]
        from_runs = drive_sdf_from_runs(counters, work)
        log(f"[pretrain] summary {json.dumps(vae_profiles)}")
        # the generation worker and the evaluation harness on those run directories
        t0 = time.perf_counter()
        serving = {"serve": drive_serve(counters, work)}
        log(f"[serve] phase {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        serving.update(drive_expr(counters, work))
        log(f"[expr] phase {time.perf_counter() - t0:.3f} s")
        # the distillation of the training path's run directory, its students'
        # requests, then the blurry-image condition end to end
        distill, distill_ms = drive_distill_cli(counters, work)
        distill_rows = profile_distill_steps(work)
        students, student_secs = drive_student_requests(counters, work)
        concat, concat_secs = drive_concat_path(counters, work)
        # the plain DDPM family and the KL autoencoder, fp32 at their widths
        family = drive_family_paths(counters, work)
        summary = dict(steps=distill_rows, cli_stage_ms=distill_ms, request_secs=student_secs,
                       request_batch=STUDENT_BATCH)
        log(f"[distill] summary {json.dumps(summary)}")
        log(f"[concat] summary {json.dumps(concat_secs)}")

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

    def serving_launches(name):  # the [serve] and [expr] paths
        return {path: n[name] for path, n in serving.items()}

    def maintenance_launches(name):  # the [maintenance] paths that launch the kernel
        return {path: n[name] for path, n in maintenance.items() if n[name]}

    def parallel_launches(name):  # the [parallel] paths that launch the kernel
        return {path: n[name] for path, n in parallel.items() if n[name]}

    fwd_bf16 = [r for r in rows if r["shape"].endswith("bfloat16")]
    bf16 = [r for r in bwd_rows if r["shape"].endswith("bfloat16")]
    hm_bf16 = [r for r in hm_rows if r["shape"].endswith("bfloat16")]
    kernels = [
        # B=128 T=1024 bf16: the sampling path's dominant shape
        entry("packed_attention", "polyffusion_tpu_torch/ops/csrc/packed_attention.cu",
              "polyffusion_tpu/ops/fused_attention.py:53",
              {"sampling": sampling, "training": training["packed_attention"],
               "inpainting": cli["inpainting"]["packed_attention"],
               "autoreg": cli["autoreg"]["packed_attention"],
               **{f"sampling_{name}": n["packed_attention"] for name, n in cond_requests.items()},
               "training_mix2": mix2_training["packed_attention"],
               "cli_mix2": mix2_cli["packed_attention"],
               **{f"sampling_{name}": n["packed_attention"] for name, n in routes.items()},
               **{name: n["packed_attention"] for name, n in s2d.items()},
               **{f"midi_{name}": n["packed_attention"] for name, n in midi_cli.items()},
               **{f"training_{name}_from_run": n["packed_attention"]
                  for name, n in from_runs.items()},
               **{f"distill_{name}": n["packed_attention"] for name, n in distill.items()},
               **{f"sampling_{name}": n["packed_attention"] for name, n in students.items()},
               **{f"concat_{name}": n["packed_attention"] for name, n in concat.items()},
               **serving_launches("packed_attention"),
               **maintenance_launches("packed_attention"),
               **parallel_launches("packed_attention")},
              rows, rows[0], fwd_bf16),
        # B=16 T=1024 bf16: the train step's dominant shape
        entry("packed_attention_bwd", "polyffusion_tpu_torch/ops/csrc/packed_attention_bwd.cu",
              "polyffusion_tpu/ops/fused_attention.py:111",
              {"training": training["packed_attention_bwd"],
               "training_s2d": s2d["training_s2d"]["packed_attention_bwd"],
               "training_mix2": mix2_training["packed_attention_bwd"],
               **{f"training_{name}_from_run": n["packed_attention_bwd"]
                  for name, n in from_runs.items()},
               "distill_cli": distill["cli"]["packed_attention_bwd"],
               "distill_cli_chain": distill["cli_chain"]["packed_attention_bwd"],
               "concat_training": concat["training"]["packed_attention_bwd"],
               **serving_launches("packed_attention_bwd"),
               **maintenance_launches("packed_attention_bwd"),
               **parallel_launches("packed_attention_bwd")},
              bwd_rows, bf16[0], bf16),
        # BH=512 T=1024 D=64 bf16: a batch-128 level-2 self-attention in head-major
        # form; on no model path, driven directly
        entry("head_major_attention", "polyffusion_tpu_torch/ops/csrc/packed_attention.cu",
              "polyffusion_tpu/ops/fused_attention.py:29", {"direct": head_major, **serving_launches("head_major_attention")}, hm_rows,
              [r for r in hm_bf16 if r["shape"].startswith("BH=512 T=1024")][0], hm_bf16),
        # B=16 C=64 128x128 bf16: the largest GroupNorm of the train step
        entry("gn_bwd", "polyffusion_tpu_torch/ops/csrc/gn_bwd.cu",
              "polyffusion_tpu/ops/gn_bwd.py:66",
              {"training": training["gn_bwd"], "training_s2d": s2d["training_s2d"]["gn_bwd"],
               "training_mix2": mix2_training["gn_bwd"],
               **{f"training_{name}_from_run": n["gn_bwd"] for name, n in from_runs.items()},
               "distill_cli": distill["cli"]["gn_bwd"],
               "distill_cli_chain": distill["cli_chain"]["gn_bwd"],
               "concat_training": concat["training"]["gn_bwd"], **family,
               **serving_launches("gn_bwd"), **maintenance_launches("gn_bwd"),
               **parallel_launches("gn_bwd")},
              gn_rows, gn_rows[0], gn_rows),
        # B=2 2x128x128 fp32: request A's sampler batch
        entry("repaint_epilogue", "polyffusion_tpu_torch/ops/csrc/repaint_epilogue.cu",
              "polyffusion_tpu/ops/pallas_sampler.py:33",
              {"inpainting": cli["inpainting"]["repaint_epilogue"],
               "concat_cli_ddpm": concat["cli_ddpm"]["repaint_epilogue"],
               **serving_launches("repaint_epilogue")}, epi_rows, epi_rows[0],
              epi_rows),
        # B=128 C=64->64 128x128 bf16 with the residual: the costliest site shape
        entry("gn_silu_conv", "polyffusion_tpu_torch/ops/csrc/gn_silu_conv.cu",
              "polyffusion_tpu/ops/fused_gn_conv.py:36",
              {"sampling_fused": gn_conv_paths["fused"]["gn_silu_conv"],
               "training_fused": fused_training["gn_silu_conv"],
               **serving_launches("gn_silu_conv"),
               **maintenance_launches("gn_silu_conv")}, gnc_rows, gnc_rows[1],
              [r for r in gnc_rows if "bfloat16" in r["shape"]]),
        entry("gn_silu_conv_q", "polyffusion_tpu_torch/ops/csrc/gn_silu_conv.cu",
              "polyffusion_tpu/ops/fused_gn_conv.py:36",
              {"sampling_int8": gn_conv_paths["int8"]["gn_silu_conv_q"],
               "cli_int8": cli["int8"]["gn_silu_conv_q"],
               **serving_launches("gn_silu_conv_q")}, gnq_rows, gnq_rows[1],
              [r for r in gnq_rows if "bfloat16" in r["shape"]]),
    ]
    # kernel 5's amax pass runs once before each of its convolutions
    kernels[-1]["amax_pass_launches_by_path"] = {
        "sampling_int8": gn_conv_paths["int8"]["gn_silu_amax"],
        "cli_int8": cli["int8"]["gn_silu_amax"]}
    kernels[-1]["amax_pass_ms"] = gnq_rows[1]["amax_pass_ms"]
    for k in kernels[3:5]:  # kernels 6 and 7: below this no launch goes
        k["launch_floor_ms"] = floor_ms
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
