#!/usr/bin/env python3
"""Kernels 6 and 7 against their earlier designs, on one CUDA card.

    python3 scripts/gn_bwd_epilogue_designs.py --parent <checkout> [--split]
        [--kernels-only] [--json out.json]

From the root of a checkout. ``<checkout>`` is another checkout of the
repository (an earlier commit, unpacked with ``git archive``) whose
``gn_bwd.cu`` and ``repaint_epilogue.cu`` hold the designs to compare with:
the GroupNorm backward of one 256-thread block per (item, group) that reads x
and dy twice and leaves the sum over B to its wrapper, and the epilogue
launched plainly as 64 blocks of 256 threads at batch 2. It builds those two
sources, and a copy of this checkout's ``repaint_epilogue.cu`` launched
without programmatic dependent launch (a text substitution), and times, with
CUDA events in turns (``chip_smoke.time_in_turns``):

- kernel 6 at every GroupNorm shape of the bf16 train step (batch 16) and at
  chip_smoke's fp32 shapes, warm and cold (``chip_smoke.cold_sets``): this
  checkout's wrapper as the train step calls it, the same kernel at other
  shared-memory budgets (plans of ``split_plan``: fewer, larger or more,
  smaller CTAs a span), and the earlier kernel alone and with the two sums
  over B its wrapper added;
- with ``--split``, at the train step's shapes, copies of this checkout's
  ``gn_bwd.cu`` with one part cut out (where the time goes) and whole
  alternatives (``VARIANTS``: among them the two-pass scheme of the earlier
  kernel with this one's in-launch sum over B), in turns with the kernel;
- kernel 7 at batch 2, 4 and 64, alone and behind the CFG combine that writes
  its eps (the pair as the sampler runs it): this checkout's kernel, the same
  without programmatic dependent launch, and the earlier kernel; and an empty
  kernel (the launch floor);
- the epilogue wrapper's host microseconds per call, in this checkout and in
  the other one (``--host``, a process each, in turns: other, this, this,
  other);
- ``profile_train``'s device kernels per train step and kernel 6's launches and
  ms per step, in both checkouts in the same turns (``--train``: this
  checkout's ``profile_train.py`` run on the other checkout's package);
  ``--kernels-only`` leaves out these last two.

Prints one JSON line (also written to ``--json``), with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import itertools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "polyffusion_tpu_torch", "ops", "csrc")
BUILD = os.path.join(ROOT, "polyffusion_tpu_torch", "ops", "build", "designs")
PROFILE_TRAIN = os.path.join(ROOT, "polyffusion_tpu_torch", "profile_train.py")
BUDGETS = (200 * 1024, 32 * 1024)  # kernel 6 at other shares a CTA (bytes of x and dy)
EPI_BATCHES = (2, 4, 64)
PDL_ON = "programmaticStreamSerializationAllowed = 1"
# --split: ablated copies of this checkout's gn_bwd.cu, each with one part cut
# out by a text substitution (their outputs are wrong by design), timed in
# turns with the full kernel at SPLIT_SHAPES (bf16, batch 16; C, H, W)
PASS1_MATH = """      Vec<T>::load(xs + i * V, xv);
      Vec<T>::load(ds + i * V, dv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        db += dv[e];
        dgv += dv[e] * ((xv[e] - mean) * inv);
      }
"""
STORE = "    Vec<T>::store(dxg + i * V, out);"
TICKET = """    __threadfence();
    __syncwarp();
    if (lane == 0) last = atomicAdd(&a.tickets[g], 1) == a.batch - 1;"""
EXCHANGE = [("""  if (k > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }""", "  __syncthreads();"),
            ("if (k > 1) {  // all k loads", "if (false) {  // all k loads"),
            ("  if (k > 1) cluster_arrive();  // done reading", "  // done reading"),
            ("  if (k > 1) cluster_wait();\n}", "}")]
ABLATIONS = {
    "no_pass1_math": [(PASS1_MATH, "")],
    "no_stores": [(STORE, "    if (out[0] == 1234.5f) " + STORE.strip())],
    "no_ticket": [(TICKET, "    if (lane == 0) last = 0;")],
    "no_exchange": EXCHANGE,
}
ABLATIONS["loads_only"] = (ABLATIONS["no_pass1_math"] + ABLATIONS["no_stores"]
                           + ABLATIONS["no_ticket"] + EXCHANGE)
# --split also times whole alternatives (correct outputs, checked against the
# plain version), copies of gn_bwd.cu by text substitution:
# - two_pass_global: both passes read x and dy from device memory, no shared
#   copy (the earlier design's scheme: one CTA a span, plan (1, span)), with
#   this kernel's in-launch sum over B and casts;
# - fence_acq_rel: the ticket's fence an acquire-release one instead of
#   __threadfence's sequentially consistent one;
# - threads_128: CTAs of 128 threads;
# - ticket_deferred: the ticket's atomic result read only after pass 2, so
#   that its round trip overlaps the ticket warp's share of pass 2;
# and this kernel at the SPLIT_BUDGETS (bytes of x and dy a CTA)
BULK_COPY = """      mbar_expect_tx(&bars[j], 2 * bytes);
      bulk_load(xs + e0, xg + e0, bytes, &bars[j]);
      bulk_load(ds + e0, dg_in + e0, bytes, &bars[j]);
"""
VARIANTS = {
    "two_pass_global": [
        (BULK_COPY, ""), ("wait_for(i);", ""),
        ("Vec<T>::load(xs + i * V, xv);", "Vec<T>::load(xg + i * V, xv);"),
        ("Vec<T>::load(ds + i * V, dv);", "Vec<T>::load(dg_in + i * V, dv);"),
        ("      2 * round_up_128(static_cast<size_t>(a.share) * sizeof(T)), stream);",
         "      0, stream);"),
        ("      2 * round_up_128(static_cast<size_t>(share) * item) > "
         "static_cast<size_t>(kMaxSmem) ||\n", "")],
    "fence_acq_rel": [("    __threadfence();\n    __syncwarp();",
                       '    asm volatile("fence.acq_rel.gpu;\\n" ::: "memory");\n'
                       '    __syncwarp();')],
    "threads_128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "ticket_deferred": [
        ("  if (rank == 0 && warp == kWarps - 1) {\n",
         "  int ticket = 0;\n  if (rank == 0 && warp == kWarps - 1) {\n"),
        ("    if (lane == 0) last = atomicAdd(&a.tickets[g], 1) == a.batch - 1;",
         "    if (lane == 0) ticket = atomicAdd(&a.tickets[g], 1);"),
        ("  if (rank == 0) {\n    __syncthreads();\n    if (last) {",
         "  if (rank == 0) {\n    if (warp == kWarps - 1 && lane == 0) last = ticket == "
         "a.batch - 1;\n    __syncthreads();\n    if (last) {")],
}
SPLIT_BUDGETS = (32 * 1024, 16 * 1024)


def nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build(sources: dict) -> dict:
    """{name: (source text, include dir)} -> {name: CDLL}, one nvcc each, in parallel."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, (text, inc) in sources.items():
        cu = os.path.join(BUILD, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = cu[:-3] + ".so"
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-I", inc, "-o", lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (p, lib) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def old_kernel(old, x, dy, mean_c, inv_c, gamma, sums=True):
    """The earlier kernel (fp32 gamma, (B, C) partials), and with ``sums`` the
    two sums over B its wrapper took after it."""
    import torch

    b, c, h, w = x.shape
    dx = torch.empty_like(x)
    dgb, dbb = (torch.empty(b, c, device="cuda") for _ in range(2))
    code = {torch.float32: 0, torch.bfloat16: 1}[x.dtype]
    err = old.gn_bwd(x.data_ptr(), dy.data_ptr(), mean_c.data_ptr(), inv_c.data_ptr(),
                     gamma.float().data_ptr(), dx.data_ptr(), dgb.data_ptr(), dbb.data_ptr(),
                     b, c, 32, h * w, code, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier gn_bwd: cudaError {err}")
    return (dx, dgb.sum(0), dbb.sum(0)) if sums else (dx, dgb, dbb)


def plan_at(span, dtype, budget):
    """Kernel 6's split of ``span`` elements at another shared-memory budget
    a CTA: the smallest cluster whose share fits it, else the largest."""
    from polyffusion_tpu_torch.ops import gn_bwd as mod

    plans = [mod.split_plan(span, dtype.itemsize, k) for k in mod.CLUSTER_SIZES]
    return next((p for p in plans if p.smem <= budget), plans[-1])


def gn_bwd_rows(old, cs):
    import torch

    from polyffusion_tpu_torch.ops import gn_bwd as mod

    mod.group_norm_bwd(*(torch.zeros(1, 32, 8, 8, device="cuda"),) * 2,
                       torch.zeros(1, 32, device="cuda"), torch.zeros(1, 32, device="cuda"),
                       torch.ones(32, device="cuda"), 32)  # loads the entry point
    new_entry = mod._entry[0]

    def new_at(plan, x, dy, mean_c, inv_c, gamma):
        """This checkout's kernel with the split ``plan``."""
        b, c, h, w = x.shape
        dx = torch.empty_like(x)
        dg, db = (torch.empty(c, dtype=gamma.dtype, device="cuda") for _ in range(2))
        part = torch.empty(2, b, c, device="cuda")
        code = mod._DTYPE_CODES
        err = new_entry(x.data_ptr(), dy.data_ptr(), mean_c.data_ptr(), inv_c.data_ptr(),
                        gamma.data_ptr(), dx.data_ptr(), dg.data_ptr(), db.data_ptr(),
                        part.data_ptr(), mod._tickets(x.device, 32).data_ptr(), b, c, 32, h * w,
                        plan.cluster, plan.share, plan.chunk, code[x.dtype], code[gamma.dtype],
                        code[gamma.dtype], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gn_bwd with {plan}: cudaError {err}")
        return dx, dg, db

    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [(16, c, h, w, torch.bfloat16, n) for c, h, w, n in cs.GN_TRAIN_SHAPES]
    cases += [(b, c, h, w, torch.float32, 0) for b, c, h, w in cs.GN_FP32_SHAPES]
    rows = []
    for b, c, h, w, dtype, sites in cases:
        x, dy, mean_c, inv_c, gamma, _ = cs.gn_bwd_inputs(g, b, c, h, w, dtype)
        gp = gamma.to(dtype)
        want = mod.gn_bwd_reference(x, dy, mean_c, inv_c, gamma, 32)
        fns = {"new": lambda: mod.group_norm_bwd(x, dy, mean_c, inv_c, gp, 32, param_dtype=dtype),
               "old_with_sums": lambda: old_kernel(old, x, dy, mean_c, inv_c, gamma),
               "old_kernel": lambda: old_kernel(old, x, dy, mean_c, inv_c, gamma, sums=False)}
        plans = {"new": mod.gn_bwd_plan(b, c, h, w, dtype, 32)}
        others = {f"new_budget_{budget // 1024}k": plan_at(c // 32 * h * w, dtype, budget)
                  for budget in BUDGETS}
        for name, plan in others.items():
            if plan not in plans.values():
                plans[name] = plan
                fns[name] = (lambda p: lambda: new_at(p, x, dy, mean_c, inv_c, gp))(plan)
        errs = {}
        for name, fn in fns.items():  # each form computes the same dx
            got = fn()[0]
            torch.cuda.synchronize()
            errs[name] = cs.limit_ratio(got, want[0], *((cs.GN_BF16_ATOL, cs.GN_BF16_RTOL)
                                        if dtype == torch.bfloat16 else
                                        (cs.GN_FP32_ATOL, cs.GN_FP32_RTOL)))
        warm = cs.time_in_turns(fns)
        sets = cs.cold_sets(x, dy, mean_c, inv_c, gp)
        turns = {n: itertools.cycle(sets) for n in ("new", "old_with_sums")}
        cold = cs.time_in_turns({
            "new": lambda: mod.group_norm_bwd(*next(turns["new"]), 32, param_dtype=dtype),
            "old_with_sums": lambda: old_kernel(old, *next(turns["old_with_sums"])[:4], gamma)})
        shape = f"B={b} C={c} H={h} W={w} {str(dtype).split('.')[1]}"
        row = dict(shape=shape, sites_per_step=sites,
                   plans={n: p._asdict() for n, p in plans.items()},
                   warm_ms=warm, cold_ms=cold, dx_limit_ratio=errs,
                   bound_ms=cs.gn_bwd_bound(x, x.element_size()))
        print(f"[gn_bwd] {shape}: " + ", ".join(f"{n} {v:.4f}" for n, v in warm.items())
              + " ms warm; cold " + ", ".join(f"{n} {v:.4f}" for n, v in cold.items())
              + f"; bound {row['bound_ms']:.4f}; dx vs plain (x the limit) "
              + ", ".join(f"{n} {v:.3g}" for n, v in errs.items()), flush=True)
        rows.append(row)
        del x, dy, sets, want
    step = {name: sum(r["sites_per_step"] * r["warm_ms"][name] for r in rows)
            for name in ("new", "old_with_sums", "old_kernel")}
    step["bound"] = sum(r["sites_per_step"] * r["bound_ms"] for r in rows)
    print("[gn_bwd] the train step's 56 GroupNorm backwards (warm, summed over the sites): "
          + ", ".join(f"{n} {v:.4f}" for n, v in step.items()) + " ms", flush=True)
    return rows, step


def split_rows(cs, old):
    """At every GroupNorm shape of the bf16 train step (batch 16): kernel 6's
    parts on the critical path (each ablated build's time in turns with the
    full kernel: ms saved without the part) and, in the same turns, the whole
    alternatives (``VARIANTS``, the kernel at ``SPLIT_BUDGETS``, the earlier
    kernel alone), each with its dx against the plain version; and each
    form's time summed over the step's sites."""
    import torch

    from polyffusion_tpu_torch.ops import gn_bwd as mod

    text = open(os.path.join(CSRC, "gn_bwd.cu")).read()
    sources = {"full": (text, CSRC)}
    for name, subs in {**ABLATIONS, **VARIANTS}.items():
        t = text
        for old_text, new_text in subs:
            if old_text not in t:
                raise SystemExit(f"gn_bwd.cu has no {old_text!r} for {name}")
            t = t.replace(old_text, new_text)
        sources[name] = (t, CSRC)
    libs = build(sources)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.gn_bwd.argtypes, lib.gn_bwd.restype = [vp] * 10 + [ci] * 10 + [vp], ci
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for c, h, w, sites in cs.GN_TRAIN_SHAPES:
        x, dy, mean_c, inv_c, gamma, _ = cs.gn_bwd_inputs(g, 16, c, h, w, torch.bfloat16)
        gp = gamma.bfloat16()
        span = c // 32 * h * w
        plan = mod.gn_bwd_plan(16, c, h, w, torch.bfloat16, 32)
        tickets = mod._tickets(x.device, 32)
        whole = _round8(span)
        forms = {name: (libs[name], plan) for name in ("full", *ABLATIONS, *VARIANTS)}
        forms["two_pass_global"] = (libs["two_pass_global"], mod.GnBwdPlan(1, whole, whole, 0))
        for budget in SPLIT_BUDGETS:
            p = plan_at(span, torch.bfloat16, budget)
            forms[f"full_budget_{budget // 1024}k"] = (libs["full"], p)

        def run(lib, p):
            dx = torch.empty_like(x)
            dg, db = (torch.empty(c, dtype=torch.bfloat16, device="cuda") for _ in range(2))
            part = torch.empty(2, 16, c, device="cuda")
            err = lib.gn_bwd(x.data_ptr(), dy.data_ptr(), mean_c.data_ptr(), inv_c.data_ptr(),
                             gp.data_ptr(), dx.data_ptr(), dg.data_ptr(), db.data_ptr(),
                             part.data_ptr(), tickets.data_ptr(), 16, c, 32, h * w, p.cluster,
                             p.share, p.chunk, 1, 1, 1, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"gn_bwd split build with {p}: cudaError {err}")
            return dx, dg, db

        fns = {n: (lambda lb, p: lambda: run(lb, p))(*f) for n, f in forms.items()}
        fns["pr2_kernel"] = lambda: old_kernel(old, x, dy, mean_c, inv_c, gamma, sums=False)
        want = mod.gn_bwd_reference(x, dy, mean_c, inv_c, gamma, 32)
        errs = {}
        for name in fns:
            if name in ABLATIONS:
                continue
            got = fns[name]()
            torch.cuda.synchronize()
            errs[name] = cs.limit_ratio(got[0], want[0], cs.GN_BF16_ATOL, cs.GN_BF16_RTOL)
        tickets.zero_()
        ms = cs.time_in_turns(fns)
        tickets.zero_()  # the builds without a ticket leave the counters as they found them
        shape = f"B=16 C={c} H={h} W={w} bfloat16 (cluster {plan.cluster})"
        saved = {n: ms["full"] - ms[n] for n in ABLATIONS}
        print(f"[split] {shape}, {sites} a step: "
              + ", ".join(f"{n} {v:.4f}" for n, v in ms.items()) + " ms; saved: "
              + ", ".join(f"{n} {v:.4f}" for n, v in saved.items())
              + "; dx vs plain (x the limit) "
              + ", ".join(f"{n} {v:.3g}" for n, v in errs.items()),
              flush=True)
        rows.append(dict(shape=shape, sites_per_step=sites, ms=ms, saved_ms=saved,
                         dx_limit_ratio=errs, bound_ms=cs.gn_bwd_bound(x, 2),
                         plans={n: p._asdict() for n, (_, p) in forms.items()}))
        del x, dy
    step = {n: sum(r["sites_per_step"] * r["ms"][n] for r in rows) for n in rows[0]["ms"]}
    print("[split] summed over the train step's 56 sites: "
          + ", ".join(f"{n} {v:.4f}" for n, v in step.items()) + " ms", flush=True)
    return rows, step


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def epilogue_rows(old, no_pdl, cs):
    import torch

    from polyffusion_tpu_torch.config import load_params
    from polyffusion_tpu_torch.diffusion.sampler import _epilogue_scalars
    from polyffusion_tpu_torch.diffusion.schedule import make_schedule
    from polyffusion_tpu_torch.ops.repaint_epilogue import (
        fused_repaint_epilogue,
        repaint_epilogue_reference,
    )

    vp = ctypes.c_void_p
    for lib in (old, no_pdl):
        lib.repaint_epilogue.argtypes = [vp] * 7 + [ctypes.c_longlong] + [ctypes.c_float] * 7 + [vp]
        lib.repaint_epilogue.restype = ctypes.c_int
    cfg = load_params("sdf_chd8bar")
    scalars = _epilogue_scalars(make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end), 500)
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for b in EPI_BATCHES:
        shape = (b, 2, 128, 128)
        x, p_noise, q_noise, e_u, e_c = (torch.randn(shape, device="cuda", generator=g)
                                         for _ in range(5))
        orig = (torch.rand(shape, device="cuda", generator=g) < 0.05).float()
        mask = (torch.rand(shape, device="cuda", generator=g) < 0.5).float()

        def direct(lib, eps):
            out = torch.empty_like(x)
            err = lib.repaint_epilogue(x.data_ptr(), eps.data_ptr(), p_noise.data_ptr(),
                                       orig.data_ptr(), q_noise.data_ptr(), mask.data_ptr(),
                                       out.data_ptr(), x.numel(), *scalars,
                                       torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"epilogue: cudaError {err}")
            return out

        def combine():
            return e_u + cs.CLI_CFG_SCALE * (e_c - e_u)

        eps = combine()
        forms = {"new": lambda e: fused_repaint_epilogue(x, e, p_noise, orig, q_noise, mask,
                                                         scalars),
                 "new_without_pdl": lambda e: direct(no_pdl, e),
                 "old": lambda e: direct(old, e)}
        want = repaint_epilogue_reference(x, eps, p_noise, orig, q_noise, mask, scalars)
        errs = {}
        for name, fn in forms.items():
            torch.cuda.synchronize()
            torch.cuda._sleep(10_000_000)
            got = fn(combine())  # queued behind the combine, as in the sampler
            torch.cuda.synchronize()
            errs[name] = cs.limit_ratio(got, want, cs.EPI_ATOL, cs.EPI_RTOL)
        fns = {n: (lambda f: lambda: f(eps))(f) for n, f in forms.items()}
        fns.update({f"pair_{n}": (lambda f: lambda: f(combine()))(f) for n, f in forms.items()})
        fns["combine"] = combine
        ms = cs.time_in_turns(fns)
        row = dict(shape=f"B={b} C=2 H=128 W=128 float32", ms=ms, limit_ratio=errs,
                   bound_ms=7 * x.numel() * 4 / cs.HBM_BYTES_PER_S * 1e3)
        print(f"[epilogue] {row['shape']}: " + ", ".join(f"{n} {v:.4f}" for n, v in ms.items())
              + f" ms; bound {row['bound_ms']:.5f}; vs plain (x the limit) "
              + ", ".join(f"{n} {v:.3g}" for n, v in errs.items()), flush=True)
        rows.append(row)
    return rows


def host_cost() -> dict:
    """The epilogue wrapper's host microseconds per call at batch 2, in the
    package this process imports (``--host``)."""
    import torch

    from polyffusion_tpu_torch.ops.repaint_epilogue import fused_repaint_epilogue
    from polyffusion_tpu_torch.profile_attention import _host_and_device

    shape = (2, 2, 128, 128)
    t = [torch.randn(shape, device="cuda") for _ in range(6)]
    scalars = [1.0, 0.5, 0.25, 0.125, 0.1, 0.9, 0.2]
    rows = [_host_and_device(lambda: fused_repaint_epilogue(*t, scalars)) for _ in range(3)]
    return dict(host_us_per_call=sorted(r[0] for r in rows)[1],
                device_ms_per_call=sorted(r[1] for r in rows)[1])


def train_profile() -> None:
    """This checkout's ``profile_train.py`` run on the package this process
    imports (``--train``): its last line is the JSON this script reads."""
    spec = importlib.util.spec_from_file_location("polyffusion_tpu_torch._profile_train_cmp",
                                                  PROFILE_TRAIN)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    mod.main()


def in_tree(tree: str, mode: str) -> dict:
    """Runs this script with ``mode`` in a process that imports ``tree``'s
    package; returns its last line."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__), mode], cwd=tree,
                         env={**os.environ, "PYTHONPATH": tree}, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"{mode} in {tree} failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the checkout with the earlier designs")
    ap.add_argument("--json", default=None)
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels only (no host costs, no train steps)")
    ap.add_argument("--split", action="store_true",
                    help="also time ablated builds of kernel 6 (where its time goes)")
    ap.add_argument("--host", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--train", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gn_bwd_epilogue_designs: no CUDA device", file=sys.stderr)
        return 1
    if args.host:
        print(json.dumps(host_cost()))
        return 0
    if args.train:
        train_profile()
        return 0
    if not args.parent:
        ap.error("--parent is required")
    parent = os.path.abspath(args.parent)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from polyffusion_tpu_torch.device import tf32
    from polyffusion_tpu_torch.ops import _build

    tf32(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    old_csrc = os.path.join(parent, "polyffusion_tpu_torch", "ops", "csrc")
    epi = open(os.path.join(CSRC, "repaint_epilogue.cu")).read()
    if PDL_ON not in epi:
        raise SystemExit(f"repaint_epilogue.cu has no {PDL_ON!r} to switch off")
    builders = [subprocess.Popen([sys.executable, "-c",
                                  "from polyffusion_tpu_torch.ops import _build; _build.build()"],
                                 cwd=tree) for tree in (parent, ROOT)]
    libs = build({"gn_bwd_old": (open(os.path.join(old_csrc, "gn_bwd.cu")).read(), old_csrc),
                  "epilogue_old": (open(os.path.join(old_csrc, "repaint_epilogue.cu")).read(),
                                   old_csrc),
                  "epilogue_no_pdl": (epi.replace(PDL_ON, PDL_ON[:-1] + "0"), CSRC)})
    if any(p.wait() != 0 for p in builders):
        raise SystemExit("building a checkout's kernels failed")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs["gn_bwd_old"].gn_bwd.argtypes = [vp] * 8 + [ci] * 5 + [vp]
    libs["gn_bwd_old"].gn_bwd.restype = ci
    _build.build_all()
    gn_rows, gn_step = gn_bwd_rows(libs["gn_bwd_old"], cs)
    line = dict(card=smi, parent=parent, launch_floor_ms=cs.launch_floor(), gn_bwd=gn_rows,
                gn_bwd_per_step_ms=gn_step,
                epilogue=epilogue_rows(libs["epilogue_old"], libs["epilogue_no_pdl"], cs))
    if args.split:
        line["gn_bwd_split"], line["gn_bwd_split_per_step_ms"] = split_rows(cs, libs["gn_bwd_old"])
    order = [("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)]
    if args.kernels_only:
        order = []
    line["host"] = [dict(tree=n, **in_tree(t, "--host")) for n, t in order]
    for r in line["host"]:
        print(f"[host] epilogue wrapper, {r['tree']}: {r['host_us_per_call']:.2f} us per call",
              flush=True)
    line["train"] = [dict(tree=n, **in_tree(t, "--train")) for n, t in order]
    for r in line["train"]:
        print(f"[train] {r['tree']}: step {r['step_ms']:.3f} ms (events), {r['wall_ms']:.3f} "
              f"host; {r['kernels_per_step']:.1f} device kernels a step; kernel 6 "
              f"{r['gn_bwd_ms_per_step']:.4f} ms over {r['gn_bwd_launches_per_step']:.1f} launches",
              flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(line, fh, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
