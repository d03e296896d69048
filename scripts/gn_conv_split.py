#!/usr/bin/env python3
"""Where kernel 4's time goes: ablated builds of the fused GroupNorm-SiLU-conv3x3.

    python3 scripts/gn_conv_split.py [--source path/to/gn_silu_conv.cu] [--json out.json]

From the root of a checkout, on one CUDA card. It compiles the source (by
default ``polyffusion_tpu_torch/ops/csrc/gn_silu_conv.cu``) several times, each
time with one part of the bf16 kernel cut out by a text substitution, and
times every build in turns with CUDA events at four batch-128 site shapes of
the UNet. The builds:

- ``full``: the source as it is;
- ``no_products``: the tensor-core products removed (the accumulators stay 0);
- ``no_build``: the patch build removed (x * a + off, SiLU and rounding; the
  products read whatever the patch buffer holds);
- ``no_copies``: the copies of the input (and, where the kernel copies them
  itself, the weights) into shared memory removed;
- ``no_epilogue``: the output stores removed (kept alive behind a test that
  never holds);
- (the wgmma design only) ``no_silu``: the patch build without x * a + off and
  SiLU (the raw input rounded as it is), and ``no_input_loads``: the patch
  build without its loads of x (a constant in their place).

Each part's share is the full time less the time without it. The parts
overlap, so the shares need not add up to the full time; what they say is
how much each part lies on the critical path. The outputs of the ablated
builds are wrong by design; only ``full`` is checked (against the plain
version). The substitutions are listed per kernel design below, keyed by a
string that identifies the design; a source that matches neither is refused,
and an ablation whose text a source lacks is skipped (and said so).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "polyffusion_tpu_torch", "ops", "csrc")
BUILD = os.path.join(ROOT, "polyffusion_tpu_torch", "ops", "build", "split")

# (B, C1, C2, O, H = W, residual)
SHAPES = [(128, 64, 0, 64, 128, True), (128, 64, 0, 64, 128, False),
          (128, 256, 0, 256, 32, True), (128, 64, 64, 64, 128, False)]

# design -> the text that identifies it, the C signature's weight layout, and
# per ablation the (old, new) substitutions
DESIGNS = {
    "mma_sync": dict(
        marker="mma_bf16(acc[mt][nt], af[mt], b0, b1)",
        packed=False,
        ablations={
            "no_products": [
                ("if constexpr (kQuant) mma_s8(acc[mt][nt], af[mt], b0, b1);\n"
                 "            else mma_bf16(acc[mt][nt], af[mt], b0, b1);", ";")],
            "no_build": [("build_patch<T, S>(g, t, c, raw, aff, patch, quant);", "")],
            "no_copies": [("fill_weights<S>(g, t, c, wbuf);", ""),
                          ("fill_input<T>(g, t, c, raw, aff);", "")],
            "no_epilogue": [("store_out<T>(g, t, m, nn, v);",
                             "if (v == 1234.5f) store_out<T>(g, t, m, nn, v);")],
        }),
    "wgmma": dict(
        marker="gn_silu_conv_bf16_wgmma",
        packed=True,
        ablations={
            "no_products": [("issue_tap<S, kN>(acc, pa, ws, tap, nk);", "")],
            "no_build": [("finish_slice<T, S>(g, t, c0, sl, total, raw, aff, patch, quant);", ""),
                         ("finish_slice<T, S>(g, t, ck, tap, total, raw, affn, pb, quant);", "")],
            "no_copies": [("mbar_expect_tx(&full[st], L::kStage); tma_load_chunk(ring + st * "
                           "L::kStage, wmap, &full[st], chunk_at(g, j / 9, L::kCC).cw, t.o0, j % 9);",
                           "mbar_arrive(&full[st]);")],
            "no_silu": [("quant(silu_affine(to_f(st.v[r][j]), a[j % 4], off[j % 4]))",
                         "quant(to_f(st.v[r][j]))")],
            "no_input_loads": [("? src[e * plane]", "? from_f<T>(1.f)")],
            "no_epilogue": [("store_segment<T>(g, t, o, oh, stage + nn * L::kLdSt + r * kTW, bias_v, "
                             "vec, rv[q]);", "if (bias_v == 1234.5f) store_segment<T>(g, t, o, oh, "
                             "stage + nn * L::kLdSt + r * kTW, bias_v, vec, rv[q]);")],
        }),
}


def nvcc() -> str:
    for p in (os.environ.get("CUDA_HOME", "/usr/local/cuda") + "/bin/nvcc", "nvcc"):
        if os.path.exists(p) or p == "nvcc":
            return p
    raise RuntimeError("nvcc not found")


def build_variants(source: str):
    text = open(source).read()
    design = [name for name, d in DESIGNS.items() if d["marker"] in text]
    if len(design) != 1:
        raise SystemExit(f"{source}: no known design (markers {[d['marker'] for d in DESIGNS.values()]})")
    d = DESIGNS[design[0]]
    os.makedirs(BUILD, exist_ok=True)
    variants = {"full": text}
    for name, subs in d["ablations"].items():
        missing = [old for old, _ in subs if old not in text]
        if missing:  # a variant of the design whose text differs there
            print(f"[split] {name} skipped: {missing[0]!r} is not in {source}", flush=True)
            continue
        t = text
        for old, new in subs:
            t = t.replace(old, new)
        variants[name] = t
    procs = {}
    for name, t in variants.items():
        cu = os.path.join(BUILD, f"{design[0]}_{name}.cu")
        with open(cu, "w") as f:
            f.write(t)
        lib = cu[:-3] + ".so"
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-I", CSRC, "-o", lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (p, lib) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return design[0], d["packed"], libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=os.path.join(CSRC, "gn_silu_conv.cu"))
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gn_conv_split: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from polyffusion_tpu_torch.ops.fused_gn_conv import gn_silu_conv3x3_reference

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    design, packed, libs = build_variants(args.source)
    print(f"[split] design {design}: builds {sorted(libs)}", flush=True)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    argtypes = [vp, vp, vp, ci, ci] * 2 + ([vp, ci] if packed else [vp]) + [vp, ci, vp, vp] \
        + [ci] * 5 + [vp]
    for lib in libs.values():
        lib.gn_silu_conv.argtypes = argtypes
        lib.gn_silu_conv.restype = ci
    g = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for b, c1, c2, o, hw, res in SHAPES:
        f = lambda *s: torch.randn(*s, device="cuda", generator=g)  # noqa: E731
        c = c1 + c2
        x = f(b, c1, hw, hw).bfloat16()
        a, off = f(b, c1) * 0.5 + 1, f(b, c1) * 0.3
        x2 = f(b, c2, hw, hw).bfloat16() if c2 else None
        a2, off2 = (f(b, c2) * 0.5 + 1, f(b, c2) * 0.3) if c2 else (None, None)
        w = (f(o, c, 3, 3) * (9 * c) ** -0.5).bfloat16()
        bias = (f(o) * 0.1).bfloat16()
        r = f(b, o, hw, hw).bfloat16() if res else None
        out = torch.empty(b, o, hw, hw, dtype=torch.bfloat16, device="cuda")
        if packed:
            cpad = (c + 15) // 16 * 16
            wk = torch.zeros(9, o, cpad, dtype=torch.bfloat16, device="cuda")
            wk[:, :, :c] = w.permute(2, 3, 0, 1).reshape(9, o, c)
            wargs = [wk.data_ptr(), cpad]
        else:
            wk = w.permute(0, 2, 3, 1).contiguous()
            wargs = [wk.data_ptr()]
        part2 = [x2.data_ptr(), a2.data_ptr(), off2.data_ptr(), c2, c2] if c2 else [None] * 3 + [0, 0]
        call_args = [x.data_ptr(), a.data_ptr(), off.data_ptr(), c1, c1, *part2, *wargs,
                     bias.data_ptr(), 1, r.data_ptr() if res else None, out.data_ptr(), b, hw, hw,
                     o, 1]

        def run(lib):
            err = lib.gn_silu_conv(*call_args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        run(libs["full"])
        want = gn_silu_conv3x3_reference(x, a, off, w, bias, r, x2, a2, off2)
        err = (out.float() - want.float()).abs().max().item()
        names = list(libs)
        samples = {n: [] for n in names}
        for n in names:
            run(libs[n])
        torch.cuda.synchronize()
        for rnd in range(7):
            for n in names if rnd % 2 == 0 else names[::-1]:
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(10_000_000)
                s.record()
                for _ in range(3):
                    run(libs[n])
                e.record()
                torch.cuda.synchronize()
                samples[n].append(s.elapsed_time(e) / 3)
        ms = {n: statistics.median(v) for n, v in samples.items()}
        shape = f"B={b} C={c1}{f'+{c2}' if c2 else ''}->{o} H=W={hw}{' residual' if res else ''}"
        share = {n[3:]: ms["full"] - ms[n] for n in names if n != "full"}
        print(f"[split] {shape}: full {ms['full']:.4f} ms (max_abs_err vs plain {err:.3g}); "
              + ", ".join(f"without {n[3:]} {ms[n]:.4f}" for n in names if n != "full")
              + "; on the critical path: " + ", ".join(f"{k} {v:.4f}" for k, v in share.items()),
              flush=True)
        results.append(dict(shape=shape, ms=ms, critical_ms=share, max_abs_err=err))
        del x, x2, w, wk, r, out, want
    line = {"card": smi, "design": design, "source": os.path.relpath(args.source, ROOT),
            "shapes": results}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(line, fh, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
