"""Batch evaluation harness over the validation split (counterpart of the JAX
package's ``expr.py``; reference ``expr.py``).

Experiment types:
    uncond     unconditional prompt generation + prmat2c integrity check
    inp_below  accompaniment arrangement: inpaint below the melody (melody track only)
    inp_bars   inpaint bars 2-5 of each 8-bar segment, emit the inpainted middle
    chd        chord-conditioned generation (saves the conditioning chords too)
    txt        texture-conditioned generation (saves the conditioning originals)
    chd_acc    chord CONTROL-FIDELITY sweep: generate at --scales, recognize
               chords back from the output, score vs the conditioning with the
               mir_eval comparison surface (majmin/triads/root/mirex + seg)
    txt_acc    texture CONTROL-FIDELITY sweep: generate at --scales, score the
               output's rhythm skeleton / density profile / texture embedding
               against the conditioning source (+ shuffled-pair chance floors)
    pnt_acc    pnotree CONTROL-FIDELITY sweep: generate at --scales, score the
               output's exact note cells / rhythm skeleton against the
               conditioning source (+ shuffled-pair chance floors)
    fd         Fréchet-distance SAMPLE-QUALITY sweep: generate at --scales,
               report FD(generated set, real val set) in a hand-crafted
               descriptor space (+ the texture-encoder embedding space when
               the checkpoint carries one), with an estimator noise-floor row

    python -m polyffusion_tpu_torch.expr --chkpt_path <run dir> --data_dir <npz dir> \\
        --type uncond --batch_num 10 --output_dir exp [--device cpu]

The JAX harness traces the CFG scale into one compiled sampler for the
sweeps, which then runs the double-batched CFG pass at every scale; the
port's sampler (``diffusion/sampler.py:make_eps_fn``) runs one pass at scales
0 and 1. Both compute the same guidance up to float rounding. Runs on the
GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from .chord.eval import evaluate
from .chord.labels import beat_labels_to_intervals, labels_from_chord_matrix
from .chord.recognizer import transcribe_midi
from .config import load_params
from .data import BatchLoader, SegmentDataset
from .inference import InferenceSession, build_task_for_inference, load_unet_params
from .utils.midi_io import prmat2c_to_midi_file
from .utils.reprs import check_prmat2c_integrity, onehot_to_chd, prmat2c_to_prmat


def _batches(data_dir, batch_size, num, use_track=(0, 1, 2), split_file=None):
    if split_file:
        _, val_ds = SegmentDataset.train_val_from_split(data_dir, split_file, use_track)
    else:
        _, val_ds = SegmentDataset.train_val_from_dir(data_dir, 0.9, use_track)
    dl = BatchLoader(val_ds, batch_size, augment=False, shuffle=False, drop_last=True)
    for i, batch in enumerate(dl):
        if i >= num:
            return
        yield batch


@torch.inference_mode()
def _encoded(encode, x, dtype=torch.float32) -> np.ndarray:
    """A frozen encoder's output on host array ``x``, as fp32 NumPy."""
    return encode(torch.as_tensor(np.asarray(x), dtype=dtype)).float().cpu().numpy()


def _full_cond(task, batch) -> np.ndarray:
    """Complete conditioning vector for generation per ``task.cond_type`` (no
    CFG dropout) — the control-fidelity sweeps must feed a ``chord+txt`` model
    BOTH halves (d_cond = chd z + txt z), not just the axis under test."""
    if task.cond_type == "chord":
        return _encoded(task.encode_chord, batch.chord)
    if task.cond_type == "txt":
        return _encoded(task.encode_txt, batch.prmat)
    if task.cond_type == "chord+txt":
        zchd = _encoded(task.encode_chord, batch.chord)
        ztxt = _encoded(task.encode_txt, batch.prmat)
        return np.concatenate([zchd, ztxt], axis=-1)
    if task.cond_type == "pnotree":
        return _encoded(task.encode_pnotree, batch.pnotree, torch.int64)
    raise NotImplementedError(task.cond_type)


def _scales(args):
    return [float(s) for s in args.scales.split(",")]


def _write_json(args, name: str, obj) -> str:
    out = os.path.join(args.output_dir, name)
    with open(out, "w") as f:
        json.dump(obj, f, indent=1)
    return out


def prompt_generation(session, task, args, check_integrity=True):
    gen = []
    for batch in _batches(args.data_dir, args.batch_size, args.batch_num, split_file=args.split_file):
        x0 = session.predict(
            np.zeros((batch.prmat2c.shape[0], 1, task.cfg.d_cond), np.float32),
            uncond_scale=0.0,
        )
        gen.append(x0)
    gen = np.concatenate(gen)
    if check_integrity:
        err = check_prmat2c_integrity(gen)
        print(f"integrity error rate: {err:.4f}")
    prmat2c_to_midi_file(gen, os.path.join(args.output_dir, "uncond.mid"))
    return gen


def acc_arrangement(session, task, args):
    """Inpaint accompaniment below the melody (melody track only, reference :34-49)."""
    gen = []
    for batch in _batches(
        args.data_dir, args.batch_size, args.batch_num, use_track=(0,), split_file=args.split_file
    ):
        cond = np.zeros((batch.prmat2c.shape[0], 1, task.cfg.d_cond), np.float32)
        x0, _ = session.inpaint(batch.prmat2c, "below", cond, uncond_scale=0.0, no_output=True)
        gen.append(x0)
    gen = np.concatenate(gen)
    prmat2c_to_midi_file(gen, os.path.join(args.output_dir, "acc_arr.mid"))
    return gen


def inpaint_bars(session, task, args):
    gen = []
    for batch in _batches(args.data_dir, args.batch_size, args.batch_num, split_file=args.split_file):
        cond = np.zeros((batch.prmat2c.shape[0], 1, task.cfg.d_cond), np.float32)
        x0, _ = session.inpaint(
            batch.prmat2c, "bars", cond, uncond_scale=0.0, bar_list=[2, 3, 4, 5], no_output=True,
        )
        gen.append(x0[:, :, 32:96, :])  # only the inpainted middle bars
    gen = np.concatenate(gen)
    prmat2c_to_midi_file(gen, os.path.join(args.output_dir, "inp_bars.mid"))
    return gen


def chd_conditioning(session, task, args):
    gen, chds = [], []
    for batch in _batches(args.data_dir, args.batch_size, args.batch_num, split_file=args.split_file):
        cond = _encoded(task.encode_chord, batch.chord)
        x0 = session.predict(cond, uncond_scale=args.uncond_scale)
        gen.append(x0)
        chds.append(batch.chord)
    gen = np.concatenate(gen)
    np.save(os.path.join(args.output_dir, f"chd[{args.uncond_scale}].npy"), np.stack(chds))
    prmat2c_to_midi_file(gen, os.path.join(args.output_dir, f"chd_cond[{args.uncond_scale}].mid"))
    return gen


def txt_conditioning(session, task, args):
    gen, orig = [], []
    for batch in _batches(args.data_dir, args.batch_size, args.batch_num, split_file=args.split_file):
        cond = _encoded(task.encode_txt, batch.prmat)
        x0 = session.predict(cond, uncond_scale=args.uncond_scale)
        gen.append(x0)
        orig.append(batch.prmat2c)
    gen, orig = np.concatenate(gen), np.concatenate(orig)
    prmat2c_to_midi_file(gen, os.path.join(args.output_dir, f"txt_cond[{args.uncond_scale}].mid"))
    prmat2c_to_midi_file(orig, os.path.join(args.output_dir, f"txt_orig[{args.uncond_scale}].mid"))
    return gen


def _recognize_segment(prmat2c_sample: np.ndarray):
    """(2, 128, 128) generated image -> (est_intervals, est_labels): write one
    8-bar MIDI (16 s at 120 bpm) and run the chord recognizer over it."""
    if not np.rint(prmat2c_sample[0]).any():  # no onsets: nothing to recognize
        return np.array([[0.0, 16.0]]), ["N"]
    with tempfile.NamedTemporaryFile(suffix=".mid", delete=False) as f:
        path = f.name
    try:
        prmat2c_to_midi_file(prmat2c_sample[None], path)
        rows = transcribe_midi(path)
    finally:
        os.unlink(path)
    if not rows:
        return np.array([[0.0, 16.0]]), ["N"]
    return np.array([[r[0], r[1]] for r in rows], float), [r[2] for r in rows]


def _sweep(session, conds, s, n_want):
    """One generation over every batch's conditions at CFG scale ``s``."""
    gen = np.concatenate([session.predict(c, uncond_scale=s) for c in conds])
    if len(gen) != n_want:
        raise RuntimeError(f"generated {len(gen)} samples for {n_want} sources")
    return gen


def chd_acc(session, task, args):
    """CONTROL-FIDELITY metric — the reference paper's headline quality claim
    (chord control accuracy; reference expr.py:86-122 generates, the paper
    scores).  For each CFG scale: generate conditioned on the val split's
    chord progressions, recognize chords from the generated MIDI
    (chord/recognizer.py), and score estimated vs conditioning labels with
    the mir_eval comparison surface (chord/eval.py).  Accuracy rising with
    guidance scale == the conditioning channel is causally steering the
    output.  Writes chd_acc.json and prints a table; scale 0.0 rows are the
    unconditional chance floor."""
    batches = list(
        _batches(args.data_dir, args.batch_size, args.batch_num, split_file=args.split_file)
    )
    refs = []  # per sample: (intervals, labels)
    for batch in batches:
        for chord_onehot in batch.chord:
            labels = labels_from_chord_matrix(onehot_to_chd(np.asarray(chord_onehot)))
            refs.append(beat_labels_to_intervals(labels))

    # conditioning encodings are scale-independent: encode once, not per scale
    conds = [_full_cond(task, b) for b in batches]

    metrics = ("majmin", "triads", "root", "mirex", "seg")
    table = {}
    for s in _scales(args):
        gen = _sweep(session, conds, s, len(refs))
        scores = {m: [] for m in metrics}
        for sample, (ref_iv, ref_lab) in zip(gen, refs):
            est_iv, est_lab = _recognize_segment(sample)
            res = evaluate(ref_iv, ref_lab, est_iv, est_lab)
            for m in metrics:
                scores[m].append(res[m])
        table[s] = {m: round(float(np.mean(v)), 4) for m, v in scores.items()}
        print(f"scale {s:>4}: " + "  ".join(f"{m}={table[s][m]:.3f}" for m in metrics))

    out = _write_json(args, "chd_acc.json", {"n_samples": len(refs), "scales": table})
    print(f"chord control accuracy table -> {out}")
    return table


def _onset_steps(prmat2c_sample: np.ndarray) -> np.ndarray:
    """(2, n_step, 128) -> (n_step,) onset count per 16th-note step."""
    return np.rint(np.asarray(prmat2c_sample[0], np.float32)).clip(0, 1).sum(-1)


# bass / mid / high register split for the rhythm skeleton: a fully
# pitch-collapsed onset-step set SATURATES on onset-dense outputs (a melody
# moving in 16ths puts an onset at every step, making F1 a function of the
# source alone, and means over a permuted multiset are invariant).  Banding
# keeps 'does the COMPING/BASS hit at step t' pairing-sensitive.
_F1_BANDS = ((0, 54), (54, 72), (72, 128))


def _banded_onsets(prmat2c_sample: np.ndarray) -> np.ndarray:
    """(2, n_step, 128) -> (n_step, 3) bool: any onset in band at step."""
    on = np.rint(np.asarray(prmat2c_sample[0], np.float32)).clip(0, 1)
    return np.stack([on[:, lo:hi].sum(-1) > 0 for lo, hi in _F1_BANDS], axis=-1)


def onset_step_f1(gen: np.ndarray, src: np.ndarray) -> float:
    """F1 between the (step x register-band) onset cells of two prmat2c
    images — 'does a note start at step t in the bass/mid/high register' —
    the rhythm-skeleton agreement."""
    g = _banded_onsets(gen)
    s = _banded_onsets(src)
    tot = float(g.sum() + s.sum())
    if tot == 0:
        return 1.0
    return float(2.0 * np.logical_and(g, s).sum() / tot)


def density_corr(gen: np.ndarray, src: np.ndarray) -> float:
    """Pearson r between per-step onset COUNTS (texture density profile);
    0.0 when either profile is constant (correlation undefined)."""
    g, s = _onset_steps(gen), _onset_steps(src)
    if g.std() == 0 or s.std() == 0:
        return 0.0
    return float(np.corrcoef(g, s)[0, 1])


def _cosine_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return num / np.maximum(den, 1e-9)


def _derangement(n: int, seed: int) -> np.ndarray:
    """A permutation of n that moves every index (when n > 1)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    while n > 1 and np.any(perm == np.arange(n)):
        perm = rng.permutation(n)
    return perm


def _txt_emb(task, prmat) -> np.ndarray:
    return _encoded(task.encode_txt, np.asarray(prmat, np.float32))[:, 0]


def txt_acc(session, task, args):
    """Texture CONTROL-FIDELITY sweep — the reference paper's second control
    axis (texture/rhythm conditioning; generation counterpart reference
    expr.py:124-160).  For each CFG scale, generate conditioned on the val
    split's textures and score the output against the conditioning SOURCE:

      onset_f1   rhythm-skeleton F1 (register-banded onset steps)
      dens_corr  Pearson r of the per-step onset-count profiles
      txt_cos    cosine between the model's own texture embeddings
                 (task.encode_txt) of generated vs source

    plus *_shuf columns: the same metrics against a SHUFFLED pairing of
    sources — the chance floor.  Metric rising with scale while the shuffled
    column stays flat == the texture channel causally steers the output.
    Writes txt_acc.json."""
    batches = list(
        _batches(args.data_dir, args.batch_size, args.batch_num, split_file=args.split_file)
    )
    srcs = np.concatenate([np.asarray(b.prmat2c) for b in batches])
    src_emb = np.concatenate([_txt_emb(task, b.prmat) for b in batches])
    perm = _derangement(len(srcs), args.seed)

    # conditioning encodings are scale-independent: encode once, not per scale
    conds = [_full_cond(task, b) for b in batches]

    table = {}
    for s in _scales(args):
        gen = _sweep(session, conds, s, len(srcs))
        gen_emb = _txt_emb(task, prmat2c_to_prmat(gen, n_step=gen.shape[2]))
        row = {
            "onset_f1": np.mean([onset_step_f1(g, t) for g, t in zip(gen, srcs)]),
            "onset_f1_shuf": np.mean([onset_step_f1(g, t) for g, t in zip(gen, srcs[perm])]),
            "dens_corr": np.mean([density_corr(g, t) for g, t in zip(gen, srcs)]),
            "dens_corr_shuf": np.mean([density_corr(g, t) for g, t in zip(gen, srcs[perm])]),
            "txt_cos": np.mean(_cosine_rows(gen_emb, src_emb)),
            "txt_cos_shuf": np.mean(_cosine_rows(gen_emb, src_emb[perm])),
        }
        table[s] = {k: round(float(v), 4) for k, v in row.items()}
        print(f"scale {s:>4}: " + "  ".join(f"{k}={table[s][k]:.3f}" for k in row))

    out = _write_json(args, "txt_acc.json", {"n_samples": len(srcs), "scales": table})
    print(f"texture control accuracy table -> {out}")
    return table


def note_cell_f1(gen: np.ndarray, src: np.ndarray) -> float:
    """Exact (step x pitch) onset-cell F1 between two prmat2c images — 'does
    THIS pitch start at THIS step'.  Unlike the register-banded rhythm F1,
    exact pitch identity cannot saturate on onset-dense outputs, which is what
    the pnotree condition (a full note-content encoding) is supposed to pin."""
    g = np.rint(np.asarray(gen[0], np.float32)).clip(0, 1)
    s = np.rint(np.asarray(src[0], np.float32)).clip(0, 1)
    tot = float(g.sum() + s.sum())
    if tot == 0:
        return 1.0
    return float(2.0 * (g * s).sum() / tot)


def pnt_acc(session, task, args):
    """Pnotree CONTROL-FIDELITY sweep (beyond-reference metric; the reference
    trains the pnotree cond_type, ``model_sdf.py:138-151``, but its eval
    harness has no quantitative control metric for it).  The pnotree z encodes
    the conditioning segment's EXACT note content, so with rising CFG scale
    the generation should reproduce the source's notes.  For each scale,
    score generated vs conditioning-source prmat2c:

      note_f1    exact (step x pitch) onset-cell F1
      onset_f1   register-banded rhythm-skeleton F1 (same as txt_acc)

    plus *_shuf chance floors against a shuffled pairing.  Writes pnt_acc.json."""
    if task.cond_type != "pnotree":
        raise ValueError(f"pnt_acc needs a pnotree-conditioned checkpoint, got {task.cond_type}")
    batches = list(
        _batches(args.data_dir, args.batch_size, args.batch_num, split_file=args.split_file)
    )
    srcs = np.concatenate([np.asarray(b.prmat2c) for b in batches])
    perm = _derangement(len(srcs), args.seed)

    conds = [_full_cond(task, b) for b in batches]

    table = {}
    for s in _scales(args):
        gen = _sweep(session, conds, s, len(srcs))
        row = {
            "note_f1": np.mean([note_cell_f1(g, t) for g, t in zip(gen, srcs)]),
            "note_f1_shuf": np.mean([note_cell_f1(g, t) for g, t in zip(gen, srcs[perm])]),
            "onset_f1": np.mean([onset_step_f1(g, t) for g, t in zip(gen, srcs)]),
            "onset_f1_shuf": np.mean([onset_step_f1(g, t) for g, t in zip(gen, srcs[perm])]),
        }
        table[s] = {k: round(float(v), 4) for k, v in row.items()}
        print(f"scale {s:>4}: " + "  ".join(f"{k}={table[s][k]:.3f}" for k in row))

    out = _write_json(args, "pnt_acc.json", {"n_samples": len(srcs), "scales": table})
    print(f"pnotree control accuracy table -> {out}")
    return table


# ---------------------------------------------------------------------------
# Fréchet distance (sample-QUALITY metric, beyond reference)
#
# The control-fidelity sweeps above score each generation against ITS OWN
# conditioning source: they measure steering, not realism.  The Fréchet
# distance between the generated SET and the real SET (the FID/FAD recipe:
# fit Gaussians in a feature space, closed-form 2-Wasserstein) measures
# distributional match instead.
# ---------------------------------------------------------------------------


def _psd_sqrtm(a: np.ndarray) -> np.ndarray:
    """Symmetric PSD matrix square root via eigh (no scipy dependency);
    negative eigenvalues from floating-point noise are clipped to zero."""
    w, v = np.linalg.eigh((a + a.T) / 2.0)
    return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """Squared Fréchet (2-Wasserstein) distance between two Gaussians:
    |mu1-mu2|^2 + tr(C1 + C2 - 2 (C1^1/2 C2 C1^1/2)^1/2).  Estimates from n
    samples are biased upward at small n — compare configs at EQUAL n only
    (the ``real_split`` row in fd() measures that noise floor directly)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.asarray(cov1, np.float64), np.asarray(cov2, np.float64)
    s1h = _psd_sqrtm(cov1)
    mean_term = float(((mu1 - mu2) ** 2).sum())
    cov_term = float(
        np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(_psd_sqrtm(s1h @ cov2 @ s1h))
    )
    return max(mean_term + cov_term, 0.0)


def _gaussian_stats(feats: np.ndarray):
    f = np.asarray(feats, np.float64)
    return f.mean(0), np.cov(f, rowvar=False)


def _knn_radii(x: np.ndarray, k: int) -> np.ndarray:
    """Distance from each row to its k-th nearest OTHER row (the manifold
    radius estimate of Kynkäänniemi et al.)."""
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    k = min(k, len(x) - 1)
    return np.sqrt(np.partition(d2, k - 1, axis=1)[:, k - 1])


def precision_recall(real: np.ndarray, gen: np.ndarray, k: int = 3):
    """Improved precision/recall for generative models (Kynkäänniemi et al.
    2019, arXiv:1904.06991): approximate each set's manifold by the union of
    k-NN hyperspheres around its samples, then

      precision  fraction of GENERATED samples inside the real manifold
                 (fidelity: are the samples realistic?)
      recall     fraction of REAL samples inside the generated manifold
                 (coverage: are all the modes produced?)

    Both sets are standardized by the REAL set's per-dim mean/std so
    heterogeneous descriptor scales don't dominate the metric.  Deterministic;
    O(n^2) in the set sizes."""
    real = np.asarray(real, np.float64)
    gen = np.asarray(gen, np.float64)
    if len(real) < 2 or len(gen) < 2:
        raise ValueError("need >= 2 samples per set")
    mu, sd = real.mean(0), np.maximum(real.std(0), 1e-8)
    r = (real - mu) / sd
    g = (gen - mu) / sd
    rr = _knn_radii(r, k)  # (nr,) real manifold radii
    rg = _knn_radii(g, k)  # (ng,) generated manifold radii
    d = np.sqrt(((g[:, None, :] - r[None, :, :]) ** 2).sum(-1))  # (ng, nr)
    precision = float((d <= rr[None, :]).any(axis=1).mean())
    recall = float((d <= rg[:, None]).any(axis=0).mean())
    return precision, recall


def feature_stats(prmat2c: np.ndarray) -> np.ndarray:
    """Hand-crafted per-sample descriptors for the ``stats`` feature space:
    (N, 2, n_step, 128) -> (N, 25) — onset chroma histogram (12), register-band
    onset rates (3), onset-count mean/std (2), sustain/onset mass ratio (1),
    onset-weighted pitch mean/std (2), density-profile autocorrelation at lags
    1/2/4/8/16 (5)."""
    x = np.asarray(prmat2c, np.float32)
    on = np.rint(x[:, 0]).clip(0.0, 1.0)  # (N, S, 128)
    sus = np.rint(x[:, 1]).clip(0.0, 1.0)
    n, s, p = on.shape
    tot = on.sum((1, 2))  # (N,)
    safe = np.maximum(tot, 1.0)

    pitch_mass = on.sum(1)  # (N, 128)
    chroma = pitch_mass.reshape(n, -1, 12).sum(1) if p % 12 == 0 else np.stack(
        [pitch_mass[:, c::12].sum(1) for c in range(12)], axis=1
    )
    chroma = chroma / safe[:, None]

    bands = np.stack(
        [(on[:, :, lo:hi].sum(-1) > 0).mean(1) for lo, hi in _F1_BANDS], axis=1
    )  # (N, 3) fraction of steps with an onset in band

    prof = on.sum(-1)  # (N, S) onset counts per step
    dens_mean = prof.mean(1)
    dens_std = prof.std(1)
    sus_ratio = sus.sum((1, 2)) / safe

    pitches = np.arange(p, dtype=np.float32)
    pmean = (pitch_mass * pitches).sum(1) / safe
    pvar = (pitch_mass * (pitches[None] - pmean[:, None]) ** 2).sum(1) / safe
    pstd = np.sqrt(pvar)

    centered = prof - dens_mean[:, None]
    denom = np.maximum((centered**2).sum(1), 1e-6)
    acorr = np.stack(
        [(centered[:, :-lag] * centered[:, lag:]).sum(1) / denom for lag in (1, 2, 4, 8, 16)],
        axis=1,
    )

    return np.concatenate(
        [
            chroma,
            bands,
            dens_mean[:, None],
            dens_std[:, None],
            sus_ratio[:, None],
            pmean[:, None] / 127.0,
            pstd[:, None] / 127.0,
            acorr,
        ],
        axis=1,
    ).astype(np.float64)


def fd(session, task, args):
    """Fréchet-distance sweep (``expr --type fd``): for each CFG scale,
    generate conditioned on the val split and report FD between the generated
    set and the real val segments, in one or two feature spaces:

      fd_stats   25-dim hand-crafted descriptors (``feature_stats``) — always
                 available, model-free
      fd_emb     the frozen texture-encoder embedding (task.encode_txt), the
                 FID recipe with the domain's own pretrained feature net —
                 only when the checkpoint carries a texture encoder

    Each row also carries improved precision/recall (``precision_recall``:
    prec_* = fidelity, rec_* = coverage) in the same feature space(s).

    Also reports ``real_split``: FD between two disjoint halves of the real
    set — the sampling-noise floor of the estimator at this n.  Writes fd.json."""
    batches = list(
        _batches(args.data_dir, args.batch_size, args.batch_num, split_file=args.split_file)
    )
    if not batches:
        raise ValueError("no val batches — the val split must hold at least --batch_size "
                         "segments (check --data_dir / --split_file / corpus size)")
    real = np.concatenate([np.asarray(b.prmat2c) for b in batches])
    spaces = {"stats": lambda p2c, prm: feature_stats(p2c)}
    has_emb = task.cond_type in ("txt", "chord+txt")
    if has_emb:
        spaces["emb"] = lambda p2c, prm: _txt_emb(task, prm).astype(np.float64)

    real_prmat = np.concatenate([np.asarray(b.prmat, np.float32) for b in batches])
    real_feats = {k: f(real, real_prmat) for k, f in spaces.items()}
    real_stats = {k: _gaussian_stats(v) for k, v in real_feats.items()}

    table = {}
    # estimator noise floor: two disjoint halves of the real set
    h = len(real) // 2
    if h >= 2:
        row = {}
        for k, v in real_feats.items():
            row[f"fd_{k}"] = round(
                frechet_distance(*_gaussian_stats(v[:h]), *_gaussian_stats(v[h : 2 * h])), 4
            )
            pr, rc = precision_recall(v[:h], v[h : 2 * h])
            row[f"prec_{k}"], row[f"rec_{k}"] = round(pr, 4), round(rc, 4)
        table["real_split"] = row
        print("real_split: " + "  ".join(f"{c}={v}" for c, v in row.items()))

    conds = [_full_cond(task, b) for b in batches]
    for s in _scales(args):
        gen = _sweep(session, conds, s, len(real))
        gen_prmat = (
            prmat2c_to_prmat(gen, n_step=gen.shape[2]).astype(np.float32) if has_emb else None
        )
        row = {}
        for k, f in spaces.items():
            gf = f(gen, gen_prmat)
            row[f"fd_{k}"] = round(frechet_distance(*real_stats[k], *_gaussian_stats(gf)), 4)
            pr, rc = precision_recall(real_feats[k], gf)
            row[f"prec_{k}"], row[f"rec_{k}"] = round(pr, 4), round(rc, 4)
        table[s] = row
        print(f"scale {s:>4}: " + "  ".join(f"{c}={v}" for c, v in row.items()))

    out = _write_json(args, "fd.json",
                      {"n_samples": len(real), "table": {str(k): v for k, v in table.items()}})
    print(f"frechet distance table -> {out}")
    return table


EXPERIMENTS = {
    "uncond": prompt_generation,
    "inp_below": acc_arrangement,
    "inp_bars": inpaint_bars,
    "chd": chd_conditioning,
    "txt": txt_conditioning,
    "chd_acc": chd_acc,
    "txt_acc": txt_acc,
    "pnt_acc": pnt_acc,
    "fd": fd,
}


def main(argv=None):
    """The CLI; returns the experiment's result (its generations, or its table)."""
    p = argparse.ArgumentParser(description="batch evaluation harness")
    p.add_argument("--chkpt_path", required=True)
    p.add_argument("--model", default=None)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--split_file", default=None)
    p.add_argument("--type", required=True, choices=sorted(EXPERIMENTS))
    p.add_argument("--batch_num", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--output_dir", default="exp")
    p.add_argument("--uncond_scale", type=float, default=1.0)
    p.add_argument("--scales", default="0,1,3,5",
                   help="chd_acc/txt_acc/pnt_acc/fd: comma-separated CFG scales to sweep")
    p.add_argument("--ddim", action="store_true")
    p.add_argument("--ddim_steps", type=int, default=None,
                   help="tau grid size (default: 50, or a distilled checkpoint's own grid)")
    p.add_argument("--dpmpp", action="store_true",
                   help="DPM-Solver++ sampler on an --ddim_steps-sized tau grid")
    p.add_argument("--dpm_order", type=int, default=2, choices=[1, 2])
    p.add_argument("--repaint_n", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pretrained_dir", default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    run_params = os.path.join(args.chkpt_path, "params.yaml")
    if args.model is None and os.path.isdir(args.chkpt_path) and os.path.exists(run_params):
        cfg = load_params(run_params)
    else:
        cfg = load_params(args.model or "sdf_chd8bar")
    task = build_task_for_inference(cfg, args.pretrained_dir, device=args.device)
    task.load_unet_state(load_unet_params(args.chkpt_path))
    session = InferenceSession(
        task, use_ddim=args.ddim, ddim_steps=args.ddim_steps,
        sampler="dpmpp" if args.dpmpp else None, dpm_order=args.dpm_order,
        repaint_n=args.repaint_n, seed=args.seed, device=args.device,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    result = EXPERIMENTS[args.type](session, task, args)
    print(f"experiment {args.type} done -> {args.output_dir}")
    return result


if __name__ == "__main__":
    main()
