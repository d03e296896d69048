"""Maintenance tools and corpus converters (JAX ``tools.py``).

    python -m polyffusion_tpu_torch.tools pop909_import --origin <POP09-PIANOROLL-4-bin> \
        --out <npz dir>
    python -m polyffusion_tpu_torch.tools synth_corpus --out <npz dir> [--n_songs 64]
        [--n_bars 32] [--seed 0] [--vary_texture]
    python -m polyffusion_tpu_torch.tools cleanup_checkpoints --result_dir result [--yes]
    python -m polyffusion_tpu_torch.tools remove_from_split --split <pickle> --song <fn>.npz

Counterparts of the reference's ``data/polydis_format_to_mine.py``,
``cleanup_checkpoints.py`` and ``remove_pickle.py``, and a synthetic corpus
with exact chord labels. Host only: nothing here touches a device.
"""

from __future__ import annotations

import argparse
import os
import pickle
import re
import shutil

import numpy as np

BIN = 4
BEAT = 4
SEG_LGTH = 32


# ---------------------------------------------------------------------------
# POP909 piano-roll release -> npz (reference data/polydis_format_to_mine.py)
# ---------------------------------------------------------------------------


def _track_note_matrix(mats) -> list:
    """(onset_beat, onset_bin, bin, offset_beat, offset_bin, bin, pitch, vel) rows."""
    notes = []
    for mat in mats:
        assert mat[2] == mat[5] == BIN
        onset = int(mat[0]) * BIN + int(mat[1])
        offset = int(mat[3]) * BIN + int(mat[4])
        dur = offset - onset
        if dur > 0:
            notes.append([onset, int(mat[6]), dur, int(mat[7]), 0])
    notes.sort(key=lambda x: (x[0], x[1], x[2]))
    return notes


def _downbeats_from_beat_table(beats) -> tuple:
    """beat rows: [..., ..., ..., in-bar position, ...]; position 0 = downbeat."""
    db_pos = [i * BIN for i, beat in enumerate(beats) if beat[3] == 0]
    db_filter = []
    for idx, db in enumerate(db_pos):
        ok = (
            idx + (SEG_LGTH / BEAT) <= len(db_pos)
            and db_pos[idx + 1] - db == BEAT * BIN
        )
        db_filter.append(bool(ok))
    return db_pos, db_filter


def _start_table(notes, db_pos) -> dict:
    row = 0
    table = {}
    for db in db_pos:
        while row < len(notes) and notes[row][0] < db:
            row += 1
        table[db] = row
    return table


def pop909_import(origin_dir: str, out_dir: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for piece in sorted(os.listdir(origin_dir)):
        if not piece.endswith(".npz"):
            continue
        f = np.load(os.path.join(origin_dir, piece), allow_pickle=True)
        tracks = [_track_note_matrix(f[name]) for name in ("melody", "bridge", "piano")]
        all_notes = [row for t in tracks for row in t]
        all_notes.sort(key=lambda x: (x[0], x[1], x[2]))
        db_pos, db_filter = _downbeats_from_beat_table(f["beat"])
        np.savez(
            os.path.join(out_dir, piece),
            notes=np.array([np.array(t) for t in tracks], dtype=object),
            start_table=np.array(
                [_start_table(t, db_pos) for t in tracks], dtype=object
            ),
            db_pos=np.array(db_pos),
            db_pos_filter=np.array(db_filter),
            chord=f["chord"],
        )
        n += 1
    print(f"imported {n} songs -> {out_dir}")
    return n


# ---------------------------------------------------------------------------
# synthetic harmonic corpus (control-fidelity training data)
# ---------------------------------------------------------------------------

# diatonic degree -> (semitone offset, quality) in a major key; V7 for color
_MAJOR_DEGREES = [
    (0, "maj"), (2, "min"), (4, "min"), (5, "maj"), (7, "maj"), (9, "min"),
    (7, "7"), (0, "maj7"), (9, "min7"),
]
# common pop progressions over the degree list above (indices)
_PROGRESSIONS = [
    [0, 4, 5, 3], [0, 5, 3, 4], [1, 4, 0, 0], [0, 3, 4, 0],
    [5, 3, 0, 4], [0, 7, 1, 6], [0, 8, 3, 4],
]
_QUALITY_TONES = {
    "maj": (0, 4, 7), "min": (0, 3, 7), "7": (0, 4, 7, 10),
    "maj7": (0, 4, 7, 11), "min7": (0, 3, 7, 10),
}

# per-song texture archetypes (``vary_texture=True``): every combination is a
# distinct rhythm skeleton / density, while every note stays a chord tone —
# between-song texture variance is what ``expr --type txt_acc`` needs to
# detect (with the default homogeneous corpus, matched and shuffled pairings
# score identically and the metric is blind)
_MELODY_STYLES = {  # (onset step within bar, duration) lists, 16 bins/bar
    "eighth_arp": [(2 * k, 2) for k in range(8)],
    "sixteenth_run": [(k, 1) for k in range(16)],
    "quarter": [(4 * k, 4) for k in range(4)],
    "sparse_long": [(0, 8), (8, 8)],
    "syncopated": [(0, 2), (3, 1), (6, 2), (10, 2), (14, 2)],
}
_COMP_STYLES = {  # beats (4 per bar) carrying a block chord, with duration
    "beats_1_3": [(0, 8), (2, 8)],
    "every_beat": [(0, 4), (1, 4), (2, 4), (3, 4)],
    "offbeats": [(1, 4), (3, 4)],
    "sustained": [(0, 16)],
    "none": [],
}
_BASS_STYLES = {  # (onset step, duration, octave offset) per bar
    "half_bar": [(0, 8, 0), (8, 8, 12)],
    "quarter_pulse": [(0, 4, 0), (4, 4, 0), (8, 4, 12), (12, 4, 0)],
    "whole_bar": [(0, 16, 0)],
}


def synth_corpus(
    out_dir: str,
    n_songs: int = 64,
    n_bars: int = 32,
    seed: int = 0,
    vary_texture: bool = False,
):
    """Write a synthetic corpus with REAL harmonic structure: every note is a
    chord tone of a labeled diatonic progression, so chord conditioning is
    perfectly learnable and the chord matrices are exact ground truth.

    Song = random key + random common progressions, one chord per bar.
    Tracks mirror POP909's (melody, bridge, piano): arpeggiated chord-tone
    melody, beat-wise block chords, half-bar bass roots.  Used to train the
    chord-conditioned model whose control fidelity ``expr --type chd_acc``
    measures (the reference paper's quality metric, on data this environment
    can actually provide).

    ``vary_texture=True``: each song additionally draws a texture archetype
    (melody rhythm x comping pattern x bass pulse, 75 combinations) so rhythm
    skeleton and density VARY between songs — required for the texture
    control-fidelity sweep (``expr --type txt_acc``), whose shuffled-pair
    chance floor is only meaningful when textures differ across the corpus.
    """
    from .chord.encode import encode_to_absolute_row
    from .chord.templates import NUM_TO_ABS_SCALE
    from .data.dataset import write_song_npz

    os.makedirs(out_dir, exist_ok=True)
    for song_i in range(n_songs):
        rng = np.random.default_rng(seed + song_i)
        key = int(rng.integers(0, 12))
        chords = []  # one (root_pc, quality) per bar
        while len(chords) < n_bars:
            prog = _PROGRESSIONS[int(rng.integers(0, len(_PROGRESSIONS)))]
            for deg in prog:
                off, quality = _MAJOR_DEGREES[deg]
                chords.append(((key + off) % 12, quality))
        chords = chords[:n_bars]

        if vary_texture:
            mel_pat = list(_MELODY_STYLES.values())[
                int(rng.integers(0, len(_MELODY_STYLES)))
            ]
            comp_pat = list(_COMP_STYLES.values())[
                int(rng.integers(0, len(_COMP_STYLES)))
            ]
            bass_pat = list(_BASS_STYLES.values())[
                int(rng.integers(0, len(_BASS_STYLES)))
            ]
        else:
            mel_pat = _MELODY_STYLES["eighth_arp"]
            comp_pat = _COMP_STYLES["beats_1_3"]
            bass_pat = _BASS_STYLES["half_bar"]

        melody, bridge, bass = [], [], []
        for bar, (root, quality) in enumerate(chords):
            t0 = bar * 16  # 16 sixteenth-bins per bar
            tones = _QUALITY_TONES[quality]
            # melody: chord-tone line in octave 5, rhythm from the style
            order = rng.permutation(len(tones))
            for k, (step, dur) in enumerate(mel_pat):
                pitch = 72 + root % 12 + tones[order[k % len(tones)]]
                melody.append([t0 + step, int(pitch), dur, 90, 0])
            # bridge: block chords in octave 4, comping pattern from the style
            for beat, dur in comp_pat:
                for iv in tones:
                    bridge.append([t0 + 4 * beat, 60 + root + iv, dur, 80, 0])
            # bass: roots in octave 2/3, pulse from the style
            for step, dur, oct_off in bass_pat:
                bass.append([t0 + step, 36 + root + oct_off, dur, 85, 0])

        rows = []
        for root, quality in chords:
            label = f"{NUM_TO_ABS_SCALE[root]}:{quality}"
            rows.extend([encode_to_absolute_row(label)] * 4)  # 4 beats per bar
        chord_mat = np.array(rows, dtype=np.float32)

        n_bins = n_bars * 16
        db_pos = np.arange(0, n_bins, 16)
        filt = db_pos + 128 <= n_bins
        tracks = [
            np.array(t, dtype=np.int64).reshape(-1, 5)  # empty -> (0, 5)
            for t in (melody, bridge, bass)
        ]
        write_song_npz(
            os.path.join(out_dir, f"synth_{song_i:03d}.npz"),
            tracks, chord_mat, db_pos, filt, n_beats=n_bars * 4,
        )
    print(f"wrote {n_songs} synthetic songs ({n_bars} bars each) -> {out_dir}")
    return n_songs


# ---------------------------------------------------------------------------
# run-dir pruning (reference cleanup_checkpoints.py)
# ---------------------------------------------------------------------------


def has_checkpoint(ckpt_dir: str) -> bool:
    """Whether a run's ``chkpts/`` holds a saved checkpoint: the JAX trainer's
    step directories or ``last/``, or the port's ``last.pt`` or
    ``step_<n>.pt``."""
    return os.path.isdir(ckpt_dir) and any(
        e.isdigit() or e in ("last", "last.pt") or re.fullmatch(r"step_\d+\.pt", e)
        for e in os.listdir(ckpt_dir)
    )


def cleanup_checkpoints(result_dir: str, assume_yes: bool = False) -> list:
    """Remove run dirs without any saved checkpoint; interactive unless --yes."""
    removed = []
    for group in sorted(os.listdir(result_dir)):
        gpath = os.path.join(result_dir, group)
        if not os.path.isdir(gpath):
            continue
        for item in sorted(os.listdir(gpath)):
            run = os.path.join(gpath, item)
            if not has_checkpoint(os.path.join(run, "chkpts")):
                if assume_yes or input(f"Remove {run} (y/n)? ") == "y":
                    shutil.rmtree(run)
                    removed.append(run)
    print(f"removed {len(removed)} empty run dir(s)")
    return removed


# ---------------------------------------------------------------------------
# split surgery (reference remove_pickle.py)
# ---------------------------------------------------------------------------


def remove_from_split(split_path: str, song_fn: str) -> None:
    with open(split_path, "rb") as f:
        split = pickle.load(f)
    assert song_fn in split[0] or song_fn in split[1], f"{song_fn} not in split"
    (split[0] if song_fn in split[0] else split[1]).remove(song_fn)
    with open(split_path, "wb") as f:
        pickle.dump(split, f)
    print(f"removed {song_fn} from {split_path}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("pop909_import")
    p1.add_argument("--origin", required=True)
    p1.add_argument("--out", required=True)
    p2 = sub.add_parser("cleanup_checkpoints")
    p2.add_argument("--result_dir", default="result")
    p2.add_argument("--yes", action="store_true")
    p3 = sub.add_parser("remove_from_split")
    p3.add_argument("--split", required=True)
    p3.add_argument("--song", required=True)
    p4 = sub.add_parser("synth_corpus")
    p4.add_argument("--out", required=True)
    p4.add_argument("--n_songs", type=int, default=64)
    p4.add_argument("--n_bars", type=int, default=32)
    p4.add_argument("--seed", type=int, default=0)
    p4.add_argument("--vary_texture", action="store_true",
                    help="per-song texture archetypes (for expr --type txt_acc)")
    args = p.parse_args(argv)
    if args.cmd == "pop909_import":
        pop909_import(args.origin, args.out)
    elif args.cmd == "cleanup_checkpoints":
        cleanup_checkpoints(args.result_dir, args.yes)
    elif args.cmd == "remove_from_split":
        remove_from_split(args.split, args.song)
    elif args.cmd == "synth_corpus":
        synth_corpus(args.out, args.n_songs, args.n_bars, args.seed,
                     vary_texture=args.vary_texture)


if __name__ == "__main__":
    main()
