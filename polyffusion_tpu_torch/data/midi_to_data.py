"""MIDI file -> training-data dict (notes / start_table / downbeats / chords): a
copy of the JAX package's ``data/midi_to_data.py``.

Counterpart of the reference ``data/midi_to_data.py``: quantize notes to 16th-note
bins, flatten tracks into one note matrix, dedup, run the chord extractor, compute
downbeat positions and the complete-8-beat-run filter, and build the per-bin
start table.  Uses the port's own MIDI reader and chord recognizer instead of
muspy/pretty_midi.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from ..chord.recognizer import (
    chord_matrix_from_chordlab,
    transcribe_midi,
)
from ..utils.midi import MidiFile, TimeSignature, load_midi

ONE_BEAT = 0.5
BIN = 4  # 16th-note bins per beat
SEG_LGTH_BIN = 32 * BIN


def _bins_per_quarter(midi: MidiFile) -> float:
    return BIN / midi.ticks_per_beat


def get_note_matrix(midi: MidiFile, melody_only: bool = False) -> List[List[int]]:
    """Flatten all (non-drum) tracks to rows (onset_bin, pitch, dur_bin, vel, program),
    sorted by (onset, pitch, dur); zero-duration notes dropped (reference :19-47).

    ``melody_only`` drops drums and program >= 113 (reference prepare_data.py:31-52).
    """
    f = _bins_per_quarter(midi)
    rows = []
    for ins in midi.instruments:
        if ins.is_drum:
            continue
        if melody_only and ins.program >= 113:
            continue
        for n in ins.notes:
            onset = int(round(n.start_tick * f))
            end = int(round(n.end_tick * f))
            dur = end - onset
            if dur > 0:
                rows.append([onset, n.pitch, dur, n.velocity, ins.program])
    rows.sort(key=lambda x: (x[0], x[1], x[2]))
    return rows


def dedup_note_matrix(rows: List[List[int]]) -> List[List[int]]:
    """Drop successive rows with equal (onset, pitch) (reference :50-67)."""
    out = []
    last: List[int] = []
    for i, row in enumerate(rows):
        if i == 0 or row[:2] != last[:2]:
            out.append(row)
        last = row
    return out


def get_downbeat_pos_and_filter(midi: MidiFile):
    """Downbeat bin positions + complete-run filter (reference :151-195).

    A downbeat passes the filter iff its bar length is 2, 4 or 8 beats and the
    following bars keep the same length for at least 8 beats total.
    """
    f = _bins_per_quarter(midi)
    sigs = list(midi.time_signatures) or [TimeSignature(4, 4, 0.0, 0)]
    if sigs[0].tick > 0:
        sigs = [TimeSignature(4, 4, 0.0, 0)] + sigs
    end_bin = int(round(midi.max_tick * f))

    db_pos: List[float] = []
    for i, sig in enumerate(sigs):
        seg_start = sig.tick * f
        seg_end = sigs[i + 1].tick * f if i + 1 < len(sigs) else end_bin
        measure = sig.numerator * 4.0 * BIN / sig.denominator  # bins per bar
        if measure <= 0:
            return None, None
        t = seg_start
        while t < seg_end - 1e-9:
            db_pos.append(t)
            t += measure

    for b in db_pos:
        if abs(b - round(b)) > 1e-9:
            return None, None  # fractional barline (reference :163-168)
    db_pos = [int(round(b)) for b in db_pos]

    diffs = np.diff(db_pos).tolist()
    diffs.append(diffs[-1] if diffs else 0)
    db_filter = []
    for i in range(len(db_pos)):
        length = diffs[i]
        if length not in {2 * BIN, 4 * BIN, 8 * BIN}:
            db_filter.append(False)
            continue
        left = 8 * BIN - length
        idx = i + 1
        bad = False
        while left > 0 and idx < len(db_pos):
            if diffs[idx] != length:
                bad = True
                break
            left -= length
            idx += 1
        db_filter.append(not bad)
    return db_pos, db_filter


def get_start_table(rows: List[List[int]], n_bins: int) -> np.ndarray:
    """Array start table: bin -> first note-row index with onset >= bin."""
    onsets = np.array([r[0] for r in rows], dtype=np.int64)
    return np.searchsorted(onsets, np.arange(n_bins + 1))


def force_length_to_8_bars(midi: MidiFile) -> MidiFile:
    """Loop a too-short file until it spans 8 bars (reference prepare_data.py:11-28)."""
    f = _bins_per_quarter(midi)
    end_bin = int(round(midi.max_tick * f))
    if end_bin >= SEG_LGTH_BIN or end_bin == 0:
        return midi
    midi = copy.deepcopy(midi)
    span_ticks = midi.max_tick
    span_sec = midi.get_end_time()
    reps = -(-SEG_LGTH_BIN // end_bin) - 1
    for ins in midi.instruments:
        base = list(ins.notes)
        for k in range(1, reps + 1):
            for n in base:
                ins.notes.append(
                    dataclasses.replace(
                        n,
                        start=n.start + k * span_sec,
                        end=n.end + k * span_sec,
                        start_tick=n.start_tick + k * span_ticks,
                        end_tick=n.end_tick + k * span_ticks,
                    )
                )
    midi.max_tick = span_ticks * (reps + 1)
    return midi


def get_data_for_single_midi(
    fpath: str,
    chdfile_path: Optional[str] = None,
    melody_only: bool = False,
    force_length: bool = False,
) -> Optional[dict]:
    """MIDI -> data dict (reference :219-242). Returns None on downbeat errors.
    The chordlab is written to ``chdfile_path``, or to a temporary file that is
    removed again."""
    midi = load_midi(fpath)
    if not midi.time_signatures:
        midi.time_signatures.append(TimeSignature(4, 4, 0.0, 0))
    if force_length:
        midi = force_length_to_8_bars(midi)

    note_mat = dedup_note_matrix(get_note_matrix(midi, melody_only))
    if not note_mat:
        return None

    if chdfile_path is None:
        # the chordlab goes to a temporary file, as in the JAX package
        # (:174-178), which is removed once read
        tmp = tempfile.NamedTemporaryFile(suffix=".out", delete=False)
        tmp.close()
        try:
            rows = transcribe_midi(fpath, tmp.name)
        finally:
            os.remove(tmp.name)
    else:
        rows = transcribe_midi(fpath, chdfile_path)
    chord = chord_matrix_from_chordlab(rows)

    db_pos, db_filter = get_downbeat_pos_and_filter(midi)
    if db_pos is None:
        return None
    n_bins = max(db_pos[-1] + SEG_LGTH_BIN, int(round(midi.max_tick * _bins_per_quarter(midi)))) + 1
    return {
        "notes": np.array(note_mat, dtype=np.int64),
        "start_table": get_start_table(note_mat, n_bins),
        "db_pos": np.array(db_pos, dtype=np.int64),
        "db_pos_filter": np.array(db_filter, dtype=bool),
        "chord": np.array(chord, dtype=np.float32),
    }


def song_from_midi(fpath: str, **kwargs):
    """MIDI -> an in-memory song usable like ``SongNpz`` (the --from_midi path)."""
    from .dataset import SongNpz

    data = get_data_for_single_midi(fpath, **kwargs)
    if data is None:
        raise ValueError(f"could not extract downbeat structure from {fpath}")
    return SongNpz.from_dict(data, song_fn=os.path.basename(fpath))
