"""Representation -> MIDI-file writers, and MIDI notes -> nmat (host-side,
NumPy in / .mid out; a copy of the JAX package's ``utils/midi_io.py``).

Semantics match the reference writers (``polyffusion/utils.py:311-523``):
16th-note step = 1/8 s at the default 120 bpm tempo; velocity 80; a separate
"inpainted" instrument track when an inpainting mask is given; optional per-segment
text labels as MIDI lyric events.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .midi import Instrument, Lyric, MidiFile, Note, save_midi
from .reprs import sustain_run_lengths

STEP_SEC = 1.0 / 8.0  # 16th note at 120 bpm


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _with_labels(midi: MidiFile, labels: Optional[Sequence[str]], seg_sec: float) -> None:
    if labels is not None:
        midi.lyrics = [Lyric(str(lab), i * seg_sec) for i, lab in enumerate(labels)]


def estx_to_midi_file(est_x, fpath: str, labels=None) -> None:
    """PianoTree batches (B, n_step, max_note_count, 6) -> .mid (reference utils.py:311-359)."""
    est_x = _np(est_x)
    n_step = est_x.shape[1]
    seg_sec = n_step * STEP_SEC
    piano = Instrument(program=0, name="piano")
    for seg_ind, seg in enumerate(est_x):
        t0 = seg_ind * seg_sec
        for step_ind, step in enumerate(seg):
            for key in step:
                pitch = int(key[0])
                if not (0 <= pitch <= 127):
                    continue
                dur = int(key[1] << 4 | key[2] << 3 | key[3] << 2 | key[4] << 1 | key[5]) + 1
                piano.notes.append(
                    Note(
                        start=t0 + step_ind * STEP_SEC,
                        end=min(t0 + (step_ind + dur) * STEP_SEC, t0 + seg_sec),
                        pitch=pitch,
                        velocity=80,
                    )
                )
    midi = MidiFile(instruments=[piano])
    _with_labels(midi, labels, seg_sec)
    save_midi(midi, fpath)


def prmat_to_midi_file(prmat, fpath: str, labels=None) -> None:
    """Duration piano-rolls (B, n_step, 128) -> .mid (reference utils.py:362-392)."""
    prmat = _np(prmat)
    n_step = prmat.shape[1]
    seg_sec = n_step * STEP_SEC
    piano = Instrument(program=0, name="piano")
    for seg_ind, seg in enumerate(prmat):
        t0 = seg_ind * seg_sec
        steps, keys = np.nonzero(np.rint(seg).astype(np.int64) > 0)
        for s, k in zip(steps, keys):
            dur = int(round(float(seg[s, k])))
            piano.notes.append(
                Note(
                    start=t0 + s * STEP_SEC,
                    end=min(t0 + (s + dur) * STEP_SEC, t0 + seg_sec),
                    pitch=int(k),
                    velocity=80,
                )
            )
    midi = MidiFile(instruments=[piano])
    _with_labels(midi, labels, seg_sec)
    save_midi(midi, fpath)


def prmat2c_to_midi_file(
    prmat2c, fpath: str, labels=None, is_custom_round: bool = False, inp_mask=None
) -> None:
    """Onset/sustain images (B, 2, n_step, 128) -> .mid (reference utils.py:433-485).

    With ``inp_mask`` given, notes whose onset lies in the regenerated region
    (mask == 0) go to a second "inpainted" instrument track.
    """
    prmat2c = _np(prmat2c)
    n_step = prmat2c.shape[2]
    seg_sec = n_step * STEP_SEC
    origin = Instrument(program=0, name="origin")
    inpainted = Instrument(program=0, name="inpainted")
    for seg_ind, seg in enumerate(prmat2c):
        t0 = seg_ind * seg_sec
        if is_custom_round:
            onset = ((seg[0] > 0.95) & (seg[0] < 1.05)).astype(np.int64)
        else:
            onset = np.rint(seg[0]).astype(np.int64)
        sustain = np.rint(seg[1]).astype(np.int64)
        run = sustain_run_lengths(sustain)
        run_next = np.vstack([run[1:], np.zeros((1, seg.shape[2]), dtype=np.int64)])
        steps, keys = np.nonzero(onset > 0)
        for s, k in zip(steps, keys):
            dur = 1 + int(run_next[s, k])
            note = Note(
                start=t0 + s * STEP_SEC,
                end=min(t0 + (s + dur) * STEP_SEC, t0 + seg_sec),
                pitch=int(k),
                velocity=80,
            )
            if inp_mask is not None and float(_np(inp_mask)[seg_ind, 0, s, k]) == 0.0:
                inpainted.notes.append(note)
            else:
                origin.notes.append(note)
    instruments = [origin] + ([inpainted] if inp_mask is not None else [])
    midi = MidiFile(instruments=instruments)
    _with_labels(midi, labels, seg_sec)
    save_midi(midi, fpath)


def chd_to_midi_file(chords, fpath: str, one_beat: float = 0.5) -> None:
    """Chord matrices (B, n_beat, 14|36) -> block-chord .mid (reference utils.py:488-523)."""
    chords = _np(chords)
    piano = Instrument(program=0, name="chords")
    t = 0.0
    for seg in chords:
        for chord in seg:
            if chord.shape[0] == 14:
                bass = int(chord[13])
                chroma = chord[1:13].astype(np.int64)
            else:
                bass = int(np.argmax(chord[24:36]))
                chroma = np.rint(chord[12:24]).astype(np.int64)
            chroma = np.roll(chroma, -bass)
            c3 = 48
            for i, on in enumerate(chroma):
                if on == 1:
                    piano.notes.append(
                        Note(
                            start=t * one_beat,
                            end=(t + 1) * one_beat,
                            pitch=c3 + i + bass,
                            velocity=80,
                        )
                    )
            t += 1
    midi = MidiFile(instruments=[piano])
    save_midi(midi, fpath)


def nmat_from_midi_seconds(midi: MidiFile, step_sec: float = STEP_SEC):
    """Quantize a MidiFile's notes onto the 16th-note grid -> nmat (onset, pitch, dur)."""
    rows = []
    for ins in midi.instruments:
        if ins.is_drum:
            continue
        for n in ins.notes:
            onset = int(round(n.start / step_sec))
            dur = max(1, int(round((n.end - n.start) / step_sec)))
            rows.append((onset, n.pitch, dur))
    rows.sort()
    return np.array(rows, dtype=np.int64) if rows else np.zeros((0, 3), dtype=np.int64)
