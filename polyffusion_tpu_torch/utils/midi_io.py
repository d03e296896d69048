"""prmat2c images -> MIDI files (host-side, NumPy in / .mid out).

A copy of ``prmat2c_to_midi_file`` from the JAX package's ``utils/midi_io.py``:
16th-note step = 1/8 s at the default 120 bpm tempo; velocity 80; a separate
"inpainted" instrument track when an inpainting mask is given.
"""

from __future__ import annotations

import numpy as np

from .midi import Instrument, Lyric, MidiFile, Note, save_midi
from .reprs import sustain_run_lengths

STEP_SEC = 1.0 / 8.0  # 16th note at 120 bpm


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _with_labels(midi: MidiFile, labels, seg_sec: float) -> None:
    if labels is not None:
        midi.lyrics = [Lyric(str(lab), i * seg_sec) for i, lab in enumerate(labels)]


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
