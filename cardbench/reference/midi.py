"""The served reply's MIDI file, written anew from onset/sustain images
(Polyffusion's ``prmat2c_to_midi_file``): each rounded onset starts a
note of velocity 80 that lasts one step plus the run of rounded sustain
pixels right after it, cut at its 8-bar segment's end; a 16th-note step is
1/8 s at 120 bpm; segments follow each other. The file is a format-1 SMF of
480 ticks a beat: a tempo and 4/4 track, then one piano track (program 0,
channel 0), events in tick order, each note-off right after its note-on in
the order of the notes."""

from __future__ import annotations

import struct

import numpy as np

STEP_SEC = 1.0 / 8.0
TPB, TEMPO_US = 480, 500000


def _varlen(value: int) -> bytes:
    buf = [value & 0x7F]
    value >>= 7
    while value:
        buf.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(buf))


def _track(events) -> bytes:
    events.sort(key=lambda e: e[0])
    out, last = bytearray(), 0
    for tick, payload in events:
        out += _varlen(tick - last) + payload
        last = tick
    out += _varlen(0) + b"\xff\x2f\x00"
    return b"MTrk" + struct.pack(">I", len(out)) + bytes(out)


def _tick(sec: float) -> int:
    return int(round(sec * 1e6 / TEMPO_US * TPB))


def notes(prmat2c: np.ndarray):
    """(start s, end s, pitch) of every note of (B, 2, steps, 128) images."""
    out = []
    n_step = prmat2c.shape[2]
    seg_sec = n_step * STEP_SEC
    for seg_ind, seg in enumerate(prmat2c):
        t0 = seg_ind * seg_sec
        onset = np.rint(seg[0]).astype(np.int64)
        sustain = np.rint(seg[1]).astype(np.int64)
        run = np.zeros_like(sustain)
        nxt = np.zeros(sustain.shape[1:], np.int64)
        for t in range(n_step - 1, -1, -1):
            nxt = sustain[t] * (nxt + 1)
            run[t] = nxt
        run_next = np.vstack([run[1:], np.zeros((1, seg.shape[2]), np.int64)])
        for s, k in zip(*np.nonzero(onset > 0)):
            dur = 1 + int(run_next[s, k])
            out.append((t0 + s * STEP_SEC, min(t0 + (s + dur) * STEP_SEC, t0 + seg_sec), int(k)))
    return out


def midi_bytes(prmat2c: np.ndarray) -> bytes:
    meta = [(0, b"\xff\x51\x03" + TEMPO_US.to_bytes(3, "big")),
            (0, bytes([0xFF, 0x58, 0x04, 4, 2, 24, 8]))]
    events = [(0, bytes([0xC0, 0]))]
    for start, end, pitch in notes(np.asarray(prmat2c)):
        on, off = _tick(start), _tick(end)
        off = max(off, on + 1)
        events.append((on, bytes([0x90, pitch & 0x7F, 80])))
        events.append((off, bytes([0x80, pitch & 0x7F, 0])))
    chunks = [_track(meta), _track(events)]
    return b"MThd" + struct.pack(">IHHH", 6, 1, len(chunks), TPB) + b"".join(chunks)
