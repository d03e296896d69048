"""MIDI inputs for the port's MIDI tests: hand-built Standard MIDI File bytes,
one case per reader rule (running status, format 0, tempo changes, meters,
controllers, pitch bends, meta events, note pairing, drums), and seeded songs
written with a package's own writer."""

import struct

import numpy as np

TPB = 480


def varlen(v: int) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    return bytes(reversed(out))


def ev(delta: int, *data: int) -> bytes:
    """A channel (or running-status) event after ``delta`` ticks."""
    return varlen(delta) + bytes(data)


def meta(delta: int, kind: int, payload: bytes) -> bytes:
    return varlen(delta) + bytes([0xFF, kind]) + varlen(len(payload)) + payload


def tempo(delta: int, us_per_beat: int) -> bytes:
    return meta(delta, 0x51, us_per_beat.to_bytes(3, "big"))


def time_sig(delta: int, num: int, den_pow: int) -> bytes:
    return meta(delta, 0x58, bytes([num, den_pow, 24, 8]))


def smf(tracks, fmt: int = 1, division: int = TPB, extra_chunks: bytes = b"") -> bytes:
    """Tracks (event streams without their end-of-track) -> file bytes;
    ``extra_chunks`` (non-track chunks) go after the header and count as tracks
    in it, as an unknown chunk does."""
    n = len(tracks) + (1 if extra_chunks else 0)
    out = b"MThd" + struct.pack(">IHHH", 6, fmt, n, division) + extra_chunks
    for t in tracks:
        body = t + varlen(0) + b"\xff\x2f\x00"
        out += b"MTrk" + struct.pack(">I", len(body)) + body
    return out


def _notes(ch: int, pitches, start: int, dur: int, step: int, vel: int = 80) -> bytes:
    """Consecutive notes of ``dur`` ticks every ``step`` ticks from ``start``
    on channel ``ch`` (step >= dur), as one event stream from tick 0."""
    out, now = b"", 0
    for k, p in enumerate(pitches):
        on = start + k * step
        out += ev(on - now, 0x90 | ch, p, vel) + ev(dur, 0x80 | ch, p, 0)
        now = on + dur
    return out


def _progression_track(ch: int = 0, bars: int = 8, beats: int = 4) -> bytes:
    """Block triads, one per bar (C, F, G, Am cycling), on channel ``ch``."""
    chords = [(60, 64, 67), (53, 57, 60), (55, 59, 62), (57, 60, 64)]
    out, now = bytes([0x00, 0xC0 | ch, 0]), 0
    for bar in range(bars):
        on = bar * beats * TPB
        ps = chords[bar % 4]
        for i, p in enumerate(ps):
            out += ev(on - now if i == 0 else 0, 0x90 | ch, p, 80)
            now = on
        for i, p in enumerate(ps):
            out += ev(beats * TPB if i == 0 else 0, 0x80 | ch, p, 0)
        now = on + beats * TPB
    return out


def hand_built_cases():
    """name -> SMF bytes."""
    cases = {}
    conductor = tempo(0, 500000) + time_sig(0, 4, 2)

    # running status: one status byte, then data pairs only; a velocity-0 on is an off
    rs = ev(0, 0xC0, 5) + ev(0, 0x90, 60, 80) + ev(0, 64, 70) + ev(0, 67, 60)
    rs += ev(TPB, 60, 0) + ev(0, 64, 0) + ev(TPB // 2, 67, 0)
    rs += ev(0, 0x91, 48, 90) + ev(TPB * 2, 48, 0) + ev(0, 50, 90) + ev(TPB * 3, 50, 0)
    cases["running_status"] = smf([conductor, rs + _progression_track(2, bars=4)])

    # format 0: conductor, programs and notes of three channels in one track
    f0 = tempo(0, 600000) + time_sig(0, 4, 2) + ev(0, 0xC0, 0) + ev(0, 0xC1, 33)
    f0 += ev(0, 0x90, 64, 80) + ev(0, 0x91, 40, 90) + ev(0, 0x99, 36, 100)
    f0 += ev(TPB // 4, 0x89, 36, 0) + ev(TPB * 3 // 4, 0x80, 64, 0) + ev(0, 0x81, 40, 0)
    f0 += ev(0, 0x90, 67, 80) + ev(TPB * 7, 0x80, 67, 0)
    cases["format0"] = smf([f0 + _progression_track(0, bars=4)], fmt=0)

    # tempo changes at odd ticks and tempos, one of them in a note track
    tm = tempo(0, 612345) + time_sig(0, 4, 2) + tempo(1000, 432100) + tempo(1500, 500001)
    late = tempo(7 * TPB + 13, 700000) + _notes(1, [72, 74, 76], 40, 333, 500)
    cases["tempo_changes"] = smf([tm, _progression_track(0, bars=6), late])

    # a 3/4 stretch between 4/4 bars, and 6/8 at the end
    ts = tempo(0, 500000) + time_sig(0, 4, 2) + time_sig(8 * TPB, 3, 2) + time_sig(6 * TPB, 6, 3)
    cases["three_four"] = smf([ts, _progression_track(0, bars=6, beats=4)
                               + _notes(0, [48, 50, 52, 53, 55, 57], 24 * TPB, TPB, TPB)])

    # sustain pedal (CC 64) down and up, with other controllers beside it
    sus = ev(0, 0xB0, 64, 127) + ev(0, 0xB0, 7, 100) + ev(0, 0x90, 60, 80) + ev(TPB, 0x80, 60, 0)
    sus += ev(0, 0x90, 64, 80) + ev(TPB, 0x80, 64, 0) + ev(TPB, 0xB0, 64, 0)
    sus += ev(0, 0x90, 67, 80) + ev(TPB, 0x80, 67, 0) + ev(0, 0xB0, 64, 100)
    sus += ev(TPB * 2, 0xB0, 64, 10)
    cases["sustain"] = smf([conductor, sus + _progression_track(0, bars=4)])

    # pitch bends up, down and back to centre
    pb = ev(0, 0x90, 62, 80) + ev(TPB // 2, 0xE0, 0x00, 0x50) + ev(TPB // 2, 0xE0, 0x00, 0x20)
    pb += ev(TPB, 0xE0, 0x00, 0x40) + ev(TPB, 0x80, 62, 0) + ev(0, 0xE0, 0x7F, 0x7F)
    pb += ev(TPB, 0xE0, 0x00, 0x00)
    cases["pitch_bends"] = smf([conductor, _progression_track(1, bars=4), pb])

    # lyrics, text, key signature, a marker and a sysex among the notes
    ly = conductor + meta(0, 0x05, b"la") + meta(0, 0x01, b"text") + meta(0, 0x59, b"\x00\x00")
    ly += meta(TPB * 2, 0x05, b"l\xe0") + meta(0, 0x06, b"marker")
    ly += varlen(TPB) + b"\xf0" + varlen(3) + b"\x7e\x7f\xf7"
    ly += meta(TPB * 10, 0x05, b"end")
    cases["lyrics"] = smf([ly, _progression_track(0, bars=4)])

    # velocity-0 note-ons as the only offs, a double on closed by one off
    v0 = ev(0, 0x90, 60, 80) + ev(TPB, 0x90, 60, 0) + ev(0, 0x90, 62, 80) + ev(TPB, 0x90, 62, 0)
    v0 += ev(0, 0x90, 65, 70) + ev(TPB // 2, 0x90, 65, 75) + ev(TPB // 2, 0x90, 65, 0)
    cases["velocity0_offs"] = smf([conductor, v0 + _progression_track(0, bars=4)])

    # a zero-length note (on and off on one tick), then the same pitch again
    zl = ev(0, 0x90, 60, 80) + ev(0, 0x80, 60, 0) + ev(100, 0x90, 60, 90) + ev(100, 0x80, 60, 0)
    cases["zero_length"] = smf([conductor, zl + _progression_track(0, bars=4)])

    # a same-tick retrigger: the off closes the old note, the new one stays open
    rt = ev(0, 0x90, 64, 80) + ev(TPB, 0x90, 64, 90) + ev(0, 0x80, 64, 0) + ev(TPB, 0x80, 64, 0)
    rt += ev(0, 0x90, 64, 70) + ev(0, 0x90, 64, 71) + ev(TPB, 0x80, 64, 0)
    cases["retrigger"] = smf([conductor, rt + _progression_track(0, bars=4)])

    # a trailing controller long after the last note-off extends the end time
    tc = _progression_track(0, bars=4) + ev(TPB * 9, 0xB0, 11, 0)
    cases["trailing_cc"] = smf([conductor, tc])

    # drums on channel 10, a percussive program (> 112) and a piano
    dr = ev(0, 0xC1, 115) + _notes(9, [36, 38, 36, 38, 42, 42], 0, TPB // 4, TPB)
    dr2 = ev(0, 0xC1, 115) + _notes(1, [70, 72, 74], 0, TPB, TPB * 2)
    cases["drums"] = smf([conductor, _progression_track(0, bars=4), dr, dr2])

    # an unknown chunk before the tracks is skipped
    cases["unknown_chunk"] = smf([conductor, _progression_track(0, bars=4)],
                                 extra_chunks=b"XFIH" + struct.pack(">I", 4) + b"abcd")
    return cases


def write_case(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / f"{name}.mid")
    with open(path, "wb") as f:
        f.write(data)
    return path


def write_song(M, path: str, n_bars: int = 16, seed: int = 0, tempo_change: bool = False):
    """A seeded three-track song with the ``M`` module's writer (``utils.midi``
    of either package): a melody of eighths, block triads one bar each, and
    drums on channel 10; 4/4 at 120 bpm. ``tempo_change``: the conductor
    track is rebuilt as raw bytes with a change to 100 bpm at the middle bar
    (the writer has one tempo). Returns the progression's roots, one a bar."""
    rng = np.random.default_rng(seed)
    roots = rng.integers(0, 12, n_bars)
    minor = rng.integers(0, 2, n_bars)
    melody, piano, drums = (M.Instrument(program=0), M.Instrument(program=0),
                            M.Instrument(program=0, is_drum=True))
    bar = 2.0
    for b in range(n_bars):
        t0 = b * bar
        for p in (48 + roots[b], 52 + roots[b] - minor[b], 55 + roots[b]):
            piano.notes.append(M.Note(t0, t0 + bar, int(p), 70))
        for k in range(8):
            p = 72 + int(rng.integers(0, 12))
            melody.notes.append(M.Note(t0 + k * 0.25, t0 + (k + 1) * 0.25, p, 90))
        for k in range(4):
            drums.notes.append(M.Note(t0 + k * 0.5, t0 + k * 0.5 + 0.1, 36 if k % 2 == 0 else 38,
                                      100))
    mf = M.MidiFile(instruments=[melody, piano, drums],
                    time_signatures=[M.TimeSignature(4, 4, 0.0)])
    M.save_midi(mf, path)
    if tempo_change:
        with open(path, "rb") as f:
            data = f.read()
        first_len = struct.unpack(">I", data[18:22])[0]
        conductor = tempo(0, 500000) + time_sig(0, 4, 2) + tempo(n_bars // 2 * 4 * TPB, 600000)
        body = conductor + varlen(0) + b"\xff\x2f\x00"
        data = (data[:14] + b"MTrk" + struct.pack(">I", len(body)) + body
                + data[22 + first_len:])
        with open(path, "wb") as f:
            f.write(data)
    return roots
