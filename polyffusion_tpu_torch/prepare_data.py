"""Data preparation CLI: a directory of MIDI files -> per-song .npz training data
(a copy of the JAX package's ``prepare_data.py``; reference ``prepare_data.py``):
note matrices, chord extraction, downbeat filter. Host NumPy only: it takes no
device.

    python -m polyffusion_tpu_torch.prepare_data --midi_dir <dir> --npz_dir <out> \
        [--melody_only] [--force_length]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def prepare_npz(
    midi_dir: str,
    npz_dir: str,
    melody_only: bool = False,
    force_length: bool = False,
) -> dict:
    from .data.midi_to_data import get_data_for_single_midi

    os.makedirs(npz_dir, exist_ok=True)
    counts = {"ok": 0, "downbeat_error": 0, "empty": 0, "read_error": 0}
    for root, _, files in os.walk(midi_dir):
        for fn in sorted(files):
            if not fn.lower().endswith((".mid", ".midi")):
                continue
            fpath = os.path.join(root, fn)
            rel = os.path.relpath(fpath, midi_dir).replace(os.sep, "_")
            out_path = os.path.join(npz_dir, os.path.splitext(rel)[0] + ".npz")
            try:
                data = get_data_for_single_midi(
                    fpath, melody_only=melody_only, force_length=force_length
                )
            except Exception as e:  # count + skip, like the reference (:75-88)
                print(f"[read_error] {fpath}: {type(e).__name__}: {e}")
                counts["read_error"] += 1
                continue
            if data is None:
                counts["downbeat_error"] += 1
                continue
            if len(data["notes"]) == 0:
                counts["empty"] += 1
                continue
            np.savez_compressed(out_path, **data)
            counts["ok"] += 1
    print(f"prepare_npz done: {counts}")
    return counts


def main(argv=None):
    p = argparse.ArgumentParser(description="MIDI dir -> npz training data")
    p.add_argument("--midi_dir", required=True)
    p.add_argument("--npz_dir", required=True)
    p.add_argument("--melody_only", action="store_true", help="drop drums & program>=113")
    p.add_argument(
        "--force_length", action="store_true", help="loop short files to 8 bars"
    )
    args = p.parse_args(argv)
    prepare_npz(args.midi_dir, args.npz_dir, args.melody_only, args.force_length)


if __name__ == "__main__":
    main()
