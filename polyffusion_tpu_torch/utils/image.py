"""Piano-roll image dumps (counterpart of the JAX package's ``utils/image.py``;
reference ``utils.py:526-549`` show_image).

Renders (B, 2, n_step, 128) prmat2c arrays as PNG: onset channel red, sustain
green, time left->right, pitch bottom->top, batch concatenated along time.
The PNG is written here with ``zlib`` and ``struct``, so that no plotting
package is needed: JAX's ``show_image`` writes nothing where matplotlib is
missing. Pixels are quantised as matplotlib's ``imsave`` quantises float
input, ``(x * 255).astype(uint8)``, and stored as 8-bit RGBA, as ``imsave``
stores them, with alpha 255 unless an alpha channel is given.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def prmat2c_to_rgb(img: np.ndarray) -> np.ndarray:
    """(B, 2, T, P) -> (P, B*T, 3) float RGB in [0, 1]."""
    img = np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
    if img.ndim == 4:
        img = np.swapaxes(img, 1, 2)  # (B, T, 2, P)
        img = np.concatenate(img, axis=0)  # (B*T, 2, P)
        img = np.swapaxes(img, 0, 1)  # (2, B*T, P)
    h, w = img.shape[1], img.shape[2]
    while img.shape[0] < 3:
        img = np.append(img, np.zeros((1, h, w), np.float32), axis=0)
    rgb = img.transpose(2, 1, 0)  # (P, B*T, 3)
    return np.ascontiguousarray(np.flip(rgb, 0))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(rgb: np.ndarray) -> bytes:
    """(H, W, 3 or 4) floats in [0, 1] -> the bytes of an 8-bit RGBA PNG."""
    rgb = np.asarray(rgb, dtype=np.float32)
    if rgb.ndim != 3 or rgb.shape[2] not in (3, 4):
        raise ValueError(f"expected an (H, W, 3 or 4) image, got shape {rgb.shape}")
    if rgb.min() < 0.0 or rgb.max() > 1.0:
        raise ValueError("float image values must lie in [0, 1]")
    h, w = rgb.shape[:2]
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[:, :, : rgb.shape[2]] = (rgb * 255).astype(np.uint8)
    # every scanline with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)  # 8-bit RGBA, no interlace
    return (PNG_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def show_image(img, path: str, mask: bool = False) -> None:
    """Save a prmat2c array as a PNG; with ``mask``, the red channel is also
    the alpha channel."""
    rgb = prmat2c_to_rgb(np.asarray(img))
    if mask:
        rgb = np.concatenate([rgb, rgb[:, :, :1]], axis=2)
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))
