"""Minimal dependency-free PNG writer.

The reference displays frames through an OpenGL textured quad
(src/GLState.c:91-111); an offline renderer has no window, so the
presentation layer becomes: device array → tone map → PNG on disk.
Pure-stdlib encoder (zlib + struct): 8-bit RGB/RGBA, no filtering
(filter type 0 per scanline).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """img: [H, W, 3|4] uint8 (or float in [0,1], converted)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w, c = img.shape
    assert c in (3, 4), f"need RGB or RGBA, got {c} channels"
    color_type = 2 if c == 3 else 6

    raw = bytearray()
    for row in img:
        raw.append(0)  # filter type 0 (None)
        raw.extend(row.tobytes())

    out = bytearray(b"\x89PNG\r\n\x1a\n")
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                       0, 0, 0))
    out += _chunk(b"IDAT", zlib.compress(bytes(raw), 6))
    out += _chunk(b"IEND", b"")
    return bytes(out)


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def tonemap(img: np.ndarray, exposure: float = 1.0,
            gamma: float = 2.2) -> np.ndarray:
    """Simple Reinhard + gamma for HDR path-traced output. Normal/mirror
    modes are already in [0,1] — pass gamma=1, exposure=1 to no-op."""
    x = np.asarray(img, np.float32) * exposure
    x = x / (1.0 + x)
    return np.clip(x, 0.0, 1.0) ** (1.0 / gamma)
