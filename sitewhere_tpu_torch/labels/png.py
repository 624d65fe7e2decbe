"""Minimal PNG writer (stdlib only) for label images.

Counterpart of ``sitewhere_tpu/labels/png.py``, whole.

The reference emits label PNGs through AWT/ImageIO inside
``service-label-generation``; here a grayscale or RGB ``uint8`` array is
serialized directly: IHDR + IDAT (zlib, filter 0) + IEND.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (
        struct.pack(">I", len(body))
        + tag
        + body
        + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)
    )


def write_png(img: np.ndarray) -> bytes:
    """Serialize ``uint8[H, W]`` (grayscale) or ``uint8[H, W, 3]`` (RGB)."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        color_type, channels = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, channels = 2, 3
    else:
        raise ValueError(f"expected [H,W] or [H,W,3], got {img.shape}")
    h, w = img.shape[:2]
    raw = img.reshape(h, w * channels)
    # prepend filter byte 0 to each scanline
    scanlines = np.concatenate(
        [np.zeros((h, 1), dtype=np.uint8), raw], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(scanlines, 6))
        + _chunk(b"IEND", b"")
    )


def read_png_size(data: bytes) -> tuple:
    """Parse (width, height) from a PNG header (test helper)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    return w, h
