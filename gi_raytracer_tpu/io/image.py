"""Image output.  The reference quantizes into a QImage per pixel write
(reference include/image.h:14-16); here the framebuffer stays float on
device and is quantized once at save, into an 8-bit RGB PNG written with
the standard library alone."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def save_png(path: str, img) -> None:
    """img: (H, W, 3) float in [0, 1] (already tonemapped)."""
    arr = np.asarray(img)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {arr.shape}")
    q = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w, _ = q.shape
    # filter type 0 (none) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), q.reshape(h, w * 3)],
                         axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw, 6))
                + _chunk(b"IEND", b""))
