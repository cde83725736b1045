"""PNG writer (``dxrexperiments_tpu.utils.image.write_png``).

Encodes 8-bit RGB PNG with the standard library (zlib), so the port needs no
imaging package. Image readers wait for the texture-env slice (ROADMAP
Queue A item 9).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(tag + data) & 0xFFFFFFFF
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write [H, W, 3] float (0..1) to an 8-bit RGB PNG."""
    arr = np.asarray(image, np.float32)
    arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
