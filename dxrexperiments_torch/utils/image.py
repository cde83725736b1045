"""Image IO (``dxrexperiments_tpu.utils.image``): PNG write, Radiance HDR
read and write, LDR read.

The PNG writer and the Radiance (.hdr, RGBE) reader and writer use only the
standard library and numpy. ``read_image`` reads LDR formats through PIL,
imported inside the function: a machine without PIL still reads .hdr files.
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


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def read_image(path: str, linearize: bool = True) -> np.ndarray:
    """Read an image file to float32 [H, W, 3]: .hdr natively, other formats
    through PIL, converted from sRGB to linear when ``linearize``."""
    if path.lower().endswith(".hdr"):
        return read_hdr(path)
    from PIL import Image

    img = Image.open(path).convert("RGB")
    arr = np.asarray(img, np.float32) / 255.0
    return srgb_to_linear(arr).astype(np.float32) if linearize else arr


def read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) decoder, RLE and flat scanlines, to float32
    [H, W, 3] (the JAX package's decoding, value for value)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    pos = data.index(b"\n\n") + 2
    dim_end = data.index(b"\n", pos)
    dims = data[pos:dim_end].split()
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {dims!r}")
    height, width = int(dims[1]), int(dims[3])
    pos = dim_end + 1

    rgbe = np.zeros((height, width, 4), np.uint8)
    for y in range(height):
        if (8 <= width < 32768 and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == width):
            pos += 4
            for c in range(4):
                x = 0
                while x < width:
                    n = data[pos]
                    pos += 1
                    if n > 128:  # run
                        rgbe[y, x:x + n - 128, c] = data[pos]
                        pos += 1
                        x += n - 128
                    else:  # literal
                        rgbe[y, x:x + n, c] = np.frombuffer(data, np.uint8, n, pos)
                        pos += n
                        x += n
        else:  # flat scanline
            rgbe[y] = np.frombuffer(data, np.uint8, width * 4, pos).reshape(width, 4)
            pos += width * 4

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0).astype(np.float32)
    # (m + 0.5) 2^(e - 136) has 9 significant bits: exact in float32 (the
    # JAX reader's float64 result holds the same values)
    return ((rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]
            * (exp[..., None] > 0)).astype(np.float32)


def _rle_channel(b: np.ndarray) -> bytes:
    """One channel of one scanline in the new-style RLE: runs of 3 or more
    equal bytes as run packets (at most 127 each), the rest as literal
    packets of at most 128."""
    out = bytearray()

    def literal(seg):
        for i in range(0, len(seg), 128):
            part = seg[i:i + 128]
            out.append(len(part))
            out.extend(part.tobytes())

    cut = np.flatnonzero(np.diff(b)) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [len(b)]])
    long_run = ends - starts >= 3
    done = 0
    for s, e in zip(starts[long_run], ends[long_run]):
        literal(b[done:s])
        while s < e:
            n = min(int(e - s), 127)
            out.extend((128 + n, int(b[s])))
            s += n
        done = e
    literal(b[done:])
    return bytes(out)


def write_hdr(path: str, image: np.ndarray, rle: bool = True) -> None:
    """Write [H, W, 3] float radiance as Radiance RGBE, with RLE scanlines
    (widths 8 to 32767) or flat ones."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    peak = img.max(axis=-1)
    mant, exp = np.frexp(peak)
    live = peak >= 1e-32
    scale = np.where(live, mant * 256.0 / np.where(live, peak, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(np.floor(img * scale[..., None]), 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(live, exp + 128, 0).astype(np.uint8)
    parts = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n", f"-Y {h} +X {w}\n".encode()]
    rle = rle and 8 <= w < 32768
    for y in range(h):
        if rle:
            parts.append(bytes((2, 2, w >> 8, w & 0xFF)))
            parts.extend(_rle_channel(rgbe[y, :, c]) for c in range(4))
        else:
            parts.append(rgbe[y].tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def mse(a: np.ndarray, b: np.ndarray) -> float:
    """Mean squared difference, in float64."""
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB; inf for equal images."""
    m = mse(a, b)
    return float("inf") if m == 0 else 10.0 * np.log10(peak * peak / m)
