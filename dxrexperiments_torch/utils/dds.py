"""DDS reader and writer for uncompressed formats, cubemaps included
(``dxrexperiments_tpu.utils.dds``).

Reads DX10 R16G16B16A16_FLOAT (the reference's radiance cubemap),
R32G32B32A32_FLOAT and R8G8B8A8_UNORM(_SRGB), legacy uncompressed 24- and
32-bit RGB(A) and the legacy float fourcc 116, mip 0 of each face.
Block-compressed (BCn) formats raise. ``write_dds`` writes the DX10 float
formats and the legacy 8-bit ones, for tests and generated inputs.
"""

from __future__ import annotations

import struct

import numpy as np

DDPF_FOURCC = 0x4
DDPF_RGB = 0x40
DDSCAPS2_CUBEMAP = 0x200
DDSCAPS2_ALL_FACES = 0xFC00
DXGI_R32G32B32A32_FLOAT = 2
DXGI_R16G16B16A16_FLOAT = 10
# write_dds formats: name -> (DXGI format or None for a legacy header,
# numpy dtype, channels)
FORMATS = {
    "rgba16f": (DXGI_R16G16B16A16_FLOAT, "<f2", 4),
    "rgba32f": (DXGI_R32G32B32A32_FLOAT, "<f4", 4),
    "rgba8": (None, "<u1", 4),
    "rgb8": (None, "<u1", 3),
}


def read_dds(path: str) -> dict:
    """Parse a DDS file. Returns {"faces": [n_faces, H, W, 3] float32,
    "is_cubemap": bool, "mips": int} (mip 0 only)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"DDS ":
        raise ValueError(f"not a DDS file: {path}")
    hdr = struct.unpack("<31I", data[4:128])
    height, width = hdr[2], hdr[3]
    mip_count = max(hdr[6], 1)
    pf_flags = hdr[19]
    fourcc = data[84:88]
    caps2 = hdr[27]
    offset = 128

    dxgi = None
    array_size = 1
    misc = 0
    if (pf_flags & DDPF_FOURCC) and fourcc == b"DX10":
        dxgi, _dim, misc, array_size, _misc2 = struct.unpack("<5I", data[128:148])
        offset = 148

    is_cube = bool(caps2 & DDSCAPS2_CUBEMAP) or bool(misc & 0x4)
    n_faces = 6 if is_cube else max(array_size, 1)

    if dxgi == DXGI_R16G16B16A16_FLOAT:
        dtype, channels = np.dtype("<f2"), 4
    elif dxgi == DXGI_R32G32B32A32_FLOAT:
        dtype, channels = np.dtype("<f4"), 4
    elif dxgi in (28, 29):  # R8G8B8A8_UNORM(_SRGB)
        dtype, channels = np.dtype("<u1"), 4
    elif dxgi is None and not (pf_flags & DDPF_FOURCC):
        bits = hdr[21]  # legacy uncompressed RGB(A)
        if bits == 32:
            dtype, channels = np.dtype("<u1"), 4
        elif bits == 24:
            dtype, channels = np.dtype("<u1"), 3
        else:
            raise ValueError(f"unsupported legacy DDS bit count {bits}")
    elif dxgi is None and fourcc == b"\x74\x00\x00\x00":
        dtype, channels = np.dtype("<f4"), 4
    else:
        raise ValueError(
            f"unsupported DDS format fourcc={fourcc!r} dxgi={dxgi} "
            "(block-compressed formats not supported)"
        )

    pix = dtype.itemsize
    faces = np.zeros((n_faces, height, width, 3), np.float32)
    for face in range(n_faces):
        arr = np.frombuffer(data, dtype, width * height * channels, offset)
        arr = arr.reshape(height, width, channels)[..., :3].astype(np.float32)
        if dtype == np.dtype("<u1"):
            arr = arr / 255.0
        faces[face] = arr
        # skip the whole mip chain of this face
        off = width * height * channels * pix
        w, h = width, height
        for _ in range(1, mip_count):
            w, h = max(w // 2, 1), max(h // 2, 1)
            off += w * h * channels * pix
        offset += off

    return {"faces": faces, "is_cubemap": is_cube, "mips": mip_count}


def load_cubemap(path: str) -> np.ndarray:
    """[6, S, S, 3] float faces in D3D order (+X -X +Y -Y +Z -Z)."""
    dds = read_dds(path)
    if not dds["is_cubemap"] or dds["faces"].shape[0] != 6:
        raise ValueError(f"{path} is not a 6-face cubemap")
    return dds["faces"]


def write_dds(path: str, faces: np.ndarray, fmt: str = "rgba16f", mips: int = 1,
              cube: bool = True) -> None:
    """Write [n_faces, H, W, 3] float faces (6 for a cubemap, D3D order) as
    a DDS of ``fmt`` (see FORMATS; the 8-bit formats take values in [0, 1])
    with a chain of ``mips`` levels per face, each a 2x2 box filter of the
    one above. Alpha is 1."""
    dxgi, dtype, channels = FORMATS[fmt]
    faces = np.asarray(faces, np.float32)
    n, h, w = faces.shape[:3]
    if cube and n != 6:
        raise ValueError(f"a cubemap has 6 faces, got {n}")
    flags = 0x1 | 0x2 | 0x4 | 0x1000 | (0x20000 if mips > 1 else 0)
    caps = 0x1000 | ((0x8 | 0x400000) if cube or mips > 1 else 0)
    caps2 = DDSCAPS2_CUBEMAP | DDSCAPS2_ALL_FACES if cube else 0
    if dxgi is None:
        pf = struct.pack("<8I", 32, DDPF_RGB | (0x1 if channels == 4 else 0), 0, 8 * channels,
                         0xFF, 0xFF00, 0xFF0000, 0xFF000000 if channels == 4 else 0)
    else:
        pf = struct.pack("<2I4s5I", 32, DDPF_FOURCC, b"DX10", 0, 0, 0, 0, 0)
    head = (b"DDS " + struct.pack("<7I", 124, flags, h, w, 0, 0, mips) + b"\0" * 44 + pf
            + struct.pack("<5I", caps, caps2, 0, 0, 0))
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0x4 if cube else 0, 1 if cube else n, 0)
    body = []
    for f in range(n):
        level = faces[f]
        for _ in range(mips):
            px = np.concatenate([level, np.ones(level.shape[:2] + (1,), np.float32)], axis=-1)
            px = px[..., :channels]
            if dtype == "<u1":
                px = np.clip(np.round(px * 255.0), 0, 255)
            body.append(np.ascontiguousarray(px.astype(dtype)).tobytes())
            lh, lw = level.shape[:2]
            nh, nw = max(lh // 2, 1), max(lw // 2, 1)
            level = level[:nh * 2 if lh > 1 else 1, :nw * 2 if lw > 1 else 1]
            level = level.reshape(nh, -1, nw, level.shape[1] // nw, 3).mean(axis=(1, 3))
    with open(path, "wb") as f:
        f.write(head + b"".join(body))
