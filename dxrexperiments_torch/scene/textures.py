"""Albedo textures (``dxrexperiments_tpu.scene.textures``): per-material
images multiplied into the constant albedo at hit UVs.

The device layout is the port's own. All materials' textures live in one
flat texel table ``texels`` [R, 3] float32 (each image's rows one after
the other); ``meta`` [M, 3] int32 holds each material's (base, width,
height), (0, 0, 0) for an untextured material, whose albedo is multiplied
by 1. A bilinear sample reads the four texels of its footprint with WRAP
addressing on both axes (``sample_albedo`` here, and the fused-traversal
kernel, ``csrc/common.cuh``). The JAX package stores quad-packed rows
[R, 12] instead (each texel with its 2x2 footprint), because a TPU gather
fetches one row; that is 4x the bytes for the same texels, and the port
does not build them. A JAX scene carried across keeps their first three
columns, which are the texels themselves (``scene/convert.py``).

The JAX ``_meta_select`` is not carried: it is a compare-select chain that
avoids XLA's per-row gather cost. Here the per-hit (base, width, height)
is a plain ``meta[mid]``; a test pins it to JAX's values.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def pack_texture_table(materials: list) -> dict | None:
    """Every material's ``albedo_texture`` in one table (numpy).

    Returns None when no material is textured (a scene then has no
    "textures" key, and the kernels' gates key off its absence). Otherwise:
      texels [R, 3] float32: every texture's texels, row-major, concatenated
      meta   [M, 3] int32: (base texel, width, height); (0, 0, 0) = none
    A 2-D (grey) image is repeated to three channels."""
    metas = np.zeros((max(len(materials), 1), 3), np.int64)
    tables = []
    base = 0
    for i, m in enumerate(materials):
        tex = getattr(m, "albedo_texture", None)
        if tex is None:
            continue
        img = np.asarray(tex, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        h, w = img.shape[0], img.shape[1]
        tables.append(np.ascontiguousarray(img[..., :3]).reshape(-1, 3))
        metas[i] = (base, w, h)
        base += h * w
    if not tables:
        return None
    return {
        "texels": np.ascontiguousarray(np.concatenate(tables), dtype=np.float32),
        "meta": metas.astype(np.int32),
    }


def sample_albedo(textures: dict, mid: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear albedo multiplier of hits: [N] material ids and [N, 2] UVs
    -> [N, 3]; 1.0 for untextured materials. WRAP on both axes (a floor
    mod, so texel -1 is the last one)."""
    texels = textures["texels"]
    meta = textures["meta"][mid.to(torch.int64)].to(torch.int64)  # [N, 3]
    base, w, h = meta[..., 0], meta[..., 1], meta[..., 2]
    has = w > 0
    wc = torch.clamp(w, min=1)
    hc = torch.clamp(h, min=1)
    x = uv[..., 0] * wc.to(torch.float32) - 0.5
    y = uv[..., 1] * hc.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), wc)
    y0i = torch.remainder(y0.to(torch.int64), hc)
    x1i = torch.remainder(x0i + 1, wc)
    y1i = torch.remainder(y0i + 1, hc)

    def tap(yi, xi):
        return texels[torch.where(has, base + yi * w + xi, torch.zeros_like(base))]

    c00, c10, c01, c11 = tap(y0i, x0i), tap(y0i, x1i), tap(y1i, x0i), tap(y1i, x1i)
    tex = c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy) + c01 * (1 - fx) * fy + c11 * fx * fy
    return torch.where(has[..., None], tex, torch.ones_like(tex))


def checker_texture(n: int = 8, c0=(1.0, 1.0, 1.0), c1=(0.2, 0.2, 0.2),
                    size: int = 64) -> np.ndarray:
    """n x n checkerboard, ``size`` texels square: a procedural test texture."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    cell = ((xx * n // size) + (yy * n // size)) % 2
    c0 = np.asarray(c0, np.float32)
    c1 = np.asarray(c1, np.float32)
    return np.where(cell[..., None] == 0, c0, c1).astype(np.float32)


def planar_uvs(mesh, scale: float = 1.0, axes=(0, 2)) -> None:
    """Planar per-corner UVs from two position axes (default XZ, for ground
    planes): uv = position[axes] / scale; WRAP addressing tiles the
    texture. Sets ``mesh.uv_corners`` [F, 3, 2]."""
    corners = mesh.positions[mesh.indices]  # [F, 3, 3]
    mesh.uv_corners = (corners[..., list(axes)] / np.float32(scale)).astype(np.float32)


def _read_ppm(path: str) -> np.ndarray | None:
    """Binary P6 PPM -> linear float32 [H, W, 3] (sRGB decoded with gamma 2.2)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P6"):
        return None
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    pos += 1  # the single whitespace after maxval
    w, h, maxv = fields
    raw = np.frombuffer(data, np.uint8, count=w * h * 3, offset=pos)
    srgb = raw.reshape(h, w, 3).astype(np.float32) / float(maxv)
    return srgb ** 2.2


def load_texture_image(path: str) -> np.ndarray | None:
    """Best-effort image load for an albedo map: Radiance .hdr
    (``utils/image.read_hdr``), .npy, or binary PPM (P6). Returns float32
    [H, W, 3] linear, or None for another format or an unreadable file
    (the material keeps its constant albedo)."""
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".hdr":
            from ..utils.image import read_hdr

            return np.asarray(read_hdr(path), np.float32)
        if ext == ".npy":
            return np.asarray(np.load(path), np.float32)[..., :3]
        if ext in (".ppm", ".pnm"):
            return _read_ppm(path)
    except (OSError, ValueError, IndexError):
        return None
    return None
