"""Brute-force ray-triangle intersection, the plain PyTorch twin of
``dxrexperiments_tpu.ops.intersect``.

Möller–Trumbore in scalar-triple-product form, so the [R rays] x [C
triangles] test is a chain of [R,3] @ [3,C] contractions:

    det   = -(D . pn)              pn = e1 x e2
    u*det =  (OxD) . e2 + D . c1   c1 = v0 x e2
    v*det = -(OxD) . e1 - D . c2   c2 = v0 x e1
    t*det =   O . pn - d0          d0 = v0 . pn

Validity uses sign-multiplied comparisons; the winner's exact (t, u, v) is
recomputed per ray after the argmin. Padding triangles are all zero, so
det == 0 and they never hit. Both entry points loop over triangle chunks
with a running best-hit state, as the JAX version scans.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm

RAY_MAX_T = 1.0e38
RAY_EPSILON = 1.0e-4

DEFAULT_CHUNK = 512


def _dot3t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[R,3] x [T,3] -> [R,T] in float32 (TF32 is off, see core/device.py)."""
    return a @ b.T


def _pair_terms(origins, directions, moments, tri):
    det = -_dot3t(directions, tri["pn"])
    u_d = _dot3t(moments, tri["e2"]) + _dot3t(directions, tri["c1"])
    v_d = -_dot3t(moments, tri["e1"]) - _dot3t(directions, tri["c2"])
    t_d = _dot3t(origins, tri["pn"]) - tri["d0"][None, :]
    return det, u_d, v_d, t_d


def _valid_mask(det, u_d, v_d, t_d, t_min, t_max, cull_backface: bool):
    s = torch.sign(det)
    det_abs = det * s
    eps = 1e-12
    # Primary rays cull backfaces: only det > 0 (CCW seen by the ray) lives.
    alive = det > eps if cull_backface else det_abs > eps
    us = u_d * s
    vs = v_d * s
    ts = t_d * s
    return (
        alive
        & (us >= 0.0)
        & (vs >= 0.0)
        & (us + vs <= det_abs)
        & (ts > t_min[:, None] * det_abs)
        & (ts < t_max[:, None] * det_abs)
    )


def _fit_chunk(t_total: int, desired: int = DEFAULT_CHUNK) -> int:
    """Largest chunk <= desired that divides the padded triangle count."""
    c = min(desired, t_total)
    while c > 1 and t_total % c != 0:
        c -= 1
    return max(c, 1)


def _slice_tris(scene: dict, start: int, size: int) -> dict:
    return {k: scene[k][start : start + size] for k in ("pn", "c1", "c2", "e1", "e2", "d0")}


def _ray_window(x, r: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device).expand(r)


def intersect_closest(
    scene: dict,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_min=RAY_EPSILON,
    t_max=RAY_MAX_T,
    cull_backface: bool = False,
    chunk: int = DEFAULT_CHUNK,
) -> dict:
    """Closest hit for rays [R,3] x [R,3] against every scene triangle.

    Returns {"hit" [R] bool, "t" [R], "tri" [R] int64, "u", "v" [R]}."""
    r = origins.shape[0]
    t_total = scene["v0"].shape[0]
    chunk = _fit_chunk(t_total, chunk)
    t_min = _ray_window(t_min, r, origins)
    t_max = _ray_window(t_max, r, origins)
    moments = vm.cross(origins, directions)

    best_t = torch.full((r,), float("inf"), dtype=torch.float32, device=origins.device)
    best_tri = torch.zeros((r,), dtype=torch.int64, device=origins.device)
    for start in range(0, t_total, chunk):
        tri = _slice_tris(scene, start, chunk)
        det, u_d, v_d, t_d = _pair_terms(origins, directions, moments, tri)
        valid = _valid_mask(det, u_d, v_d, t_d, t_min, t_max, cull_backface)
        # Approximate t for selection only; exact recompute after the argmin.
        t_pair = t_d / torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))
        t_pair = torch.where(valid, t_pair, torch.full_like(t_pair, float("inf")))
        c_best, c_idx = torch.min(t_pair, dim=1)  # first index on ties
        better = c_best < best_t
        best_t = torch.where(better, c_best, best_t)
        best_tri = torch.where(better, c_idx + start, best_tri)

    hit = torch.isfinite(best_t)
    tri_safe = torch.where(hit, best_tri, torch.zeros_like(best_tri))

    # Exact per-ray recompute on the winning triangle (classic MT).
    v0 = scene["v0"][tri_safe]
    e1 = scene["e1"][tri_safe]
    e2 = scene["e2"][tri_safe]
    p = vm.cross(directions, e2)
    det = vm.dot(e1, p)
    inv = torch.where(torch.abs(det) > 1e-12, 1.0 / det, torch.zeros_like(det))
    tv = origins - v0
    u = vm.dot(tv, p) * inv
    q = vm.cross(tv, e1)
    v = vm.dot(directions, q) * inv
    t = vm.dot(e2, q) * inv

    zero = torch.zeros_like(t)
    return {
        "hit": hit,
        "t": torch.where(hit, t, zero - 1.0),
        "tri": torch.where(hit, best_tri, torch.full_like(best_tri, -1)),
        "u": torch.where(hit, u, zero),
        "v": torch.where(hit, v, zero),
    }


def intersect_any(
    scene: dict,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_min=RAY_EPSILON,
    t_max=RAY_MAX_T,
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Occlusion query: True where ANY triangle blocks the segment (no
    backface culling, no closest-hit resolution)."""
    r = origins.shape[0]
    t_total = scene["v0"].shape[0]
    chunk = _fit_chunk(t_total, chunk)
    t_min = _ray_window(t_min, r, origins)
    t_max = _ray_window(t_max, r, origins)
    moments = vm.cross(origins, directions)
    occluded = torch.zeros((r,), dtype=torch.bool, device=origins.device)
    for start in range(0, t_total, chunk):
        tri = _slice_tris(scene, start, chunk)
        det, u_d, v_d, t_d = _pair_terms(origins, directions, moments, tri)
        valid = _valid_mask(det, u_d, v_d, t_d, t_min, t_max, cull_backface=False)
        occluded = occluded | valid.any(dim=1)
    return occluded
