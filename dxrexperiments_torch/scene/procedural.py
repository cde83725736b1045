"""Procedural test geometry (``dxrexperiments_tpu.scene.procedural``):
quads, boxes, the Cornell box and random triangle soups, copied in numpy."""

from __future__ import annotations

import numpy as np

from .materials import MATERIAL_DIFFUSE, MATERIAL_GLOSSY, Material
from .mesh import Mesh, compute_smooth_normals


def quad(p0, p1, p2, p3) -> tuple[np.ndarray, np.ndarray]:
    """Two CCW triangles for the quad p0..p3 (positions, indices)."""
    pos = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return pos, idx


def box_mesh(center, size, material_id: int = 0, yaw: float = 0.0) -> Mesh:
    """Axis-aligned box rotated by `yaw` about Y, outward-facing CCW faces."""
    cx, cy, cz = center
    sx, sy, sz = (s / 2.0 for s in size)
    corners = np.array(
        [
            [-sx, -sy, -sz], [sx, -sy, -sz], [sx, -sy, sz], [-sx, -sy, sz],
            [-sx, sy, -sz], [sx, sy, -sz], [sx, sy, sz], [-sx, sy, sz],
        ],
        np.float32,
    )
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    corners = corners @ rot.T + np.array([cx, cy, cz], np.float32)
    faces = np.array(
        [
            [0, 1, 2], [0, 2, 3],  # bottom (-y)
            [4, 6, 5], [4, 7, 6],  # top (+y)
            [0, 5, 1], [0, 4, 5],  # front (-z)
            [2, 7, 3], [2, 6, 7],  # back (+z)
            [3, 4, 0], [3, 7, 4],  # left (-x)
            [1, 6, 2], [1, 5, 6],  # right (+x)
        ],
        np.int32,
    )
    # Flat shading: unweld so each face keeps its geometric normal.
    pos = corners[faces.reshape(-1)]
    idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    nrm = np.repeat(fn, 3, axis=0).astype(np.float32)
    return Mesh(
        pos, nrm, idx, material_ids=np.full(len(idx), material_id, np.int32), name="box"
    )


def merge_meshes(meshes: list[Mesh], name: str = "merged") -> Mesh:
    pos = np.concatenate([m.positions for m in meshes])
    nrm = np.concatenate([m.normals for m in meshes])
    offs = np.cumsum([0] + [len(m.positions) for m in meshes[:-1]])
    idx = np.concatenate([m.indices + o for m, o in zip(meshes, offs)])
    mids = np.concatenate([m.material_ids for m in meshes])
    return Mesh(pos, nrm, idx, material_ids=mids, name=name)


def cornell_box(glossy_tall_box: bool = False) -> tuple[Mesh, list[Material]]:
    """Classic Cornell box scaled to x in [-1,1], y in [0,2], z in [-1,1],
    open toward +z: white floor/ceiling/back, red left, green right wall,
    an emissive ceiling panel and two boxes (36 triangles).

    Material ids: 0 white, 1 red, 2 green, 3 ceiling light (emissive),
    4 tall box (glossy if requested else white)."""
    meshes = []

    def add_quad(p0, p1, p2, p3, mid):
        pos, idx = quad(p0, p1, p2, p3)
        nrm = compute_smooth_normals(pos, idx)
        meshes.append(
            Mesh(pos, nrm, idx, material_ids=np.full(2, mid, np.int32), name="wall")
        )

    add_quad([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1], 0)  # floor
    add_quad([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1], 0)  # ceiling
    add_quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1], 0)  # back
    add_quad([-1, 0, -1], [-1, 2, -1], [-1, 2, 1], [-1, 0, 1], 1)  # left, red
    add_quad([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1], 2)  # right, green
    e = 0.35  # emissive ceiling panel slightly below the ceiling
    add_quad([-e, 1.98, -e], [e, 1.98, -e], [e, 1.98, e], [-e, 1.98, e], 3)

    # tall box (left-back), rotated ~17 deg; short box (right-front), ~-18 deg
    meshes.append(box_mesh((-0.35, 0.6, -0.35), (0.6, 1.2, 0.6), 4, yaw=np.radians(17)))
    meshes.append(box_mesh((0.4, 0.3, 0.35), (0.6, 0.6, 0.6), 0, yaw=np.radians(-18)))

    materials = [
        Material(albedo=(0.73, 0.73, 0.73, 1.0)),
        Material(albedo=(0.65, 0.05, 0.05, 1.0)),
        Material(albedo=(0.12, 0.45, 0.15, 1.0)),
        Material(albedo=(0.78, 0.78, 0.78, 1.0), emissive=(1.0, 0.85, 0.6, 15.0)),
        Material(
            albedo=(0.73, 0.73, 0.73, 1.0),
            specular=(0.58, 0.58, 0.58, 1.0),
            reflectivity=0.7,
            roughness=0.2,
            type=MATERIAL_GLOSSY,
        )
        if glossy_tall_box
        else Material(albedo=(0.73, 0.73, 0.73, 1.0), type=MATERIAL_DIFFUSE),
    ]
    return merge_meshes(meshes, name="cornell_box"), materials


def random_triangle_soup(n: int, seed: int = 0, extent: float = 10.0) -> Mesh:
    """N random small triangles in a cube."""
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-extent, extent, size=(n, 1, 3))
    offsets = rs.normal(scale=extent * 0.02, size=(n, 3, 3))
    pos = (centers + offsets).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * 3, dtype=np.int32).reshape(-1, 3)
    return Mesh(pos, None, idx, name=f"soup{n}")
