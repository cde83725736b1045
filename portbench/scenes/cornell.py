"""The Cornell box with the glossy tall box, frozen for the benchmark.

A copy of ``cornell_box`` (``glossy_tall_box=True``), ``quad``, ``box_mesh``
and ``compute_smooth_normals`` of ``dxrexperiments_torch/scene/procedural.py``
and ``scene/mesh.py``, and of the "cornell-glossy" rig and framing of
``app/headless.build_scene``, in numpy alone. The benchmark hands the arrays
built here to the port, through its public ``Scene`` API, and to the
reference renderer, so a later change to the port's generators moves
neither side.

36 triangles in one mesh; material ids 0 white, 1 red, 2 green, 3 the
emissive ceiling panel, 4 the glossy tall box.
"""

from __future__ import annotations

import numpy as np

from .spec import material


def smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (float64 sums, float32 result)."""
    normals = np.zeros_like(positions, dtype=np.float64)
    v0 = positions[indices[:, 0]].astype(np.float64)
    v1 = positions[indices[:, 1]].astype(np.float64)
    v2 = positions[indices[:, 2]].astype(np.float64)
    face_n = np.cross(v1 - v0, v2 - v0)
    for k in range(3):
        np.add.at(normals, indices[:, k], face_n)
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.where(lens > 1e-12, lens, 1.0)).astype(np.float32)


def _quad(p0, p1, p2, p3, mid):
    pos = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return pos, smooth_normals(pos, idx), idx, np.full(2, mid, np.int32)


def _box(center, size, mid, yaw):
    """Box rotated by ``yaw`` about y, unwelded so each face keeps its
    geometric normal."""
    sx, sy, sz = (s / 2.0 for s in size)
    corners = np.array([[-sx, -sy, -sz], [sx, -sy, -sz], [sx, -sy, sz], [-sx, -sy, sz],
                        [-sx, sy, -sz], [sx, sy, -sz], [sx, sy, sz], [-sx, sy, sz]], np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    corners = corners @ rot.T + np.array(center, np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 5, 1], [0, 4, 5],
                      [2, 7, 3], [2, 6, 7], [3, 4, 0], [3, 7, 4], [1, 6, 2], [1, 5, 6]], np.int32)
    pos = corners[faces.reshape(-1)]
    idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
    fn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]], pos[idx[:, 2]] - pos[idx[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    return pos, np.repeat(fn, 3, axis=0).astype(np.float32), idx, np.full(len(idx), mid, np.int32)


def build(params: dict) -> dict:
    """The scene spec (``scenes/spec.py``) of the glossy Cornell box."""
    e = 0.35
    parts = [
        _quad([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1], 0),  # floor
        _quad([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1], 0),  # ceiling
        _quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1], 0),  # back
        _quad([-1, 0, -1], [-1, 2, -1], [-1, 2, 1], [-1, 0, 1], 1),  # left, red
        _quad([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1], 2),  # right, green
        _quad([-e, 1.98, -e], [e, 1.98, -e], [e, 1.98, e], [-e, 1.98, e], 3),  # light panel
        _box((-0.35, 0.6, -0.35), (0.6, 1.2, 0.6), 4, np.radians(17)),  # tall box
        _box((0.4, 0.3, 0.35), (0.6, 0.6, 0.6), 0, np.radians(-18)),  # short box
    ]
    offsets = np.cumsum([0] + [len(p[0]) for p in parts[:-1]])
    mesh = {
        "positions": np.concatenate([p[0] for p in parts]),
        "normals": np.concatenate([p[1] for p in parts]),
        "indices": np.concatenate([p[2] + o for p, o in zip(parts, offsets)]).astype(np.int32),
        "material_ids": np.concatenate([p[3] for p in parts]),
    }
    materials = [
        material(albedo=(0.73, 0.73, 0.73)),
        material(albedo=(0.65, 0.05, 0.05)),
        material(albedo=(0.12, 0.45, 0.15)),
        material(albedo=(0.78, 0.78, 0.78), emissive=(1.0, 0.85, 0.6, 15.0)),
        material(albedo=(0.73, 0.73, 0.73), specular=(0.58, 0.58, 0.58), reflectivity=0.7,
                 roughness=0.2, type=1),
    ]
    return {
        "meshes": [mesh],
        "instances": [{"mesh": 0, "transform": np.eye(4, dtype=np.float32), "material": None}],
        "materials": materials,
        "lights": {
            "dir": {"forward": (0.0, -0.6, -0.8), "color": (0.9, 0.9, 0.9), "intensity": 0.6},
            "point": {"position": (0.0, 1.8, 0.0), "color": (1.0, 0.9, 0.7), "intensity": 6.0},
        },
        "env": {"kind": "constant", "color": (0.0, 0.0, 0.0), "strength": 1.0},
        "camera": {"eye": (0.0, 1.0, 3.4), "at": (0.0, 1.0, 0.0), "up": (0.0, 1.0, 0.0),
                   "fov_y": float(np.pi / 4.0)},
    }
