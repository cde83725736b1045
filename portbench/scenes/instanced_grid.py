"""A K x K grid of UV spheres on a floor quad, frozen for the benchmark.

A copy of ``_instanced_scene`` of ``dxrexperiments_torch/app/headless.py``
(``instanced:K``) with ``sphere_mesh`` of ``scene/procedural.py`` and the
default rig of ``scene/lights.py`` (the animated sun frozen at the
reference's t = 142 s and a point light at the origin), in numpy alone.
At K = 32 with 16 x 32 spheres it has 32 * 32 * 960 + 2 = 983,042
triangles: the repository's stand-in for the reference's "1M+ triangle
instanced scene". Spheres alternate the reference's red glossy material and
white; the floor is white; the env is the gradient sky.
"""

from __future__ import annotations

import math

import numpy as np

from .cornell import smooth_normals
from .spec import material


def sphere(lat: int, lon: int) -> dict:
    """Unit UV sphere at the origin with smooth (radial) normals."""
    thetas = np.linspace(0, np.pi, lat + 1)
    phis = np.linspace(0, 2 * np.pi, lon, endpoint=False)
    t, p = np.meshgrid(thetas, phis, indexing="ij")
    pos = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)],
                   axis=-1).reshape(-1, 3)
    idx = []
    for i in range(lat):
        for j in range(lon):
            a, b = i * lon + j, i * lon + (j + 1) % lon
            c, d = (i + 1) * lon + j, (i + 1) * lon + (j + 1) % lon
            if i > 0:
                idx.append([a, c, b])
            if i < lat - 1:
                idx.append([b, c, d])
    idx = np.asarray(idx, np.int32)
    return {"positions": pos.astype(np.float32), "normals": pos.astype(np.float32),
            "indices": idx, "material_ids": np.zeros(len(idx), np.int32)}


def sun_forward(elapsed_time: float) -> tuple:
    """The reference's animated sun: (0.3, -0.2, -1) turned about y by
    sin(0.2 t) * pi / 2, rounded to float32."""
    angle = math.sin(elapsed_time * 0.2) * math.pi * 0.5
    c, s = math.cos(angle), math.sin(angle)
    rot = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
    return tuple(float(x) for x in (np.array([0.3, -0.2, -1.0]) @ rot).astype(np.float32))


def build(params: dict) -> dict:
    """The scene spec (``scenes/spec.py``): ``params`` gives ``grid`` (K),
    ``spacing``, ``lat`` and ``lon``."""
    k, spacing = int(params["grid"]), float(params["spacing"])
    ext = k * spacing
    floor_pos = np.array([[-ext, 0, -ext], [-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext]],
                         np.float32)
    floor_idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    meshes = [sphere(int(params["lat"]), int(params["lon"])),
              {"positions": floor_pos, "normals": smooth_normals(floor_pos, floor_idx),
               "indices": floor_idx, "material_ids": np.zeros(2, np.int32)}]
    instances = []
    for i in range(k):
        for j in range(k):
            t = np.eye(4, dtype=np.float32)
            t[0, 3] = (i - k / 2) * spacing
            t[2, 3] = (j - k / 2) * spacing
            t[1, 3] = 1.0
            instances.append({"mesh": 0, "transform": t, "material": 0 if (i + j) % 2 else 1})
    instances.append({"mesh": 1, "transform": np.eye(4, dtype=np.float32), "material": 1})
    return {
        "meshes": meshes,
        "instances": instances,
        "materials": [
            material(albedo=(0.95, 0.05, 0.0), specular=(0.58, 0.58, 0.58), roughness=0.5,
                     reflectivity=0.7, type=1),
            material(albedo=(0.73, 0.73, 0.73)),
        ],
        "lights": {
            "dir": {"forward": sun_forward(142.0), "color": (0.9, 0.9, 0.9), "intensity": 1.0},
            "point": {"position": (0.0, 0.0, 0.0), "color": (0.2, 0.8, 0.6), "intensity": 2.0},
        },
        "env": {"kind": "gradient", "horizon": (0.8, 0.85, 1.0), "zenith": (0.2, 0.35, 0.7),
                "strength": 1.0},
        "camera": {"eye": (ext * 0.9, ext * 0.5, ext * 0.9), "at": (0.0, 1.0, 0.0),
                   "up": (0.0, 1.0, 0.0), "fov_y": float(np.pi / 4.0)},
    }
