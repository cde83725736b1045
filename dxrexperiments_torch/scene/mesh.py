"""Triangle mesh container (``dxrexperiments_tpu.scene.mesh``).

The numpy ``Mesh`` and ``compute_smooth_normals`` are copied as they are.
The OBJ/PLY/glTF loaders wait for ROADMAP Queue A item 15.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .materials import Material


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh on the host.

    positions: [V, 3] float32, normals: [V, 3] float32 (unit),
    indices: [F, 3] int32, material_ids: [F] int32 (index into materials),
    materials: list of Material declared by the source (may be empty).
    """

    positions: np.ndarray
    normals: np.ndarray
    indices: np.ndarray
    material_ids: np.ndarray | None = None
    materials: list[Material] = dataclasses.field(default_factory=list)
    name: str = ""

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float32).reshape(-1, 3)
        self.indices = np.asarray(self.indices, np.int32).reshape(-1, 3)
        if self.normals is None or len(self.normals) == 0:
            self.normals = compute_smooth_normals(self.positions, self.indices)
        self.normals = np.asarray(self.normals, np.float32).reshape(-1, 3)
        if self.material_ids is None:
            self.material_ids = np.zeros(len(self.indices), np.int32)
        self.material_ids = np.asarray(self.material_ids, np.int32)


def compute_smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    normals = np.zeros_like(positions, dtype=np.float64)
    v0 = positions[indices[:, 0]].astype(np.float64)
    v1 = positions[indices[:, 1]].astype(np.float64)
    v2 = positions[indices[:, 2]].astype(np.float64)
    face_n = np.cross(v1 - v0, v2 - v0)  # length = 2*area (area weighting)
    for k in range(3):
        np.add.at(normals, indices[:, k], face_n)
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    lens = np.where(lens > 1e-12, lens, 1.0)
    return (normals / lens).astype(np.float32)
