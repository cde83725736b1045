"""Scene assembly: instances -> flattened world-space SoA + intersection
precomputes (``dxrexperiments_tpu.scene.scene``, brute-force fields only).

The numpy lowering is copied line for line, so ``mt_pack`` and ``attr_pack``
are bit-identical to the JAX build. Scenes that need a BVH (more than
BVH_THRESHOLD triangles), textures or a PRIME table raise: they wait for
ROADMAP Queue A items 11-13.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import envmap as envmap_mod
from .lights import default_lights
from .materials import Material, stack_materials, stack_materials_np
from .mesh import Mesh

TRI_ALIGN = 8  # pad the triangle count to a multiple of 8 (the JAX packing)
BVH_THRESHOLD = 4096  # above this the JAX build attaches a BVH


def to_device(tree, device):
    """Move every tensor of a nested dict/list to ``device``; other leaves
    (Python ints such as an env's ``kind``) pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


@dataclasses.dataclass
class Instance:
    """One placed model: mesh + 4x4 transform + optional material override."""

    mesh: Mesh
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    material_override: int | None = None


class Scene:
    """Host-side scene graph; ``build()`` lowers it to the device dict."""

    def __init__(self):
        self.instances: list[Instance] = []
        self.materials: list[Material] = []
        self.lights: dict | None = None
        self.environment: dict | None = None

    def add_material(self, material: Material) -> int:
        self.materials.append(material)
        return len(self.materials) - 1

    def add_model(self, mesh: Mesh, transform=None, material=None) -> int:
        t = np.eye(4, dtype=np.float32) if transform is None else np.asarray(
            transform, np.float32
        )
        if t.shape == (3, 4):
            t = np.concatenate([t, [[0, 0, 0, 1]]], axis=0).astype(np.float32)
        override = self.add_material(material) if isinstance(material, Material) else material
        self.instances.append(Instance(mesh, t, override))
        return len(self.instances) - 1

    def build_numpy(self) -> dict[str, Any]:
        """The numpy half of ``build``: world-space triangles, the
        Möller–Trumbore precomputes and the kernel packs."""
        v0s, e1s, e2s, n0s, n1s, n2s, mat_ids = [], [], [], [], [], [], []
        mat_offset_for_mesh: dict[int, int] = {}
        materials = list(self.materials)

        for inst in self.instances:
            mesh = inst.mesh
            m = inst.transform
            rot = m[:3, :3]
            trans = m[:3, 3]
            nrm_m = np.linalg.inv(rot).T if abs(np.linalg.det(rot)) > 1e-12 else rot
            pos = mesh.positions @ rot.T + trans
            nrm = mesh.normals @ nrm_m.T
            nl = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = nrm / np.where(nl > 1e-12, nl, 1.0)
            tri = mesh.indices
            p0, p1, p2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
            v0s.append(p0)
            e1s.append(p1 - p0)
            e2s.append(p2 - p0)
            n0s.append(nrm[tri[:, 0]])
            n1s.append(nrm[tri[:, 1]])
            n2s.append(nrm[tri[:, 2]])
            if inst.material_override is not None:
                ids = np.full(len(tri), inst.material_override, np.int32)
            elif mesh.materials:
                key = id(mesh)
                if key not in mat_offset_for_mesh:
                    mat_offset_for_mesh[key] = len(materials)
                    materials.extend(mesh.materials)
                ids = mesh.material_ids + mat_offset_for_mesh[key]
            else:
                ids = np.clip(mesh.material_ids, 0, max(len(materials) - 1, 0))
            mat_ids.append(ids)

        if not materials:
            materials = [Material()]
        if v0s:
            v0 = np.concatenate(v0s).astype(np.float32)
            e1 = np.concatenate(e1s).astype(np.float32)
            e2 = np.concatenate(e2s).astype(np.float32)
            n0 = np.concatenate(n0s).astype(np.float32)
            n1 = np.concatenate(n1s).astype(np.float32)
            n2 = np.concatenate(n2s).astype(np.float32)
            mid = np.concatenate(mat_ids).astype(np.int32)
        else:
            v0 = e1 = e2 = n0 = n1 = n2 = np.zeros((0, 3), np.float32)
            mid = np.zeros((0,), np.int32)

        num_tris = len(v0)
        if num_tris > BVH_THRESHOLD:
            raise NotImplementedError(
                f"{num_tris} triangles need a BVH, which is not ported yet "
                "(ROADMAP Queue A item 11)"
            )
        if num_tris <= 512:
            padded = max(TRI_ALIGN, -(-num_tris // TRI_ALIGN) * TRI_ALIGN)
        else:
            padded = -(-num_tris // 512) * 512

        def pad3(a):
            out = np.zeros((padded, 3), np.float32)
            out[: len(a)] = a
            return out

        v0, e1, e2 = pad3(v0), pad3(e1), pad3(e2)
        n0, n1, n2 = pad3(n0), pad3(n1), pad3(n2)
        mid_p = np.zeros((padded,), np.int32)
        mid_p[:num_tris] = mid
        mid = mid_p

        # Plücker / scalar-triple-product precomputes (ops/intersect.py):
        #   det = -(D . pn), u*det = M . e2 + D . c1, v*det = -M . e1 - D . c2,
        #   t*det = O . pn - d0, with M = O x D.
        pn = np.cross(e1, e2)
        c1 = np.cross(v0, e2)
        c2 = np.cross(v0, e1)
        d0 = np.sum(v0 * pn, axis=-1)

        # mt_pack [4, T, 16]: per term group g, term = sum_k mt[g, c, k] * lhs_k
        # with lhs = [D, M, O, 1].
        mt_pack = np.zeros((4, padded, 16), np.float32)
        mt_pack[0, :, 0:3] = -pn
        mt_pack[1, :, 0:3] = c1
        mt_pack[1, :, 3:6] = e2
        mt_pack[2, :, 0:3] = -c2
        mt_pack[2, :, 3:6] = -e1
        mt_pack[3, :, 6:9] = pn
        mt_pack[3, :, 9] = -d0

        # attr_pack [32, T]: vertex normals, material id and the material row.
        mat_np = stack_materials_np(materials)
        attr = np.zeros((32, padded), np.float32)
        attr[0:3] = n0.T
        attr[3:6] = n1.T
        attr[6:9] = n2.T
        attr[9] = mid.astype(np.float32)
        attr[10:13] = mat_np["albedo"][mid].T
        attr[13:16] = mat_np["specular"][mid].T
        attr[16:19] = mat_np["emissive"][mid].T
        attr[19] = mat_np["emissive_strength"][mid]
        attr[20] = mat_np["reflectivity"][mid]
        attr[21] = mat_np["roughness"][mid]
        attr[22] = mat_np["ior"][mid]
        attr[23] = mat_np["type"][mid].astype(np.float32)

        return {
            "mt_pack": mt_pack,
            "attr_pack": attr,
            "v0": v0, "e1": e1, "e2": e2,
            "n0": n0, "n1": n1, "n2": n2,
            "pn": pn.astype(np.float32),
            "c1": c1.astype(np.float32),
            "c2": c2.astype(np.float32),
            "d0": d0.astype(np.float32),
            "mat_id": mid,
            "num_tris": num_tris,
            "materials": materials,
        }

    def build(self, device: str | torch.device = "cpu") -> dict[str, Any]:
        """Lower to the scene dict: geometry, packs and materials on
        ``device``; ``lights`` and ``env`` stay host (CPU) tensors, since they
        are per-frame parameters (the kernel wrapper packs them into its one
        upload per dispatch, the plain path moves them to its device)."""
        d = self.build_numpy()
        lights = self.lights if self.lights is not None else default_lights()
        env = (
            self.environment
            if self.environment is not None
            else envmap_mod.constant_env((0.0, 0.0, 0.0))
        )
        out = {
            k: torch.as_tensor(v).to(device)
            for k, v in d.items()
            if k not in ("materials", "num_tris")
        }
        out["mat_id"] = out["mat_id"].to(torch.int64)
        out["num_tris"] = d["num_tris"]
        out["materials"] = stack_materials(d["materials"], device)
        out["lights"] = to_device(lights, "cpu")
        out["env"] = to_device(env, "cpu")
        return out
