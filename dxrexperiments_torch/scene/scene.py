"""Scene assembly (``dxrexperiments_tpu.scene.scene``): instances ->
flattened world-space SoA + intersection precomputes + the BVH (``build``),
or the two-level TLAS/BLAS scene (``build_two_level``).

The numpy lowering is copied line for line, so ``mt_pack``, ``attr_pack``,
the ``bvh`` sub-dict and the two-level BLAS arrays are bit-identical to the
JAX build. ``accel``: 'auto' attaches a BVH above BVH_THRESHOLD triangles,
and below it to a scene with a texture env or an albedo texture that the
fused-traversal kernel's gate would take (tagged ``tex_autoroute``: the BVH
exists for the route, and the brute-force megakernel still takes such a
scene where it can); 'bvh' always, 'none' never. A scene with a textured
material carries ``textures`` (``scene/textures.py``: the texel table and
the per-material meta) and the corner UVs ``uv0``, ``uv1``, ``uv2`` [T, 2]
(two-level: ``uv0_obj`` ...). Both builds place the scene on the card by
default and raise without one. ``rebake_material`` replaces one material
of a built flat scene (the viewer's live edit), rebuilding the arrays that
hold material values. A scene with a BVH (or a two-level one) whose few
largest triangles dominate it carries the PRIME table ``prime_v0``,
``prime_e1``, ``prime_e2`` (``select_prime_triangles``): the world-space
triangles that ``trace/integrator._prime_seed_tmax`` tests bounce rays
against under ``DXR_PRIME=1``; a two-level scene also keeps their
object-space sources in ``tlas_meta["prime_src"]`` for the refit.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..accel import bvh as bvh_mod
from ..accel import tlas as tlas_mod
from ..core.device import setup_device
from ..ops.traverse import leaf_records, pack_for_traversal, tri_records
from ..utils.profiling import annotate
from . import envmap as envmap_mod
from .lights import default_lights, light_counts
from .materials import (
    MP_MAX_MATERIALS,
    Material,
    material_pack,
    stack_materials,
    stack_materials_np,
)
from .mesh import Mesh
from .textures import pack_texture_table

TRI_ALIGN = 8  # pad the triangle count to a multiple of 8 (the JAX packing)
BVH_THRESHOLD = 4096  # above this triangle count, 'auto' attaches a BVH
BVH_LEAF_SIZE = 32  # fixed leaf size (slots per leaf) of the traversal kernels
ACCELS = ("auto", "bvh", "none")

# PRIME triangles: the few scene-dominating triangles (floors, walls) kept
# as a world-space side table so that bounce traces can pre-seed their t_max
# against them (trace/integrator._prime_seed_tmax). The selection is a
# heuristic: correctness never depends on which triangles are chosen, only
# on their world-space coordinates being current (see the refit).
PRIME_MAX = 8
PRIME_AREA_FRAC = 0.02  # keep triangles with area >= frac * max_extent^2


def select_prime_triangles(v0, e1, e2) -> np.ndarray:
    """Indices of up to PRIME_MAX triangles whose world area is at least
    PRIME_AREA_FRAC x (scene max extent)^2, typically floors and walls. An
    empty index array when nothing qualifies (a triangle soup), which the
    builds treat as "no prime table"."""
    if len(v0) == 0:
        return np.zeros((0,), np.int64)
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    p1, p2 = v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(v0.min(0), p1.min(0)), p2.min(0))
    hi = np.maximum(np.maximum(v0.max(0), p1.max(0)), p2.max(0))
    ext = float(np.max(hi - lo))
    if not np.isfinite(ext) or ext <= 0.0:
        return np.zeros((0,), np.int64)
    idx = np.argsort(-area, kind="stable")[:PRIME_MAX]
    return idx[area[idx] >= PRIME_AREA_FRAC * ext * ext]


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


def add_tri_records(scene: dict) -> None:
    """Give a flat scene of at most BVH_THRESHOLD triangle rows the triangle
    records (``ops/traverse.tri_records``) that B1 (at most FUSED_MAX_TRIS
    rows) and B3 stage, built from its ``mt_pack`` on that pack's device. A
    larger flat scene (``accel="none"`` forced) gets none: B3's wrapper
    builds them at each trace."""
    if int(scene["mt_pack"].shape[1]) <= BVH_THRESHOLD:
        scene["tri_records"] = tri_records(scene["mt_pack"])


def bvh_to_device(bvh: dict, materials: dict, device) -> dict:
    """The scene entries of a BVH (``pack_for_traversal``'s arrays, numpy or
    tensors) and its stacked materials: {"bvh": ...} with the kernels'
    arrays ``bvhf_rows`` (B4a, B5), ``bvh_rows`` (B4b), ``bvh8_rows``
    (B4d), ``mt_rows`` and ``slot_tri`` on ``device``, the fused-traversal
    kernel's leaf arrays ``ft_test`` and ``ft_attr`` built from ``mt_rows``
    there (``ops/traverse.leaf_records``), and the JAX
    package's node layouts ``bvh_nodes``, ``bvhf_nodes`` and ``bvh8_nodes``
    left on the host (no kernel reads them); and, for at most MP_MAX_MATERIALS
    materials, ``material_pack``, the fused-traversal kernel's material
    table, built once here."""
    on_device = ("bvhf_rows", "bvh_rows", "bvh8_rows", "mt_rows", "slot_tri")
    out = {"bvh": {
        k: v if isinstance(v, (int, str))
        else torch.as_tensor(v).to(device if k in on_device else "cpu")
        for k, v in bvh.items()
    }}
    out["bvh"]["ft_test"], out["bvh"]["ft_attr"] = leaf_records(out["bvh"]["mt_rows"])
    if int(materials["albedo"].shape[0]) <= MP_MAX_MATERIALS:
        out["material_pack"] = material_pack(materials)
    return out


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

    def _env(self) -> dict:
        return (self.environment if self.environment is not None
                else envmap_mod.constant_env((0.0, 0.0, 0.0)))

    def _texture_route(self, num_materials: int, textured: bool) -> bool:
        """JAX ``scene.py:316-346``: a texture env or an albedo texture
        routes a small scene through a BVH when the fused-traversal kernel's
        rig and material gates would take it (at most one light per group,
        at least one light, at most MP_MAX_MATERIALS materials)."""
        lights = self.lights if self.lights is not None else default_lights()
        d_n, p_n, a_n = light_counts(lights)
        rig_ok = d_n <= 1 and p_n <= 1 and a_n <= 1 and d_n + p_n + a_n >= 1
        texture_env = int(self._env()["kind"]) in (envmap_mod.ENV_LATLONG,
                                                    envmap_mod.ENV_CUBEMAP)
        return rig_ok and (texture_env or textured) and num_materials <= MP_MAX_MATERIALS

    def build_numpy(self, accel: str = "auto") -> dict[str, Any]:
        """The numpy half of ``build``: world-space triangles, the
        Möller–Trumbore precomputes, the kernel packs and, per ``accel``,
        the ``bvh`` sub-dict (with ``builder``: "sah" or "morton", and
        ``tex_autoroute``: 1 when the BVH exists only for the route of a
        texture env or an albedo texture), and ``textures``, ``uv0``,
        ``uv1``, ``uv2`` when some
        material is textured."""
        if accel not in ACCELS:
            raise ValueError(f"unknown accel {accel!r} ({', '.join(ACCELS)})")
        v0s, e1s, e2s, n0s, n1s, n2s, mat_ids, uvcs = [], [], [], [], [], [], [], []
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
            uvcs.append(mesh.uv_corners if mesh.uv_corners is not None
                        else np.zeros((len(tri), 3, 2), np.float32))
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

        out = {
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
        # albedo textures: the table and the corner UVs only when some
        # material is textured (the kernels' gates key off "textures")
        textures = pack_texture_table(materials)
        if textures is not None:
            uv_pad = np.zeros((padded, 3, 2), np.float32)
            if uvcs:
                uvc = np.concatenate(uvcs).astype(np.float32)
                uv_pad[: len(uvc)] = uvc
            out["textures"] = textures
            for k in range(3):
                out[f"uv{k}"] = np.ascontiguousarray(uv_pad[:, k])
        want_bvh = accel == "bvh" or (accel == "auto" and num_tris > BVH_THRESHOLD)
        tex_autoroute = (accel == "auto" and not want_bvh and num_tris > 0
                         and self._texture_route(len(materials), textures is not None))
        # the world-space PRIME table, wherever a BVH is attached (the
        # brute-force routes ignore it), whether DXR_PRIME is set or not
        pidx = select_prime_triangles(v0, e1, e2)
        if len(pidx) and (want_bvh or tex_autoroute):
            out["prime_v0"], out["prime_e1"], out["prime_e2"] = v0[pidx], e1[pidx], e2[pidx]
        if (want_bvh or tex_autoroute) and num_tris > 0:
            nodes, builder = bvh_mod.build_nodes(v0, e1, e2, num_tris, BVH_LEAF_SIZE)
            packed = pack_for_traversal(nodes, out, BVH_LEAF_SIZE)
            packed.pop("leaf_size")  # always BVH_LEAF_SIZE
            packed["builder"] = builder
            if tex_autoroute:
                packed["tex_autoroute"] = 1
            out["bvh"] = packed
        return out

    def build(self, device: str | torch.device = "cuda", accel: str = "auto") -> dict[str, Any]:
        """Lower to the scene dict: geometry, packs, the BVH (per ``accel``,
        see ``build_numpy`` and ``bvh_to_device``), materials and albedo
        textures on ``device`` (default the card; without one it raises),
        each moved once per build, and the ``tri_records`` of B1 and B3 built there
        (``add_tri_records``); ``lights`` and the env's
        scalars stay host (CPU) tensors, since they are per-frame parameters
        (the kernel wrapper packs them into its one upload per dispatch, the
        plain path moves them to its device); a texture env's texture leaves
        go to ``device`` here, once (``envmap.place``)."""
        with annotate("scene.build"):
            device = setup_device(device)
            d = self.build_numpy(accel)
            lights = self.lights if self.lights is not None else default_lights()
            with annotate("scene.upload"):
                out = {
                    k: torch.as_tensor(v).to(device)
                    for k, v in d.items()
                    if k not in ("materials", "num_tris", "bvh", "textures")
                }
                if "textures" in d:
                    out["textures"] = {k: torch.as_tensor(v).to(device)
                                       for k, v in d["textures"].items()}
                out["mat_id"] = out["mat_id"].to(torch.int64)
                materials = stack_materials(d["materials"], device)
                env = envmap_mod.place(self._env(), device)
            out["num_tris"] = d["num_tris"]
            with annotate("scene.records"):
                add_tri_records(out)
            out["materials"] = materials
            if "bvh" in d:
                with annotate("scene.bvh_to_device"):
                    out.update(bvh_to_device(d["bvh"], materials, device))
            out["lights"] = to_device(lights, "cpu")
            out["env"] = env
            return out

    def build_two_level(self, device: str | torch.device = "cuda") -> dict[str, Any]:
        """Lower to the two-level TLAS/BLAS scene (``accel/tlas.py``): one
        object-space BLAS per unique mesh (keyed by ``id(mesh)``), shared by
        all its instances, a refittable TLAS over the instances' AABBs and
        per-instance inverse transforms. Geometry is not flattened, so memory
        is O(unique geometry) and animating transforms is a TLAS refit
        (``scene/dynamic.refit_scene_instances``).

        Returns ``tlas`` (tensors, see accel/tlas.py), ``tlas_meta`` (a plain
        dict: num_instances, slot_mesh, mesh_tri_ranges, refit_ctx), the
        concatenated object-space arrays ``v0_obj`` ... ``d0_obj``,
        ``n0_obj`` ... ``n2_obj`` and ``mat_id_obj`` and the stacked
        materials on ``device`` (default the card; without one it raises),
        ``lights`` and the env's scalars on the host (its texture leaves on
        ``device``), ``num_tris`` (the instanced total) and, when some
        material is textured, ``textures`` and the object-space corner UVs
        ``uv0_obj``, ``uv1_obj``, ``uv2_obj`` on ``device``; where some
        instanced triangles dominate the scene, the world-space PRIME table
        ``prime_v0``, ``prime_e1``, ``prime_e2`` and its sources
        ``tlas_meta["prime_src"]`` (object-space ``v0``, ``e1``, ``e2`` and
        the owning instance ``inst``, original instance order) on
        ``device``."""
        with annotate("scene.build"):
            device = setup_device(device)
            materials = list(self.materials)
            mat_offset_for_mesh: dict[int, int] = {}
            mesh_index: dict[int, int] = {}
            meshes_geo = []  # (v0, e1, e2) per unique mesh
            mesh_attr = []  # (n0, n1, n2, mat_id, uv_corners) per unique mesh
            inst_mesh = np.zeros((len(self.instances),), np.int64)
            transforms = np.zeros((len(self.instances), 4, 4), np.float32)
            overrides = np.full((len(self.instances),), -1, np.int64)

            for inst_idx, inst in enumerate(self.instances):
                mesh = inst.mesh
                key = id(mesh)
                if key not in mesh_index:
                    mesh_index[key] = len(meshes_geo)
                    tri = mesh.indices
                    p0 = mesh.positions[tri[:, 0]]
                    p1 = mesh.positions[tri[:, 1]]
                    p2 = mesh.positions[tri[:, 2]]
                    if mesh.materials:
                        if key not in mat_offset_for_mesh:
                            mat_offset_for_mesh[key] = len(materials)
                            materials.extend(mesh.materials)
                        mid = mesh.material_ids + mat_offset_for_mesh[key]
                    else:
                        mid = np.clip(mesh.material_ids, 0, max(len(materials) - 1, 0))
                    meshes_geo.append((p0.astype(np.float32), (p1 - p0).astype(np.float32),
                                       (p2 - p0).astype(np.float32)))
                    mesh_attr.append((mesh.normals[tri[:, 0]].astype(np.float32),
                                      mesh.normals[tri[:, 1]].astype(np.float32),
                                      mesh.normals[tri[:, 2]].astype(np.float32),
                                      mid.astype(np.int32),
                                      mesh.uv_corners if mesh.uv_corners is not None
                                      else np.zeros((len(tri), 3, 2), np.float32)))
                inst_mesh[inst_idx] = mesh_index[key]
                transforms[inst_idx] = inst.transform
                if inst.material_override is not None:
                    overrides[inst_idx] = inst.material_override

            if not materials:
                materials = [Material()]
            if not meshes_geo:
                raise ValueError("two-level build requires at least one instance")

            tl, ctx = tlas_mod.build_two_level(meshes_geo, inst_mesh, transforms, overrides,
                                               leaf_size=BVH_LEAF_SIZE, device=device)

            # concatenated object-space attribute and plain-version arrays
            v0 = np.concatenate([g[0] for g in meshes_geo])
            e1 = np.concatenate([g[1] for g in meshes_geo])
            e2 = np.concatenate([g[2] for g in meshes_geo])
            pn = np.cross(e1, e2)
            c1 = np.cross(v0, e2)
            c2 = np.cross(v0, e1)
            d0 = np.sum(v0 * pn, axis=-1)
            obj = {"v0": v0, "e1": e1, "e2": e2, "pn": pn, "c1": c1, "c2": c2, "d0": d0}
            for k in range(3):
                obj[f"n{k}"] = np.concatenate([a[k] for a in mesh_attr])
            ranges = []
            base = 0
            for g in meshes_geo:
                ranges.append((base, base + len(g[0])))
                base += len(g[0])

            lights = self.lights if self.lights is not None else default_lights()
            with annotate("scene.upload"):
                out = {
                    "tlas": tl,
                    "tlas_meta": {
                        "num_instances": ctx.num_instances,
                        "slot_mesh": inst_mesh[ctx.inst_order].astype(np.int32),
                        "mesh_tri_ranges": ranges,
                        "refit_ctx": ctx,
                    },
                    **{f"{k}_obj": torch.as_tensor(v.astype(np.float32)).to(device)
                       for k, v in obj.items()},
                    "mat_id_obj": torch.as_tensor(
                        np.concatenate([a[3] for a in mesh_attr]).astype(np.int64)).to(device),
                    "materials": stack_materials(materials, device),
                    "lights": to_device(lights, "cpu"),
                    "env": envmap_mod.place(self._env(), device),
                    "num_tris": int(sum(len(meshes_geo[int(m)][0]) for m in inst_mesh)),
                }
            self._prime_two_level(out, meshes_geo, inst_mesh, transforms, device)
            textures = pack_texture_table(materials)
            if textures is not None:
                uvc = np.concatenate([a[4] for a in mesh_attr]).astype(np.float32)
                out["textures"] = {k: torch.as_tensor(v).to(device) for k, v in textures.items()}
                for k in range(3):
                    out[f"uv{k}_obj"] = torch.as_tensor(np.ascontiguousarray(uvc[:, k])).to(device)
            return out

    @staticmethod
    def _prime_two_level(out: dict, meshes_geo, inst_mesh, transforms, device) -> None:
        """The two-level PRIME table (JAX ``scene.py:500-538``): candidates are
        each mesh's top-PRIME_MAX object-space triangles by area, taken
        through every instance's transform (no full world flatten); the
        selection then runs on the world candidates."""
        cand_obj, cand_inst = [], []
        for mi, (gv0, ge1, ge2) in enumerate(meshes_geo):
            top = select_prime_triangles(gv0, ge1, ge2)
            top = (
                np.argsort(-0.5 * np.linalg.norm(np.cross(ge1, ge2), axis=-1),
                           kind="stable")[:PRIME_MAX]
                if len(top) == 0 else top
            )
            for ii in np.nonzero(inst_mesh == mi)[0]:
                cand_obj.append((gv0[top], ge1[top], ge2[top]))
                cand_inst.append(np.full((len(top),), ii, np.int64))
        cv0 = np.concatenate([c[0] for c in cand_obj])
        ce1 = np.concatenate([c[1] for c in cand_obj])
        ce2 = np.concatenate([c[2] for c in cand_obj])
        cinst = np.concatenate(cand_inst)
        rot = transforms[cinst, :3, :3]
        trn = transforms[cinst, :3, 3]
        wv0 = np.einsum("nij,nj->ni", rot, cv0) + trn
        we1 = np.einsum("nij,nj->ni", rot, ce1)
        we2 = np.einsum("nij,nj->ni", rot, ce2)
        pidx = select_prime_triangles(wv0, we1, we2)
        if len(pidx):
            def dev(a, dtype=np.float32):
                return torch.as_tensor(np.ascontiguousarray(a.astype(dtype))).to(device)

            out["prime_v0"], out["prime_e1"], out["prime_e2"] = (
                dev(w[pidx]) for w in (wv0, we1, we2))
            out["tlas_meta"]["prime_src"] = {
                "v0": dev(cv0[pidx]), "e1": dev(ce1[pidx]), "e2": dev(ce2[pidx]),
                "inst": dev(cinst[pidx], np.int64),
            }


def scene_device(scene: dict) -> torch.device:
    """The device a scene dict's geometry lives on (flattened or two-level)."""
    return scene["materials"]["albedo"].device


def rebake_material(scene: dict, index: int, material: Material) -> dict:
    """A scene dict with material ``index`` replaced by ``material``
    (``dxrexperiments_tpu.scene.scene.rebake_material``): the live
    material edit of the viewer. Rebuilds every derived array that holds
    material values, on the scene's device: the stacked ``materials``,
    ``attr_pack`` rows 10-23 (the material row of each triangle, read by B1,
    B3 and the plain paths) from the unchanged per-triangle ``mat_id``, and
    ``material_pack`` (B5's material table) where the scene has one. The
    arrays that hold geometry and material ids only (``mt_pack``,
    ``tri_records``, the ``bvh`` with ``ft_test`` / ``ft_attr``) are shared
    with ``scene``, unchanged; so is the albedo texture table (JAX's
    function rebuilds no texture either). The input dict is not modified.

    A two-level scene (``Scene.build_two_level``) has no ``mat_id`` or
    ``attr_pack``: it raises KeyError, as JAX's function does on the same
    dict."""
    m = stack_materials_np([material])
    mats = {}
    for k, v in scene["materials"].items():
        mats[k] = v.clone()
        mats[k][index] = torch.as_tensor(m[k][0]).to(v.device, v.dtype)
    mid = scene["mat_id"]
    attr = scene["attr_pack"].clone()
    attr[10:13] = mats["albedo"][mid].T
    attr[13:16] = mats["specular"][mid].T
    attr[16:19] = mats["emissive"][mid].T
    attr[19] = mats["emissive_strength"][mid]
    attr[20] = mats["reflectivity"][mid]
    attr[21] = mats["roughness"][mid]
    attr[22] = mats["ior"][mid]
    attr[23] = mats["type"][mid].to(torch.float32)
    out = dict(scene, materials=mats, attr_pack=attr)
    if "material_pack" in scene:
        out["material_pack"] = material_pack(mats)
    return out
