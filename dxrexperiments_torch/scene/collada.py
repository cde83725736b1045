"""COLLADA (.dae) geometry importer (``dxrexperiments_tpu.scene.collada``,
copied): a minimal XML reader of triangles/polylist geometry, node
transforms baked into the vertices, per-primitive materials with
Phong/Lambert diffuse colours. Animation, controllers, cameras and textures
are ignored.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from .materials import MATERIAL_DIFFUSE, Material
from .mesh import Mesh, compute_smooth_normals


def _strip(tag: str) -> str:
    return tag.split("}")[-1]


def _find_all(el, name):
    return [c for c in el.iter() if _strip(c.tag) == name]


def _children(el, name):
    return [c for c in el if _strip(c.tag) == name]



def _parse_sources(mesh_el) -> dict[str, np.ndarray]:
    out = {}
    for src in _children(mesh_el, "source"):
        arr = _children(src, "float_array")
        if not arr:
            continue
        vals = np.asarray(arr[0].text.split(), np.float64)
        stride = 3
        for tc in _find_all(src, "accessor"):
            stride = int(tc.get("stride", 3))
        out["#" + src.get("id", "")] = vals.reshape(-1, stride)
    return out


def _node_matrix(node_el) -> np.ndarray:
    m = np.eye(4)
    for c in node_el:
        tag = _strip(c.tag)
        if tag == "matrix":
            m = m @ np.asarray(c.text.split(), np.float64).reshape(4, 4)
        elif tag == "translate":
            t = np.asarray(c.text.split(), np.float64)
            tm = np.eye(4)
            tm[:3, 3] = t
            m = m @ tm
        elif tag == "rotate":
            x, y, z, a = np.asarray(c.text.split(), np.float64)
            a = np.deg2rad(a)
            axis = np.array([x, y, z])
            n = np.linalg.norm(axis)
            if n > 1e-12:
                axis /= n
                c_, s_ = np.cos(a), np.sin(a)
                k = np.array(
                    [
                        [0, -axis[2], axis[1]],
                        [axis[2], 0, -axis[0]],
                        [-axis[1], axis[0], 0],
                    ]
                )
                rm = np.eye(4)
                rm[:3, :3] = np.eye(3) * c_ + s_ * k + (1 - c_) * np.outer(axis, axis)
                m = m @ rm
        elif tag == "scale":
            s = np.asarray(c.text.split(), np.float64)
            sm = np.eye(4)
            sm[0, 0], sm[1, 1], sm[2, 2] = s
            m = m @ sm
    return m


def _material_colors(root) -> dict[str, Material]:
    """material id -> Material via material->effect diffuse/specular."""
    effects = {}
    for eff in _find_all(root, "effect"):
        eid = "#" + eff.get("id", "")
        diffuse = (0.8, 0.8, 0.8, 1.0)
        specular = (0.0, 0.0, 0.0, 1.0)
        for ph in _find_all(eff, "diffuse") + _find_all(eff, "specular"):
            cols = _find_all(ph, "color")
            if not cols:
                continue
            v = np.asarray(cols[0].text.split(), np.float64)
            if _strip(ph.tag) == "diffuse":
                diffuse = tuple(v[:4]) if len(v) >= 4 else (*v[:3], 1.0)
            else:
                specular = tuple(v[:4]) if len(v) >= 4 else (*v[:3], 1.0)
        effects[eid] = Material(
            albedo=tuple(float(x) for x in diffuse),
            specular=tuple(float(x) for x in specular),
            type=MATERIAL_DIFFUSE,
        )
    mats = {}
    for mat in _find_all(root, "material"):
        mid = mat.get("id", "")
        inst = _find_all(mat, "instance_effect")
        url = inst[0].get("url", "") if inst else ""
        mats[mid] = effects.get(url, Material())
    return mats


def load_collada(path: str) -> Mesh:
    """Load a .dae file into one flattened Mesh (transforms baked,
    triangulated, smooth normals when absent)."""
    root = ET.parse(path).getroot()
    mats = _material_colors(root)
    mat_list: list[Material] = []
    mat_of: dict[str, int] = {}

    def mat_slot(name: str) -> int:
        if name not in mat_of:
            mat_of[name] = len(mat_list)
            mat_list.append(mats.get(name, Material()))
        return mat_of[name]

    # geometry id -> parsed (positions, normals, tris, mat symbol per tri)
    geoms: dict[str, tuple] = {}
    for geo in _find_all(root, "geometry"):
        gid = "#" + geo.get("id", "")
        meshes = _children(geo, "mesh")
        if not meshes:
            continue
        mesh_el = meshes[0]
        sources = _parse_sources(mesh_el)
        # vertices indirection
        for v in _children(mesh_el, "vertices"):
            vid = "#" + v.get("id", "")
            for inp in _children(v, "input"):
                if inp.get("semantic") == "POSITION":
                    sources[vid] = sources.get(inp.get("source", ""), None)
        prims = _children(mesh_el, "triangles") + _children(mesh_el, "polylist")
        tris_all, nrm_all, mat_sym = [], [], []
        pos = None
        for prim in prims:
            inputs = _children(prim, "input")
            offs = {
                inp.get("semantic"): (
                    int(inp.get("offset", 0)),
                    inp.get("source", ""),
                )
                for inp in inputs
            }
            stride = max(int(i.get("offset", 0)) for i in inputs) + 1
            p_el = _children(prim, "p")
            if not p_el or "VERTEX" not in offs:
                continue
            idx = np.asarray(p_el[0].text.split(), np.int64).reshape(-1, stride)
            pos = sources.get(offs["VERTEX"][1])
            nrm_src = (
                sources.get(offs["NORMAL"][1]) if "NORMAL" in offs else None
            )
            if _strip(prim.tag) == "polylist":
                vcount = np.asarray(
                    _children(prim, "vcount")[0].text.split(), np.int64
                )
                tri_rows = []
                start = 0
                for n in vcount:
                    for k in range(1, n - 1):
                        tri_rows.append((start, start + k, start + k + 1))
                    start += n
                rows = np.asarray(tri_rows, np.int64)
            else:
                rows = np.arange(len(idx), dtype=np.int64).reshape(-1, 3)
            v_idx = idx[:, offs["VERTEX"][0]]
            tri = v_idx[rows]
            tris_all.append(tri)
            if nrm_src is not None:
                n_idx = idx[:, offs["NORMAL"][0]]
                nrm_all.append((rows, n_idx, nrm_src))
            mat_sym.extend([prim.get("material", "")] * len(tri))
        if pos is None or not tris_all:
            continue
        geoms[gid] = (
            np.asarray(pos[:, :3], np.float64),
            np.concatenate(tris_all),
            nrm_all,
            mat_sym,
        )

    # instances with node transforms
    all_pos, all_tri, all_mid = [], [], []
    v_base = 0
    found = False

    def walk(node_el, parent_m):
        nonlocal v_base, found
        m = parent_m @ _node_matrix(node_el)
        for inst in _children(node_el, "instance_geometry"):
            url = inst.get("url", "")
            if url not in geoms:
                continue
            found = True
            pos, tri, _nrm, mat_sym = geoms[url]
            # material symbol binding (instance_material target overrides)
            bound = {}
            for im in _find_all(inst, "instance_material"):
                bound[im.get("symbol", "")] = im.get("target", "#").lstrip("#")
            p = pos @ m[:3, :3].T + m[:3, 3]
            all_pos.append(p.astype(np.float32))
            all_tri.append(tri + v_base)
            all_mid.append(
                np.asarray(
                    [mat_slot(bound.get(s, s)) for s in mat_sym], np.int32
                )
            )
            v_base += len(p)
        for child in _children(node_el, "node"):
            walk(child, m)

    for scene in _find_all(root, "visual_scene"):
        for node_el in _children(scene, "node"):
            walk(node_el, np.eye(4))

    if not found:
        # no scene instancing: take geometries verbatim
        for pos, tri, _nrm, mat_sym in geoms.values():
            all_pos.append(pos.astype(np.float32))
            all_tri.append(tri + v_base)
            all_mid.append(
                np.asarray([mat_slot(s) for s in mat_sym], np.int32)
            )
            v_base += len(pos)

    if not all_pos:
        raise ValueError("Collada file contains no mesh geometry")
    positions = np.concatenate(all_pos)
    indices = np.concatenate(all_tri).astype(np.int32)
    normals = compute_smooth_normals(positions, indices)
    material_ids = np.concatenate(all_mid)
    if not mat_list:
        material_ids = None
    return Mesh(
        positions,
        normals,
        indices,
        material_ids=material_ids,
        materials=mat_list,
        name=os.path.basename(path),
        loader="dae",
    )
