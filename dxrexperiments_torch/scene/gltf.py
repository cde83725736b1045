"""glTF 2.0 loader (``dxrexperiments_tpu.scene.gltf``, copied): .glb and
.gltf with a .bin or data URIs. Triangle primitives, POSITION/NORMAL
accessors (f32), u8/u16/u32 indices, the node hierarchy's transforms baked
into the vertices, pbrMetallicRoughness materials mapped onto the Phong-style
material model. Returns one merged world-space ``Mesh``.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from .materials import MATERIAL_DIFFUSE, MATERIAL_GLOSSY, Material
from .mesh import Mesh, compute_smooth_normals

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_buffers(doc: dict, base_dir: str, glb_bin: bytes | None) -> list[bytes]:
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_bin or b"")
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _accessor(doc: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]]).newbyteorder("<")
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or dtype.itemsize * ncomp
    raw = buffers[view["buffer"]]
    if stride == dtype.itemsize * ncomp:
        arr = np.frombuffer(raw, dtype, count * ncomp, offset).reshape(count, ncomp)
    else:  # interleaved
        arr = np.stack(
            [
                np.frombuffer(raw, dtype, ncomp, offset + i * stride)
                for i in range(count)
            ]
        )
    return arr


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T  # column-major
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"], np.float64)
    if "rotation" in node:  # xyzw quaternion
        x, y, z, w = node["rotation"]
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        m2 = np.eye(4)
        m2[:3, :3] = rot @ m[:3, :3]
        m2[:3, 3] = m[:3, 3]
        m = m2
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _material(doc: dict, idx: int | None) -> Material:
    if idx is None:
        return Material()
    md = doc.get("materials", [])[idx]
    pbr = md.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1, 1, 1, 1])
    metallic = pbr.get("metallicFactor", 1.0)
    roughness = pbr.get("roughnessFactor", 1.0)
    emissive = md.get("emissiveFactor", [0, 0, 0])
    mat = Material(
        albedo=(base[0], base[1], base[2], base[3]),
        roughness=float(roughness),
        emissive=(*emissive, 1.0 if max(emissive) > 0 else 0.0),
    )
    if metallic > 0.3:
        mat.type = MATERIAL_GLOSSY
        mat.reflectivity = float(metallic)
        mat.specular = (base[0], base[1], base[2], 1.0)
    else:
        mat.type = MATERIAL_DIFFUSE
    return mat


def load_gltf(path: str) -> Mesh:
    """Load a .glb/.gltf file into one merged, world-space Mesh."""
    base_dir = os.path.dirname(path)
    glb_bin = None
    if path.lower().endswith(".glb"):
        with open(path, "rb") as f:
            magic, _version, _length = struct.unpack("<4sII", f.read(12))
            if magic != b"glTF":
                raise ValueError(f"not a GLB file: {path}")
            chunks = {}
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                clen, ctype = struct.unpack("<I4s", hdr)
                chunks[ctype] = f.read(clen)
            doc = json.loads(chunks[b"JSON"])
            glb_bin = chunks.get(b"BIN\x00")
    else:
        with open(path, "r") as f:
            doc = json.load(f)

    buffers = _load_buffers(doc, base_dir, glb_bin)

    positions, normals, faces, face_mats = [], [], [], []
    materials: list[Material] = []
    mat_index: dict[int | None, int] = {}

    def emit(mesh_idx: int, world: np.ndarray):
        mesh = doc["meshes"][mesh_idx]
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:
                continue  # triangles only
            attrs = prim["attributes"]
            pos = _accessor(doc, buffers, attrs["POSITION"]).astype(np.float64)
            pos = pos @ world[:3, :3].T + world[:3, 3]
            if "NORMAL" in attrs:
                nrm_m = np.linalg.inv(world[:3, :3]).T
                nrm = _accessor(doc, buffers, attrs["NORMAL"]).astype(np.float64)
                nrm = nrm @ nrm_m.T
                nl = np.linalg.norm(nrm, axis=-1, keepdims=True)
                nrm = nrm / np.where(nl > 1e-12, nl, 1.0)
            else:
                nrm = None
            if "indices" in prim:
                idx = _accessor(doc, buffers, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(len(pos))
            tri = idx.reshape(-1, 3).astype(np.int64)

            mkey = prim.get("material")
            if mkey not in mat_index:
                mat_index[mkey] = len(materials)
                materials.append(_material(doc, mkey))
            mid = mat_index[mkey]

            base = sum(len(p) for p in positions)
            positions.append(pos.astype(np.float32))
            normals.append(
                nrm.astype(np.float32)
                if nrm is not None
                else np.zeros_like(pos, dtype=np.float32)
            )
            faces.append(tri + base)
            face_mats.append(np.full(len(tri), mid, np.int32))

    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [{"nodes": list(range(len(doc.get("nodes", []))))}])
    roots = scenes[scene_idx].get("nodes", [])

    def walk(node_idx: int, parent: np.ndarray):
        node = doc["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            emit(node["mesh"], world)
        for child in node.get("children", []):
            walk(child, world)

    for r in roots:
        walk(r, np.eye(4))
    if not doc.get("nodes") and doc.get("meshes"):
        emit(0, np.eye(4))

    if not faces:
        raise ValueError(f"no triangle geometry in {path}")

    pos = np.concatenate(positions)
    nrm = np.concatenate(normals)
    tri = np.concatenate(faces).astype(np.int32)
    mids = np.concatenate(face_mats)
    if np.all(np.abs(nrm).sum(-1) < 1e-12):
        nrm = compute_smooth_normals(pos, tri)
    return Mesh(
        pos, nrm, tri, material_ids=mids, materials=materials,
        name=os.path.basename(path), loader="gltf",
    )
