"""Binary-FBX geometry importer (``dxrexperiments_tpu.scene.fbx``, copied).

Minimal, dependency-free reader for Kaydara FBX *binary* files (versions
7100-7700), covering what the reference framework imports through Assimp
(triangulated, smooth normals generated, transforms baked): mesh
geometry (positions, polygon indices, normals), per-polygon material
assignment, Phong material colors, and node transforms baked into the
vertices (the PreTransformVertices equivalent). Animation, skinning,
cameras, lights and embedded textures are ignored.

Format notes (public spec, widely documented):
  header = "Kaydara FBX Binary  \\x00\\x1a\\x00" + u32 version
  node record (v<7500: u32 fields, 13-byte terminator;
               v>=7500: u64 fields, 25-byte terminator):
    endOffset, numProps, propListLen, u8 nameLen, name, props, children
  property typecodes: Y i16, C bool, I i32, F f32, D f64, L i64,
    f/d/l/i/b = arrays (u32 count, u32 encoding, u32 byteLen; encoding 1 =
    zlib), S string, R raw.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .materials import MATERIAL_DIFFUSE, MATERIAL_GLOSSY, Material
from .mesh import Mesh, compute_smooth_normals

_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"

_SCALAR = {
    b"Y": ("<h", 2),
    b"C": ("<b", 1),
    b"I": ("<i", 4),
    b"F": ("<f", 4),
    b"D": ("<d", 8),
    b"L": ("<q", 8),
}
_ARRAY = {
    b"f": np.float32,
    b"d": np.float64,
    b"l": np.int64,
    b"i": np.int32,
    b"b": np.uint8,
}


class FbxNode:
    __slots__ = ("name", "props", "children")

    def __init__(self, name: str, props: list, children: list):
        self.name = name
        self.props = props
        self.children = children

    def child(self, name: str) -> "FbxNode | None":
        for c in self.children:
            if c.name == name:
                return c
        return None

    def all(self, name: str) -> list:
        return [c for c in self.children if c.name == name]


def _read_props(buf: memoryview, pos: int, count: int) -> tuple[list, int]:
    props = []
    for _ in range(count):
        code = bytes(buf[pos : pos + 1])
        pos += 1
        if code in _SCALAR:
            fmt, size = _SCALAR[code]
            props.append(struct.unpack_from(fmt, buf, pos)[0])
            pos += size
        elif code in _ARRAY:
            n, enc, blen = struct.unpack_from("<III", buf, pos)
            pos += 12
            raw = bytes(buf[pos : pos + blen])
            pos += blen
            if enc == 1:
                raw = zlib.decompress(raw)
            props.append(np.frombuffer(raw, dtype=_ARRAY[code], count=n))
        elif code == b"S" or code == b"R":
            (blen,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            raw = bytes(buf[pos : pos + blen])
            pos += blen
            props.append(raw.decode("utf-8", "replace") if code == b"S" else raw)
        else:
            raise ValueError(f"unknown FBX property typecode {code!r}")
    return props, pos


def _read_node(buf: memoryview, pos: int, big: bool) -> tuple[FbxNode | None, int]:
    if big:
        end, n_props, _plen = struct.unpack_from("<QQQ", buf, pos)
        pos += 24
    else:
        end, n_props, _plen = struct.unpack_from("<III", buf, pos)
        pos += 12
    (name_len,) = struct.unpack_from("<B", buf, pos)
    pos += 1
    if end == 0 and n_props == 0 and name_len == 0:
        return None, pos  # null terminator record
    name = bytes(buf[pos : pos + name_len]).decode("ascii", "replace")
    pos += name_len
    props, pos = _read_props(buf, pos, n_props)
    children = []
    while pos < end:
        child, pos = _read_node(buf, pos, big)
        if child is None:
            break
        children.append(child)
    return FbxNode(name, props, children), end


def parse_fbx(path: str) -> tuple[list[FbxNode], int]:
    """Parse a binary FBX file into top-level nodes. Raises on ASCII FBX."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_MAGIC):
        raise ValueError(
            "not a binary FBX file (ASCII FBX is unsupported; re-export as "
            "binary or convert to OBJ/glTF)"
        )
    (version,) = struct.unpack_from("<I", data, len(_MAGIC))
    big = version >= 7500
    buf = memoryview(data)
    pos = len(_MAGIC) + 4
    nodes = []
    while pos < len(data):
        node, pos = _read_node(buf, pos, big)
        if node is None:
            break
        nodes.append(node)
    return nodes, version


def _deg2rad(v):
    return np.asarray(v, np.float64) * (np.pi / 180.0)


def _euler_xyz(rx, ry, rz) -> np.ndarray:
    """FBX default rotation order: R = Rz @ Ry @ Rx (eEulerXYZ applies X
    first)."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def _prop70(node: FbxNode, name: str, default):
    p70 = node.child("Properties70")
    if p70 is None:
        return default
    for p in p70.all("P"):
        if p.props and p.props[0] == name:
            vals = [v for v in p.props[4:] if isinstance(v, (int, float))]
            if len(vals) == 1:
                return vals[0]
            if vals:
                return np.asarray(vals, np.float64)
    return default


def _local_transform(model: FbxNode) -> np.ndarray:
    """T * Rpre * R * S (the common subset of the FBX transform chain;
    offsets/pivots default to zero in exporter output)."""
    zero3 = np.zeros(3)
    t = np.asarray(_prop70(model, "Lcl Translation", zero3), np.float64)
    r = _deg2rad(_prop70(model, "Lcl Rotation", zero3))
    pre = _deg2rad(_prop70(model, "PreRotation", zero3))
    s = np.asarray(_prop70(model, "Lcl Scaling", np.ones(3)), np.float64)
    m = np.eye(4)
    m[:3, :3] = _euler_xyz(*pre) @ _euler_xyz(*r) @ np.diag(s)
    m[:3, 3] = t
    return m


def _material_from_node(mat: FbxNode) -> Material:
    diffuse = np.asarray(
        _prop70(mat, "DiffuseColor", np.array([0.8, 0.8, 0.8])), np.float64
    )
    specular = np.asarray(
        _prop70(mat, "SpecularColor", np.zeros(3)), np.float64
    )
    emissive = np.asarray(
        _prop70(mat, "EmissiveColor", np.zeros(3)), np.float64
    )
    emissive_factor = float(_prop70(mat, "EmissiveFactor", 0.0))
    shininess = float(_prop70(mat, "Shininess", 0.0))
    glossy = float(specular.max()) > 0.0 and shininess > 1.0
    return Material(
        albedo=(*[float(x) for x in diffuse], 1.0),
        specular=(*[float(x) for x in specular], 1.0),
        emissive=(*[float(x) for x in emissive], emissive_factor),
        reflectivity=min(float(specular.max()), 1.0) if glossy else 0.0,
        roughness=float(np.clip(1.0 - np.log2(max(shininess, 1.0)) / 13.0, 0.0, 1.0)),
        type=MATERIAL_GLOSSY if glossy else MATERIAL_DIFFUSE,
    )


def _triangulate(poly_idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """PolygonVertexIndex -> (tri indices [F,3], polygon id per tri [F]).

    Negative entries mark polygon ends and encode ~index."""
    fixed = np.where(poly_idx < 0, ~poly_idx, poly_idx)
    ends = np.nonzero(poly_idx < 0)[0]
    tris, poly_of = [], []
    start = 0
    for pid, end in enumerate(ends):
        n = end - start + 1
        for k in range(1, n - 1):
            tris.append((fixed[start], fixed[start + k], fixed[start + k + 1]))
            poly_of.append(pid)
        start = end + 1
    return (
        np.asarray(tris, np.int64).reshape(-1, 3),
        np.asarray(poly_of, np.int64),
    )


def _corner_indices(poly_idx: np.ndarray) -> np.ndarray:
    """Corner (polygon-vertex) index of each triangulated triangle corner,
    for ByPolygonVertex attribute mappings."""
    ends = np.nonzero(poly_idx < 0)[0]
    out = []
    start = 0
    for end in ends:
        n = end - start + 1
        for k in range(1, n - 1):
            out.append((start, start + k, start + k + 1))
        start = end + 1
    return np.asarray(out, np.int64).reshape(-1, 3)


def load_fbx(path: str) -> Mesh:
    """Load a binary FBX into one flattened Mesh (node transforms baked,
    polygons triangulated, smooth normals generated when absent) — the
    aiProcess_Triangulate|GenSmoothNormals|PreTransformVertices pipeline the
    reference framework requests of Assimp.
    """
    top, _version = parse_fbx(path)
    by_name = {n.name: n for n in top}
    objects = by_name.get("Objects")
    if objects is None:
        raise ValueError("FBX file has no Objects section")

    geoms: dict[int, FbxNode] = {}
    models: dict[int, FbxNode] = {}
    mats: dict[int, FbxNode] = {}
    for n in objects.children:
        if not n.props or not isinstance(n.props[0], int):
            continue
        uid = n.props[0]
        if n.name == "Geometry":
            geoms[uid] = n
        elif n.name == "Model":
            models[uid] = n
        elif n.name == "Material":
            mats[uid] = n

    # Connections: child -> parent (OO). Geometry->Model, Material->Model,
    # Model->Model (hierarchy; parent 0 = scene root).
    parents: dict[int, list[int]] = {}
    conns = by_name.get("Connections")
    if conns is not None:
        for c in conns.all("C"):
            if len(c.props) >= 3 and c.props[0] == "OO":
                parents.setdefault(c.props[1], []).append(c.props[2])

    def model_global(mid: int, depth: int = 0) -> np.ndarray:
        m = _local_transform(models[mid])
        if depth > 64:
            return m
        for p in parents.get(mid, []):
            if p in models:
                return model_global(p, depth + 1) @ m
        return m

    # unit scale (centimeters are FBX-native; assimp keeps file units, so we
    # do too unless GlobalSettings asks otherwise via UnitScaleFactor != 1)
    all_pos, all_nrm, all_tri, all_mid = [], [], [], []
    materials: list[Material] = []
    mat_index: dict[int, int] = {}
    v_base = 0

    for gid, g in geoms.items():
        vnode = g.child("Vertices")
        inode = g.child("PolygonVertexIndex")
        if vnode is None or inode is None:
            continue
        pos = np.asarray(vnode.props[0], np.float64).reshape(-1, 3)
        poly_idx = np.asarray(inode.props[0], np.int64)
        tris, poly_of = _triangulate(poly_idx)
        if len(tris) == 0:
            continue

        # owning model: transform + materials
        owner = next((p for p in parents.get(gid, []) if p in models), None)
        xform = model_global(owner) if owner is not None else np.eye(4)
        pos = pos @ xform[:3, :3].T + xform[:3, 3]

        # normals (ByPolygonVertex expands corners; ByVertex maps directly)
        normals = None
        ln = g.child("LayerElementNormal")
        corner_idx = None
        if ln is not None and ln.child("Normals") is not None:
            nvals = np.asarray(ln.child("Normals").props[0], np.float64).reshape(-1, 3)
            mapping = ln.child("MappingInformationType")
            mtype = mapping.props[0] if mapping and mapping.props else ""
            nrm_m = np.linalg.inv(xform[:3, :3]).T
            nvals = nvals @ nrm_m.T
            ln_len = np.linalg.norm(nvals, axis=-1, keepdims=True)
            nvals = nvals / np.where(ln_len > 1e-12, ln_len, 1.0)
            if mtype == "ByVertice" or mtype == "ByVertex":
                if len(nvals) == len(pos):
                    normals = nvals
            elif mtype == "ByPolygonVertex":
                corner_idx = _corner_indices(poly_idx)
                # expand to unindexed corners
                new_pos = pos[tris.reshape(-1)]
                normals = nvals[corner_idx.reshape(-1)]
                pos = new_pos
                tris = np.arange(len(new_pos), dtype=np.int64).reshape(-1, 3)

        # per-polygon materials
        mat_ids = np.zeros(len(tris), np.int64)
        conn_mats = [p for p in parents.get(gid, []) if p in mats]
        if owner is not None:
            conn_mats = [c for c in mats if owner in parents.get(c, [])]
        local_mat_global: list[int] = []
        for muid in conn_mats:
            if muid not in mat_index:
                mat_index[muid] = len(materials)
                materials.append(_material_from_node(mats[muid]))
            local_mat_global.append(mat_index[muid])
        lm = g.child("LayerElementMaterial")
        if lm is not None and lm.child("Materials") is not None and local_mat_global:
            marr = np.asarray(lm.child("Materials").props[0], np.int64)
            mapping = lm.child("MappingInformationType")
            mtype = mapping.props[0] if mapping and mapping.props else "AllSame"
            if mtype == "ByPolygon" and len(marr) > 0:
                per_poly = np.clip(marr, 0, len(local_mat_global) - 1)
                mat_ids = np.asarray(local_mat_global, np.int64)[
                    per_poly[np.clip(poly_of, 0, len(per_poly) - 1)]
                ]
            else:  # AllSame
                mat_ids[:] = local_mat_global[int(marr[0]) if len(marr) else 0]
        elif local_mat_global:
            mat_ids[:] = local_mat_global[0]

        all_pos.append(pos.astype(np.float32))
        all_nrm.append(
            normals.astype(np.float32) if normals is not None else None
        )
        all_tri.append(tris + v_base)
        all_mid.append(mat_ids)
        v_base += len(pos)

    if not all_pos:
        raise ValueError("FBX file contains no mesh geometry")

    positions = np.concatenate(all_pos)
    indices = np.concatenate(all_tri).astype(np.int32)
    if any(n is None for n in all_nrm):
        normals = compute_smooth_normals(positions, indices)
    else:
        normals = np.concatenate(all_nrm)
    material_ids = np.concatenate(all_mid).astype(np.int32)
    if not materials:
        material_ids = None
    return Mesh(
        positions,
        normals,
        indices,
        material_ids=material_ids,
        materials=materials,
        name=os.path.basename(path),
        loader="fbx",
    )
