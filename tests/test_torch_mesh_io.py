"""Port mesh loaders (scene/mesh.py, gltf.py, fbx.py, collada.py, the native
OBJ parser csrc/mesh_io.cpp) against the JAX package's on the same files.

The loaders are copied numpy code, so every array must be equal (tolerance
0) except normals, atol 1e-6 (float64 renormalisation rounded to float32);
Material fields equal. Files are written here: hand-written OBJ/PLY/DAE
text, the JAX tests' glTF and FBX writers (copied below), and
chip_smoke.py's writers, which make the files its phase 42 loads on the
card.
"""

import base64
import dataclasses
import json
import os
import struct
import textwrap
import zlib

import numpy as np
import pytest

import chip_smoke as cs
from dxrexperiments_torch.scene import mesh as tmesh
from dxrexperiments_torch.scene.procedural import sphere_mesh
from dxrexperiments_torch.utils import native as tnative
from dxrexperiments_tpu.scene import mesh as jmesh
from dxrexperiments_tpu.utils import native as jnative

NORMAL_ATOL = 1e-6


def assert_same_mesh(got, want):
    """A port Mesh against a JAX Mesh: arrays equal, normals within 1e-6,
    materials field by field."""
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.normals, want.normals, rtol=0, atol=NORMAL_ATOL)
    np.testing.assert_array_equal(got.material_ids, want.material_ids)
    assert (got.uv_corners is None) == (want.uv_corners is None)
    if want.uv_corners is not None:
        np.testing.assert_array_equal(got.uv_corners, want.uv_corners)
    assert got.name == want.name
    assert len(got.materials) == len(want.materials)
    for a, b in zip(got.materials, want.materials):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        ta, tb = da.pop("albedo_texture"), db.pop("albedo_texture")
        assert da == db
        assert (ta is None) == (tb is None)
        if tb is not None:
            np.testing.assert_array_equal(ta, tb)


# --------------------------------------------------------------------------- #
# OBJ
# --------------------------------------------------------------------------- #
OBJ_SAMPLE = textwrap.dedent(
    """
    mtllib m.mtl
    v 0 0 0
    v 1 0 0
    v 1 1 0
    v 0 1 0
    v 0 0 1
    vn 0 0 1
    vn 0 1 0
    usemtl red
    f 1//1 2//1 3//1 4//1
    usemtl blue
    f 1/2/2 2//2 5//2
    f -5 -4 -1
    """
)
MTL_SAMPLE = textwrap.dedent(
    """
    newmtl red
    Kd 1 0 0
    Ks 0.5 0.5 0.5
    Ns 64
    newmtl blue
    Kd 0 0 1
    Ke 2 2 2
    Ni 1.33
    d 0.5
    """
)
OBJ_TEXTURED = textwrap.dedent(
    """
    v 0 0 0
    v 2 0 0
    v 2 0 2
    v 0 0 2
    vt 0 0
    vt 1 0
    vt 1 1
    vt 0 1
    vn 0 1 0
    f 1/1/1 2/2/1 3/3/1 4/4/1
    """
)
OBJ_QUADS = textwrap.dedent(
    """
    # a unit cube without normals: smooth normals are generated
    v -1 -1 -1
    v 1 -1 -1
    v 1 1 -1
    v -1 1 -1
    v -1 -1 1
    v 1 -1 1
    v 1 1 1
    v -1 1 1
    f 1 2 3 4
    f 5 8 7 6
    f 1 5 6 2
    f 2 6 7 3
    f 3 7 8 4
    f 5 1 4 8
    """
)
OBJ_CASES = {"sample": OBJ_SAMPLE, "textured": OBJ_TEXTURED, "quads": OBJ_QUADS}


@pytest.fixture
def obj_files(tmp_path):
    paths = {}
    for name, text in OBJ_CASES.items():
        p = tmp_path / f"{name}.obj"
        p.write_text(text)
        paths[name] = str(p)
    (tmp_path / "m.mtl").write_text(MTL_SAMPLE)
    return paths


@pytest.mark.parametrize("name", sorted(OBJ_CASES))
def test_obj_matches_jax(obj_files, name):
    got = tmesh.load_obj(obj_files[name])
    assert_same_mesh(got, jmesh.load_obj(obj_files[name]))
    assert_same_mesh(tmesh._load_obj_python(obj_files[name]),
                     jmesh._load_obj_python(obj_files[name]))
    # a textured OBJ takes the Python parser, the others the native one
    assert got.loader == ("obj-python" if name == "textured" else "obj-native")


@pytest.mark.parametrize("name", ["sample", "quads"])
def test_native_obj_parser_matches_python_and_jax(obj_files, name):
    path = obj_files[name]
    got = tnative.parse_obj_native(path)
    assert got is not None, "g++ could not build csrc/mesh_io.cpp"
    assert tnative.get_mesh_lib() is not None
    want = jnative.parse_obj_native(path)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    native = tmesh.load_obj(path, use_native=True)
    python = tmesh._load_obj_python(path)
    assert (native.loader, python.loader) == ("obj-native", "obj-python")
    native.loader = python.loader
    assert_same_mesh(native, python)


def test_native_library_is_the_ports_own():
    lib = tnative.get_mesh_lib()
    assert lib is not None
    assert os.path.dirname(lib._name) == os.path.join(
        os.path.dirname(os.path.dirname(tnative.__file__)), "build")
    assert os.path.basename(tnative.MESH_SOURCE) == "mesh_io.cpp"
    assert os.path.dirname(tnative.MESH_SOURCE).endswith(os.path.join(
        "dxrexperiments_torch", "csrc"))


def test_native_obj_missing_file_raises():
    with pytest.raises(IOError):
        tnative.parse_obj_native("/nonexistent/file.obj")


# --------------------------------------------------------------------------- #
# PLY
# --------------------------------------------------------------------------- #
PLY_ASCII = textwrap.dedent(
    """\
    ply
    format ascii 1.0
    element vertex 5
    property float x
    property float y
    property float z
    element face 2
    property list uchar int vertex_indices
    end_header
    0 0 0
    1 0 0
    1 1 0
    0 1 0
    0.5 0.5 1
    4 0 1 2 3
    3 0 1 4
    """
)


def write_ply_binary_quads(path, rng):
    """Binary PLY with normals and a mix of quads and triangles."""
    verts = rng.uniform(-1, 1, (6, 6)).astype("<f4")
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 6\n"
              + "".join(f"property float {c}\n" for c in ("x", "y", "z", "nx", "ny", "nz"))
              + "element face 2\nproperty list uchar int vertex_indices\nend_header\n")
    faces = struct.pack("<B4i", 4, 0, 1, 2, 3) + struct.pack("<B3i", 3, 2, 4, 5)
    with open(path, "wb") as f:
        f.write(header.encode() + verts.tobytes() + faces)


@pytest.mark.parametrize("kind", ["ascii", "binary"])
def test_ply_matches_jax(tmp_path, kind):
    p = str(tmp_path / f"{kind}.ply")
    if kind == "ascii":
        with open(p, "w") as f:
            f.write(PLY_ASCII)
    else:
        write_ply_binary_quads(p, np.random.default_rng(3))
    got = tmesh.load_ply(p)
    assert got.loader == "ply" and got.num_triangles == 3
    assert_same_mesh(got, jmesh.load_ply(p))


# --------------------------------------------------------------------------- #
# glTF (the writer of tests/test_gltf.py, copied)
# --------------------------------------------------------------------------- #
def make_doc(translation=None):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], "<f4")
    nrm = np.tile(np.array([[0, 0, 1]], "<f4"), (3, 1))
    idx = np.array([0, 1, 2], "<u2")
    bin_data = pos.tobytes() + nrm.tobytes() + idx.tobytes() + b"\x00\x00"
    node = {"mesh": 0}
    if translation:
        node["translation"] = translation
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [node],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1},
                                    "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.2, 0.1, 1.0],
                                                "metallicFactor": 0.9,
                                                "roughnessFactor": 0.3}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5123, "count": 3, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 36},
            {"buffer": 0, "byteOffset": 72, "byteLength": 6},
        ],
        "buffers": [{"byteLength": len(bin_data)}],
    }
    return doc, bin_data


def write_glb(path, doc, bin_data):
    js = json.dumps(doc).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    bin_pad = bin_data + b"\x00" * ((4 - len(bin_data) % 4) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_pad)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(js), b"JSON") + js)
        f.write(struct.pack("<I4s", len(bin_pad), b"BIN\x00") + bin_pad)


def gltf_case(tmp_path, case):
    if case == "glb translation":
        doc, bin_data = make_doc(translation=[5, 0, 0])
        p = str(tmp_path / "tri.glb")
        write_glb(p, doc, bin_data)
    elif case == "data uri":
        doc, bin_data = make_doc()
        doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                    + base64.b64encode(bin_data).decode())
        p = str(tmp_path / "tri.gltf")
        with open(p, "w") as f:
            json.dump(doc, f)
    else:  # rotation node: 90 degrees about z
        doc, bin_data = make_doc()
        s = np.sin(np.pi / 4)
        doc["nodes"][0]["rotation"] = [0, 0, float(s), float(np.cos(np.pi / 4))]
        p = str(tmp_path / "rot.glb")
        write_glb(p, doc, bin_data)
    return p


@pytest.mark.parametrize("case", ["glb translation", "data uri", "rotation node"])
def test_gltf_matches_jax(tmp_path, case):
    from dxrexperiments_torch.scene.gltf import load_gltf as t_load
    from dxrexperiments_tpu.scene.gltf import load_gltf as j_load

    p = gltf_case(tmp_path, case)
    got = t_load(p)
    assert got.loader == "gltf" and got.num_triangles == 1
    assert_same_mesh(got, j_load(p))


# --------------------------------------------------------------------------- #
# FBX (the writer of tests/test_fbx_collada.py, copied)
# --------------------------------------------------------------------------- #
def _prop(v):
    if isinstance(v, int):
        return b"L" + struct.pack("<q", v)
    if isinstance(v, float):
        return b"D" + struct.pack("<d", v)
    if isinstance(v, str):
        b = v.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    if isinstance(v, np.ndarray):
        code = {np.dtype("f8"): b"d", np.dtype("i4"): b"i", np.dtype("i8"): b"l"}[v.dtype]
        raw = zlib.compress(v.tobytes())
        return code + struct.pack("<III", len(v), 1, len(raw)) + raw
    raise TypeError(type(v))


def _node_tree(name, props=(), children=(), base=0):
    name_b = name.encode()
    body = b"".join(_prop(p) for p in props)
    header_len = 24 + 1 + len(name_b)
    pos = base + header_len + len(body)
    kid_blobs = []
    for kname, kprops, kchildren in children:
        kb = _node_tree(kname, kprops, kchildren, pos)
        kid_blobs.append(kb)
        pos += len(kb)
    kids = b"".join(kid_blobs)
    if children:
        kids += b"\x00" * 25
        pos += 25
    header = struct.pack("<QQQB", pos, len(props), len(body), len(name_b))
    return header + name_b + body + kids


def write_fbx(path, verts, poly_idx, mat_ids=None, translation=(0, 0, 0), rotation=None):
    geo_children = [
        ("Vertices", [np.asarray(verts, np.float64).reshape(-1)], []),
        ("PolygonVertexIndex", [np.asarray(poly_idx, np.int32)], []),
    ]
    if mat_ids is not None:
        geo_children.append(("LayerElementMaterial", [], [
            ("MappingInformationType", ["ByPolygon"], []),
            ("Materials", [np.asarray(mat_ids, np.int32)], []),
        ]))
    p70 = [("P", ["Lcl Translation", "Lcl Translation", "", "A"]
            + [float(t) for t in translation], [])]
    if rotation is not None:
        p70.append(("P", ["Lcl Rotation", "Lcl Rotation", "", "A"]
                    + [float(r) for r in rotation], []))
    objects = ("Objects", [], [
        ("Geometry", [1001, "Geometry::geo", "Mesh"], geo_children),
        ("Model", [2001, "Model::mesh", "Mesh"], [("Properties70", [], p70)]),
        ("Material", [3001, "Material::red", ""], [("Properties70", [], [
            ("P", ["DiffuseColor", "Color", "", "A", 0.9, 0.1, 0.1], []),
            ("P", ["SpecularColor", "Color", "", "A", 0.5, 0.5, 0.5], []),
            ("P", ["Shininess", "Number", "", "A", 32.0], []),
        ])]),
        ("Material", [3002, "Material::green", ""], []),
    ])
    conns = ("Connections", [], [
        ("C", ["OO", 1001, 2001], []), ("C", ["OO", 2001, 0], []),
        ("C", ["OO", 3001, 2001], []), ("C", ["OO", 3002, 2001], []),
    ])
    magic = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7500)
    pos = len(magic)
    blobs = []
    for name, props, children in (objects, conns):
        b = _node_tree(name, props, children, pos)
        blobs.append(b)
        pos += len(b)
    with open(path, "wb") as f:
        f.write(magic + b"".join(blobs) + b"\x00" * 25)


QUAD_VERTS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [2, 0, 0], [2, 1, 0]],
                      np.float64)
QUAD_POLY = np.array([0, 1, 2, ~3, 1, 4, ~5], np.int32)


@pytest.mark.parametrize("case", ["plain", "transform", "materials"])
def test_fbx_matches_jax(tmp_path, case):
    from dxrexperiments_torch.scene.fbx import load_fbx as t_load
    from dxrexperiments_tpu.scene.fbx import load_fbx as j_load

    p = str(tmp_path / "t.fbx")
    kw = {"transform": {"translation": (10.0, -2.0, 5.0), "rotation": (0.0, 30.0, 0.0)},
          "materials": {"mat_ids": [0, 1]}}.get(case, {})
    write_fbx(p, QUAD_VERTS, QUAD_POLY, **kw)
    got = t_load(p)
    assert got.loader == "fbx" and got.num_triangles == 3
    assert_same_mesh(got, j_load(p))


# --------------------------------------------------------------------------- #
# COLLADA (the document of tests/test_fbx_collada.py, with a rotation)
# --------------------------------------------------------------------------- #
DAE = """<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
 <library_effects>
  <effect id="e1"><profile_COMMON><technique sid="t"><phong>
    <diffuse><color>0.2 0.4 0.6 1</color></diffuse>
    <specular><color>0.3 0.3 0.3 1</color></specular>
  </phong></technique></profile_COMMON></effect>
 </library_effects>
 <library_materials>
  <material id="m1"><instance_effect url="#e1"/></material>
 </library_materials>
 <library_geometries>
  <geometry id="g1"><mesh>
   <source id="s1"><float_array id="a1" count="15">0 0 0 1 0 0 1 1 0 0 1 0 0.5 0.5 1</float_array>
    <technique_common><accessor source="#a1" count="5" stride="3"/></technique_common>
   </source>
   <vertices id="v1"><input semantic="POSITION" source="#s1"/></vertices>
   <polylist material="sym" count="2">
    <input semantic="VERTEX" source="#v1" offset="0"/>
    <vcount>4 3</vcount>
    <p>0 1 2 3 0 1 4</p>
   </polylist>
  </mesh></geometry>
 </library_geometries>
 <library_visual_scenes>
  <visual_scene id="scene">
   <node><translate>5 0 0</translate><rotate>0 1 0 30</rotate>
    <instance_geometry url="#g1">
     <bind_material><technique_common>
      <instance_material symbol="sym" target="#m1"/>
     </technique_common></bind_material>
    </instance_geometry>
   </node>
  </visual_scene>
 </library_visual_scenes>
</COLLADA>
"""


def test_collada_matches_jax(tmp_path):
    from dxrexperiments_torch.scene.collada import load_collada as t_load
    from dxrexperiments_tpu.scene.collada import load_collada as j_load

    p = str(tmp_path / "t.dae")
    with open(p, "w") as f:
        f.write(DAE)
    got = t_load(p)
    assert got.loader == "dae" and got.num_triangles == 3
    assert_same_mesh(got, j_load(p))


# --------------------------------------------------------------------------- #
# load_mesh: dispatch, fallback, and chip_smoke.py's writers
# --------------------------------------------------------------------------- #
def sphere_source():
    """phase 42's sphere: 960 triangles wound outward, smooth normals."""
    base = sphere_mesh((0.0, 0.0, 0.0), 1.0, lat=16, lon=32)
    return tmesh.Mesh(base.positions, None, base.indices[:, [0, 2, 1]])


WRITERS = {"obj": cs.write_obj, "ply": cs.write_ply, "glb": cs.write_glb,
           "gltf": cs.write_gltf, "fbx": cs.write_fbx, "dae": cs.write_dae}
LOADERS = {"obj": "obj-native", "ply": "ply", "glb": "gltf", "gltf": "gltf", "fbx": "fbx",
           "dae": "dae"}


@pytest.mark.parametrize("ext", sorted(WRITERS))
def test_chip_smoke_writers_round_trip(tmp_path, ext):
    """Each writer's file loads, through load_mesh's dispatch, to the mesh
    written (corner positions exact, indices exact but for the OBJ's vertex
    welding, normals within 1e-6), equal to the JAX loader's."""
    src = sphere_source()
    p = str(tmp_path / f"sphere.{ext}")
    WRITERS[ext](p, src)
    got = tmesh.load_mesh(p, on_error="raise")
    assert got.loader == LOADERS[ext]
    np.testing.assert_array_equal(got.positions[got.indices], src.positions[src.indices])
    if ext != "obj":
        np.testing.assert_array_equal(got.indices, src.indices)
    np.testing.assert_allclose(got.normals[got.indices], src.normals[src.indices], rtol=0,
                               atol=NORMAL_ATOL)
    assert_same_mesh(got, jmesh.load_mesh(p, on_error="raise"))


def test_unit_normals_are_fixed_points_and_obj_materials(tmp_path):
    """chip_smoke.unit_normals: the glTF loader hands them back bit for bit;
    write_obj's usemtl runs come back as the mesh's material ids."""
    rng = np.random.default_rng(5)
    src = sphere_source()
    n = cs.unit_normals(rng.normal(size=src.normals.shape).astype(np.float32))
    ids = (np.arange(src.num_triangles) // 100 % 3).astype(np.int32)
    mats = [tmesh.Material(albedo=(0.1 * k, 0.2, 0.3, 1.0)) for k in range(3)]
    src = cs.first_use_order(tmesh.Mesh(src.positions, n, src.indices, material_ids=ids[::-1],
                                        materials=mats))
    for ext in ("glb", "obj"):
        p = str(tmp_path / f"m.{ext}")
        WRITERS[ext](p, src)
        got = tmesh.load_mesh(p, on_error="raise")
        np.testing.assert_array_equal(got.normals[got.indices], src.normals[src.indices])
    np.testing.assert_array_equal(got.material_ids, src.material_ids)
    assert [m.albedo for m in got.materials] == [m.albedo for m in src.materials]


def test_load_mesh_fallback_and_raise(tmp_path):
    for path in (str(tmp_path / "missing.obj"), str(tmp_path / "x.stl")):
        got = tmesh.load_mesh(path)
        want = jmesh.load_mesh(path)
        assert got.loader == "fallback" and got.name == "fallback_triangle"
        got.loader = ""
        assert_same_mesh(got, want)
        with pytest.raises((OSError, ValueError)):
            tmesh.load_mesh(path, on_error="raise")
    assert tmesh.fallback_triangle().num_triangles == 1
    lo, hi = tmesh.fallback_triangle().aabb()
    np.testing.assert_array_equal(lo, [-1, -1, 0])
    np.testing.assert_array_equal(hi, [1, 1, 0])
