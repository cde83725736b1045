"""Port accel/bvh.py, utils/native.py, ops/traverse.pack_for_traversal and the
BVH attach of Scene.build vs the JAX package, bit for bit.

Both packages build the same triangles (Cornell with accel='bvh', a
600-triangle soup from seed 11 and the 3,842-triangle 'instanced:2' grid):
the Morton build and its node arrays, the native SAH build, the traversal
packs fed the same node arrays, and the ``bvh`` sub-dict of Scene.build must
be equal to the last bit. Then the 'auto' threshold, the Morton fallback
without g++ and the paths that stay unported.
"""

import jax
import numpy as np
import pytest
import torch

from dxrexperiments_torch.accel import bvh as tbvh
from dxrexperiments_torch.app import headless as thead
from dxrexperiments_torch.ops import traverse as ttv
from dxrexperiments_torch.scene import Scene as TScene
from dxrexperiments_torch.scene import cornell_box as t_cornell
from dxrexperiments_torch.scene import envmap as tenvmap
from dxrexperiments_torch.scene import procedural as tproc
from dxrexperiments_torch.scene import scene as tscene_mod
from dxrexperiments_torch.scene.convert import scene_from_numpy
from dxrexperiments_torch.scene.materials import Material as TMaterial
from dxrexperiments_torch.utils import native as tnative
from dxrexperiments_tpu.accel import bvh as jbvh
from dxrexperiments_tpu.app.headless import build_scene as j_build_scene
from dxrexperiments_tpu.ops import traverse_pallas as jtv
from dxrexperiments_tpu.scene import Scene as JScene
from dxrexperiments_tpu.scene import cornell_box as j_cornell
from dxrexperiments_tpu.scene import materials as jmaterials
from dxrexperiments_tpu.scene import procedural as jproc
from dxrexperiments_tpu.scene.materials import Material as JMaterial

SCENES = ("cornell", "soup600", "instanced:2")
PACK_KEYS = ("bvh_nodes", "bvhf_nodes", "bvh8_nodes", "mt_rows", "slot_tri")


def scene_pair(kind):
    """(JAX Scene, port Scene) holding the same triangles and materials."""
    if kind == "instanced:2":
        return j_build_scene(kind)[0], thead.build_scene(kind)[0]
    out = []
    for sc_cls, cornell, proc, mat in ((JScene, j_cornell, jproc, JMaterial),
                                       (TScene, t_cornell, tproc, TMaterial)):
        sc = sc_cls()
        if kind == "cornell":
            mesh, materials = cornell(glossy_tall_box=True)
            for m in materials:
                sc.add_material(mat(**{k: getattr(m, k) for k in (
                    "albedo", "specular", "emissive", "reflectivity", "roughness", "ior",
                    "type")}))
        else:
            mesh = proc.random_triangle_soup(600, seed=11, extent=3.0)
            sc.add_material(mat.reference_default())
        sc.add_model(mesh)
        out.append(sc)
    return tuple(out)


def npy(x):
    return np.asarray(jax.device_get(x))


def _triangles(kind):
    jsc, tsc = scene_pair(kind)
    jd = jsc.build(accel="none")
    td = tsc.build_numpy(accel="none")
    n = int(td["num_tris"])
    return jd, td, n


@pytest.mark.parametrize("kind", SCENES)
def test_morton_build_equals_jax(kind):
    jd, td, n = _triangles(kind)
    tri = [td[k] for k in ("v0", "e1", "e2")]
    want = jbvh.build_bvh(*(npy(jd[k]) for k in ("v0", "e1", "e2")), n, 32)
    got = tbvh.build_bvh(*tri, n, 32)
    assert (got["levels"], got["leaf_size"]) == (want["levels"], want["leaf_size"])
    for k in ("order", "nodes_lo", "nodes_hi"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got_n, want_n = tbvh.to_node_arrays(got), jbvh.to_node_arrays(want)
    for k in ("nodes_lo", "nodes_hi", "child", "order"):
        np.testing.assert_array_equal(got_n[k], want_n[k], err_msg=k)


@pytest.mark.parametrize("kind", SCENES)
def test_sah_build_equals_jax(kind):
    jd, td, n = _triangles(kind)
    got = tbvh.build_bvh_sah(td["v0"], td["e1"], td["e2"], n, 32)
    want = jbvh.build_bvh_sah(*(npy(jd[k]) for k in ("v0", "e1", "e2")), n, 32)
    if got is None or want is None:
        pytest.skip("no C++ compiler for the native SAH builders")
    for k in ("nodes_lo", "nodes_hi", "child", "order"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", SCENES)
@pytest.mark.parametrize("builder", ["morton", "sah"])
def test_pack_equals_jax(kind, builder):
    jd, td, n = _triangles(kind)
    if builder == "sah":
        nodes = jbvh.build_bvh_sah(td["v0"], td["e1"], td["e2"], n, 32)
        if nodes is None:
            pytest.skip("no C++ compiler for the native SAH builder")
    else:
        nodes = jbvh.to_node_arrays(jbvh.build_bvh(td["v0"], td["e1"], td["e2"], n, 32))
    want = jtv.pack_for_traversal(nodes, jd, 32)
    got = ttv.pack_for_traversal(nodes, td, 32)
    for k in PACK_KEYS:
        np.testing.assert_array_equal(got[k], npy(want[k]), err_msg=k)
    assert got["mt_attr_lanes"] == int(npy(want["mt_attr_lanes"]))
    np.testing.assert_array_equal(got["bvhf_rows"], got["bvhf_nodes"].T)
    np.testing.assert_array_equal(got["bvh_rows"], got["bvh_nodes"].T)
    np.testing.assert_array_equal(got["bvh8_rows"], got["bvh8_nodes"])
    child = nodes["child"]
    np.testing.assert_array_equal(
        ttv.fat_nodes(nodes["nodes_lo"], nodes["nodes_hi"], child),
        jtv.fat_nodes(nodes["nodes_lo"], nodes["nodes_hi"], child),
    )


@pytest.mark.parametrize("kind", SCENES)
def test_scene_build_bvh_equals_jax(kind):
    jsc, tsc = scene_pair(kind)
    want = jsc.build(accel="bvh")["bvh"]
    got = tsc.build("cpu", accel="bvh")["bvh"]
    assert got["builder"] in ("sah", "morton")
    for k in PACK_KEYS:
        g = got[k].numpy()
        assert g.dtype == npy(want[k]).dtype, k
        np.testing.assert_array_equal(g, npy(want[k]), err_msg=k)
    assert got["mt_attr_lanes"] == int(npy(want["mt_attr_lanes"]))
    for k in ("bvhf_rows", "bvh_rows", "bvh8_rows"):
        assert got[k].is_contiguous() and got[k].dtype == torch.float32, k


def test_morton_fallback_without_gxx(monkeypatch):
    monkeypatch.setattr(tnative, "build_sah_native", lambda *a, **k: None)
    jd, td, n = _triangles("soup600")
    nodes, builder = tbvh.build_nodes(td["v0"], td["e1"], td["e2"], n, 32)
    assert builder == "morton"
    want = jbvh.to_node_arrays(jbvh.build_bvh(td["v0"], td["e1"], td["e2"], n, 32))
    for k in ("nodes_lo", "nodes_hi", "child", "order"):
        np.testing.assert_array_equal(nodes[k], want[k], err_msg=k)
    _, tsc = scene_pair("soup600")
    assert tsc.build("cpu", accel="bvh")["bvh"]["builder"] == "morton"


def test_accel_threshold_and_modes():
    sc, _ = thead.build_scene("soup:5000")  # 5000 > BVH_THRESHOLD: auto attaches
    assert "bvh" in sc.build_numpy() and "bvh" not in sc.build_numpy(accel="none")
    small, _ = thead.build_scene("instanced:2")  # 3,842 triangles
    assert "bvh" not in small.build_numpy() and "bvh" in small.build_numpy(accel="bvh")
    assert tscene_mod.BVH_THRESHOLD == 4096 and tscene_mod.BVH_LEAF_SIZE == 32
    with pytest.raises(ValueError, match="accel"):
        sc.build_numpy(accel="two-level")


def test_unported_build_paths_raise(monkeypatch):
    sc, _ = thead.build_scene("soup:5000")
    # DXR_PRIME=1 builds since the PRIME table is ported; a soup has no
    # dominating triangle, so it gets no table, as from the JAX build
    monkeypatch.setenv("DXR_PRIME", "1")
    assert "prime_v0" not in sc.build("cpu") and "prime_v0" not in j_build_scene("soup:5000")[0].build()
    monkeypatch.delenv("DXR_PRIME")
    # texture envs build (ROADMAP item 9): above the threshold the BVH is the
    # size's, below it a texture env's route (tagged tex_autoroute)
    img = np.random.default_rng(0).uniform(0, 2, (4, 8, 3)).astype(np.float32)
    sc.environment = tenvmap.latlong_env(img)
    built = sc.build("cpu")
    assert built["env"]["kind"] == 2 and "tex_autoroute" not in built["bvh"]
    np.testing.assert_array_equal(built["env"]["latlong"].numpy(), img)
    small, _ = thead.build_scene("soup:300")
    small.environment = tenvmap.cubemap_env(np.zeros((6, 2, 2, 3), np.float32))
    assert small.build_numpy()["bvh"]["tex_autoroute"] == 1
    assert "bvh" not in small.build_numpy(accel="none")


def test_sphere_mesh_and_instanced_scene_equal_jax():
    tm = tproc.sphere_mesh((0.5, 1.0, -2.0), 1.5, material_id=1, lat=8, lon=12)
    jm = jproc.sphere_mesh((0.5, 1.0, -2.0), 1.5, material_id=1, lat=8, lon=12)
    for k in ("positions", "normals", "indices", "material_ids"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k), err_msg=k)
    jsc, tsc = scene_pair("instanced:2")
    jd, td = jsc.build(accel="none"), tsc.build("cpu", accel="none")
    assert td["num_tris"] == int(jd["num_tris"]) == 3842
    for k in ("mt_pack", "attr_pack"):
        np.testing.assert_array_equal(td[k].numpy(), npy(jd[k]), err_msg=k)
    assert torch.equal(td["mat_id"], torch.as_tensor(np.array(npy(jd["mat_id"]))).long())


@pytest.mark.parametrize("kind", SCENES)
def test_scene_material_pack_equals_jax(kind):
    jsc, tsc = scene_pair(kind)
    jd = jsc.build(accel="bvh")
    want = npy(jmaterials.material_pack(jd["materials"]))
    got = tsc.build("cpu", accel="bvh")["material_pack"]
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    ported = scene_from_numpy(jax.tree.map(np.asarray, jd), "cpu")
    np.testing.assert_array_equal(ported["material_pack"].numpy(), want)
    assert "material_pack" not in tsc.build("cpu", accel="none")
