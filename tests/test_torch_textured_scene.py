"""Textured scenes through the port's scene build vs the JAX package's, on
the CPU: the textured Cornell box, ``Scene.build``'s albedo textures,
corner UVs, mt_rows lanes 74..79 and the ``tex_autoroute`` BVH, the
two-level object-space UVs, ``scene_from_numpy`` of a textured JAX scene,
and the route each pipeline takes. Every pack is copied numpy code, so
every comparison is bit-equal.
"""

import jax
import numpy as np
import pytest

from dxrexperiments_torch.app import headless as thead
from dxrexperiments_torch.models.base import select_route
from dxrexperiments_torch.scene import Scene as TScene
from dxrexperiments_torch.scene import cornell_box as t_cornell
from dxrexperiments_torch.scene import envmap as tenv
from dxrexperiments_torch.scene import lights as tlights
from dxrexperiments_torch.scene.convert import scene_from_numpy
from dxrexperiments_torch.scene.mesh import Mesh as TMesh
from dxrexperiments_torch.scene.procedural import merge_meshes as t_merge
from dxrexperiments_tpu.app.headless import build_scene as j_build_scene
from dxrexperiments_tpu.ops import fused_sample_pallas as jfs
from dxrexperiments_tpu.ops import fused_traverse_pallas as jft
from dxrexperiments_tpu.scene import Scene as JScene
from dxrexperiments_tpu.scene import cornell_box as j_cornell
from dxrexperiments_tpu.scene import envmap as jenv
from dxrexperiments_tpu.scene import lights as jlights
from dxrexperiments_tpu.scene.mesh import Mesh as JMesh
from dxrexperiments_tpu.scene.procedural import merge_meshes as j_merge

MATERIAL_FIELDS = ("albedo", "specular", "emissive", "reflectivity", "roughness", "ior", "type")


def npy(tree):
    return jax.tree.map(np.asarray, tree)


def area_rig(lm):
    return {"dir": [lm.directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.3))],
            "point": [],
            "area": [lm.area_light((-0.4, 1.96, -0.4), (0.8, 0, 0), (0, 0, 0.8),
                                   (1.0, 0.9, 0.7, 4.0))]}


def two_dirs(lm):
    return {"dir": [lm.directional_light((0.0, -0.6, -0.8)),
                    lm.directional_light((0.5, -0.7, 0.2))]}


def scenes(textured=True, rig="area"):
    """(JAX Scene, port Scene): the glossy Cornell box, its floor textured
    or not, under the 1 directional + 1 area rig (or two directional
    lights, a rig no megakernel takes) and a gradient env."""
    out = []
    for scene_cls, cornell, env, lm in ((JScene, j_cornell, jenv, jlights),
                                        (TScene, t_cornell, tenv, tlights)):
        mesh, mats = cornell(glossy_tall_box=True, textured_floor=textured)
        sc = scene_cls()
        for m in mats:
            sc.add_material(m)
        sc.add_model(mesh)
        sc.lights = area_rig(lm) if rig == "area" else two_dirs(lm)
        sc.environment = env.gradient_env()
        out.append(sc)
    return out


def test_textured_cornell_box_equals_jax():
    (jm, jmats), (tm, tmats) = j_cornell(textured_floor=True), t_cornell(textured_floor=True)
    for k in ("positions", "normals", "indices", "material_ids", "uv_corners"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k), err_msg=k)
    assert tm.uv_corners.shape == (36, 3, 2) and np.count_nonzero(tm.material_ids == 5) == 2
    assert len(tmats) == len(jmats) == 6
    for t, j in zip(tmats, jmats):
        for k in MATERIAL_FIELDS:
            assert getattr(t, k) == getattr(j, k), k
        assert (t.albedo_texture is None) == (j.albedo_texture is None)
        if t.albedo_texture is not None:
            np.testing.assert_array_equal(t.albedo_texture, j.albedo_texture)
    assert t_cornell()[0].uv_corners is None and len(t_cornell()[1]) == 5


def test_merge_meshes_fills_missing_uvs_with_zeros():
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([[0, 1, 2]], np.int32)
    uv = np.array([[[0.1, 0.2], [0.3, 0.4], [0.5, 0.6]]], np.float32)
    got = t_merge([TMesh(pos, None, idx, uv_corners=uv), TMesh(pos, None, idx)])
    want = j_merge([JMesh(pos, None, idx, uv_corners=uv), JMesh(pos, None, idx)])
    np.testing.assert_array_equal(got.uv_corners, want.uv_corners)
    np.testing.assert_array_equal(got.uv_corners[1], 0.0)
    assert t_merge([TMesh(pos, None, idx)]).uv_corners is None


@pytest.mark.parametrize("case", ["cornell-tex", "area_bvh", "area_none", "two_dirs_auto",
                                  "untextured_auto"])
def test_build_textures_match_jax(case):
    if case == "cornell-tex":
        jsc, tsc = j_build_scene(case)[0], thead.build_scene(case)[0]
    else:
        jsc, tsc = scenes(textured=case != "untextured_auto",
                          rig="two_dirs" if case == "two_dirs_auto" else "area")
    accel = {"area_bvh": "bvh", "area_none": "none"}.get(case, "auto")
    jd, td = npy(jsc.build(accel=accel)), tsc.build("cpu", accel=accel)
    assert ("textures" in td) == ("textures" in jd) == (case != "untextured_auto")
    assert ("bvh" in td) == ("bvh" in jd)
    if "textures" in td:
        np.testing.assert_array_equal(td["textures"]["texels"].numpy(), jd["textures"]["rows"][:, :3])
        np.testing.assert_array_equal(td["textures"]["meta"].numpy(), jd["textures"]["meta"])
        for k in ("uv0", "uv1", "uv2"):
            np.testing.assert_array_equal(td[k].numpy(), jd[k], err_msg=k)
    else:
        assert "uv0" not in td and "uv0" not in jd
    if "bvh" in td:
        np.testing.assert_array_equal(td["bvh"]["mt_rows"].numpy(), jd["bvh"]["mt_rows"])
        assert td["bvh"]["mt_attr_lanes"] == int(jd["bvh"]["mt_attr_lanes"])
        assert td["bvh"]["mt_attr_lanes"] == (2 if "textures" in td else 1)
        assert ("tex_autoroute" in td["bvh"]) == ("tex_autoroute" in jd["bvh"])
    # the albedo texture triggers the routing BVH when B5's rig gate takes the scene
    assert ("bvh" in td) == (case in ("cornell-tex", "area_bvh"))


def test_build_two_level_uvs_match_jax():
    jsc, tsc = scenes()
    jd, td = npy(jsc.build_two_level()), tsc.build_two_level("cpu")
    for k in ("uv0_obj", "uv1_obj", "uv2_obj"):
        np.testing.assert_array_equal(td[k].numpy(), jd[k], err_msg=k)
    np.testing.assert_array_equal(td["textures"]["texels"].numpy(), jd["textures"]["rows"][:, :3])
    np.testing.assert_array_equal(td["textures"]["meta"].numpy(), jd["textures"]["meta"])
    assert "textures" not in scenes(textured=False)[1].build_two_level("cpu")


@pytest.mark.parametrize("form", ["flattened", "two_level"])
def test_scene_from_numpy_carries_textures(form):
    jsc, tsc = scenes()
    jd = npy(jsc.build_two_level() if form == "two_level" else jsc.build())
    got = scene_from_numpy(jd, "cpu")
    built = tsc.build_two_level("cpu") if form == "two_level" else tsc.build("cpu")
    suffix = "_obj" if form == "two_level" else ""
    for k in ("texels", "meta"):
        np.testing.assert_array_equal(got["textures"][k].numpy(), built["textures"][k].numpy())
        assert got["textures"][k].dtype == built["textures"][k].dtype
    for k in range(3):
        np.testing.assert_array_equal(got[f"uv{k}{suffix}"].numpy(),
                                      built[f"uv{k}{suffix}"].numpy())
    if form == "flattened":
        assert got["bvh"]["mt_attr_lanes"] == 2 and "tex_autoroute" in got["bvh"]


def jax_route(scene, mode):
    if jfs.supports_fused(scene, mode, False):
        return "fused"
    if jft.supports_fused_traverse(scene, mode, False):
        return "fused_traverse"
    return "wavefront"


ROUTES = {
    "cornell-tex": {"progressive": "fused_traverse", "realtime": "wavefront"},
    "textured_none": {"progressive": "wavefront", "realtime": "wavefront"},
    "area_bvh": {"progressive": "fused_traverse", "realtime": "fused_traverse"},
    "textured_two_level": {"progressive": "wavefront", "realtime": "wavefront"},
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_select_route_matches_jax(case):
    if case == "cornell-tex":
        jd = j_build_scene(case)[0].build()
    else:
        jsc = scenes(textured=case != "area_bvh")[0]
        jd = {"textured_none": lambda: jsc.build(accel="none"),
              "area_bvh": lambda: jsc.build(accel="bvh"),
              "textured_two_level": jsc.build_two_level}[case]()
    td = scene_from_numpy(npy(jd), "cpu")
    for mode, want in ROUTES[case].items():
        assert select_route(td, mode) == jax_route(jd, mode) == want, mode
