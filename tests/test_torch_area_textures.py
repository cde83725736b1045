"""Albedo textures and area lights (BASELINE config 2's features) through
the port vs the JAX package, on the CPU.

The fused-traversal kernel's plain versions (loops over the wavefront
integrator, whose BVH traces are the brute-force sweep) render the CLI's
``cornell-tex`` (a checker-textured floor, 1 directional + 1 area light),
tests/test_fused_traverse.py's ``cornell_area`` (textured, under a seeded
cubemap: area light, albedo texture and texture env in one scene) and the
untextured area Cornell's realtime AOVs; the wavefront routes (brute force,
BVH, two-level) render a textured scene. Each is held against the JAX jnp
route on the image gate of benchmarks/kernel_parity.py: at most 1% of
pixels differ by more than 1e-3 and the median |difference| is at most
1e-5 (roughness as a one-channel image). Two cases are held on the same
gate against the JAX kernel itself in interpret mode (its area and
tex-deferred modes). The CUDA kernel is held against these plain versions
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.app import headless as thead
from dxrexperiments_torch.models.base import select_route
from dxrexperiments_torch.ops import fused_traverse as tft
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene.convert import (
    camera_from_numpy,
    options_from_numpy,
    scene_from_numpy,
)
from dxrexperiments_torch.trace import integrator as tint
from dxrexperiments_tpu.app.headless import build_scene as j_build_scene
from dxrexperiments_tpu.core.camera import Camera, camera_params
from dxrexperiments_tpu.ops import fused_traverse_pallas as jft
from dxrexperiments_tpu.scene import Scene, cornell_box, envmap
from dxrexperiments_tpu.scene.lights import area_light, directional_light
from dxrexperiments_tpu.trace import default_options, render_sample

W = H = 32
AOVS = ("color", "direct", "indirect_specular", "albedo", "roughness")
AREA_RIG = {
    "dir": [directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.3))],
    "point": [],
    "area": [area_light((-0.4, 1.96, -0.4), (0.8, 0, 0), (0, 0, 0.8), (1.0, 0.9, 0.7, 4.0))],
}


def npy(tree):
    return jax.tree.map(np.asarray, tree)


def cornell_area(textured=False, env="gradient", accel="bvh"):
    """tests/test_fused_traverse.py's area Cornell: the glossy tall box, the
    1 directional + 1 area rig, a gradient env or a seeded 8^2 cubemap."""
    mesh, materials = cornell_box(glossy_tall_box=True, textured_floor=textured)
    sc = Scene()
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh)
    sc.lights = AREA_RIG
    if env == "gradient":
        sc.environment = envmap.gradient_env()
    else:
        rs = np.random.default_rng(3)
        sc.environment = envmap.cubemap_env(rs.uniform(0, 2, (6, 8, 8, 3)).astype(np.float32),
                                            strength=1.3)
    return sc.build_two_level() if accel == "two_level" else sc.build(accel=accel)


def cornell_tex():
    """The JAX CLI's cornell-tex scene, built as the CLI builds it."""
    return j_build_scene("cornell-tex")[0].build()


def jax_camera(frame=5, size=W):
    cam = Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(size, size)
    return camera_params(cam, jitter=(0.3 / size, -0.2 / size), frame_count=frame)


def port(jscene, jopts, jcam):
    return (scene_from_numpy(npy(jscene), "cpu"), options_from_numpy(npy(jopts)),
            camera_from_numpy(npy(jcam)))


def assert_images_match(got, want, frac=0.01, tol=1e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    bad = (diff > tol).any(axis=-1).mean() if diff.ndim == 3 else (diff > tol).mean()
    assert bad <= frac, f"{bad:.4%} pixels differ by more than {tol}"
    assert float(np.median(diff)) <= 1e-5


def progressive_vs_jnp(jscene, opts):
    jopts, jcam = default_options(**opts), jax_camera()
    tscene, topts, tcam = port(jscene, jopts, jcam)
    ek = int(jscene["env"]["kind"])
    want = render_sample(jscene, jopts, jcam, W, H, mode="progressive", impl="jnp",
                         env_kind=ek)["color"]
    before = launch_counts()["B5"]
    got = tft.fused_traverse_progressive_sum(tscene, topts, {k: v[None] for k, v in tcam.items()},
                                             W, H, ek)
    assert launch_counts()["B5"] == before  # the CPU path launches no kernel
    assert_images_match(got.numpy(), want)
    return got


@pytest.mark.parametrize("opts", [{}, {"debug": 2}, {"show_gbuffer_albedo_only": True}],
                         ids=["defaults", "debug2", "albedo_only"])
def test_cornell_tex_progressive_matches_jnp(opts):
    jscene = cornell_tex()
    assert "tex_autoroute" in jscene["bvh"]
    got = progressive_vs_jnp(jscene, opts)
    if opts:
        return
    # the checker shows: the floor's two texel colours differ in the image
    floor = got[-4:, 8:24].reshape(-1, 3)
    assert float(floor[:, 0].max() - floor[:, 0].min()) > 0.05


def test_textured_cubemap_area_progressive_matches_jnp():
    progressive_vs_jnp(cornell_area(textured=True, env="cubemap"), {})


def test_area_realtime_aovs_match_jnp():
    jscene = cornell_area()
    jopts, jcam = default_options(debug=2), jax_camera(frame=9)
    tscene, topts, tcam = port(jscene, jopts, jcam)
    assert select_route(tscene, "realtime") == "fused_traverse"
    want = render_sample(jscene, jopts, jcam, W, H, mode="realtime", jitter_scale=10.0,
                         impl="jnp", env_kind=1)
    got = tft.fused_traverse_realtime_outputs(tscene, topts, tcam, W, H, 1)
    for k in AOVS:
        assert_images_match(got[k].numpy(), want[k])


@pytest.mark.parametrize("route", ["brute", "bvh", "two_level"])
def test_textured_wavefront_routes_match_jnp(route):
    accel = {"brute": "none", "bvh": "bvh", "two_level": "two_level"}[route]
    jscene = cornell_area(textured=True, accel=accel)
    jopts, jcam = default_options(), jax_camera(frame=3)
    tscene, topts, tcam = port(jscene, jopts, jcam)
    assert "textures" in tscene and ("bvh" in tscene) == (route == "bvh")
    for mode in ("progressive", "realtime"):
        if route == "bvh" and mode == "progressive":
            continue  # B5's route; the realtime frame takes the BVH wavefront route
        assert select_route(tscene, mode) == "wavefront"
        scale = 10.0 if mode == "realtime" else 30.0
        want = render_sample(jscene, jopts, jcam, W, H, mode=mode, jitter_scale=scale,
                             impl="jnp", env_kind=1)
        got = tint.render_sample(tscene, topts, tcam, W, H, mode=mode, jitter_scale=scale,
                                 impl="torch", env_kind=1)
        for k in (AOVS if mode == "realtime" else ("color",)):
            assert_images_match(got[k].numpy(), want[k])


def test_textured_progressive_matches_pallas_interpret():
    jscene = cornell_area(textured=True)
    jopts = default_options()
    jcams = jax.tree.map(lambda x: x[None], jax_camera(frame=7, size=16))
    tscene, topts, tcams = port(jscene, jopts, jcams)
    want = jft.fused_traverse_progressive_sum(jscene, jopts, jcams, 16, 16, 1, interpret=True)
    got = tft.fused_traverse_progressive_sum(tscene, topts, tcams, 16, 16, 1)
    assert_images_match(got.numpy(), want)


def test_area_realtime_matches_pallas_interpret():
    jscene = cornell_area()
    jopts, jcam = default_options(), jax_camera(frame=11, size=16)
    tscene, topts, tcam = port(jscene, jopts, jcam)
    want = jft.fused_traverse_realtime_outputs(jscene, jopts, jcam, 16, 16, 1, interpret=True)
    got = tft.fused_traverse_realtime_outputs(tscene, topts, tcam, 16, 16, 1)
    for k in AOVS:
        assert_images_match(got[k].numpy(), want[k])


def test_area_pack_matches_jax():
    from dxrexperiments_tpu.ops.fused_sample_pallas import pack_area_consts

    jscene = cornell_tex()
    want = np.asarray(pack_area_consts(jscene))
    got = tft.pack_area_consts(scene_from_numpy(npy(jscene), "cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)
    cst, rig = tft._rig_consts(scene_from_numpy(npy(jscene), "cpu"), options_from_numpy(
        npy(default_options())), 0)
    assert rig == 1 | 4 and tuple(cst.shape) == (3, 16)
    np.testing.assert_array_equal(cst[2].numpy(), got[0].numpy())


def test_cli_cornell_tex(tmp_path, capsys):
    out = tmp_path / "tex.png"
    assert thead.main(["--scene", "cornell-tex", "--size", "16x16", "--spp", "1",
                       "--device", "cpu", "-o", str(out)]) == 0
    assert out.exists() and out.stat().st_size > 0
    assert "progressive (cpu)" in capsys.readouterr().out


def test_cornell_tex_scene_matches_jax():
    tsc, tcam = thead.build_scene("cornell-tex")
    jsc, jcam = j_build_scene("cornell-tex")
    np.testing.assert_array_equal(tcam.view_proj_matrix(), jcam.view_proj_matrix())
    built, jd = tsc.build("cpu"), jsc.build()
    for k in ("uv0", "uv1", "uv2", "mat_id"):
        np.testing.assert_array_equal(built[k].numpy(), np.asarray(jd[k]), err_msg=k)
    np.testing.assert_array_equal(built["bvh"]["mt_rows"].numpy(), np.asarray(jd["bvh"]["mt_rows"]))
    for group in ("dir", "area"):
        for k, v in jsc.lights[group][0].items():
            np.testing.assert_array_equal(tsc.lights[group][0][k].numpy(), np.asarray(v))
    assert len(tsc.lights["point"]) == 0 and int(tsc.environment["kind"]) == 0
    assert select_route(built, "progressive") == "fused_traverse"
    assert select_route(built, "realtime") == "wavefront"
    assert jnp.asarray(jd["bvh"]["tex_autoroute"]) == 1 and built["bvh"]["tex_autoroute"] == 1
