"""Port the brute-force wavefront route vs the JAX package: the trace
kernels' plain versions (ops/intersect_kernel.py, kernel B3 on the card),
area lights, the AO view, the refraction bounce, the route choice and the
CLI.

On the CPU ``trace_closest``/``trace_any`` take their plain versions. They
are held against the JAX Pallas kernels in interpret mode
(``intersect_pallas.trace_closest``/``trace_any``) on the 960-triangle
sphere (two 512-triangle chunks) and the Cornell box, culled and not, with
per-ray t_max and zero-direction rays. Tolerances: hit and triangle equal on
at least 99% of rays; on rays that hit the same triangle, t within rtol
2e-4 / atol 2e-5 (tests/test_intersect_pallas.py: the plain version
recomputes t by classic Möller–Trumbore, the kernel divides the sweep's
terms), normal and position within 1e-5, material rows and ids exact.

Whole samples (32^2) go through the port's integrator and JAX
``render_sample`` (impl "jnp", and "pallas_interpret" for instanced:1) on
the same scene, cameras and seeds, held to the image gate of
benchmarks/kernel_parity.py: at most 1% of pixels differ by more than 1e-3,
median |difference| at most 1e-5, every realtime AOV on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.app import headless as thead
from dxrexperiments_torch.core import vecmath as tvm
from dxrexperiments_torch.models.base import select_route
from dxrexperiments_torch.models.progressive import ProgressiveRaytracingPipeline
from dxrexperiments_torch.ops import fused_traverse as tft
from dxrexperiments_torch.ops import intersect_kernel as tik
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene import lights as tlights
from dxrexperiments_torch.scene.convert import camera_from_numpy, options_from_numpy, scene_from_numpy
from dxrexperiments_torch.trace import integrator as tint
from dxrexperiments_tpu.app.headless import build_scene as j_build_scene
from dxrexperiments_tpu.core import vecmath as jvm
from dxrexperiments_tpu.core.camera import Camera, camera_params
from dxrexperiments_tpu.ops import fused_sample_pallas as jfs
from dxrexperiments_tpu.ops import fused_traverse_pallas as jft
from dxrexperiments_tpu.ops import intersect_pallas as jip
from dxrexperiments_tpu.scene import Scene, cornell_box, envmap
from dxrexperiments_tpu.scene import lights as jlights
from dxrexperiments_tpu.scene.lights import area_light, directional_light, point_light
from dxrexperiments_tpu.scene.procedural import sphere_mesh
from dxrexperiments_tpu.trace import default_options, render_sample

SIZE = 32
N_RAYS = 400
AOVS = ("direct", "indirect_specular", "albedo", "roughness", "color")
MATERIAL_KEYS = tik.MATERIAL_KEYS
RIGS = {
    "2dir_2point": {"dir": [directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
                            directional_light((0.5, -0.7, 0.2), (0.3, 0.5, 0.9, 0.4))],
                    "point": [point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
                              point_light((-0.6, 1.2, 0.5), (0.4, 0.9, 0.5, 3.0))]},
    "0dir_3point": {"point": [point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
                              point_light((-0.6, 1.2, 0.5), (0.4, 0.9, 0.5, 3.0)),
                              point_light((0.7, 0.5, -0.3), (0.9, 0.4, 0.4, 2.0))]},
    "1dir_1area": {"dir": directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
                   "area": [area_light((-0.3, 1.95, -0.3), (0.6, 0.0, 0.0), (0.0, 0.0, 0.6),
                                       (1.0, 0.9, 0.8, 8.0))]},
    "2area": {"area": [area_light((-0.3, 1.95, -0.3), (0.6, 0.0, 0.0), (0.0, 0.0, 0.6),
                                  (1.0, 0.9, 0.8, 8.0)),
                       area_light((-0.9, 0.4, 0.8), (0.0, 0.8, 0.0), (0.5, 0.0, 0.0),
                                  (0.5, 0.6, 1.0, 4.0))]},
}


def npy(tree):
    return jax.tree.map(np.asarray, tree)


def cornell(rig=None, glossy=True, env="const"):
    mesh, materials = cornell_box(glossy_tall_box=glossy)
    sc = Scene()
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh)
    sc.lights = rig if rig is not None else {
        "dir": directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
        "point": point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
    }
    sc.environment = (envmap.constant_env((0.05, 0.1, 0.2), strength=1.5) if env == "const"
                      else envmap.gradient_env())
    return sc.build(accel="none")


def sphere():
    sc = Scene()
    sc.add_model(sphere_mesh((0.0, 0.0, 0.0), 1.0, lat=16, lon=32))  # 960 triangles
    return sc.build(accel="none")


def rays(kind, seed):
    """N_RAYS rays with per-ray t_max and one in nine at zero direction:
    from inside the Cornell box, or from a shell of radius 3 aimed at the
    sphere's neighbourhood."""
    rs = np.random.default_rng(seed)
    if kind == "cornell":
        o = rs.uniform(-0.9, 0.9, size=(N_RAYS, 3)).astype(np.float32)
        o[:, 1] = rs.uniform(0.1, 1.9, size=N_RAYS)
        d = rs.normal(size=(N_RAYS, 3))
    else:
        o = rs.normal(size=(N_RAYS, 3))
        o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
        d = rs.uniform(-0.9, 0.9, size=(N_RAYS, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[::9] = 0.0
    o = o.astype(np.float32)
    tmax = np.where(np.arange(N_RAYS) % 3 == 0, 1.5, 3.0e37).astype(np.float32)
    return o, d, tmax


def scene_pair(kind):
    jscene = cornell() if kind == "cornell" else sphere()
    return jscene, scene_from_numpy(npy(jscene), "cpu")


@pytest.mark.parametrize("kind", ["sphere", "cornell"])
@pytest.mark.parametrize("cull", [False, True])
def test_trace_closest_plain_matches_pallas(kind, cull):
    jscene, tscene = scene_pair(kind)
    o, d, tmax = rays(kind, seed=3)
    want = npy(jip.trace_closest(jscene, jnp.asarray(o), jnp.asarray(d), 1e-4,
                                 jnp.asarray(tmax), cull_backface=cull, interpret=True))
    before = launch_counts()["B3 closest"]
    got = {k: v.numpy() for k, v in tik.trace_closest(
        tscene, torch.as_tensor(o), torch.as_tensor(d), 1e-4, torch.as_tensor(tmax),
        cull_backface=cull).items()}
    assert launch_counts()["B3 closest"] == before  # the CPU path launches no kernel
    same = (got["hit"] == want["hit"]) & (got["tri"] == want["tri"])
    assert same.mean() >= 0.99 and 0.2 < want["hit"].mean() < 0.95
    assert not want["hit"][::9].any() and not got["hit"][::9].any()
    both = same & got["hit"]
    np.testing.assert_allclose(got["t"][same], want["t"][same], rtol=2e-4, atol=2e-5)
    for k in ("normal", "position"):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=0, atol=1e-5, err_msg=k)
    for k in (*MATERIAL_KEYS, "mat_id"):
        np.testing.assert_array_equal(got[k][same], want[k][same], err_msg=k)
    assert got["type"].dtype == np.int64 and got["mat_id"].dtype == np.int64
    miss = same & ~got["hit"]
    assert (got["t"][miss] == -1).all() and (got["tri"][miss] == -1).all()
    assert (got["normal"][miss] == 0).all() and both.sum() > 100


@pytest.mark.parametrize("kind", ["sphere", "cornell"])
def test_trace_any_plain_matches_pallas(kind):
    jscene, tscene = scene_pair(kind)
    o, d, tmax = rays(kind, seed=4)
    want = np.asarray(jip.trace_any(jscene, jnp.asarray(o), jnp.asarray(d), 1e-4,
                                    jnp.asarray(tmax), interpret=True))
    before = launch_counts()["B3 any"]
    got = tik.trace_any(tscene, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                        torch.as_tensor(tmax)).numpy()
    assert launch_counts()["B3 any"] == before
    assert 0.05 < want.mean() < 0.95
    assert not got[::9].any() and not want[::9].any()
    assert float((got != want).mean()) <= 0.01
    # a scalar window: the same result as the same window per ray
    scalar = tik.trace_any(tscene, torch.as_tensor(o), torch.as_tensor(d), 1e-4, 1.5).numpy()
    per_ray = tik.trace_any(tscene, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                            torch.full((N_RAYS,), 1.5)).numpy()
    np.testing.assert_array_equal(scalar, per_ray)


def camera(eye, at, jitter=(0.3 / SIZE, -0.2 / SIZE), frame=5):
    cam = Camera()
    cam.set_eye_at_up(eye, at, (0.0, 1.0, 0.0))
    cam.set_aspect(SIZE, SIZE)
    return camera_params(cam, jitter=jitter, frame_count=frame)


CORNELL_EYE = ((0.0, 1.0, 3.4), (0.0, 1.0, 0.0))


def image_gate(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if got.ndim == 2:
        got, want = got[..., None], want[..., None]
    diff = np.abs(got - want)
    assert (diff > 1e-3).any(axis=-1).mean() <= 0.01
    assert float(np.median(diff)) <= 1e-5


def render_both(jscene, jcam, opts=None, impl="jnp", **kw):
    """JAX render_sample and the port's plain integrator on the same
    scene, camera and seeds; returns (got, want) dicts of numpy images."""
    jopts = default_options(**(opts or {}))
    ek = int(jscene["env"]["kind"])
    want = npy(render_sample(jscene, jopts, jcam, SIZE, SIZE, impl=impl, env_kind=ek, **kw))
    got = tint.render_sample(scene_from_numpy(npy(jscene), "cpu"), options_from_numpy(npy(jopts)),
                             camera_from_numpy(npy(jcam)), SIZE, SIZE, impl="torch",
                             env_kind=ek, **kw)
    return {k: v.numpy() for k, v in got.items()}, want


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("mode", ["progressive", "realtime"])
def test_instanced1_sample_matches_jax(mode, impl):
    sc, cam = j_build_scene("instanced:1")
    jscene = sc.build()
    assert "bvh" not in jscene and int(jscene["num_tris"]) == 962
    cam.set_aspect(SIZE, SIZE)
    jcam = camera_params(cam, jitter=(0.3 / SIZE, -0.2 / SIZE), frame_count=2**31 + 7)
    kw = {"mode": mode, "jitter_scale": 10.0 if mode == "realtime" else 30.0}
    got, want = render_both(jscene, jcam, impl=impl, **kw)
    for k in (AOVS if mode == "realtime" else ("color",)):
        image_gate(got[k], want[k])
    assert float(got["color"].mean()) > 0.0


@pytest.mark.parametrize("cosine", [True, False])
def test_ao_only_matches_jnp(cosine):
    got, want = render_both(cornell(env="gradient"), camera(*CORNELL_EYE),
                            {"cosine_hemisphere_sampling": cosine}, ao_only=True)
    image_gate(got["color"], want["color"])
    assert 0.0 < float(got["color"].mean())


def test_refraction_matches_jnp():
    sc, cam = j_build_scene("cornell-glass")
    jscene = sc.build()
    tsc, _ = thead.build_scene("cornell-glass")
    built = tsc.build("cpu")
    for k in ("mt_pack", "attr_pack"):
        np.testing.assert_array_equal(built[k].numpy(), np.asarray(jscene[k]), err_msg=k)
    jcam = camera(*CORNELL_EYE)
    got, want = render_both(jscene, jcam, refraction=True)
    image_gate(got["color"], want["color"])
    plain, _ = render_both(jscene, jcam, refraction=False)
    assert float(np.abs(got["color"] - plain["color"]).max()) > 1e-3  # the pane transmits


@pytest.mark.parametrize("mode", ["progressive", "realtime"])
@pytest.mark.parametrize("debug", [0, 2])
@pytest.mark.parametrize("rig", sorted(RIGS))
def test_light_rigs_match_jnp(rig, debug, mode):
    kw = {"mode": mode, "jitter_scale": 10.0 if mode == "realtime" else 30.0}
    got, want = render_both(cornell(RIGS[rig]), camera(*CORNELL_EYE), {"debug": debug}, **kw)
    for k in (AOVS if mode == "realtime" else ("color",)):
        image_gate(got[k], want[k])
    assert float(got["color"].mean()) > 0.0


@pytest.mark.parametrize("kind", ["bvh", "two_level"])
@pytest.mark.parametrize("option", ["ao_only", "area_refraction"])
def test_other_routes_take_the_new_options(kind, option):
    """AO, area lights and refraction on the BVH and two-level routes (B4a
    and B6a on the card), against JAX jnp at 32^2."""
    sc, cam = j_build_scene("instanced:2")
    if option == "area_refraction":
        sc.lights = RIGS["2area"]  # two area lights: B5's gate declines
    jscene = sc.build(accel="bvh") if kind == "bvh" else sc.build_two_level()
    cam.set_aspect(SIZE, SIZE)
    jcam = camera_params(cam, jitter=(0.3 / SIZE, -0.2 / SIZE), frame_count=9)
    kw = {"ao_only": True} if option == "ao_only" else {"refraction": True}
    got, want = render_both(jscene, jcam, **kw)
    image_gate(got["color"], want["color"])
    assert float(got["color"].mean()) > 0.0
    tscene = scene_from_numpy(npy(jscene), "cpu")
    assert select_route(tscene, "progressive", kw.get("ao_only", False),
                        kw.get("refraction", False)) == "wavefront"


def test_area_light_draws_and_rigs_bit_equal():
    seeds = np.random.default_rng(0).integers(0, 2**32, size=257, dtype=np.uint64)
    want = jlights.area_light_draws(jnp.asarray(seeds.astype(np.uint32)))
    got = tlights.area_light_draws(torch.as_tensor(seeds.astype(np.int64)))
    assert len(got) == len(want) == tlights.AREA_LIGHT_SAMPLES
    for (g0, g1), (w0, w1) in zip(got, want):
        np.testing.assert_array_equal(g0.numpy(), np.asarray(w0))
        np.testing.assert_array_equal(g1.numpy(), np.asarray(w1))
    for name, rig in RIGS.items():
        want = npy(jlights.normalize_lights(rig))
        port_rig = scene_from_numpy(npy(cornell(rig)), "cpu")["lights"]
        got = tlights.normalize_lights(port_rig)
        assert tlights.light_counts(port_rig) == jlights.light_counts(rig), name
        for group in ("dir", "point", "area"):
            for k, v in want[group].items():
                np.testing.assert_array_equal(got[group][k].numpy(), v, err_msg=f"{name} {k}")
    area = tlights.area_lights([tlights.area_light((0, 1, 0), (1, 0, 0), (0, 0, 1))])
    want = npy(jlights.area_lights([jlights.area_light((0, 1, 0), (1, 0, 0), (0, 0, 1))]))
    for k, v in want.items():
        np.testing.assert_array_equal(area[k].numpy(), v)


def test_refract_matches_jax():
    rs = np.random.default_rng(1)
    i = rs.normal(size=(300, 3)).astype(np.float32)
    n = rs.normal(size=(300, 3)).astype(np.float32)
    i /= np.linalg.norm(i, axis=-1, keepdims=True)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ior = rs.uniform(1.1, 2.4, size=300).astype(np.float32)
    r_w, ok_w = npy(jvm.refract(jnp.asarray(i), jnp.asarray(n), jnp.asarray(ior)))
    r_g, ok_g = tvm.refract(torch.as_tensor(i), torch.as_tensor(n), torch.as_tensor(ior))
    np.testing.assert_array_equal(ok_g.numpy(), ok_w)
    assert 0 < ok_w.mean() < 1  # total internal reflection on some lanes
    np.testing.assert_allclose(r_g.numpy(), r_w, rtol=0, atol=1e-6)


def jax_route(scene, mode, ao_only, refraction):
    """make_progressive_step's choice in the JAX package (the realtime
    pipeline has no refraction)."""
    if not refraction and jfs.supports_fused(scene, mode, ao_only):
        return "fused"
    if not refraction and jft.supports_fused_traverse(scene, mode, ao_only):
        return "fused_traverse"
    return "wavefront"


TEX_ROUTES = {"cornell_latlong": "fused", "cornell_cube_bvh": "fused_traverse",
              "instanced:2_latlong": "fused_traverse", "instanced:2_latlong_two_level": "wavefront",
              "cornell_rig_latlong": "wavefront"}


@pytest.mark.parametrize("case", ["instanced:1", "cornell", "cornell_ao", "cornell-glass",
                                  "cornell_rig", "soup_2area", *TEX_ROUTES])
def test_select_route_matches_jax(case):
    ao, refraction = case == "cornell_ao", case == "cornell-glass"
    rs = np.random.default_rng(2)
    latlong = envmap.latlong_env(rs.uniform(0, 2, (4, 8, 3)).astype(np.float32))
    if case in ("instanced:1", "cornell-glass"):
        jscene = j_build_scene(case)[0].build()
    elif case == "soup_2area":
        jscene = j_build_scene("soup:300")[0]
        jscene.lights = RIGS["2area"]
        jscene = jscene.build(accel="bvh")
    elif case.startswith("instanced:2"):  # 3,842 triangles, a tex_autoroute BVH
        sc = j_build_scene("instanced:2")[0]
        sc.environment = latlong
        jscene = sc.build_two_level() if case.endswith("two_level") else sc.build()
    elif case in TEX_ROUTES:
        sc = j_build_scene("cornell-glossy")[0]
        if case == "cornell_rig_latlong":  # two of a kind: neither gate, no routing BVH
            sc.lights = RIGS["2dir_2point"]
        sc.environment = (envmap.cubemap_env(rs.uniform(0, 2, (6, 2, 2, 3)).astype(np.float32))
                          if "cube" in case else latlong)
        jscene = sc.build(accel="bvh" if case.endswith("bvh") else "auto")
    else:
        jscene = cornell(RIGS["2dir_2point"] if case == "cornell_rig" else None)
    tscene = scene_from_numpy(npy(jscene), "cpu")
    if case in ("cornell_latlong", "instanced:2_latlong"):
        assert "tex_autoroute" in jscene["bvh"] and "tex_autoroute" in tscene["bvh"]
    for mode in ("progressive", "realtime"):
        refr = refraction and mode == "progressive"
        assert select_route(tscene, mode, ao, refr) == jax_route(jscene, mode, ao, refr)
    want = {"cornell": "fused", **TEX_ROUTES}.get(case, "wavefront")
    assert select_route(tscene, "progressive", ao, refraction) == want


def test_bvh_scene_with_one_area_light_raises():
    """A BVH scene whose rig holds one area light takes B5's area mode in
    both packages (it raised before that mode was ported); its plain
    version matches the JAX jnp route on the image gate."""
    sc = j_build_scene("soup:300")[0]
    sc.lights = RIGS["1dir_1area"]
    jscene = sc.build(accel="bvh")
    tscene = scene_from_numpy(npy(jscene), "cpu")
    for mode in ("progressive", "realtime"):
        assert jft.supports_fused_traverse(jscene, mode, False)  # JAX: B5's area mode
        assert select_route(tscene, mode) == jax_route(jscene, mode, False, False)
        assert select_route(tscene, mode) == "fused_traverse"
    assert select_route(tscene, "progressive", ao_only=True) == "wavefront"
    cam = j_build_scene("soup:300")[1]
    cam.set_aspect(16, 16)
    jcam = camera_params(cam, jitter=(0.01, -0.02), frame_count=6)
    jopts = default_options(debug=2)
    want = render_sample(jscene, jopts, jcam, 16, 16, impl="jnp", env_kind=1)["color"]
    got = tft.fused_traverse_progressive_sum(
        tscene, options_from_numpy(npy(jopts)),
        {k: v[None] for k, v in camera_from_numpy(npy(jcam)).items()}, 16, 16, 1)
    image_gate(got.numpy(), want)


def test_pipeline_ao_and_refraction_steps():
    sc, cam = thead.build_scene("cornell-glass")
    cam.set_aspect(16, 16)
    pipe = ProgressiveRaytracingPipeline(16, 16, seed=0, samples_per_frame=2, device="cpu")
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    images = {}
    for ao, refraction in ((False, False), (True, False), (False, True)):
        pipe.ao_only, pipe.refraction = ao, refraction
        pipe.mark_dirty()
        pipe.rng = np.random.default_rng(0)
        pipe.update(0.0, 0)
        images[ao, refraction] = pipe.render().clone()
        assert pipe._step_key[3:5] == (ao, refraction)
        cams = pipe._camera_params
        want = tint.progressive_sample_sum(pipe.scene_data, pipe.options, cams, 16, 16,
                                           int(pipe.scene_data["env"]["kind"]), ao_only=ao,
                                           refraction=refraction) / 2
        torch.testing.assert_close(images[ao, refraction], want, rtol=0, atol=1e-6)
    assert not torch.equal(images[False, False], images[True, False])
    assert not torch.equal(images[False, False], images[False, True])


@pytest.mark.parametrize("args", [["--scene", "instanced:1"], ["--ao-only"],
                                  ["--scene", "cornell-glass", "--refraction"]],
                         ids=["instanced1", "ao_only", "refraction"])
def test_cli_brute_wavefront(tmp_path, capsys, args):
    before = launch_counts()
    out = tmp_path / "b.png"
    assert thead.main([*args, "--size", "16x16", "--spp", "2", "--device", "cpu",
                       "-o", str(out)]) == 0
    assert out.exists() and "progressive (cpu): 2 spp" in capsys.readouterr().out
    assert launch_counts() == before
    if "--ao-only" in args:
        # realtime has no AO view: it renders the beauty frame and says it
        # ignored the flag, as the JAX CLI renders it
        rt = ["--pipeline", "realtime", "--size", "16x16", "--device", "cpu"]
        flagged, plain = tmp_path / "flagged.npy", tmp_path / "plain.npy"
        assert thead.main([*args, *rt, "-o", str(flagged)]) == 0
        assert "realtime: ignoring --ao-only" in capsys.readouterr().out
        assert thead.main([*rt, "-o", str(plain)]) == 0
        assert np.array_equal(np.load(flagged), np.load(plain))


def test_wrapper_windows():
    _, tscene = scene_pair("cornell")
    o, d, _ = rays("cornell", seed=6)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    a = tik.trace_closest(tscene, o, d, 1e-4, 2.0)
    b = tik.trace_closest(tscene, o, d, torch.tensor(1e-4), torch.full((N_RAYS,), 2.0))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    with pytest.raises(ValueError):
        tik._window(torch.ones(3), N_RAYS, o.device)
    assert tik._window(2.5, N_RAYS, o.device) == (None, 2.5)
    assert tik._window(torch.tensor(2.5), N_RAYS, o.device) == (None, 2.5)
