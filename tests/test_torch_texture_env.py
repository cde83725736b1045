"""Texture envs (lat-long and cubemap) through the port vs the JAX package,
on the CPU.

B1's and B5's plain versions (loops over the wavefront integrator, which
samples the texture env in torch) are held against the JAX kernels in
interpret mode, whose texture envs run env-deferred (the kernel writes the
bounce directions and env weights, XLA gathers resolve the env outside):
the Cornell box with a seeded lat-long or cubemap env (tests/
test_fused_sample.py's and test_fused_traverse.py's scenes) at 32^2,
progressive with S = 2 samples per launch and realtime on every AOV. Gate
(tests/test_torch_fused_sample.py): at most 0.5% of pixels differ by more
than 1e-3 and the median |difference| is below 1e-5 (per-sample sums;
roughness as a one-channel image). The wavefront routes (brute force, BVH,
two-level) with a lat-long env are held against JAX jnp on the image gate
of benchmarks/kernel_parity.py (1%, 1e-5); the scene build's
``tex_autoroute`` BVH is bit-equal to JAX's.

The CUDA kernels' in-kernel lookup is held against these plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.app import headless as thead
from dxrexperiments_torch.models.base import select_route
from dxrexperiments_torch.models.progressive import make_progressive_step
from dxrexperiments_torch.ops import fused_sample as tfs
from dxrexperiments_torch.ops import fused_traverse as tft
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene import envmap as tenvmap
from dxrexperiments_torch.scene.convert import (
    camera_from_numpy,
    options_from_numpy,
    scene_from_numpy,
)
from dxrexperiments_torch.trace import integrator as tint
from dxrexperiments_tpu.app.headless import build_scene as j_build_scene
from dxrexperiments_tpu.core.camera import Camera, camera_params
from dxrexperiments_tpu.models.progressive import make_progressive_step as j_make_step
from dxrexperiments_tpu.ops import fused_sample_pallas as jfs
from dxrexperiments_tpu.ops import fused_traverse_pallas as jft
from dxrexperiments_tpu.scene import Scene, cornell_box, envmap
from dxrexperiments_tpu.scene.lights import directional_light, point_light
from dxrexperiments_tpu.trace import default_options, render_sample

W = H = 32
S = 2
AOVS = ("color", "direct", "indirect_specular", "albedo", "roughness")
RIG = {"dir": directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
       "point": point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0))}
TWO_OF_A_KIND = {"dir": [RIG["dir"], directional_light((0.5, -0.7, 0.2), (0.3, 0.5, 0.9, 0.4))],
                 "point": [RIG["point"], point_light((-0.6, 1.2, 0.5), (0.4, 0.9, 0.5, 3.0))]}


def npy(tree):
    return jax.tree.map(np.asarray, tree)


def tex_env(module, kind, size=(8, 16)):
    """The JAX tests' seeded texture env (values in [0, 2), strength 1.3),
    built by ``module`` (either package's envmap) from the same numpy."""
    rs = np.random.default_rng(3)
    if kind == "latlong":
        return module.latlong_env(rs.uniform(0, 2, (*size, 3)).astype(np.float32), strength=1.3)
    return module.cubemap_env(rs.uniform(0, 2, (6, size[0], size[0], 3)).astype(np.float32),
                              strength=1.3)


def jax_cornell(kind, accel="auto", lights=RIG):
    mesh, materials = cornell_box(glossy_tall_box=True)
    sc = Scene()
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh)
    sc.lights = lights
    sc.environment = tex_env(envmap, kind)
    return sc.build(accel=accel)


def jax_cameras(frames=(5, 6)):
    """Cameras that see the box and, past its open side, the env."""
    cam = Camera()
    cam.set_eye_at_up((1.2, 1.5, 3.6), (0.1, 1.3, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(W, H)
    jit = [(0.002, -0.001), (-0.15 / W, 0.35 / H)]
    cams = [camera_params(cam, jitter=jit[i % 2], frame_count=f) for i, f in enumerate(frames)]
    return jax.tree.map(lambda *x: jnp.stack(x), *cams)


def both_sides(jscene, opts=None, frames=(5, 6)):
    jopts = default_options(**(opts or {}))
    jcams = jax_cameras(frames)
    port = (scene_from_numpy(npy(jscene), "cpu"), options_from_numpy(npy(jopts)),
            camera_from_numpy(npy(jcams)))
    return (jscene, jopts, jcams), port


def assert_images_match(got, want, frac=0.005, median=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    if got.ndim == 2:  # roughness: a one-channel image
        got, want = got[..., None], want[..., None]
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    bad = (diff > 1e-3).any(axis=-1).mean()
    assert bad <= frac, f"{bad:.4%} pixels differ by more than 1e-3"
    assert float(np.median(diff)) <= median


@pytest.mark.parametrize("kind,opts", [("latlong", {}), ("cubemap", {}), ("latlong", {"debug": 2})],
                         ids=["latlong", "cubemap", "latlong-debug2"])
def test_b1_progressive_matches_pallas_interpret(kind, opts):
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(jax_cornell(kind), opts)
    assert "tex_autoroute" in tscene["bvh"] and select_route(tscene, "progressive") == "fused"
    ek = int(jscene["env"]["kind"])
    want = jfs.fused_progressive_sum(jscene, jopts, jcams, W, H, ek, interpret=True)
    before = launch_counts()["B1"]
    got = tfs.fused_progressive_sum(tscene, topts, tcams, W, H, ek)
    assert launch_counts()["B1"] == before  # the CPU path launches no kernel
    assert_images_match(got.numpy() / S, np.asarray(want) / S)


@pytest.mark.parametrize("kind", ["latlong", "cubemap"])
def test_b1_realtime_matches_pallas_interpret(kind):
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(jax_cornell(kind), frames=(5,))
    ek = int(jscene["env"]["kind"])
    assert select_route(tscene, "realtime") == "fused"
    want = jfs.fused_realtime_outputs(jscene, jopts, jax.tree.map(lambda x: x[0], jcams), W, H, ek,
                                      interpret=True)
    got = tfs.fused_realtime_outputs(tscene, topts, {k: v[0] for k, v in tcams.items()}, W, H, ek)
    for k in AOVS:
        assert_images_match(got[k].numpy(), want[k])
    # the primary misses route the env into the direct AOV
    miss = got["albedo"].abs().sum(-1) == 0
    assert 0.02 < float(miss.float().mean()) < 0.5
    assert float(got["direct"][miss].mean()) > 0.1


@pytest.mark.parametrize("kind", ["latlong", "cubemap"])
def test_b5_progressive_matches_pallas_interpret(kind):
    jscene = jax_cornell(kind, accel="bvh")  # a BVH of its own: B5's scene
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(jscene)
    assert "tex_autoroute" not in tscene["bvh"]
    assert select_route(tscene, "progressive") == "fused_traverse"
    ek = int(jscene["env"]["kind"])
    want = jft.fused_traverse_progressive_sum(jscene, jopts, jcams, W, H, ek, interpret=True)
    before = launch_counts()["B5"]
    got = tft.fused_traverse_progressive_sum(tscene, topts, tcams, W, H, ek)
    assert launch_counts()["B5"] == before
    assert_images_match(got.numpy() / S, np.asarray(want) / S)


@pytest.mark.parametrize("kind", ["latlong", "cubemap"])
def test_b5_realtime_matches_pallas_interpret(kind):
    jscene = jax_cornell(kind, accel="bvh")
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(jscene, frames=(5,))
    ek = int(jscene["env"]["kind"])
    want = jft.fused_traverse_realtime_outputs(jscene, jopts, jax.tree.map(lambda x: x[0], jcams),
                                               W, H, ek, interpret=True)
    got = tft.fused_traverse_realtime_outputs(tscene, topts, {k: v[0] for k, v in tcams.items()},
                                              W, H, ek)
    for k in AOVS:
        assert_images_match(got[k].numpy(), want[k])


def wavefront_scene(route):
    if route == "brute":  # two lights of a kind: no routing BVH, brute force (B3)
        return jax_cornell("latlong", lights=TWO_OF_A_KIND)
    sc, _ = j_build_scene("instanced:2")
    sc.environment = tex_env(envmap, "latlong")
    return sc.build(accel="bvh") if route == "bvh" else sc.build_two_level()


@pytest.mark.parametrize("mode", ["progressive", "realtime"])
@pytest.mark.parametrize("route", ["brute", "bvh", "two_level"])
def test_wavefront_routes_match_jnp(route, mode):
    """The integrator with a lat-long env (kernels B3, B4a, B6a on the card)."""
    jscene = wavefront_scene(route)
    sc_cam = j_build_scene("cornell-glossy" if route == "brute" else "instanced:2")[1]
    sc_cam.set_aspect(W, H)
    jcam = camera_params(sc_cam, jitter=(0.3 / W, -0.2 / H), frame_count=9)
    kw = {"mode": mode, "jitter_scale": 10.0 if mode == "realtime" else 30.0, "env_kind": 2}
    jopts = default_options()
    want = npy(render_sample(jscene, jopts, jcam, W, H, impl="jnp", **kw))
    tscene = scene_from_numpy(npy(jscene), "cpu")
    got = tint.render_sample(tscene, options_from_numpy(npy(jopts)), camera_from_numpy(npy(jcam)),
                             W, H, impl="torch", **kw)
    for k in (AOVS if mode == "realtime" else ("color",)):
        assert_images_match(got[k].numpy(), want[k], frac=0.01)
    if route != "brute":
        assert select_route(tscene, mode) == ("wavefront" if route == "two_level"
                                              else "fused_traverse")


@pytest.mark.parametrize("case", ["cornell-glossy", "cornell-glossy_none", "instanced:2",
                                  "soup:5000", "cornell_rig", "two_level"])
def test_build_tex_autoroute_matches_jax(case):
    """Scene.build's routing BVH for a texture env: where it is attached and
    tagged, its arrays and the env's textures bit-equal to JAX's."""
    name = case.split("_")[0] if case != "two_level" else "instanced:2"
    jsc, _ = j_build_scene(name)
    tsc, _ = thead.build_scene(name)
    kind = "cubemap" if case == "instanced:2" else "latlong"
    jsc.environment, tsc.environment = tex_env(envmap, kind), tex_env(tenvmap, kind)
    if case == "cornell_rig":
        jsc.lights = TWO_OF_A_KIND
        tsc.lights = scene_from_numpy(npy(jax_cornell("latlong", lights=TWO_OF_A_KIND)), "cpu")["lights"]
    if case == "two_level":
        jd, td = jsc.build_two_level(), tsc.build_two_level("cpu")
    else:
        accel = "none" if case.endswith("_none") else "auto"
        jd, td = jsc.build(accel=accel), tsc.build("cpu", accel=accel)
    assert ("bvh" in td) == ("bvh" in jd)
    if "bvh" in jd:
        assert ("tex_autoroute" in td["bvh"]) == ("tex_autoroute" in jd["bvh"])
        for k in ("bvhf_nodes", "mt_rows"):
            np.testing.assert_array_equal(td["bvh"][k].numpy(), np.asarray(jd["bvh"][k]), err_msg=k)
    want_tag = case in ("cornell-glossy", "instanced:2")
    assert ("bvh" in td and "tex_autoroute" in td["bvh"]) == want_tag
    k = tenvmap.TEXTURE_KEY[td["env"]["kind"]]
    np.testing.assert_array_equal(td["env"][k].numpy(), np.asarray(jd["env"][k]), err_msg=k)
    ported = scene_from_numpy(npy(jd), "cpu")
    assert ported["env"]["kind"] == td["env"]["kind"]
    assert set(ported["env"]) == set(td["env"])
    for mode in ("progressive", "realtime"):
        assert select_route(ported, mode) == select_route(td, mode)


def test_progressive_step_matches_jax():
    jscene = jax_cornell("latlong")
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(jscene)
    jcams = dict(jcams, accum_count=jnp.zeros((S,), jnp.float32))
    tcams = dict(tcams, accum_count=torch.zeros(S))
    accum = np.full((H, W, 3), 0.5, np.float32)
    jstep = j_make_step(jscene, W, H, samples_per_step=S, impl="jnp")
    want = jstep(jnp.asarray(accum), jopts, jcams, jscene["lights"], jscene["env"],
                 jnp.asarray(1024, jnp.int32))
    step = make_progressive_step(tscene, W, H, samples_per_step=S)
    got = step(torch.as_tensor(accum), topts, tcams, tscene["lights"], tscene["env"], 1024)
    assert_images_match(got.numpy(), np.asarray(want), frac=0.01)
    # a new texture of the same kind rides the same step
    other = dict(tscene["env"], latlong=tscene["env"]["latlong"] * 0.0)
    dark = step(torch.as_tensor(accum), topts, tcams, tscene["lights"], other, 1024)
    assert float(dark.sum()) < float(got.sum())
