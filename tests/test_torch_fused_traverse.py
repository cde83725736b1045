"""Port ops/fused_traverse.py (the fused-traversal megakernel's wrappers and
plain versions) vs the JAX package.

On the CPU the port's ``fused_traverse_progressive_sum`` and
``realtime_aovs`` take their plain versions (the wavefront integrator, whose
BVH traces are then the brute-force sweep); they are held against the JAX
kernel run in interpret mode on the Cornell box with accel='bvh' at 32^2 and
the 600-triangle soup at 16^2, with the tolerance of
tests/test_fused_traverse.py: at most 0.5% of pixels differ by more than
1e-3 (BVH-order tie-breaks on knife-edge pairs) and the median |difference|
is below 1e-5. Against the JAX jnp route, brute force on both sides, the
port's progressive step agrees to atol 2e-5.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.models.base import select_route
from dxrexperiments_torch.models.progressive import make_progressive_step
from dxrexperiments_torch.ops import fused_traverse as tft
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene import envmap as tenvmap
from dxrexperiments_torch.scene.convert import (
    camera_from_numpy,
    options_from_numpy,
    scene_from_numpy,
)
from dxrexperiments_tpu.core.camera import Camera, camera_params
from dxrexperiments_tpu.ops import fused_traverse_pallas as jft
from dxrexperiments_tpu.scene import Scene, cornell_box, envmap
from dxrexperiments_tpu.scene.lights import area_light, directional_light, point_light
from dxrexperiments_tpu.scene.materials import Material
from dxrexperiments_tpu.scene.procedural import random_triangle_soup
from dxrexperiments_tpu.trace import default_options, render_sample

SIZES = {"cornell": 32, "soup": 16}
RIG = {
    "dir": directional_light((0.2, -0.8, -0.5), (1.0, 1.0, 0.9, 0.8)),
    "point": point_light((0.5, 2.0, 0.5), (1.0, 0.9, 0.7, 5.0)),
}


def jax_scene(kind, lights=None):
    sc = Scene()
    if kind == "cornell":
        mesh, materials = cornell_box(glossy_tall_box=True)
        for m in materials:
            sc.add_material(m)
        sc.environment = envmap.constant_env((0.05, 0.1, 0.2), strength=1.5)
    else:
        mesh = random_triangle_soup(600, seed=11, extent=3.0)
        sc.add_material(Material.reference_default())
        sc.environment = envmap.gradient_env()
    sc.add_model(mesh)
    sc.lights = RIG if lights is None else lights
    return sc.build(accel="bvh")


def jax_cameras(size, frames, realtime=False):
    cam = Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(size, size)
    jit = [(0.3 / size, -0.2 / size), (-0.15 / size, 0.35 / size)]
    cams = [camera_params(cam, jitter=jit[i % 2], frame_count=f) for i, f in enumerate(frames)]
    return jax.tree.map(lambda *x: jnp.stack(x), *cams)


def both_sides(kind, opts, frames=(7,), lights=None):
    jscene = jax_scene(kind, lights)
    jopts = default_options(**opts)
    jcams = jax_cameras(SIZES[kind], frames)
    npy = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    port = (scene_from_numpy(npy(jscene), "cpu"), options_from_numpy(npy(jopts)),
            camera_from_numpy(npy(jcams)))
    return (jscene, jopts, jcams), port


def assert_images_match(got, want, frac=0.005, tol=1e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if diff.ndim == 3:
        bad = (diff > tol).any(axis=-1).mean()
    else:
        bad = (diff > tol).mean()
    assert bad <= frac, f"{bad:.4%} pixels differ by more than {tol}"
    assert float(np.median(diff)) < 1e-5


CASES = [
    ("cornell", {}),
    ("cornell", {"debug": 2}),
    ("cornell", {"no_indirect_diffuse": True}),
    ("cornell", {"show_fresnel_term": True}),
    ("soup", {}),
    ("soup", {"cosine_hemisphere_sampling": False}),
]


@pytest.mark.parametrize("kind,opts", CASES, ids=[f"{k}-{'-'.join(o) or 'defaults'}"
                                                  for k, o in CASES])
def test_progressive_matches_pallas_interpret(kind, opts):
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(kind, opts)
    size, ek = SIZES[kind], int(jscene["env"]["kind"])
    assert select_route(tscene, "progressive") == "fused_traverse"
    want = jft.fused_traverse_progressive_sum(jscene, jopts, jcams, size, size, ek,
                                              interpret=True)
    before = launch_counts()["B5"]
    got = tft.fused_traverse_progressive_sum(tscene, topts, tcams, size, size, ek)
    assert launch_counts()["B5"] == before  # the CPU path launches no kernel
    assert tuple(got.shape) == (size, size, 3) and got.dtype == torch.float32
    assert_images_match(got.numpy(), want)


@pytest.mark.parametrize("kind", ["cornell", "soup"])
def test_progressive_step_matches_jnp(kind):
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(kind, {"debug": 2})
    size, ek = SIZES[kind], int(jscene["env"]["kind"])
    want = render_sample(jscene, jopts, jax.tree.map(lambda x: x[0], jcams), size, size,
                         mode="progressive", impl="jnp", env_kind=ek)["color"]
    step = make_progressive_step(tscene, size, size, samples_per_step=1)
    accum = torch.zeros((size, size, 3))
    got = step(accum, topts, tcams, tscene["lights"], tscene["env"], 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("kind,opts", [("cornell", {}), ("cornell", {"debug": 2}), ("soup", {})])
def test_realtime_matches_pallas_interpret(kind, opts):
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(kind, opts)
    size, ek = SIZES[kind], int(jscene["env"]["kind"])
    want = jft.fused_traverse_realtime_outputs(jscene, jopts, jax.tree.map(lambda x: x[0], jcams),
                                               size, size, ek, interpret=True)
    got = tft.fused_traverse_realtime_outputs(tscene, topts, {k: v[0] for k, v in tcams.items()},
                                              size, size, ek)
    for k in ("direct", "indirect_specular", "albedo", "roughness", "color"):
        assert_images_match(got[k].numpy(), want[k])


def test_one_light_rig_matches_pallas_interpret():
    lights = {"dir": RIG["dir"]}
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides("cornell", {"debug": 2},
                                                                lights=lights)
    assert jft.supports_fused_traverse(jscene, "progressive", False)
    want = jft.fused_traverse_progressive_sum(jscene, jopts, jcams, 32, 32, 0, interpret=True)
    got = tft.fused_traverse_progressive_sum(tscene, topts, tcams, 32, 32, 0)
    assert_images_match(got.numpy(), want)
    cst, rig = tft._rig_consts(tscene, topts, 0)
    assert rig == 1 and tuple(cst.shape) == (3, 16)  # B1's two rows and the (empty) area pack
    assert not bool(cst[2].any())


def test_two_samples_sum_single_samples():
    _, (tscene, topts, tcams) = both_sides("soup", {}, frames=(3, 4))
    size = SIZES["soup"]
    both = tft.fused_traverse_progressive_sum(tscene, topts, tcams, size, size, 1)
    singles = [
        tft.fused_traverse_progressive_sum(tscene, topts, {k: v[s:s + 1] for k, v in tcams.items()},
                                           size, size, 1)
        for s in range(2)
    ]
    torch.testing.assert_close(both, singles[0] + singles[1], rtol=0, atol=0)
    rt = tft.realtime_aovs(tscene, topts, tcams, size, size, 1)
    assert tuple(rt["direct"].shape) == (2, size, size, 3)


def test_unported_modes_raise():
    _, (tscene, topts, tcams) = both_sides("soup", {})
    # texture envs run (ROADMAP item 9), on the plain path here
    faces = np.random.default_rng(0).uniform(0, 2, (6, 4, 4, 3)).astype(np.float32)
    cube = dict(tscene, env=tenvmap.cubemap_env(faces, strength=1.3))
    got = tft.fused_traverse_progressive_sum(cube, topts, tcams, 16, 16, 3)
    assert tuple(got.shape) == (16, 16, 3) and bool(got.isfinite().all())
    rt = tft.realtime_aovs(cube, topts, tcams, 16, 16, 3)
    assert tuple(rt["direct"].shape) == (1, 16, 16, 3)
    with pytest.raises(ValueError, match="texture leaf"):
        tft.fused_traverse_progressive_sum(tscene, topts, tcams, 16, 16, 2)
    # albedo textures run progressive only (a realtime frame is outside the
    # gate and raises; the pipelines send it to the wavefront route), with
    # the corner-UV lanes of mt_rows
    textured = dict(tscene, textures={})
    with pytest.raises(NotImplementedError, match="scope"):
        tft.realtime_aovs(textured, topts, tcams, 16, 16, 1)
    assert not tft.supports_fused_traverse(textured, "progressive", False)  # mt_attr_lanes 1
    assert tft.supports_fused_traverse(dict(textured, bvh=dict(tscene["bvh"], mt_attr_lanes=2)),
                                       "progressive", False)
    # an area light runs in both pipelines and matches JAX's area mode
    area_rig = {"dir": RIG["dir"], "area": [area_light((-0.5, 2.5, -0.5), (1.0, 0.0, 0.0),
                                                       (0.0, 0.0, 1.0), (1.0, 0.9, 0.8, 6.0))]}
    (jscene, jopts, jcams), (ascene, aopts, acams) = both_sides("soup", {}, lights=area_rig)
    for mode in ("progressive", "realtime"):
        assert tft.supports_fused_traverse(ascene, mode, False)
        assert jft.supports_fused_traverse(jscene, mode, False)
    want = jft.fused_traverse_progressive_sum(jscene, jopts, jcams, 16, 16, 1, interpret=True)
    got = tft.fused_traverse_progressive_sum(ascene, aopts, acams, 16, 16, 1)
    assert_images_match(got.numpy(), want)
    assert tft._rig_consts(ascene, aopts, 1)[1] == 1 | 4
    assert not tft.supports_fused_traverse(tscene, "progressive", True)  # ao_only
    brute = {k: v for k, v in tscene.items() if k != "bvh"}
    assert not tft.supports_fused_traverse(brute, "realtime", False)
