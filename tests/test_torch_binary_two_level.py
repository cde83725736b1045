"""Port the binary two-level walk (kernel B6b) and the wavefront route over
BVH and TLAS packs without fat nodes vs the JAX package.

- ``binary_walk2_numpy``, the host model of the CUDA walk, against the JAX
  kernel ``traverse2_closest``/``traverse2_any`` in interpret mode on 512
  probe rays of tests/test_tlas.py's 5-instance scene and of 'instanced:2'
  two-level: the hit flag equal, t within rtol 2e-4, the leaf slot and the
  instance slot equal on at least 99% of hits, occlusion equal (a seventh of
  the shadow rays at zero direction, never occluded).
- The routes: a JAX BVH pytree without ``bvhf_nodes`` and a JAX two-level
  pytree without ``tlasf_nodes``, carried across by ``scene_from_numpy``,
  render one 32^2 progressive sample and one realtime frame through the
  port's integrator (plain traces on the CPU) against JAX
  ``render_sample(impl="jnp")`` of the same fat-less pytree on the image
  gate of benchmarks/kernel_parity.py (at most 1% of pixels off by more
  than 1e-3, median |difference| <= 1e-5, every realtime AOV). Both
  pipelines' gates send such scenes to the wavefront route, whose CUDA
  traces are the binary walks (B4b, B6b), and a TLAS refit keeps a TLAS
  without fat nodes so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.models.base import select_route
from dxrexperiments_torch.models.progressive import ProgressiveRaytracingPipeline
from dxrexperiments_torch.models.realtime import RealtimeRaytracingPipeline
from dxrexperiments_torch.ops import traverse as ttv
from dxrexperiments_torch.ops import traverse2 as tt2
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene.convert import camera_from_numpy, options_from_numpy, scene_from_numpy
from dxrexperiments_torch.trace import integrator as tint
from dxrexperiments_tpu.app.headless import build_scene as j_build_scene
from dxrexperiments_tpu.core.camera import Camera, camera_params
from dxrexperiments_tpu.ops import traverse2_pallas as jt2
from dxrexperiments_tpu.trace import default_options, render_sample
from test_torch_cuda import chain_two_level, tf
from test_torch_tlas import both, rays_for
from test_torch_two_level import AOVS, SIZE, image_gate

KINDS = ("five", "instanced:2")
FAT_BVH = ("bvhf_nodes", "bvhf_rows")
FAT_TLAS = ("tlasf_nodes", "tlasf_rows")


def drop(tree: dict, keys) -> dict:
    return {k: v for k, v in tree.items() if k not in keys}


@pytest.mark.parametrize("kind", KINDS)
def test_binary_walk2_matches_pallas(kind):
    jd, td = both(kind)
    tl_np = {k: v.numpy() for k, v in td["tlas"].items()}
    o, d = rays_for(kind, 5)
    want = jt2.traverse2_closest(jd["tlas"], jnp.asarray(o), jnp.asarray(d), 1e-4, 3.0e37,
                                 leaf_size=32, interpret=True)
    got, counts = tt2.binary_walk2_numpy(tl_np, o, d, 1e-4, 3.0e37)
    hit = np.asarray(want["hit"])
    np.testing.assert_array_equal(got["hit"], hit)
    assert 0.1 < hit.mean() < 0.95
    np.testing.assert_allclose(got["t"][hit], np.asarray(want["t"])[hit], rtol=2e-4)
    assert (got["slot"][hit] == np.asarray(want["slot"])[hit]).mean() >= 0.99
    assert (got["inst"][hit] == np.asarray(want["inst"])[hit]).mean() >= 0.99
    n_inst = td["tlas_meta"]["num_instances"]
    assert 0 < counts["instance_entries"] < 512 * n_inst  # the TLAS prunes
    assert counts["slab_tests"] == counts["tlas_visits"] + counts["blas_visits"]
    fat = tt2.fat_walk2_numpy(tl_np, o, d, 1e-4, 3.0e37)[1]
    assert counts["blas_visits"] > fat["blas_visits"]  # no near-first order, no child boxes
    # the wrapper on CPU rays: the plain version, no launch
    before = launch_counts()
    plain = tt2.traverse2_closest(td, torch.as_tensor(o), torch.as_tensor(d), 1e-4, 3.0e37)
    assert launch_counts() == before
    np.testing.assert_array_equal(plain["hit"].numpy(), hit)


@pytest.mark.parametrize("kind", KINDS)
def test_binary_walk2_any_matches_pallas(kind):
    jd, td = both(kind)
    tl_np = {k: v.numpy() for k, v in td["tlas"].items()}
    o, d = rays_for(kind, 4)
    tmax = np.where(np.arange(512) % 2 == 0, 3.0e37, 7.5).astype(np.float32)
    d[::7] = 0.0  # dead lanes: zero directions are never occluded
    want = np.asarray(jt2.traverse2_any(jd["tlas"], jnp.asarray(o), jnp.asarray(d), 1e-4,
                                        jnp.asarray(tmax), leaf_size=32, interpret=True))
    got, counts = tt2.binary_walk2_numpy(tl_np, o, d, 1e-4, tmax, occlusion=True)
    np.testing.assert_array_equal(got["occluded"], want)
    assert 0.05 < want.mean() < 0.95 and not got["occluded"][::7].any()
    plain = tt2.traverse2_any(td, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                              torch.as_tensor(tmax)).numpy()
    np.testing.assert_array_equal(plain, want)


def test_binary_walk2_stack():
    o = np.zeros((2, 3), np.float32)
    d = np.array([[0.0, 0.0, 1.0]] * 2, np.float32)

    def tl_np(levels, right_deep):
        return {k: v.numpy() for k, v in chain_two_level(levels, "cpu", right_deep)["tlas"].items()}

    with pytest.raises(RuntimeError, match="stack overflowed"):
        tt2.binary_walk2_numpy(tl_np(120, True), o, d, 0.0, 1e38)
    for levels, right_deep in ((40, True), (120, False)):
        got, _ = tt2.binary_walk2_numpy(tl_np(levels, right_deep), o, d, 0.0, 1e38)
        assert got["hit"].all() and np.allclose(got["t"], 5.0) and (got["inst"] == 0).all()


def fatless_sides(accel: str, opts: dict):
    """(JAX pytree, options, camera) and the port's conversion of them, for
    'instanced:2' built with a BVH without fat nodes or two-level without a
    fat TLAS."""
    sc = j_build_scene("instanced:2")[0]
    if accel == "bvh":
        jd = sc.build(accel="bvh")
        jd = dict(jd, bvh=drop(jd["bvh"], FAT_BVH))
    else:
        jd = sc.build_two_level()
        jd = dict(jd, tlas=drop(jd["tlas"], FAT_TLAS))
    cam = Camera()
    cam.set_eye_at_up((5.0, 3.0, 5.0), (0.0, 0.3, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(SIZE, SIZE)
    jcam = camera_params(cam, jitter=(0.3 / SIZE, -0.2 / SIZE), frame_count=3)
    jopts = default_options(**opts)
    npy = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    port = (scene_from_numpy(npy(jd), "cpu"), options_from_numpy(npy(jopts)),
            camera_from_numpy(npy(jcam)))
    return (jd, jopts, jcam), port


@pytest.mark.parametrize("accel,opts", [("bvh", {}), ("bvh", {"debug": 2}), ("two-level", {})])
def test_fatless_progressive_matches_jnp(accel, opts):
    (jd, jopts, jcam), (td, topts, tcam) = fatless_sides(accel, opts)
    if accel == "bvh":
        assert "bvhf_nodes" not in td["bvh"] and "bvh8_rows" in td["bvh"]
        assert tint.walk_functions(td, "cuda") == (ttv.traverse_closest, ttv.traverse_any)
    else:
        assert "tlasf_rows" not in td["tlas"] and "tlas_rows" in td["tlas"]
        assert tint.walk_functions(td, "cuda") == (tt2.traverse2_closest, tt2.traverse2_any)
    for mode in ("progressive", "realtime"):
        assert select_route(td, mode) == "wavefront"
    ek = int(jd["env"]["kind"])
    want = render_sample(jd, jopts, jcam, SIZE, SIZE, mode="progressive", impl="jnp",
                         env_kind=ek)["color"]
    got = tint.render_sample(td, topts, tcam, SIZE, SIZE, mode="progressive", impl="torch",
                             env_kind=ek)["color"]
    image_gate(got.numpy(), want)
    assert float(got.mean()) > 0.0


@pytest.mark.parametrize("accel", ["bvh", "two-level"])
def test_fatless_realtime_matches_jnp(accel):
    (jd, jopts, jcam), (td, topts, tcam) = fatless_sides(accel, {})
    ek = int(jd["env"]["kind"])
    want = render_sample(jd, jopts, jcam, SIZE, SIZE, mode="realtime", jitter_scale=10.0,
                         impl="jnp", env_kind=ek)
    got = tint.render_sample(td, topts, tcam, SIZE, SIZE, mode="realtime", jitter_scale=10.0,
                             impl="torch", env_kind=ek)
    for k in AOVS:
        image_gate(got[k].numpy(), want[k])


def test_fatless_pipelines_and_refit():
    """Both pipelines take the wavefront route on fat-less scenes, and a
    TLAS refit replaces the binary TLAS rows without adding fat ones."""
    from dxrexperiments_torch.app.headless import build_scene

    sc, cam = build_scene("instanced:2")
    cam.set_aspect(16, 16)
    flat = sc.build("cpu", accel="bvh")
    flat = dict(flat, bvh=drop(flat["bvh"], FAT_BVH))
    two = sc.build_two_level("cpu")
    two = dict(two, tlas=drop(two["tlas"], FAT_TLAS))
    for scene in (flat, two):
        pipe = ProgressiveRaytracingPipeline(16, 16, seed=0, samples_per_frame=2, device="cpu")
        pipe.set_camera(cam)
        pipe.set_scene_data(scene)
        pipe.update(0.0, 0)
        img = pipe.render()
        assert bool(img.isfinite().all()) and float(img.mean()) > 0.0
        rt = RealtimeRaytracingPipeline(16, 16, seed=0, device="cpu")
        rt.set_camera(cam)
        rt.set_scene_data(scene)
        rt.update(0.0, 0)
        direct, spec = rt.render()
        assert bool((direct + spec).isfinite().all()) and float(direct.mean()) > 0.0
    base = np.stack([inst.transform for inst in sc.instances])
    pipe.set_instance_transforms(np.einsum("ij,njk->nik", tf(yaw=0.3), base))
    tl = pipe.scene_data["tlas"]
    assert not set(FAT_TLAS) & set(tl)
    assert not torch.equal(tl["tlas_rows"], two["tlas"]["tlas_rows"])
    torch.testing.assert_close(tl["tlas_rows"], tl["tlas_nodes"].T, rtol=0, atol=0)
    assert tl["blas_rows"] is two["tlas"]["blas_rows"]
