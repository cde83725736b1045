"""Port ops/traverse.py and the integrator's BVH route vs the JAX package.

On the CPU the port's ``traverse_fat_closest``/``traverse_fat_any`` take
their plain versions (the brute-force sweep over the same triangles); they
are held against the JAX fat-node kernel run in interpret mode, on the
600-triangle soup and the 'instanced:2' grid with accel='bvh', by the hit
gates of benchmarks/kernel_parity.py: on lanes that hit the same triangle
the relative t has median <= 1e-6, p99.9 <= 1e-4 and max <= 0.05; lanes
whose hit differs (knife-edge ties resolved in another order) <= 1%;
occlusion disagrees on <= 1% of rays. ``fat_walk_numpy``, the host model of
the CUDA walk, is held to the same gates, so the walk's order, pruning and
stack are checked here although the kernel runs only on the card.

``select_route`` is held against the JAX gates (``supports_fused``,
``supports_fused_traverse``) on Cornell, the soup with the 1 directional +
1 point rig, the soup with two point lights and ``ao_only``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.models.base import select_route
from dxrexperiments_torch.ops import traverse as ttv
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene.convert import scene_from_numpy
from dxrexperiments_torch.trace import integrator as tint
from dxrexperiments_tpu.app.headless import build_scene as j_build_scene
from dxrexperiments_tpu.ops import fused_sample_pallas as jfs
from dxrexperiments_tpu.ops import fused_traverse_pallas as jft
from dxrexperiments_tpu.ops import traverse_pallas as jtv
from dxrexperiments_tpu.scene import Scene, cornell_box, envmap
from dxrexperiments_tpu.scene.lights import directional_light, point_light
from dxrexperiments_tpu.scene.materials import Material
from dxrexperiments_tpu.scene.procedural import random_triangle_soup
from test_torch_cuda import chain_scene

R = 640


def soup_scene(lights="rig"):
    sc = Scene()
    sc.add_material(Material.reference_default())
    sc.add_model(random_triangle_soup(600, seed=11, extent=3.0))
    if lights == "rig":
        sc.lights = {
            "dir": directional_light((0.2, -0.8, -0.5), (1.0, 1.0, 0.9, 0.8)),
            "point": point_light((0.5, 2.0, 0.5), (1.0, 0.9, 0.7, 5.0)),
        }
    else:  # two point lights: outside both megakernels' rigs
        sc.lights = {"point": [point_light((0.5, 2.0, 0.5)), point_light((-1.0, 2.5, 0.0))]}
    sc.environment = envmap.gradient_env()
    return sc.build(accel="bvh")


def jax_scene(kind):
    if kind == "soup":
        return soup_scene()
    sc, _ = j_build_scene(kind)
    return sc.build(accel="bvh")


def port(jscene):
    return scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")


def rays(tscene, seed=3):
    """R rays from a sphere of radius 8 around the scene, three in four aimed
    at a triangle's centroid (so most hit), the rest at random."""
    rs = np.random.default_rng(seed)
    o = rs.normal(size=(R, 3))
    o = (8.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    n = tscene["num_tris"]
    centroid = (tscene["v0"] + (tscene["e1"] + tscene["e2"]) / 3.0).numpy()[:n]
    target = centroid[rs.integers(0, n, R)] + rs.normal(scale=0.002, size=(R, 3))
    target[::4] = rs.uniform(-3.0, 3.0, size=(len(target[::4]), 3))
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def hit_gate(hit, t, tri, w_hit, w_t, w_tri):
    hit, w_hit = np.asarray(hit), np.asarray(w_hit)
    same = (hit == w_hit) & (~hit | (np.asarray(tri) == np.asarray(w_tri)))
    both = same & hit
    rel = np.abs(np.asarray(t) - np.asarray(w_t)) / np.maximum(1.0, np.abs(np.asarray(w_t)))
    vals = rel[both]
    assert both.sum() > 50
    assert float(np.median(vals)) <= 1e-6
    assert float(np.quantile(vals, 0.999)) <= 1e-4
    assert float(vals.max()) <= 0.05
    assert float((~same).mean()) <= 0.01


@pytest.mark.parametrize("kind", ["soup", "instanced:2"])
@pytest.mark.parametrize("cull", [False, True])
def test_plain_matches_pallas_fat_closest(kind, cull):
    jscene = jax_scene(kind)
    tscene = port(jscene)
    o, d = rays(tscene)
    want = jtv.traverse_fat_closest(jscene["bvh"], jnp.asarray(o), jnp.asarray(d), t_min=1e-4,
                                    leaf_size=32, cull_backface=cull, interpret=True)
    before = launch_counts()["B4a closest"]
    got = ttv.traverse_fat_closest(tscene, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                                   cull_backface=cull)
    assert launch_counts()["B4a closest"] == before  # the CPU path launches no kernel
    hit_gate(got["hit"], got["t"], got["tri"], want["hit"], want["t"], want["tri"])
    same = np.asarray(got["hit"]) & (got["tri"].numpy() == np.asarray(want["tri"]))
    np.testing.assert_array_equal(got["slot"].numpy()[same], np.asarray(want["slot"])[same])
    # u: the plain version recomputes it by classic Möller–Trumbore, the
    # kernel divides the sign-folded terms; grazing hits differ by ~1e-4
    np.testing.assert_allclose(got["u"].numpy()[same], np.asarray(want["u"])[same], atol=1e-3)


@pytest.mark.parametrize("kind", ["soup", "instanced:2"])
def test_plain_matches_pallas_fat_any(kind):
    jscene = jax_scene(kind)
    tscene = port(jscene)
    o, d = rays(tscene, seed=4)
    tmax = np.where(np.arange(R) % 2 == 0, 3.0e37, 7.5).astype(np.float32)
    d[::7] = 0.0  # dead lanes: zero directions are never occluded
    want = np.asarray(jtv.traverse_fat_any(jscene["bvh"], jnp.asarray(o), jnp.asarray(d), 1e-4,
                                           jnp.asarray(tmax), leaf_size=32, interpret=True))
    got = ttv.traverse_fat_any(tscene, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                               torch.as_tensor(tmax)).numpy()
    assert 0.05 < want.mean() < 0.95
    assert not got[::7].any() and not want[::7].any()
    assert float((got != want).mean()) <= 0.01


@pytest.mark.parametrize("kind", ["soup", "instanced:2"])
def test_walk_model_matches_plain(kind):
    tscene = port(jax_scene(kind))
    o, d = rays(tscene, seed=5)
    want = ttv.traverse_fat_closest_reference(tscene, torch.as_tensor(o), torch.as_tensor(d))
    got, counts = ttv.fat_walk_numpy(tscene["bvh"], o, d, 1e-4, 3.0e37)
    tri = np.where(got["hit"], tscene["bvh"]["slot_tri"].numpy()[np.maximum(got["slot"], 0)], -1)
    hit_gate(got["hit"], got["t"], tri, want["hit"], want["t"], want["tri"])
    n_slots = int((tscene["bvh"]["slot_tri"] >= 0).sum())
    assert 0 < counts["pair_tests"] < R * n_slots  # the walk prunes
    assert counts["slab_tests"] == 2 * counts["visits"]
    occ, occ_counts = ttv.fat_walk_numpy(tscene["bvh"], o, d, 1e-4, 7.5, occlusion=True)
    want_occ = ttv.traverse_fat_any_reference(tscene, torch.as_tensor(o), torch.as_tensor(d),
                                              1e-4, 7.5).numpy()
    assert 0.05 < want_occ.mean() < 0.95
    assert float((occ["occluded"] != want_occ).mean()) <= 0.01
    assert occ_counts["pair_tests"] < counts["pair_tests"]


def test_walk_model_stack_overflow_raises():
    base, packed = chain_scene(levels=120)
    o = np.zeros((2, 3), np.float32)
    d = np.array([[0.0, 0.0, 1.0]] * 2, np.float32)
    with pytest.raises(RuntimeError, match="stack overflowed"):
        ttv.fat_walk_numpy(packed, o, d, 0.0, 1e38)
    _, shallow = chain_scene(levels=40)
    got, _ = ttv.fat_walk_numpy(shallow, o, d, 0.0, 1e38)
    assert got["hit"].all() and np.allclose(got["t"], 5.0)


def test_pack_rays_layout():
    o = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    d = -o
    tmax = torch.tensor([1.0, 2.0, 3.0, 4.0])
    rays = ttv.pack_rays(o, d, 0.5, tmax)
    assert rays.shape == (4, 8) and rays.is_contiguous()
    torch.testing.assert_close(rays[:, 0:3], o)
    torch.testing.assert_close(rays[:, 3:6], d)
    assert (rays[:, 6] == 0.5).all() and torch.equal(rays[:, 7], tmax)


def test_bvh_route_needs_fat_nodes():
    """B4a's walk needs the fat nodes; a BVH without them takes the binary
    walk (B4b), as the JAX integrator keys it (``"bvhf_nodes" in bvh``), and
    the route runs on the CPU through the same plain versions."""
    tscene = port(soup_scene())
    fatless = dict(tscene, bvh={k: v for k, v in tscene["bvh"].items()
                                if k not in ("bvhf_nodes", "bvhf_rows")})
    with pytest.raises(ValueError, match="bvhf_rows"):
        ttv.check_bvh(fatless["bvh"], torch.device("cpu"))
    assert len(ttv.check_bvh(fatless["bvh"], torch.device("cpu"), "binary")) == 2
    assert tint.walk_functions(tscene, "cuda") == (ttv.traverse_fat_closest, ttv.traverse_fat_any)
    assert tint.walk_functions(fatless, "cuda") == (ttv.traverse_closest, ttv.traverse_any)
    assert tint.walk_functions(fatless, "torch") == tint.walk_functions(tscene, "torch")
    o, d = (torch.as_tensor(x) for x in rays(tscene, seed=6))
    before = launch_counts()
    got = tint._trace_any(fatless, o, d, 1e-4, 7.5, impl="torch")
    assert torch.equal(got, tint._trace_any(tscene, o, d, 1e-4, 7.5, impl="torch"))
    # the binary wrappers on CPU rays take the plain version and launch nothing
    assert torch.equal(ttv.traverse_any(fatless, o, d, 1e-4, 7.5), got)
    assert launch_counts() == before


@pytest.mark.parametrize("case", ["cornell", "soup_rig", "soup_two_points", "ao_only"])
def test_select_route_matches_jax_gates(case):
    if case == "cornell":
        mesh, materials = cornell_box(glossy_tall_box=True)
        sc = Scene()
        for m in materials:
            sc.add_material(m)
        sc.add_model(mesh)
        sc.lights = {
            "dir": directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
            "point": point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
        }
        jscene = sc.build()
    else:
        jscene = soup_scene("two_points" if case == "soup_two_points" else "rig")
    ao = case == "ao_only"
    tscene = port(jscene)
    for mode in ("progressive", "realtime"):
        if jfs.supports_fused(jscene, mode, ao):
            want = "fused"
        elif jft.supports_fused_traverse(jscene, mode, ao):
            want = "fused_traverse"
        else:
            want = "wavefront"
        assert select_route(tscene, mode, ao) == want
    expected = {"cornell": "fused", "soup_rig": "fused_traverse",
                "soup_two_points": "wavefront", "ao_only": "wavefront"}[case]
    assert select_route(tscene, "progressive", ao) == expected
