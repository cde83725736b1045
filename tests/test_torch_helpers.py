"""The port's small public helpers against the JAX package's, on the CPU:
vecmath's affine transforms, utils.image's mse and psnr, the stacked light
groups, and the host BVH walks with their slab test. Inputs are made from
seeds with numpy; the tolerance is 1e-6 (the walks: the same hit triangle
and t)."""

import numpy as np
import pytest
import torch

from dxrexperiments_torch.accel import bvh as tbvh
from dxrexperiments_torch.core import vecmath as tvm
from dxrexperiments_torch.scene import lights as tlights
from dxrexperiments_torch.utils import image as timage
from dxrexperiments_tpu.accel import bvh as jbvh
from dxrexperiments_tpu.core import vecmath as jvm
from dxrexperiments_tpu.scene import lights as jlights
from dxrexperiments_tpu.utils import image as jimage


def affine(seed, rows):
    rng = np.random.default_rng(seed)
    m = np.eye(4, dtype=np.float32)[:rows]
    m[:3, :3] = rng.normal(size=(3, 3)).astype(np.float32) + 2.0 * np.eye(3, dtype=np.float32)
    m[:3, 3] = rng.normal(size=3).astype(np.float32)
    return m, rng.normal(size=(5, 7, 3)).astype(np.float32)


@pytest.mark.parametrize("rows", [3, 4])
@pytest.mark.parametrize("name", ["transform_points", "transform_vectors", "transform_normals"])
def test_transforms_match_jax(name, rows):
    m, x = affine(rows, rows)
    got = getattr(tvm, name)(torch.from_numpy(m), torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jvm, name)(m, x))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mse_psnr_match_jax():
    rng = np.random.default_rng(3)
    a = rng.random((9, 11, 3)).astype(np.float32)
    b = a + rng.normal(scale=0.01, size=a.shape).astype(np.float32)
    assert timage.mse(a, b) == jimage.mse(a, b)
    for peak in (1.0, 4.0):
        assert timage.psnr(a, b, peak) == pytest.approx(jimage.psnr(a, b, peak), rel=1e-6)
    assert timage.psnr(a, a) == jimage.psnr(a, a) == float("inf")


@pytest.mark.parametrize("count", [0, 1, 3])
def test_light_groups_match_jax(count):
    rng = np.random.default_rng(count)
    dirs = [(rng.normal(size=3), tuple(rng.random(4))) for _ in range(count)]
    points = [(rng.normal(size=3), tuple(rng.random(4))) for _ in range(count)]
    got = (tlights.dir_lights([tlights.directional_light(*a) for a in dirs]),
           tlights.point_lights([tlights.point_light(*a) for a in points]))
    want = (jlights.dir_lights([jlights.directional_light(*a) for a in dirs]),
            jlights.point_lights([jlights.point_light(*a) for a in points]))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=1e-6, atol=1e-6)


def soup(seed, n):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return v0, e1, e2


def tri_test(v0, e1, e2):
    """Möller-Trumbore in float64: t or None."""
    def test(i, o, d):
        p = np.cross(d, e2[i])
        det = float(np.dot(e1[i], p))
        if abs(det) < 1e-12:
            return None
        s = o - v0[i]
        u = float(np.dot(s, p)) / det
        q = np.cross(s, e1[i])
        v = float(np.dot(d, q)) / det
        if u < 0.0 or v < 0.0 or u + v > 1.0:
            return None
        return float(np.dot(e2[i], q)) / det
    return test


def rays(seed, n):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3))
    d = rng.uniform(-4, 4, (n, 3)) - o
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("form", ["heap", "nodes"])
def test_host_walks_match_jax_and_brute_force(form):
    v0, e1, e2 = soup(5, 300)
    built = tbvh.build_bvh(v0, e1, e2, 300, leaf_size=4)
    jbuilt = jbvh.build_bvh(v0, e1, e2, 300, leaf_size=4)
    test = tri_test(v0, e1, e2)
    if form == "heap":
        walk, jwalk, tree, jtree = tbvh.traverse_numpy, jbvh.traverse_numpy, built, jbuilt
    else:
        walk, jwalk = tbvh.traverse_nodes_numpy, jbvh.traverse_nodes_numpy
        tree, jtree = tbvh.to_node_arrays(built), jbvh.to_node_arrays(jbuilt)
    o, d = rays(6, 64)
    hits = 0
    for k in range(len(o)):
        got = walk(tree, test, o[k], d[k], 0.0, 1e30)
        assert got == jwalk(jtree, test, o[k], d[k], 0.0, 1e30)
        ts = [(test(i, o[k], d[k]), i) for i in range(300)]
        best = min(((t, i) for t, i in ts if t is not None and t > 0.0), default=(np.inf, -1))
        assert got == best
        hits += got[1] >= 0
    assert hits > 8  # the rays aim into the soup


def test_ray_aabb_matches_jax():
    rng = np.random.default_rng(9)
    for _ in range(200):
        o = rng.uniform(-3, 3, 3)
        d = rng.normal(size=3)
        inv_d = 1.0 / np.where(np.abs(d) > 1e-12, d, 1e-12)
        lo = rng.uniform(-2, 1, 3)
        hi = lo + rng.uniform(0, 2, 3)
        t_min, t_max = 0.0, float(rng.uniform(0.5, 10))
        assert tbvh.ray_aabb(o, inv_d, lo, hi, t_min, t_max) == jbvh.ray_aabb(
            o, inv_d, lo, hi, t_min, t_max)
