"""Port the opt-in ray sorting of the wavefront integrator against the JAX
package's (tests/test_ray_sorting.py): ``_ray_sort_order`` equal to JAX's
permutation as integers on the same BVH and rays, and the sort helper
``_sorted_trace`` (gather, walk, scatter back) around the plain walk
bit-equal to the unsorted call, closest (every hit field) and any (per-ray
t_max). The kernels' sorted walks are held the same way on the card
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.ops import traverse as ttv
from dxrexperiments_torch.scene.convert import scene_from_numpy
from dxrexperiments_torch.trace import integrator as tint
from dxrexperiments_tpu.scene import Scene as JScene
from dxrexperiments_tpu.scene.procedural import random_triangle_soup
from dxrexperiments_tpu.trace import integrator as jint
from test_torch_cuda import one_thread  # noqa: F401

N = 600


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def scenes():
    sc = JScene()
    sc.add_model(random_triangle_soup(2000, seed=4, extent=10.0))
    jd = sc.build(accel="bvh")
    return jd, scene_from_numpy(jax.tree.map(np.asarray, jd), "cpu")


def rays(n, seed):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-12, 12, size=(n, 3)).astype(np.float32)  # some outside the root box
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_order_equals_jax(scenes, seed):
    jd, td = scenes
    o, d = rays(N, seed)
    want = np.asarray(jint._ray_sort_order(jd, jnp.asarray(o), jnp.asarray(d)))
    got = tint._ray_sort_order(td, torch.as_tensor(o), torch.as_tensor(d))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, np.arange(N))


def test_sorted_closest_round_trip(scenes):
    td = scenes[1]
    o, d = (torch.as_tensor(x) for x in rays(N, 1))
    plain = ttv.traverse_fat_closest_reference(td, o, d, 1e-4, 3.0e37)
    srt = tint._sorted_trace(td, ttv.traverse_fat_closest_reference, o, d, 1e-4, 3.0e37,
                             cull_backface=False)
    assert set(srt) == set(plain) and bool(plain["hit"].any())
    for k in plain:
        assert torch.equal(srt[k], plain[k]), k
    # the integrator ignores the flag off the kernels, as JAX's jnp path does
    a = tint._trace_closest(td, o, d, 1e-4, 3.0e37, cull=False, impl="torch", sort_rays=True)
    b = tint._trace_closest(td, o, d, 1e-4, 3.0e37, cull=False, impl="torch")
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))


def test_sorted_any_round_trip(scenes):
    td = scenes[1]
    o, d = (torch.as_tensor(x) for x in rays(N, 2))
    tmax = torch.as_tensor(np.random.default_rng(3).uniform(0.5, 20.0, N).astype(np.float32))
    plain = ttv.traverse_fat_any_reference(td, o, d, 1e-4, tmax)
    srt = tint._sorted_trace(td, ttv.traverse_fat_any_reference, o, d, 1e-4, tmax)
    assert torch.equal(srt, plain) and 0 < int(plain.sum()) < N
    assert torch.equal(tint._trace_any(td, o, d, 1e-4, tmax, "torch", sort_rays=True), plain)
