"""Port the binary and 8-wide BVH walks (kernels B4b and B4d) vs the JAX
package.

- ``accel/bvh.collapse_wide`` equals the JAX collapse bit for bit on the
  Cornell box, a 600-triangle soup (Morton build) and the soup's SAH build
  (``pack_for_traversal``'s ``bvh8_nodes`` is held in tests/test_torch_bvh.py).
- ``binary_walk_numpy`` and ``wide_walk_numpy``, the host models of the CUDA
  walks, against the JAX kernels ``traverse_closest``/``traverse_any`` and
  ``traverse8_closest``/``traverse8_any`` in interpret mode, on 600 rays of
  the soup and of the 'instanced:2' grid with accel='bvh': the hit flag
  equal, t within rtol 2e-4, the leaf slot equal on at least 99% of hits
  (the JAX kernel, a packet walk, visits the leaves in the same fixed order,
  so knife-edge ties resolve alike), occlusion equal. The port's wrappers on
  CPU rays (their plain version, the brute-force sweep) pass the hit gate of
  benchmarks/kernel_parity.py against the same JAX kernels and launch no
  kernel.
- the walks' stacks: a right-deep chain overflows the binary model's 96
  entries (as a left-deep one overflows the fat walk), a shallow one does
  not; the deepest stack is reported.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.accel import bvh as tbvh
from dxrexperiments_torch.ops import traverse as ttv
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_tpu.accel import bvh as jbvh
from dxrexperiments_tpu.ops import traverse_pallas as jtv
from test_torch_bvh import _triangles
from test_torch_cuda import chain_scene
from test_torch_traverse import R, hit_gate, jax_scene, port, rays


def walk_gate(got: dict, want: dict, slot_frac: float = 0.99) -> None:
    """The host model against a JAX kernel: hit equal, t within rtol 2e-4,
    the slot equal on at least `slot_frac` of the hits."""
    hit = np.asarray(want["hit"])
    np.testing.assert_array_equal(got["hit"], hit)
    assert hit.mean() > 0.3
    np.testing.assert_allclose(got["t"][hit], np.asarray(want["t"])[hit], rtol=2e-4)
    assert (got["slot"][hit] == np.asarray(want["slot"])[hit]).mean() >= slot_frac


@pytest.mark.parametrize("kind,builder", [("cornell", "morton"), ("soup600", "morton"),
                                          ("soup600", "sah")])
def test_collapse_wide_equals_jax(kind, builder):
    _, td, n = _triangles(kind)
    if builder == "sah":
        nodes = jbvh.build_bvh_sah(td["v0"], td["e1"], td["e2"], n, 32)
        if nodes is None:
            pytest.skip("no C++ compiler for the native SAH builder")
    else:
        nodes = jbvh.to_node_arrays(jbvh.build_bvh(td["v0"], td["e1"], td["e2"], n, 32))
    args = (np.asarray(nodes["nodes_lo"], np.float32), np.asarray(nodes["nodes_hi"], np.float32),
            np.asarray(nodes["child"], np.int64))
    want = jbvh.collapse_wide(*args)
    got = tbvh.collapse_wide(*args)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    internal = got["w_count"] < -0.5
    assert internal.any() or kind == "cornell"
    assert (got["w_child"][internal] < len(got["w_child"])).all()


@pytest.mark.parametrize("kind,cull", [("soup", False), ("instanced:2", False),
                                       ("instanced:2", True)])
def test_binary_walk_matches_pallas(kind, cull):
    jscene = jax_scene(kind)
    tscene = port(jscene)
    o, d = rays(tscene)
    want = jtv.traverse_closest(jscene["bvh"], jnp.asarray(o), jnp.asarray(d), 1e-4,
                                leaf_size=32, cull_backface=cull, interpret=True)
    got, counts = ttv.binary_walk_numpy(tscene["bvh"], o, d, 1e-4, 3.0e37, cull=cull)
    walk_gate(got, want)
    assert counts["slab_tests"] == counts["visits"] > R
    n_slots = int((tscene["bvh"]["slot_tri"] >= 0).sum())
    assert 0 < counts["pair_tests"] < R * n_slots  # the walk prunes
    assert len(counts["node_ids"]) <= tscene["bvh"]["bvh_rows"].shape[0]
    # the wrapper on CPU rays: the brute-force plain version, no launch
    before = launch_counts()
    plain = ttv.traverse_closest(tscene, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                                 cull_backface=cull)
    assert launch_counts() == before
    hit_gate(plain["hit"], plain["t"], plain["tri"], want["hit"], want["t"], want["tri"])


@pytest.mark.parametrize("kind", ["soup", "instanced:2"])
def test_wide_walk_matches_pallas(kind):
    jscene = jax_scene(kind)
    tscene = port(jscene)
    o, d = rays(tscene, seed=7)
    want = jtv.traverse8_closest(jscene["bvh"], jnp.asarray(o), jnp.asarray(d), 1e-4,
                                 leaf_size=32, interpret=True)
    got, counts = ttv.wide_walk_numpy(tscene["bvh"], o, d, 1e-4, 3.0e37)
    walk_gate(got, want)
    assert counts["slab_tests"] == 8 * counts["visits"]
    binary = ttv.binary_walk_numpy(tscene["bvh"], o, d, 1e-4, 3.0e37)[1]
    assert counts["visits"] < binary["visits"]  # fewer, wider steps
    assert 1 <= counts["max_stack"] <= ttv.MAX_STACK
    before = launch_counts()
    plain = ttv.traverse8_closest(tscene, torch.as_tensor(o), torch.as_tensor(d), 1e-4)
    assert launch_counts() == before
    hit_gate(plain["hit"], plain["t"], plain["tri"], want["hit"], want["t"], want["tri"])


@pytest.mark.parametrize("walk", ["binary", "wide"])
def test_walk_any_matches_pallas(walk):
    jscene = jax_scene("instanced:2")
    tscene = port(jscene)
    o, d = rays(tscene, seed=4)
    tmax = np.where(np.arange(R) % 2 == 0, 3.0e37, 7.5).astype(np.float32)
    d[::7] = 0.0  # dead lanes: zero directions are never occluded
    jfn, model, wrapper = ((jtv.traverse_any, ttv.binary_walk_numpy, ttv.traverse_any)
                           if walk == "binary" else
                           (jtv.traverse8_any, ttv.wide_walk_numpy, ttv.traverse8_any))
    want = np.asarray(jfn(jscene["bvh"], jnp.asarray(o), jnp.asarray(d), 1e-4,
                          jnp.asarray(tmax), leaf_size=32, interpret=True))
    got, counts = model(tscene["bvh"], o, d, 1e-4, tmax, occlusion=True)
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got["occluded"], want)
    closest = model(tscene["bvh"], o, d, 1e-4, tmax)[1]
    assert counts["pair_tests"] < closest["pair_tests"]  # occlusion ends at the first hit
    plain = wrapper(tscene, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                    torch.as_tensor(tmax)).numpy()
    assert not plain[::7].any()
    assert float((plain != want).mean()) <= 0.01


def test_binary_walk_stack():
    o = np.zeros((2, 3), np.float32)
    d = np.array([[0.0, 0.0, 1.0]] * 2, np.float32)
    with pytest.raises(RuntimeError, match="stack overflowed"):
        ttv.binary_walk_numpy(chain_scene(120, right_deep=True)[1], o, d, 0.0, 1e38)
    for levels, right_deep in ((40, True), (120, False)):
        got, counts = ttv.binary_walk_numpy(chain_scene(levels, right_deep)[1], o, d, 0.0, 1e38)
        assert got["hit"].all() and np.allclose(got["t"], 5.0)
        assert counts["max_stack"] == (levels + 1 if right_deep else 3)
