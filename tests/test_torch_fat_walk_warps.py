"""The host model of the fat-node walk B4a as it is redesigned for the card:
leaf postponement per warp with a hold of two leaves, on the CPU.

- ``fat_walk_numpy(..., postpone=True)`` (``ops/traverse.held_walk``: a ray
  holds the up to two leaves a visit hits, child 0 first, and its warp of
  32 rays tests the held leaves once no ray of it still walks without one)
  equals the walk without postponement bit for bit: t, slot, u, v and
  occlusion, the ordered list of leaves each ray tests and its pair
  tests; each ray's turns are its own. Scenes and rays of
  tests/test_torch_walk_warps.py (Cornell, a 2,000-triangle soup,
  ``chain_scene``'s trees; zero direction components, dead shadow rays).
- The postponed model against the JAX package's ``traverse_fat_closest`` /
  ``traverse_fat_any`` in interpret mode (as its own tests run it) on the
  600-triangle soup of tests/test_torch_traverse.py, 512 rays, by the hit
  gates of benchmarks/kernel_parity.py: on rays that hit the same triangle
  the relative t has median <= 1e-6, p99.9 <= 1e-4, max <= 0.05; rays whose
  hit differs (knife-edge ties resolved in another order) <= 1%;
  occlusion disagrees on <= 1% of rays.
- By hand, one warp: a fat root whose two leaf children each hold one
  triangle, one ray through both. Its occlusion walk holds both leaves and
  stops at the first; its closest walk tests both, in order. The warp's
  rounds: one traversal turn and one leaf phase of the ray's pair tests.
- Partial masks, as B5's walks vote (``live``: the lanes that make the
  walk): a lane outside never visits, never tests a leaf and never holds
  up a leaf phase, and a warp without a live lane makes no round; the
  live lanes get the hits, the leaves in order and the turns of the same
  rays walked alone without postponement, at no more pair slots a warp.
- B4a's wrapper reads the records ``ft_test`` (``check_bvh(..., "fat")``):
  a BVH without them, or with a record count other than mt_rows' rows,
  raises before any launch.
"""

import numpy as np
import pytest
import torch

from dxrexperiments_torch.ops import traverse as ttv
from dxrexperiments_torch.ops import traverse2 as tt2
from dxrexperiments_torch.scene import Scene
from dxrexperiments_torch.scene.mesh import Mesh
from dxrexperiments_tpu.ops import traverse_pallas as jtv
from test_torch_traverse import hit_gate, port, rays, soup_scene
from test_torch_walk_warps import ONE_LEVEL, assert_same_walk, one_level, shadow_window, sorted_turns

import jax.numpy as jnp


@pytest.mark.parametrize("mode", ["closest", "culled", "any"])
@pytest.mark.parametrize("kind", ONE_LEVEL)
def test_postponed_fat_walk_equals_fat_walk(kind, mode):
    bvh, o, d = one_level(kind)
    occlusion = mode == "any"
    dd, tmax = shadow_window(d) if occlusion else (d, np.float32(3.0e37))
    kw = {"cull": mode == "culled", "occlusion": occlusion}
    want, wc = ttv.fat_walk_numpy(bvh, o, dd, 1e-4, tmax, **kw)
    got, gc = ttv.fat_walk_numpy(bvh, o, dd, 1e-4, tmax, postpone=True, **kw)
    assert_same_walk(got, want, gc, wc)
    np.testing.assert_array_equal(sorted_turns(gc), sorted_turns(wc))
    w = tt2.turn_costs(gc["turns"], len(o))
    assert (w["postponed_slots"] <= w["pair_slots"]).all()
    assert (w["postponed_turns"] >= w["turns"]).all()
    if kind in ("cornell", "soup"):  # rays whose visits hit both leaf children
        assert (np.bincount(gc["leaf_order"]["ray"], minlength=len(o)) > 1).any()


@pytest.mark.parametrize("mode", ["closest", "culled", "any"])
@pytest.mark.parametrize("kind", ONE_LEVEL)
def test_postponed_fat_walk_partial_masks(kind, mode):
    bvh, o, d = one_level(kind)
    occlusion = mode == "any"
    dd, tmax = (shadow_window(d) if occlusion
                else (d, np.full(len(d), 3.0e37, np.float32)))
    live = np.random.default_rng(8).random(len(o)) < 0.6
    live[32:64] = False  # a warp that makes no walk
    kw = {"cull": mode == "culled", "occlusion": occlusion}
    want, wc = ttv.fat_walk_numpy(bvh, o[live], dd[live], 1e-4, tmax[live], **kw)
    got, gc = ttv.fat_walk_numpy(bvh, o, dd, 1e-4, tmax, postpone=True, live=live, **kw)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k][live], v, err_msg=k)
    if occlusion:
        assert not got["occluded"][~live].any()
    else:
        assert not got["hit"][~live].any() and (got["slot"][~live] == -1).all()
    for k in ("ray_visits", "ray_leaves"):
        assert not gc[k][~live].any(), k
        np.testing.assert_array_equal(gc[k][live], wc[k], err_msg=k)
    rays = np.nonzero(live)[0]
    np.testing.assert_array_equal(gc["leaf_order"]["ray"], rays[wc["leaf_order"]["ray"]])
    np.testing.assert_array_equal(gc["leaf_order"]["start"], wc["leaf_order"]["start"])
    mapped = dict(wc["turns"], ray=rays[wc["turns"]["ray"]])
    np.testing.assert_array_equal(sorted_turns(gc), sorted_turns({"turns": mapped}))
    assert 1 not in gc["turns"]["rounds"]["warp"] and gc["pair_tests"] == wc["pair_tests"] > 0
    _, uc = ttv.fat_walk_numpy(bvh, o, dd, 1e-4, tmax, live=live, **kw)
    w = tt2.turn_costs(gc["turns"], len(o))
    assert (w["postponed_slots"] <= tt2.turn_costs(uc["turns"], len(o))["pair_slots"]).all()
    assert w["postponed_turns"][1] == w["postponed_slots"][1] == 0


@pytest.fixture(scope="module")
def soup():
    jscene = soup_scene()
    return jscene, port(jscene)


def test_postponed_fat_walk_matches_pallas_closest(soup):
    jscene, tscene = soup
    o, d = rays(tscene, seed=21)
    o, d = o[:512], d[:512]
    want = jtv.traverse_fat_closest(jscene["bvh"], jnp.asarray(o), jnp.asarray(d), t_min=1e-4,
                                    leaf_size=32, interpret=True)
    bvh = {k: v.numpy() for k, v in tscene["bvh"].items() if isinstance(v, torch.Tensor)}
    got, counts = ttv.fat_walk_numpy(bvh, o, d, 1e-4, 3.0e37, postpone=True)
    tri = np.where(got["hit"], bvh["slot_tri"][np.maximum(got["slot"], 0)], -1)
    hit_gate(got["hit"], got["t"], tri, want["hit"], want["t"], want["tri"])
    assert "rounds" in counts["turns"]


def test_postponed_fat_walk_matches_pallas_any(soup):
    jscene, tscene = soup
    o, d = rays(tscene, seed=22)
    o, d = o[:512], d[:512].copy()
    tmax = np.where(np.arange(512) % 2 == 0, 3.0e37, 7.5).astype(np.float32)
    d[::7] = 0.0  # dead lanes
    want = np.asarray(jtv.traverse_fat_any(jscene["bvh"], jnp.asarray(o), jnp.asarray(d), 1e-4,
                                           jnp.asarray(tmax), leaf_size=32, interpret=True))
    bvh = {k: v.numpy() for k, v in tscene["bvh"].items() if isinstance(v, torch.Tensor)}
    got, _ = ttv.fat_walk_numpy(bvh, o, d, 1e-4, tmax, occlusion=True, postpone=True)
    assert 0.05 < want.mean() < 0.95
    assert not got["occluded"][::7].any()
    assert float((got["occluded"] != want).mean()) <= 0.01


def two_leaf_bvh() -> dict:
    """A fat root whose child 0 is a leaf of triangle 0 (z = 5) and child 1
    a leaf of triangle 1 (z = 7), both under x, y in [-1, 1]."""
    sc = Scene()
    pos = np.array([[-1, -1, 5], [1, -1, 5], [0, 1, 5], [-1, -1, 7], [1, -1, 7], [0, 1, 7]],
                   np.float32)
    sc.add_model(Mesh(pos, None, np.array([[0, 1, 2], [3, 4, 5]], np.int32)))
    base = sc.build_numpy(accel="none")
    nodes = {"nodes_lo": np.array([[-1, -1, 5], [-1, -1, 5], [-1, -1, 7]], np.float32),
             "nodes_hi": np.array([[1, 1, 7], [1, 1, 5], [1, 1, 7]], np.float32),
             "child": np.array([[1, 2], [-1, 1], [-2, 1]], np.int32),
             "order": np.array([0, 1], np.int32)}
    return ttv.pack_for_traversal(nodes, base, 32)


@pytest.mark.parametrize("occlusion", [False, True])
def test_postponed_fat_walk_by_hand(occlusion):
    """One warp: ray 0 goes through both leaves, rays 1-31 pass beside the
    root's box. Ray 0 holds both leaves after its one visit; its occlusion
    walk stops at leaf 0 (1 pair test), its closest walk tests both (2) and
    keeps triangle 0 at t = 5. Rounds: one traversal turn, one leaf phase."""
    bvh = two_leaf_bvh()
    o = np.zeros((32, 3), np.float32)
    o[1:, 0] = 10.0
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (32, 1))
    tmax = np.float32(10.0)
    kw = {"occlusion": occlusion}
    want, wc = ttv.fat_walk_numpy(bvh, o, d, 1e-4, tmax, **kw)
    got, gc = ttv.fat_walk_numpy(bvh, o, d, 1e-4, tmax, postpone=True, **kw)
    assert_same_walk(got, want, gc, wc)
    pairs = 1 if occlusion else 2
    np.testing.assert_array_equal(gc["leaf_order"]["ray"], [0] * pairs)
    np.testing.assert_array_equal(gc["leaf_order"]["start"], [0, 32][:pairs])
    assert gc["pair_tests"] == pairs and gc["visits"] == 32
    if occlusion:
        assert got["occluded"][0] and not got["occluded"][1:].any()
    else:
        assert got["hit"][0] and got["t"][0] == 5.0 and got["slot"][0] == 0
        assert not got["hit"][1:].any()
    w = tt2.turn_costs(gc["turns"], 32)
    np.testing.assert_array_equal(w["turns"], [1])
    np.testing.assert_array_equal(w["pair_slots"], [pairs])
    np.testing.assert_array_equal(w["postponed_turns"], [1])
    np.testing.assert_array_equal(w["postponed_slots"], [pairs])


def test_fat_walk_reads_leaf_records():
    """B4a's inputs: bvhf_rows and the records ft_test (one per mt_rows
    row), whatever mt_rows holds; a missing or stale ft_test raises."""
    assert all(w[3] == "ft_test" for w in ttv.WALKS.values())
    tscene = port(soup_scene())
    bvh = tscene["bvh"]
    nodes, rec = ttv.check_bvh(bvh, torch.device("cpu"), "fat")
    assert nodes is bvh["bvhf_rows"] and rec is bvh["ft_test"]
    assert torch.equal(rec, ttv.coef_records(bvh["mt_rows"]))
    for bad, match in (({k: v for k, v in bvh.items() if k != "ft_test"}, "ft_test missing"),
                       (dict(bvh, ft_test=bvh["ft_test"][:-1].contiguous()), "one record per"),
                       (dict(bvh, ft_test=bvh["mt_rows"]), "expected float32")):
        with pytest.raises(ValueError, match=match):
            ttv.check_bvh(bad, torch.device("cpu"), "fat")
