"""The host model of the 8-wide walk B4d as it is redesigned for the card:
leaf postponement per warp with a hold of up to eight leaves, on the CPU.

- ``wide_walk_numpy(..., postpone=True)`` (``ops/traverse.held_walk`` with a
  hold of eight: a ray holds the leaf children a visit hits, in child
  order, and its warp of 32 rays tests the held leaves once no ray of it
  still walks without one) equals the walk without postponement bit for
  bit: t, slot, u, v and occlusion, the ordered list of leaves each ray
  tests and its pair tests; each ray's turns are its own. Scenes and rays
  of tests/test_torch_walk_warps.py (Cornell, a 2,000-triangle soup,
  ``chain_scene``'s trees; zero direction components, dead shadow rays).
- Both against the JAX package's ``traverse8_closest`` / ``traverse8_any``
  in interpret mode, on tests/test_traverse8_pallas.py's Cornell case (600
  rays, leaf size 8, the Morton build): the hit flags equal, t within rtol
  2e-4, the leaf slot equal on every hit, occlusion equal.
- By hand, one warp: a wide node whose eight children are leaves of one
  triangle each, one ray through all eight. It holds eight leaves after its
  one visit; its closest walk tests them in child order and keeps the
  nearest, its occlusion walk stops at the first.
- ``wide_ladder``'s tree, whose walk overflows its stack while it holds a
  leaf: both models raise, and a ladder one level short does not.
- B4a's two-leaf figures are unchanged by the hold's generalisation: the
  postponed fat walk's rounds and leaf-phase slots on Cornell and the soup
  equal the figures of the walk with its hold of two written out.
- B4d and B4c read the records ``ft_test`` (``check_bvh(..., "wide" |
  "grouped")``): a BVH without them, or with a record count other than
  mt_rows' rows, raises before any launch.
"""

import numpy as np
import pytest
import torch

from dxrexperiments_torch.ops import traverse as ttv
from dxrexperiments_torch.ops import traverse2 as tt2
from dxrexperiments_torch.scene import Scene
from dxrexperiments_torch.scene.mesh import Mesh
from dxrexperiments_tpu.ops import traverse_pallas as jtv
from dxrexperiments_tpu.scene import cornell_box
from test_torch_cuda import wide_ladder
from test_torch_traverse import port, soup_scene
from test_torch_walk_warps import ONE_LEVEL, assert_same_walk, one_level, shadow_window, sorted_turns
from test_traverse8_pallas import build, rays_for

import jax.numpy as jnp


@pytest.mark.parametrize("mode", ["closest", "culled", "any"])
@pytest.mark.parametrize("kind", ONE_LEVEL)
def test_postponed_wide_walk_equals_wide_walk(kind, mode):
    bvh, o, d = one_level(kind)
    occlusion = mode == "any"
    dd, tmax = shadow_window(d) if occlusion else (d, np.float32(3.0e37))
    kw = {"cull": mode == "culled", "occlusion": occlusion}
    want, wc = ttv.wide_walk_numpy(bvh, o, dd, 1e-4, tmax, **kw)
    got, gc = ttv.wide_walk_numpy(bvh, o, dd, 1e-4, tmax, postpone=True, **kw)
    assert_same_walk(got, want, gc, wc)
    np.testing.assert_array_equal(sorted_turns(gc), sorted_turns(wc))
    # a ray's turns fall in distinct rounds (a warp's leaf phases can cost
    # more than its turns' largest leaves: two lanes' leaves of one turn may
    # be held to different phases)
    w = tt2.turn_costs(gc["turns"], len(o))
    assert (w["postponed_turns"] >= w["turns"]).all()
    assert "rounds" in gc["turns"] and "rounds" not in wc["turns"]


@pytest.fixture(scope="module")
def cornell8():
    """tests/test_traverse8_pallas.py's Cornell case: the packed arrays, the
    host models' arrays and 600 rays."""
    mesh, _ = cornell_box(glossy_tall_box=True)
    _, packed = build(mesh, leaf_size=8)
    bvh = {"bvh8_rows": np.asarray(packed["bvh8_nodes"]), "mt_rows": np.asarray(packed["mt_rows"])}
    o, d = (np.asarray(x) for x in rays_for("cornell", 600))
    return packed, bvh, o, d


def test_postponed_wide_walk_matches_pallas_closest(cornell8):
    packed, bvh, o, d = cornell8
    want = jtv.traverse8_closest(packed, jnp.asarray(o), jnp.asarray(d), t_min=1e-4, leaf_size=8,
                                 interpret=True)
    hit = np.asarray(want["hit"])
    assert 0.3 < hit.mean()
    for postpone in (False, True):
        got, _ = ttv.wide_walk_numpy(bvh, o, d, 1e-4, 3.0e37, postpone=postpone)
        np.testing.assert_array_equal(got["hit"], hit)
        np.testing.assert_allclose(got["t"][hit], np.asarray(want["t"])[hit], rtol=2e-4)
        np.testing.assert_array_equal(got["slot"][hit], np.asarray(want["slot"])[hit])


def test_postponed_wide_walk_matches_pallas_any(cornell8):
    packed, bvh, o, d = cornell8
    d = d.copy()
    d[::7] = 0.0  # dead lanes: never occluded
    tmax = np.where(np.arange(len(o)) % 2 == 0, 3.0e37, 0.8).astype(np.float32)
    want = np.asarray(jtv.traverse8_any(packed, jnp.asarray(o), jnp.asarray(d), 1e-4,
                                        jnp.asarray(tmax), leaf_size=8, interpret=True))
    assert 0.05 < want.mean() < 0.95
    for postpone in (False, True):
        got, _ = ttv.wide_walk_numpy(bvh, o, d, 1e-4, tmax, occlusion=True, postpone=postpone)
        np.testing.assert_array_equal(got["occluded"], want)


def eight_leaf_bvh() -> dict:
    """A binary tree of depth 3 whose eight leaves hold one triangle each,
    leaf k's at z = 12 - k under x, y in [-1, 1]: its 8-wide collapse is one
    wide node with eight leaf children, child 7 the nearest along +z."""
    sc = Scene()
    tri = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    pos = np.concatenate([tri + [0, 0, 12 - k] for k in range(8)])
    sc.add_model(Mesh(pos, None, np.arange(24, dtype=np.int32).reshape(8, 3)))
    base = sc.build_numpy(accel="none")
    lo = [[-1, -1, 12 - k] for k in range(8)]
    hi = [[1, 1, 12 - k] for k in range(8)]
    child = [[2 * i + 1, 2 * i + 2] for i in range(7)] + [[-(k + 1), 1] for k in range(8)]
    nodes_lo, nodes_hi = np.zeros((15, 3), np.float32), np.zeros((15, 3), np.float32)
    nodes_lo[7:], nodes_hi[7:] = lo, hi
    for i in range(6, -1, -1):  # each internal box the union of its children's
        nodes_lo[i] = np.minimum(nodes_lo[2 * i + 1], nodes_lo[2 * i + 2])
        nodes_hi[i] = np.maximum(nodes_hi[2 * i + 1], nodes_hi[2 * i + 2])
    nodes = {"nodes_lo": nodes_lo, "nodes_hi": nodes_hi, "child": np.asarray(child, np.int32),
             "order": np.arange(8, dtype=np.int32)}
    return ttv.pack_for_traversal(nodes, base, 8)


@pytest.mark.parametrize("occlusion", [False, True])
def test_hold_of_eight_by_hand(occlusion):
    """One warp: ray 0 goes through all eight leaves, rays 1-31 pass beside
    the wide node's boxes. Ray 0 holds eight leaves after its one visit;
    its closest walk tests them in child order (8 pair tests) and keeps
    leaf 7's triangle at t = 5, its occlusion walk stops at leaf 0 (1 pair
    test). Rounds: one traversal turn, one leaf phase."""
    bvh = eight_leaf_bvh()
    rows = bvh["bvh8_rows"]
    assert rows.shape[0] == 8 and (rows[:, 7] == 1).all()  # one wide node, eight leaves
    o = np.zeros((32, 3), np.float32)
    o[1:, 0] = 10.0
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (32, 1))
    kw = {"occlusion": occlusion}
    want, wc = ttv.wide_walk_numpy(bvh, o, d, 1e-4, np.float32(20.0), **kw)
    got, gc = ttv.wide_walk_numpy(bvh, o, d, 1e-4, np.float32(20.0), postpone=True, **kw)
    assert_same_walk(got, want, gc, wc)
    pairs = 1 if occlusion else 8
    np.testing.assert_array_equal(gc["leaf_order"]["ray"], [0] * pairs)
    np.testing.assert_array_equal(gc["leaf_order"]["start"], (8 * np.arange(8))[:pairs])
    assert gc["pair_tests"] == pairs and gc["visits"] == 32
    if occlusion:
        assert got["occluded"][0] and not got["occluded"][1:].any()
    else:
        assert got["hit"][0] and got["t"][0] == 5.0 and got["slot"][0] == 56
        assert not got["hit"][1:].any()
    w = tt2.turn_costs(gc["turns"], 32)
    np.testing.assert_array_equal(w["turns"], [1])
    np.testing.assert_array_equal(w["pair_slots"], [pairs])
    np.testing.assert_array_equal(w["postponed_turns"], [1])
    np.testing.assert_array_equal(w["postponed_slots"], [pairs])


@pytest.mark.parametrize("postpone", [False, True])
def test_wide_ladder_overflows(postpone):
    """The ray through the triangle overflows in its closest walk; its
    occlusion walk ends at the first leaf, before the overflow; a ray
    beside the triangle (inside every box) overflows in both."""
    o = np.zeros((2, 3), np.float32)
    d = np.array([[0.0, 0.0, 1.0]] * 2, np.float32)
    beside = o + [5.0, 0.0, 0.0]
    for origin, occlusion in ((o, False), (beside, False), (beside, True)):
        with pytest.raises(RuntimeError, match="stack overflowed"):
            ttv.wide_walk_numpy(wide_ladder(20)[1], origin, d, 0.0, 1e38, occlusion=occlusion,
                                postpone=postpone)
    occ, _ = ttv.wide_walk_numpy(wide_ladder(20)[1], o, d, 0.0, 1e38, occlusion=True,
                                 postpone=postpone)
    assert occ["occluded"].all()
    got, counts = ttv.wide_walk_numpy(wide_ladder(15)[1], o, d, 0.0, 1e38, postpone=postpone)
    assert got["hit"].all() and np.allclose(got["t"], 5.0) and (got["slot"] == 0).all()
    assert counts["max_stack"] == ttv.MAX_STACK - 5  # 15 levels: 90 entries, 6 more at the last


# B4a's postponed figures (a hold of two): (postponed turns, leaf-phase slots,
# turns, pair slots) summed over the warps, closest and occlusion
FAT_FIGURES = {"cornell": ((16, 576, 16, 576), (16, 387, 16, 387)),
               "soup": ((808, 5933, 441, 12915), (398, 2714, 304, 4632))}


@pytest.mark.parametrize("kind", sorted(FAT_FIGURES))
def test_fat_walk_figures_unchanged(kind):
    bvh, o, d = one_level(kind)
    for occlusion, want in zip((False, True), FAT_FIGURES[kind]):
        dd, tmax = shadow_window(d) if occlusion else (d, np.float32(3.0e37))
        _, c = ttv.fat_walk_numpy(bvh, o, dd, 1e-4, tmax, occlusion=occlusion, postpone=True)
        w = tt2.turn_costs(c["turns"], len(o))
        assert tuple(int(w[k].sum()) for k in ("postponed_turns", "postponed_slots", "turns",
                                               "pair_slots")) == want


@pytest.mark.parametrize("kind", ["wide", "grouped"])
def test_wide_and_grouped_walks_read_leaf_records(kind):
    """B4d's and B4c's inputs: their node rows and the records ft_test (one
    per mt_rows row); a missing or stale ft_test raises."""
    bvh = port(soup_scene())["bvh"]
    nodes, rec = ttv.check_bvh(bvh, torch.device("cpu"), kind)
    assert nodes is bvh[ttv.WALKS[kind][1]] and rec is bvh["ft_test"]
    for bad, match in (({k: v for k, v in bvh.items() if k != "ft_test"}, "ft_test missing"),
                       (dict(bvh, ft_test=bvh["ft_test"][:-1].contiguous()), "one record per"),
                       (dict(bvh, ft_test=bvh["mt_rows"]), "expected float32")):
        with pytest.raises(ValueError, match=match):
            ttv.check_bvh(bad, torch.device("cpu"), kind)
