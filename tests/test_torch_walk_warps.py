"""The leaf-weighted warp model of the BVH walks, and the host model of the
binary walks B4b and B6b as they are redesigned for the card, on the CPU.

- Every host model of a walk (``ops/traverse``: fat and 8-wide, with and
  without leaf postponement, binary, and ``parent_walk_numpy``;
  ``ops/traverse2``: fat and binary) logs the work of each loop turn of each ray
  (``counts["turns"]``, ``ops/traverse.TurnLog``): one record per visit
  (two-level: per TLAS and per BLAS visit), whose pair tests sum to
  ``counts["pair_tests"]``. Scenes: the Cornell box, a 2,000-triangle soup
  and ``chain_scene``'s degenerate trees (left- and right-deep); two-level:
  the 5-instance scene, 'instanced:2' and the chain as a BLAS.
- ``traverse2.turn_costs`` on warps built by hand equals the hand
  computation: loop turns, pair slots (the largest pair tests of each
  turn) and the cost c_slab x turns + c_pair x slots, lined up loop by
  loop in a nested walk; with leaf postponement (``ops/traverse.held_walk``
  driven by a scripted visit) the traversal rounds and the largest held
  leaf of each leaf phase.
- ``parent_walk_numpy``, B4b's walk (each node's children slab-tested
  when it is popped and pushed with their entry t, a popped entry visited
  only while that t is within the window; with and without leaf
  postponement in warps of 32 rays, ``ops/traverse.held_walk``), equals
  ``binary_walk_numpy`` (the JAX kernel's walk, held against it in
  tests/test_torch_binary_walks.py) bit for bit: t, slot, u, v and
  occlusion, and the ordered list of leaves each ray tests; postponement
  leaves each ray's turns as they were. The rays include direction components of exactly zero, whose slab
  products reach +-inf, and dead shadow rays (a zero direction). At most
  512 rays a case.
- The redesigned walk's stack: as deep as the JAX kernel's walk on
  ``chain_scene``'s chains, so a chain deeper than 96 entries overflows
  (the kernels set ``E_STACK``).
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dxrexperiments_torch.app.headless import build_scene
from dxrexperiments_torch.ops import traverse as ttv
from dxrexperiments_torch.ops import traverse2 as tt2
from test_torch_cuda import chain_scene, chain_two_level, port_five

N_RAYS = 512
ONE_LEVEL = ("cornell", "soup", "chain", "chain right-deep")
TWO_LEVEL = ("five", "instanced:2", "chain right-deep")
WALKS1 = {"fat": ttv.fat_walk_numpy, "binary": ttv.binary_walk_numpy,
          "wide": ttv.wide_walk_numpy, "parent": ttv.parent_walk_numpy,
          "parent postponed": functools.partial(ttv.parent_walk_numpy, postpone=True),
          "fat postponed": functools.partial(ttv.fat_walk_numpy, postpone=True),
          "wide postponed": functools.partial(ttv.wide_walk_numpy, postpone=True)}
WALKS2 = {"fat": tt2.fat_walk2_numpy, "binary": tt2.binary_walk2_numpy}


def host(tree: dict) -> dict:
    return {k: v.numpy() for k, v in tree.items() if isinstance(v, torch.Tensor)}


def one_level(kind: str) -> tuple[dict, np.ndarray, np.ndarray]:
    """(bvh arrays, origins, directions) of a one-level case."""
    rng = np.random.default_rng(len(kind))
    if kind.startswith("chain"):
        bvh = chain_scene(40, right_deep=kind.endswith("right-deep"))[1]
        o = (rng.uniform(-1.2, 1.2, (N_RAYS, 3)) * [1, 1, 0]).astype(np.float32)
        d = rng.normal(size=(N_RAYS, 3)) * 0.1 + [0, 0, 1]
    else:
        name = "cornell-glossy" if kind == "cornell" else "soup:2000"
        bvh = host(build_scene(name)[0].build("cpu", accel="bvh")["bvh"])
        lo, hi = bvh["bvh_rows"][0, 0:3], bvh["bvh_rows"][0, 3:6]
        centre, size = (lo + hi) / 2, float((hi - lo).max())
        o = (centre + rng.normal(size=(N_RAYS, 3)) * size).astype(np.float32)
        d = centre + rng.uniform(-0.4, 0.4, (N_RAYS, 3)) * size - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[::5, 0] = 0.0  # zero components: slab products of +-inf
    d[1::7, 1] = 0.0
    return bvh, o, d


def two_level(kind: str) -> tuple[dict, np.ndarray, np.ndarray]:
    """(tlas arrays, origins, directions) of a two-level case."""
    rng = np.random.default_rng(len(kind) + 7)
    if kind.startswith("chain"):
        scene = chain_two_level(40, "cpu", right_deep=True)
        o = (rng.uniform(-1.2, 1.2, (N_RAYS, 3)) * [1, 1, 0]).astype(np.float32)
        d = rng.normal(size=(N_RAYS, 3)) * 0.1 + [0, 0, 1]
    else:
        scene = (port_five() if kind == "five" else build_scene(kind)[0]).build_two_level("cpu")
        radius = 8.0 if kind == "five" else 12.0
        o = rng.normal(size=(N_RAYS, 3))
        o = (o / np.linalg.norm(o, axis=1, keepdims=True) * radius).astype(np.float32)
        d = rng.normal(size=(N_RAYS, 3)) * radius / 4 - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[::5, 2] = 0.0
    d[1::7, 0] = 0.0
    return host(scene["tlas"]), o, d


def shadow_window(d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(directions with a quarter dead, per-ray t_max) of occlusion rays."""
    d = d.copy()
    d[::4] = 0.0  # dead shadow rays: never occluded
    tmax = np.random.default_rng(3).uniform(2.0, 30.0, len(d)).astype(np.float32)
    return d, tmax


def check_turns(counts: dict, visits: int) -> None:
    turns = counts["turns"]
    assert set(turns) - {"rounds"} == {"ray", "loop", "turn", "pairs"}  # rounds: postponed
    assert len(turns["ray"]) == visits > 0
    assert int(turns["pairs"].sum()) == counts["pair_tests"]
    assert (turns["pairs"] >= 0).all() and (turns["turn"] >= 0).all()
    # a ray's turns of one loop are numbered 0, 1, 2, ... without gaps
    key = turns["ray"] * (int(turns["loop"].max()) + 1) + turns["loop"]
    for k in np.unique(key)[:50]:
        np.testing.assert_array_equal(np.sort(turns["turn"][key == k]),
                                      np.arange((key == k).sum()))


@pytest.mark.parametrize("walk", WALKS1)
@pytest.mark.parametrize("kind", ONE_LEVEL)
def test_turn_records_sum_to_counts(kind, walk):
    bvh, o, d = one_level(kind)
    for occlusion in (False, True):
        dd, tmax = shadow_window(d) if occlusion else (d, np.float32(3.0e37))
        res, counts = WALKS1[walk](bvh, o, dd, 1e-4, tmax, occlusion=occlusion)
        check_turns(counts, counts["visits"])
        assert (counts["turns"]["loop"] == 0).all()
        np.testing.assert_array_equal(np.bincount(counts["turns"]["ray"], minlength=len(o)),
                                      counts["ray_visits"])
        assert counts["max_stack"] == int(counts["ray_depth"].max())
        if occlusion:
            assert not res["occluded"][::4].any()


@pytest.mark.parametrize("walk", WALKS2)
@pytest.mark.parametrize("kind", TWO_LEVEL)
def test_turn_records_sum_to_counts_two_level(kind, walk):
    tl, o, d = two_level(kind)
    for occlusion in (False, True):
        dd, tmax = shadow_window(d) if occlusion else (d, np.float32(3.0e37))
        res, counts = WALKS2[walk](tl, o, dd, 1e-4, tmax, occlusion=occlusion)
        check_turns(counts, counts["tlas_visits"] + counts["blas_visits"])
        turns = counts["turns"]
        tlas_turns = turns["loop"] % 3 == 0
        assert int(tlas_turns.sum()) == counts["tlas_visits"]
        assert not turns["pairs"][tlas_turns].any()  # pair tests only in BLAS turns
        if walk != "fat":  # a binary TLAS leaf has one child: side 0
            assert (turns["loop"] % 3 != 2).all()
        per = counts["per_ray"]
        np.testing.assert_array_equal(
            np.bincount(turns["ray"][~tlas_turns], minlength=len(o)), per["blas_visits"])


def test_turn_costs_by_hand():
    # warp 0 (rays 0-31): lane 0 visits, visits, tests a 5-pair leaf; lane 1
    # tests a 3-pair leaf in its first turn, then visits; lane 2 one visit;
    # the others none. warp 1 (rays 32-63): lane 0 a 2-pair leaf in a BLAS
    # walk (loop 1) entered at its TLAS turn 0, lane 1 its TLAS turn only.
    log = ttv.TurnLog()
    log.add(np.array([0, 1, 2]), 0, 0, np.array([0, 3, 0]))
    log.add(np.array([0, 1]), 0, 1, np.array([0, 0]))
    log.add(np.array([0]), 0, 2, np.array([5]))
    log.add(np.array([32, 33]), 0, 0, np.array([0, 0]))
    log.add(np.array([32]), 1, 0, np.array([2]))
    w = tt2.turn_costs(log.arrays(), 64, c_slab=10.0, c_pair=3.0)
    np.testing.assert_array_equal(w["turns"], [3, 2])
    np.testing.assert_array_equal(w["pair_slots"], [3 + 5, 2])
    np.testing.assert_array_equal(w["pairs"], [8, 2])
    np.testing.assert_allclose(w["cost"], [10 * 3 + 3 * 8, 10 * 2 + 3 * 2])
    assert "postponed_turns" not in w


def test_held_walk_by_hand():
    """Leaf postponement on warps built by hand: each ray's turns scripted
    (0 an internal node, k > 0 a leaf of k pair tests). Warp 0: lane 0
    visits, visits, pops a 5-pair leaf; lane 1 pops a 3-pair leaf, then
    visits; lane 2 visits once. Warp 1: lane 0 visits, pops a 2-pair leaf;
    lane 1 visits once. Postponed, warp 0: round 1 lanes 0-2 walk (lane 1
    holds 3); round 2 lanes 0, 2 (lane 2 ends); round 3 lane 0 holds 5, so
    the warp tests both leaves in one phase of max(3, 5); round 4 lane 1's
    last turn: 4 traversal rounds, 5 pair slots, where testing each leaf
    when popped costs 3 turns and 3 + 5 slots. Warp 1: 2 rounds, 2 slots."""
    script = {0: [0, 0, 5], 1: [3, 0], 2: [0], 32: [0, 2], 33: [0]}
    r = 64
    st = ttv.RayStacks(r, 8)
    for ray, turns in script.items():
        st.sp[ray] = len(turns)
    pos = np.zeros(r, np.int64)
    state = SimpleNamespace(occ=np.zeros(r, bool), ray_pairs=np.zeros(r, np.int64))

    def visit(idx, _nodes, _o, _inv, _state, stacks, hold):
        stacks.sp[idx] -= 1
        pairs = np.array([script[i][pos[i]] for i in idx])
        pos[idx] += 1
        lf = pairs > 0
        hold(idx[lf], pairs[lf], pairs[lf], 0)
        return idx

    def leaf_test(idx, _start, count):
        state.ray_pairs[idx] += count

    log = ttv.TurnLog()
    ttv.held_walk(None, visit, None, None, state, st, leaf_test, log, np.zeros(r, np.int64))
    w = tt2.turn_costs(log.arrays(), r, c_slab=10.0, c_pair=3.0)
    np.testing.assert_array_equal(w["turns"], [3, 2])
    np.testing.assert_array_equal(w["pair_slots"], [3 + 5, 2])
    np.testing.assert_array_equal(w["postponed_turns"], [4, 2])
    np.testing.assert_array_equal(w["postponed_slots"], [5, 2])
    np.testing.assert_allclose(w["postponed_cost"], [10 * 4 + 3 * 5, 10 * 2 + 3 * 2])
    np.testing.assert_array_equal(state.ray_pairs[list(script)], [5, 3, 0, 2, 0])


@pytest.mark.parametrize("kind", ONE_LEVEL)
def test_turn_costs_of_a_walk(kind):
    """On a real walk: a warp's cost lies between its slowest lane's and the
    sum of its lanes'; postponement never tests more pair slots."""
    bvh, o, d = one_level(kind)
    _, counts = ttv.parent_walk_numpy(bvh, o, d, 1e-4, 3.0e37, postpone=True)
    w = tt2.turn_costs(counts["turns"], len(o))
    per_ray_turns = counts["ray_visits"].reshape(-1, 32)
    np.testing.assert_array_equal(w["turns"], per_ray_turns.max(1))
    assert (w["pair_slots"] <= w["pairs"]).all()
    assert (w["pair_slots"] >= counts["ray_leaves"].reshape(-1, 32).max(1)).all()
    assert (w["postponed_slots"] <= w["pair_slots"]).all()
    assert (w["postponed_turns"] >= w["turns"]).all()


def sorted_turns(counts: dict) -> np.ndarray:
    t = counts["turns"]
    cols = np.stack([t["ray"], t["loop"], t["turn"], t["pairs"]])
    return cols[:, np.lexsort(cols[::-1])]


def assert_same_walk(got, want, got_counts, want_counts):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k in ("ray", "start"):
        np.testing.assert_array_equal(got_counts["leaf_order"][k],
                                      want_counts["leaf_order"][k], err_msg=k)
    assert got_counts["pair_tests"] == want_counts["pair_tests"]


@pytest.mark.parametrize("postpone", [False, True])
@pytest.mark.parametrize("mode", ["closest", "culled", "any"])
@pytest.mark.parametrize("kind", ONE_LEVEL)
def test_parent_walk_equals_binary_walk(kind, mode, postpone):
    bvh, o, d = one_level(kind)
    occlusion = mode == "any"
    dd, tmax = shadow_window(d) if occlusion else (d, np.float32(3.0e37))
    kw = {"cull": mode == "culled", "occlusion": occlusion}
    want, wc = ttv.binary_walk_numpy(bvh, o, dd, 1e-4, tmax, **kw)
    got, gc = ttv.parent_walk_numpy(bvh, o, dd, 1e-4, tmax, postpone=postpone, **kw)
    assert_same_walk(got, want, gc, wc)
    if postpone:  # each ray's turns are its own: postponement only makes it wait
        own = ttv.parent_walk_numpy(bvh, o, dd, 1e-4, tmax, **kw)[1]
        np.testing.assert_array_equal(sorted_turns(gc), sorted_turns(own))
    if occlusion:
        assert 0.0 < want["occluded"].mean() < 0.75 and not got["occluded"][::4].any()
    elif mode == "closest":
        assert 0.05 < want["hit"].mean() < 0.95
    if not kind.startswith("chain"):  # (every box of a chain is hit)
        assert gc["visits"] < wc["visits"]  # a child that misses is never popped
    assert gc["max_stack"] <= wc["max_stack"]


def test_parent_walk_stack():
    """The redesigned walk pushes only the children that hit: on a
    right-deep chain (every box the same) as deep as the JAX kernel's walk,
    so a chain deeper than the stack still overflows; on a left-deep one
    as shallow."""
    o = np.zeros((2, 3), np.float32)
    d = np.array([[0.0, 0.0, 1.0]] * 2, np.float32)
    for occlusion in (False, True):
        with pytest.raises(RuntimeError, match="stack overflowed"):
            ttv.parent_walk_numpy(chain_scene(120, right_deep=True)[1], o, d, 0.0, 1e38,
                                  occlusion=occlusion)
    for levels, right_deep in ((40, True), (120, False)):
        packed = chain_scene(levels, right_deep)[1]
        got, counts = ttv.parent_walk_numpy(packed, o, d, 0.0, 1e38)
        assert got["hit"].all() and np.allclose(got["t"], 5.0)
        assert counts["max_stack"] == ttv.binary_walk_numpy(packed, o, d, 0.0, 1e38)[1][
            "max_stack"]
