"""Port the grouped fat-node packet walk (kernel B4c) vs the JAX package.

- ``fat_packet_walk_numpy``, the host model of the CUDA kernel's packet
  walk, against JAX's ``traverse_fat_closest``/``traverse_fat_any`` with
  ``group > 1`` (``_make_traverse_fat_grouped_kernel``) in interpret mode,
  on tests/test_traverse_fat.py's cases of the sub-packet layout: the
  2,000-triangle soup, 512 rays, tile 512, (group, common_origin) in
  {(2, False), (4, False), (4, True)}, closest and occlusion. The gate is
  the one the other walks' host models meet (tests/test_torch_binary_walks.py):
  the hit flag equal, t within rtol 2e-4, the leaf slot equal on at least
  99% of hits, occlusion equal.
- the model with the TPU kernel's one-leaf lag (its double-buffered leaf
  DMA) and without it finds the same hits: the lag changes which nodes a
  stale best fails to prune, not the winner.
- the model of the CUDA kernel's walk (``packet=32``: each warp of 32 rays
  one packet on its own stack) against the same JAX results: the hit flags
  and occlusion equal, t within rtol 2e-4 and the slot equal on at least
  99% of hits; and against ``fat_walk_numpy`` (B4a's walk) on the same
  rays: hits, t and occlusion equal bit for bit. ``packet=tile`` is the
  default, step for step; a packet that is no whole number of warps
  dividing the tile raises.
- the port's ``traverse_fat_closest``/``traverse_fat_any(group=...)`` on CPU
  rays (their plain version, the brute-force sweep; with ``common_origin``
  every ray starts at origins[0]) against JAX's B4c on the hit gate of
  benchmarks/kernel_parity.py, launching no kernel.
- the packet layouts B4c refuses raise ValueError, and a left-deep chain
  overflows the packet's stack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.ops import traverse as ttv
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene.convert import scene_from_numpy
from dxrexperiments_tpu.ops import traverse_pallas as jtv
from dxrexperiments_tpu.scene.procedural import random_triangle_soup
from test_torch_cuda import chain_scene
from test_traverse_fat import build, rays_for

N, TILE = 512, 512


@pytest.fixture(scope="module")
def soup():
    data, packed = build(random_triangle_soup(2000, seed=4, extent=10.0), leaf_size=16)
    model_bvh = {"bvhf_rows": np.asarray(packed["bvhf_nodes"]).T.copy(),
                 "mt_rows": np.asarray(packed["mt_rows"])}
    tscene = scene_from_numpy(jax.tree.map(np.asarray, dict(data, bvh=packed)), "cpu")
    return packed, model_bvh, tscene


def case_rays(common_origin: bool):
    """tests/test_traverse_fat.py's rays: from a shared point above the soup,
    or its soup rays."""
    if common_origin:
        rs = np.random.default_rng(6)
        o = np.broadcast_to(np.array([0.0, 0.0, 24.0], np.float32), (N, 3)).copy()
        d = rs.normal(size=(N, 3)).astype(np.float32)
        d[:, 2] -= 1.5
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return o, d
    return tuple(np.array(x) for x in rays_for("soup", N, seed=5))


def plain_gate(got: dict, want: dict) -> None:
    """benchmarks/kernel_parity.py's hit gate (test_torch_traverse.hit_gate)
    on however many rays hit: the shared-origin case hits 4% of its 512."""
    hit, w_hit = got["hit"].numpy(), np.asarray(want["hit"])
    same = (hit == w_hit) & (~hit | (got["tri"].numpy() == np.asarray(want["tri"])))
    both = same & hit
    rel = (np.abs(got["t"].numpy() - np.asarray(want["t"]))
           / np.maximum(1.0, np.abs(np.asarray(want["t"]))))[both]
    assert both.sum() >= 10
    assert float(np.median(rel)) <= 1e-6
    assert float(np.quantile(rel, 0.999)) <= 1e-4
    assert float(rel.max()) <= 0.05
    assert float((~same).mean()) <= 0.01


def model_gate(got: dict, want: dict) -> None:
    hit = np.asarray(want["hit"])
    np.testing.assert_array_equal(got["hit"], hit)
    assert hit.any()
    np.testing.assert_allclose(got["t"][hit], np.asarray(want["t"])[hit], rtol=2e-4)
    assert (got["slot"][hit] == np.asarray(want["slot"])[hit]).mean() >= 0.99


CASES = [(2, False), (4, False), (4, True)]  # (group, common_origin)
_PALLAS: dict = {}


def pallas_grouped(packed, group: int, common_origin: bool):
    """JAX's B4c in interpret mode on case_rays(common_origin): (closest
    result, occlusion flags), computed once per case."""
    if (group, common_origin) not in _PALLAS:
        o, d = case_rays(common_origin)
        want = jtv.traverse_fat_closest(packed, jnp.asarray(o), jnp.asarray(d), t_min=1e-4,
                                        leaf_size=16, interpret=True, tile=TILE, group=group,
                                        common_origin=common_origin)
        want_any = np.asarray(jtv.traverse_fat_any(packed, jnp.asarray(o), jnp.asarray(d),
                                                   t_min=1e-4, leaf_size=16, interpret=True,
                                                   tile=TILE, group=group))
        _PALLAS[group, common_origin] = (want, want_any)
    return _PALLAS[group, common_origin]


@pytest.mark.parametrize("group,common_origin", CASES)
def test_packet_model_matches_pallas_grouped(soup, group, common_origin):
    packed, bvh, tscene = soup
    o, d = case_rays(common_origin)
    want, want_any = pallas_grouped(packed, group, common_origin)
    runs = {}
    for lag in (False, True):
        got, counts = ttv.fat_packet_walk_numpy(bvh, o, d, 1e-4, 3.0e37, TILE, group,
                                                common_origin=common_origin, lag=lag)
        model_gate(got, want)
        occ, occ_counts = ttv.fat_packet_walk_numpy(bvh, o, d, 1e-4, 3.0e37, TILE, group,
                                                    occlusion=True, lag=lag)
        np.testing.assert_array_equal(occ["occluded"], want_any)
        runs[lag] = got
        # one packet: 2 slab tests per lane and step, one more per leaf re-test
        assert counts["slab_tests"] > 2 * TILE * counts["visits"] > 0
        assert (counts["ray_visits"] == counts["visits"]).all()
        n_slots = int((np.asarray(packed["slot_tri"]) >= 0).sum())
        # 512 scattered rays reach every leaf: the packet tests each slot at most once per lane
        assert 0 < counts["pair_tests"] <= N * n_slots
        assert occ_counts["pair_tests"] < counts["pair_tests"]  # an occluded lane stops
        assert 1 <= counts["max_stack"] <= ttv.MAX_STACK
    # the one-leaf lag finds the same winners
    for k in ("hit", "t", "slot"):
        np.testing.assert_array_equal(runs[True][k], runs[False][k], err_msg=k)

    # the port's wrappers on CPU rays: the plain version, no launch
    before = launch_counts()
    o_t = torch.as_tensor(o)
    if common_origin:  # only origins[0] counts
        o_t = o_t + torch.arange(N, dtype=torch.float32)[:, None] * (torch.arange(N) > 0)[:, None]
    plain = ttv.traverse_fat_closest(tscene, o_t, torch.as_tensor(d), 1e-4, tile=TILE,
                                     group=group, common_origin=common_origin)
    plain_any = ttv.traverse_fat_any(tscene, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                                     tile=TILE, group=group).numpy()
    assert launch_counts() == before
    plain_gate(plain, want)
    assert float((plain_any != want_any).mean()) <= 0.01


@pytest.mark.parametrize("group,common_origin", CASES)
def test_warp_packet_model_matches_pallas_and_fat_walk(soup, group, common_origin):
    packed, bvh, _ = soup
    o, d = case_rays(common_origin)
    want, want_any = pallas_grouped(packed, group, common_origin)
    got, counts = ttv.fat_packet_walk_numpy(bvh, o, d, 1e-4, 3.0e37, TILE, group,
                                            common_origin=common_origin, packet=32)
    model_gate(got, want)
    occ, _ = ttv.fat_packet_walk_numpy(bvh, o, d, 1e-4, 3.0e37, TILE, group, occlusion=True,
                                       packet=32)
    np.testing.assert_array_equal(occ["occluded"], want_any)
    # B4a's walk of the same rays: the same hits, bit for bit
    o_all = np.broadcast_to(o[:1], o.shape) if common_origin else o
    fat, _ = ttv.fat_walk_numpy(bvh, o_all, d, 1e-4, 3.0e37)
    fat_occ, _ = ttv.fat_walk_numpy(bvh, o, d, 1e-4, 3.0e37, occlusion=True)
    for k in ("hit", "t"):
        np.testing.assert_array_equal(got[k], fat[k], err_msg=k)
    assert (got["slot"] == fat["slot"]).mean() >= 0.99
    np.testing.assert_array_equal(occ["occluded"], fat_occ["occluded"])
    # one stack per warp: 16 packets, each ray's steps its warp's
    steps = counts["ray_visits"].reshape(-1, 32)
    assert (steps == steps[:, :1]).all() and counts["visits"] == int(steps[:, 0].sum())
    assert counts["warp_slots"].shape == (N // 32,)
    assert 0 < counts["warp_slots"].sum() <= counts["pair_tests"]
    tile_counts = ttv.fat_packet_walk_numpy(bvh, o, d, 1e-4, 3.0e37, TILE, group,
                                            common_origin=common_origin)[1]
    # warps walk the union of 32 rays' paths, the tile the union of 512
    assert counts["ray_visits"].sum() < tile_counts["ray_visits"].sum()


def test_packet_argument(soup):
    _, bvh, _ = soup
    o, d = case_rays(False)
    base = ttv.fat_packet_walk_numpy(bvh, o, d, 1e-4, 3.0e37, TILE, 4)
    same = ttv.fat_packet_walk_numpy(bvh, o, d, 1e-4, 3.0e37, TILE, 4, packet=TILE)
    for a, b in zip(base, same):
        for k, v in a.items():
            np.testing.assert_array_equal(b[k], v, err_msg=k)
    for packet in (0, 48, 2 * TILE, 96):
        with pytest.raises(ValueError, match="packet"):
            ttv.fat_packet_walk_numpy(bvh, o, d, 1e-4, 3.0e37, TILE, 4, packet=packet)


@pytest.mark.parametrize("tile,group,rule", [
    (512, 3, "tile % group"),
    (512, 32, "multiple of 32"),
    (4096, 4, "at most 2048"),
    (1056, 33, "multiple of 64"),
    (512, 1, "group > 1"),
])
def test_grouped_layouts_that_raise(soup, tile, group, rule):
    _, bvh, tscene = soup
    o, d = case_rays(False)
    with pytest.raises(ValueError, match=rule):
        ttv.check_grouping(tile, group)
    with pytest.raises(ValueError, match=rule):
        ttv.fat_packet_walk_numpy(bvh, o, d, 1e-4, 3.0e37, tile, group)
    if group > 1:  # group <= 1 is B4a, which takes any tile
        with pytest.raises(ValueError, match=rule):
            ttv.traverse_fat_closest(tscene, torch.as_tensor(o), torch.as_tensor(d), tile=tile,
                                     group=group)
        with pytest.raises(ValueError, match=rule):
            ttv.traverse_fat_any(tscene, torch.as_tensor(o), torch.as_tensor(d), tile=tile,
                                 group=group)


def test_grouped_launch_arguments(soup):
    """prepare_launch takes the packet layout with the grouped walk only,
    and checks it before touching the card."""
    _, _, tscene = soup
    o, d = (torch.as_tensor(x) for x in case_rays(False))
    with pytest.raises(ValueError, match="grouped walk only"):
        ttv.prepare_launch(tscene, o, d, 1e-4, 3.0e37, False, False, "fat", (512, 2, False))
    with pytest.raises(ValueError, match="grouped walk only"):
        ttv.prepare_launch(tscene, o, d, 1e-4, 3.0e37, False, False, "grouped")
    with pytest.raises(ValueError, match="multiple of 32"):
        ttv.prepare_launch(tscene, o, d, 1e-4, 3.0e37, False, False, "grouped", (512, 32, False))


def test_common_origin_on_every_route(soup):
    """common_origin: every route uses origins[0], B4a's plain version too."""
    _, _, tscene = soup
    o, d = (torch.as_tensor(x) for x in case_rays(True))
    moved = o.clone()
    moved[1:] += 5.0
    for group in (0, 4):
        got = ttv.traverse_fat_closest(tscene, moved, d, 1e-4, tile=TILE, group=group,
                                       common_origin=True)
        want = ttv.traverse_fat_closest(tscene, o, d, 1e-4)
        assert want["hit"].any()
        for k in ("hit", "t", "tri", "u", "v"):
            assert torch.equal(got[k], want[k]), (group, k)


def test_packet_walk_stack():
    o = np.zeros((64, 3), np.float32)
    d = np.array([[0.0, 0.0, 1.0]] * 64, np.float32)
    with pytest.raises(RuntimeError, match="stack overflowed"):
        ttv.fat_packet_walk_numpy(chain_scene(120)[1], o, d, 0.0, 1e38, 64, 2)
    got, counts = ttv.fat_packet_walk_numpy(chain_scene(40)[1], o, d, 0.0, 1e38, 64, 2)
    assert got["hit"].all() and np.allclose(got["t"], 5.0)
    assert 40 <= counts["max_stack"] <= ttv.MAX_STACK
