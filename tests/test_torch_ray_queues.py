"""The order rules of the redesigned trace kernels B3 (csrc/intersect_brute.cu)
and B6a (csrc/traverse2_fat.cu), and the host figures that size them, on the
CPU (the kernels themselves run only on the card: tests/test_torch_cuda.py).

- B3's queue of live rays (queue_kernel): ``intersect_kernel.queue_model``
  queues exactly the live rays, in lane order within each warp, and writes
  the dead rays' outputs bit for bit as the plain version gives them.
- B3's occlusion ring with refill: ``intersect_kernel.ring_occlusion_model``
  over the plain sweep's pair verdicts gives the same bits as the
  index-order plain version and as JAX's ``_any_kernel`` in interpret mode,
  for every ring start, at the tile edges 256, 512 and 513 triangles, and
  on all-dead and all-occluded batches; each ray ends at the first tile with
  a blocker in ring order from its start, or after one full ring.
- B3's figures (``sweep_work``, ``sweep_figures``): the pair counts of an
  index-order sweep, the live share and the lane slots of both designs.
- B6a's host model (``traverse2.fat_walk2_numpy``): its per-ray counts sum
  to its totals, the single loop's warp cost is never above the nested
  walk's, and its hits still equal JAX's fat two-level kernel in interpret
  mode (t and u within tests/test_tlas.py's rtol 2e-4, atol 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.ops import intersect, intersect_kernel as tik
from dxrexperiments_torch.ops import traverse2 as tt2
from dxrexperiments_torch.scene.convert import scene_from_numpy
from dxrexperiments_tpu.ops import intersect_pallas as jip
from dxrexperiments_tpu.ops import traverse2_pallas as jt2
from dxrexperiments_tpu.scene import Scene as JScene
from dxrexperiments_tpu.scene.procedural import random_triangle_soup
from test_torch_tlas import assert_hits_equal, both, rays_for

N_RAYS = 512


def soup_pair(n: int):
    """(JAX scene, the port's conversion) of an n-triangle soup, brute force."""
    sc = JScene()
    sc.add_model(random_triangle_soup(n, seed=2, extent=2.0))
    jscene = sc.build(accel="none")
    return jscene, scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")


def soup_rays(tscene, n_tris: int, kind: str, seed: int = 7):
    """N_RAYS shadow-like rays at the soup: "mixed" (from a sphere of radius
    6 at triangle centroids or random points, every fifth with a zero
    direction, every third with t_max 4), "dead" (every ray a zero
    direction or an empty window) or "occluded" (every ray one unit above a
    triangle's centroid, along its normal toward it)."""
    rng = np.random.default_rng(seed)
    v0, e1, e2 = (tscene[k][:n_tris].numpy() for k in ("v0", "e1", "e2"))
    pick = rng.integers(0, n_tris, N_RAYS)
    cen = (v0 + (e1 + e2) / 3.0)[pick]
    tmax = np.where(np.arange(N_RAYS) % 3 == 0, 4.0, 1e38).astype(np.float32)
    if kind == "occluded":
        nrm = np.cross(e1, e2)[pick]
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        o, d = cen + nrm, -nrm
        tmax[:] = 1e38
    else:
        o = rng.normal(size=(N_RAYS, 3))
        o = 6.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
        target = cen.copy()
        target[::4] = rng.uniform(-2.0, 2.0, size=(len(target[::4]), 3))
        d = target - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d[::5] = 0.0
        if kind == "dead":
            d[1::2] = 0.0
            tmax[::2] = 1e-5
    return o.astype(np.float32), d.astype(np.float32), tmax


def verdicts(tscene, o, d, tmax) -> np.ndarray:
    """[R, T] bool: the plain sweep's pair verdicts (no culling)."""
    n = int(tscene["num_tris"])
    tris = {k: tscene[k][:n] for k in ("pn", "c1", "c2", "e1", "e2", "d0")}
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    mom = torch.linalg.cross(o, d, dim=1)
    r = len(o)
    return intersect._valid_mask(*intersect._pair_terms(o, d, mom, tris),
                                 intersect._ray_window(1e-4, r, o),
                                 torch.as_tensor(tmax), False).numpy()


@pytest.mark.parametrize("n_tris", [256, 512, 513])
@pytest.mark.parametrize("kind", ["mixed", "dead", "occluded"])
def test_ring_occlusion_matches_index_order_and_pallas(n_tris, kind):
    jscene, tscene = soup_pair(n_tris)
    o, d, tmax = soup_rays(tscene, n_tris, kind)
    want = np.asarray(jip.trace_any(jscene, jnp.asarray(o), jnp.asarray(d), 1e-4,
                                    jnp.asarray(tmax), interpret=True))
    plain = tik.trace_any_reference(tscene, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                                    torch.as_tensor(tmax)).numpy()
    np.testing.assert_array_equal(plain, want)
    valid = verdicts(tscene, o, d, tmax)
    live = tik.live_rays(torch.as_tensor(d), 1e-4, torch.as_tensor(tmax)).numpy()
    np.testing.assert_array_equal(valid.any(1) & live, want)
    if kind == "dead":
        assert not live.any()
    if kind == "occluded":
        assert want.all()
    n_tiles = -(-n_tris // tik.TILE)
    for lanes in (256, 37):  # a full block, and one that refills many times
        for start in range(n_tiles):
            m = tik.ring_occlusion_model(valid, live, lanes=lanes, start_tile=start)
            np.testing.assert_array_equal(m["occluded"], want)
            assert (m["start"][~live] == -1).all() and (m["tiles"][~live] == 0).all()
            assert ((m["start"][live] >= 0) & (m["start"][live] < n_tiles)).all()
            # a ray ends at the first tile, in ring order from its start, that
            # holds a blocker, or after one full ring
            for i in np.nonzero(live)[0]:
                order = [(m["start"][i] + k) % n_tiles for k in range(n_tiles)]
                hits = [valid[i, t * tik.TILE:(t + 1) * tik.TILE].any() for t in order]
                assert m["tiles"][i] == (hits.index(True) + 1 if any(hits) else n_tiles)
                assert m["slots"][i] == sum(min(tik.TILE, n_tris - t * tik.TILE)
                                            for t in order[:m["tiles"][i]])
            if not live.any():
                assert m["block_tiles"] == 0


def test_queue_model_dead_outputs_equal_plain():
    _, tscene = soup_pair(513)
    o, d, tmax = soup_rays(tscene, 513, "mixed")
    tmax[7::11] = 1e-4  # an empty window: t_max == t_min
    o_t, d_t, tmax_t = torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)
    live = tik.live_rays(d_t, 1e-4, tmax_t)
    assert 0 < int(live.sum()) < N_RAYS and not bool(live[7::11].any())
    want = tik.trace_closest_reference(tscene, o_t, d_t, 1e-4, tmax_t)
    queue, dead = tik.queue_model(o_t, d_t, 1e-4, tmax_t, 513, occlusion=False)
    assert torch.equal(queue, torch.nonzero(live).reshape(-1))  # each live ray once, in order
    assert torch.equal(dead["index"], torch.nonzero(~live).reshape(-1))
    for k, v in want.items():
        got, exp = dead[k], v[dead["index"]]
        if got.dtype == torch.float32:
            got, exp = got.view(torch.int32), exp.view(torch.int32)
        assert torch.equal(got, exp), k
    queue, dead = tik.queue_model(o_t, d_t, 1e-4, tmax_t, 513, occlusion=True)
    assert not bool(dead["occluded"].any())
    assert not bool(tik.trace_any_reference(tscene, o_t, d_t, 1e-4, tmax_t)[dead["index"]].any())
    # no triangle to test: every ray is dead
    queue, dead = tik.queue_model(o_t, d_t, 1e-4, tmax_t, 0, occlusion=True)
    assert len(queue) == 0 and len(dead["index"]) == N_RAYS


@pytest.mark.parametrize("occlusion", [False, True])
def test_sweep_figures(occlusion):
    _, tscene = soup_pair(513)
    o, d, tmax = soup_rays(tscene, 513, "mixed")
    o_t, d_t, tmax_t = torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)
    work = tik.sweep_work(tscene, o_t, d_t, 1e-4, tmax_t, occlusion, slice_rays=200)
    live = work["live"].numpy()
    valid = verdicts(tscene, o, d, tmax)
    if occlusion:
        first = np.where(valid.any(1), valid.argmax(1) + 1, 513)
        np.testing.assert_array_equal(work["pairs"].numpy(), np.where(live, first, 0))
        np.testing.assert_array_equal(work["tile_hits"].numpy()[:, 2], valid[:, 512:].any(1))
    else:
        np.testing.assert_array_equal(work["pairs"].numpy(), np.where(live, 513, 0))
    fig = tik.sweep_figures(work, 513)
    assert fig["live"] == live.sum() and fig["warps"] == N_RAYS // 32
    assert fig["live_share"] == pytest.approx(live.mean())
    assert fig["warp_max_over_mean"] >= 1.0
    assert fig["pairs"] == work["pairs"].sum()
    # packed warps never hold more lane slots than the warps of the index order
    assert 0.0 < fig["predicted_ratio"] <= 1.0
    if occlusion:  # the ring's slots: every ray from each start tile in turn, averaged
        hits = valid[live]
        slots = np.mean([tik.ring_occlusion_model(hits, np.ones(len(hits), bool),
                                                  lanes=len(hits), start_tile=s)["slots"].sum()
                         for s in range(3)])
        assert fig["queue_slots"] == pytest.approx(slots)


@pytest.mark.parametrize("kind", ["five", "instanced:1"])
def test_walk2_per_ray_counts_and_warp_costs(kind):
    jscene, tscene = both(kind)
    tl_np = {k: v.numpy() for k, v in tscene["tlas"].items()}
    o, d = rays_for("five" if kind == "five" else "instanced:2", 8)
    got, counts = tt2.fat_walk2_numpy(tl_np, o, d, 1e-4, 3.0e37)
    want = jt2.traverse2_fat_closest(jscene["tlas"], jnp.asarray(o), jnp.asarray(d), 1e-4, 3.0e37,
                                     leaf_size=32, interpret=True)
    tri = np.where(got["hit"], tl_np["slot_tri"][np.maximum(got["slot"], 0)], -1)
    assert_hits_equal(dict(got, tri=tri), want)
    tmax = np.where(np.arange(len(o)) % 2 == 0, 3.0e37, 7.5).astype(np.float32)
    d_any = d.copy()
    d_any[::7] = 0.0
    occ, occ_counts = tt2.fat_walk2_numpy(tl_np, o, d_any, 1e-4, tmax, occlusion=True)
    occ_want = np.asarray(jt2.traverse2_fat_any(jscene["tlas"], jnp.asarray(o),
                                                jnp.asarray(d_any), 1e-4, jnp.asarray(tmax),
                                                leaf_size=32, interpret=True))
    np.testing.assert_array_equal(occ["occluded"], occ_want)
    for c, live in ((counts, None), (occ_counts, np.abs(d_any).sum(1) > 0)):
        per = c["per_ray"]
        for k in ("tlas_visits", "instance_entries", "blas_visits", "pair_tests"):
            assert int(per[k].sum()) == c[k], k
        np.testing.assert_array_equal(per["blas_after_tlas"].sum(1), per["blas_visits"])
        # no BLAS visit after a TLAS visit the ray has not made
        cols = np.arange(per["blas_after_tlas"].shape[1])
        assert not per["blas_after_tlas"][cols[None, :] >= per["tlas_visits"][:, None]].any()
        w = tt2.warp_costs(per, live)
        assert (w["single"] <= w["nested"]).all()
        if kind == "five" and live is None:  # rays that enter two instances wait less
            assert (w["single"] < w["nested"]).any()
        assert (w["lane_visits"] <= 32 * w["single"]).all()
        assert int(w["lane_visits"].sum()) == c["tlas_visits"] + c["blas_visits"]
        if live is not None:
            assert w["dead_share"] == pytest.approx(1.0 - live.mean())
            assert w["single_queued"].sum() <= w["single"].sum()
            assert not per["tlas_visits"][~live].any()  # a dead ray makes no visit
