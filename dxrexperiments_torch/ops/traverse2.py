"""Two-level TLAS/BLAS traversal: the wrappers of the fat walk (B6a) and the
binary walk (B6b) and host models of the walks.

Port of ``dxrexperiments_tpu.ops.traverse2_pallas``'s kernels
``_make_traverse2_fat_kernel`` (``traverse2_fat_closest``,
``traverse2_fat_any``) and ``_make_traverse2_kernel`` (``traverse2_closest``,
``traverse2_any``). On CUDA tensors the wrappers launch the hand-written
kernels in ``csrc/traverse2_fat.cu`` and ``csrc/traverse2_binary.cu`` (one
thread per ray: a walk of the TLAS, and at each instance leaf the ray moved
into object space and a walk of that instance's BLAS) or raise; on CPU
tensors they take the plain versions, ``accel/tlas.two_level_closest_reference``
and ``two_level_any_reference``, which test every instance's triangles.
There is no fallback from a kernel to its plain version.

A stack overflow or an index outside the arrays sets the launch's error
flag, which ``ops/kernel.check_errors`` reads later, as for B4a. Each
launch is a ``B6a.launch`` or ``B6b.launch`` span (``ops/kernel``; n: the
rays), inside the integrator's ``wavefront.trace``.

``fat_walk2_numpy`` and ``binary_walk2_numpy`` are host models of the
kernels' walks (B6b's is the JAX kernel's binary walk): they return the
same hits and count the TLAS visits, instance entries, BLAS visits and
pair tests, from which ``chip_smoke.py`` computes the kernels' bounds.
``warp_costs`` (node visits) and ``turn_costs`` (each turn weighed by its
leaf tests; with leaf postponement, the rounds that
``ops/traverse.held_walk`` logs) are the warp models of the walks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel.tlas import two_level_any_reference, two_level_closest_reference
from . import kernel
from .traverse import (
    COEF_LANES,
    MAX_STACK,
    REC_WORDS,
    WARP,
    RayStacks,
    TurnLog,
    WalkState,
    binary_visit,
    check_records,
    check_rows,
    distinct,
    fat_visit,
    pack_rays,
    safe_inv,
    walk_kernel,
)

TLAS_STACK = 64  # per-ray TLAS stack entries (traverse2_pallas.TLAS_STACK)

# kind -> (its kernel, the rows the walk reads and their widths, the
# instance row column of the BLAS root)
WALKS = {
    "fat": (walk_kernel("B6a", "traverse2_fat", 5, 7, 8),
            {"tlasf_rows": 16, "inst_rows_t": 16, "blasf_rows": 16, "blas_test": REC_WORDS}, 15),
    "binary": (walk_kernel("B6b", "traverse2_binary", 5, 7, 8),
               {"tlas_rows": 8, "inst_rows_t": 16, "blas_rows": 8, "blas_test": REC_WORDS}, 12),
}


def check_tlas(tl: dict, device, kind: str = "fat") -> tuple[torch.Tensor, ...]:
    """Walk ``kind``'s two-level inputs, checked (``ops/traverse.check_rows``):
    (tlasf_rows [Ft, 16], inst_rows_t [I, 16], blasf_rows [Fb, 16],
    blas_test [S, 20]) for the fat walk, (tlas_rows [Mt, 8], inst_rows_t,
    blas_rows [Mb, 8], blas_test) for the binary one. blas_test, the BLAS
    leaf slots' records (``ops/traverse.coef_records`` of mt_rows), is
    built with the rest by ``accel/tlas.build_two_level`` and
    ``scene_from_numpy``; a hand-built tlas dict needs it, one row per
    mt_rows row (``ops/traverse.check_records``)."""
    names = dict(WALKS[kind][1])
    del names["blas_test"]
    return (*check_rows(tl, names, device), check_records(tl, "blas_test", device))


def prepare_launch(tl, origins, directions, t_min, t_max, cull: bool, occlusion: bool,
                   kind: str = "fat", lib=None):
    """Pack the rays and allocate the outputs of one launch of walk ``kind``
    (WALKS: "fat" B6a, "binary" B6b). Returns (launch, outs, err):
    ``launch()`` enqueues the kernel and returns the CUDA error code; outs
    is (occ,) or (t, slot, u, v, inst). Timing ``launch`` alone measures the kernel without
    the wrapper's packing. ``lib``: another build of the walk's source,
    bound (``WALKS[kind][0].bind``)."""
    device = origins.device
    tlas, inst, blas, rows = check_tlas(tl, device, kind)
    rays = pack_rays(origins, directions, t_min, t_max)
    r = rays.shape[0]
    err = torch.zeros(1, dtype=torch.int32, device=device)
    if occlusion:
        outs = (torch.empty(r, dtype=torch.bool, device=device),)
        ptrs = (None,) * 5 + (outs[0].data_ptr(),)
    else:
        outs = (torch.empty(r, dtype=torch.float32, device=device),
                torch.empty(r, dtype=torch.int32, device=device),
                torch.empty(r, dtype=torch.float32, device=device),
                torch.empty(r, dtype=torch.float32, device=device),
                torch.empty(r, dtype=torch.int32, device=device))
        ptrs = (*(o.data_ptr() for o in outs), None)
    walk = WALKS[kind][0]
    fn = getattr(lib or walk.library(), f"dxr_{walk.source}")

    def launch() -> int:
        return kernel.on_stream(fn, device, rays.data_ptr(), tlas.data_ptr(), inst.data_ptr(),
                                blas.data_ptr(), rows.data_ptr(), r, tlas.shape[0],
                                inst.shape[0], blas.shape[0], rows.shape[0], int(occlusion),
                                int(cull), *ptrs, err.data_ptr())

    return launch, outs, err


def _launch(tl, origins, directions, t_min, t_max, cull: bool, occlusion: bool,
            kind: str = "fat"):
    launch, outs, err = prepare_launch(tl, origins, directions, t_min, t_max, cull, occlusion,
                                       kind)
    walk = WALKS[kind][0]
    walk.run(launch, walk.counters[int(occlusion)], n=int(origins.shape[0]), err=err)
    if occlusion:
        return outs[0]
    t, slot, u, v, inst = outs
    hit = slot >= 0
    tri = torch.where(hit, tl["slot_tri"][slot.clamp(min=0).long()], -1).long()
    return {"hit": hit, "t": t, "tri": tri, "slot": slot.long(), "u": u, "v": v,
            "inst": inst.long()}


def traverse2_fat_closest(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                          t_min=1e-4, t_max=3.0e37, cull_backface: bool = False) -> dict:
    """Closest hit through the scene's fat TLAS and BLAS (kernel B6a):
    {"hit" [R] bool, "t" [R] (-1 on a miss), "tri" [R] int64 (concatenated
    object-space triangle, -1), "slot" [R] int64 (BLAS leaf slot, -1), "u",
    "v" [R] (0 on a miss), "inst" [R] int64 (sorted instance slot, -1; map
    it through tlas["inst_orig"] for the user's instance index)}.
    t_min/t_max: scalars or [R]. CUDA rays -> one kernel launch; CPU rays ->
    the plain version."""
    if kernel.on_card(origins.device):
        return _launch(scene["tlas"], origins, directions, t_min, t_max, cull_backface, False)
    return two_level_closest_reference(scene, origins, directions, t_min, t_max, cull_backface)


def traverse2_fat_any(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                      t_min=1e-4, t_max=3.0e37) -> torch.Tensor:
    """Occlusion through the two-level structure's fat nodes (kernel B6a):
    [R] bool, True where a triangle of any instance blocks (t_min, t_max).
    Zero-direction rays are not occluded. CUDA rays -> one kernel launch;
    CPU rays -> the plain version."""
    if kernel.on_card(origins.device):
        return _launch(scene["tlas"], origins, directions, t_min, t_max, False, True)
    return two_level_any_reference(scene, origins, directions, t_min, t_max)


def traverse2_closest(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                      t_min=1e-4, t_max=3.0e37, cull_backface: bool = False) -> dict:
    """Closest hit through the binary TLAS and BLAS (``tlas_rows``,
    ``blas_rows``; kernel B6b), the route of a TLAS without fat nodes. Same
    keys as ``traverse2_fat_closest``; CPU rays take the same plain
    version."""
    if kernel.on_card(origins.device):
        return _launch(scene["tlas"], origins, directions, t_min, t_max, cull_backface, False,
                       "binary")
    return two_level_closest_reference(scene, origins, directions, t_min, t_max, cull_backface)


def traverse2_any(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                  t_min=1e-4, t_max=3.0e37) -> torch.Tensor:
    """Occlusion through the binary TLAS and BLAS (kernel B6b), as
    ``traverse2_fat_any``."""
    if kernel.on_card(origins.device):
        return _launch(scene["tlas"], origins, directions, t_min, t_max, False, True, "binary")
    return two_level_any_reference(scene, origins, directions, t_min, t_max)


def _walk2_numpy(kind: str, tl: dict, origins, directions, t_min, t_max, cull: bool,
                 occlusion: bool) -> tuple[dict, dict]:
    """The two-level walk of ``kind`` ("fat": fat_visit on tlasf_rows and
    blasf_rows, the BLAS root in instance column 15; "binary": binary_visit
    on tlas_rows and blas_rows, the root in column 12)."""
    tname, _, bname = list(WALKS[kind][1])[:3]
    root_col = WALKS[kind][2]
    visit = fat_visit if kind == "fat" else binary_visit
    tnodes = np.asarray(tl[tname], np.float32)
    inst_rows = np.asarray(tl["inst_rows_t"], np.float32)
    bnodes = np.asarray(tl[bname], np.float32)
    o_w = np.asarray(origins, np.float32)
    d_w = np.asarray(directions, np.float32)
    r = len(o_w)
    state = WalkState(np.asarray(tl["mt_rows"], np.float32)[:, list(COEF_LANES)],
                      np.broadcast_to(np.asarray(t_min, np.float32), (r,)).copy(),
                      np.broadcast_to(np.asarray(t_max, np.float32), (r,)).copy(),
                      cull, occlusion)
    inv_w = safe_inv(d_w)
    # each ray's current instance (object-space ray and its terms)
    o2, d2, inv2, mom2 = o_w.copy(), d_w.copy(), inv_w.copy(), np.zeros_like(o_w)
    cur = np.full(r, -1, np.int64)
    inst = np.full(r, -1, np.int64)
    tst, bst = RayStacks(r, TLAS_STACK), RayStacks(r, MAX_STACK)
    pend = np.full((r, 2), -1, np.int64)  # instance leaves hit by the last TLAS visit
    entry_side = np.zeros(r, np.int64)  # the leaf child of the current BLAS walk
    entry_turns = np.zeros(r, np.int64)  # the current BLAS walk's turns so far
    live = np.ones(r, bool)
    if occlusion:
        live = np.abs(d_w).sum(axis=1) >= 1e-30
    c = {"tlas_visits": 0, "instance_entries": 0, "blas_visits": 0}
    seen = {"tlas_node_ids": [], "inst_ids": [], "blas_node_ids": []}
    # per ray: TLAS visits, instance entries, BLAS visits, and the BLAS
    # visits after each TLAS visit (column j: after the j-th)
    t_vis, entries, b_vis = (np.zeros(r, np.int64) for _ in range(3))
    b_after = np.zeros((r, 8), np.int64)
    log = TurnLog()

    def blas_leaf(idx, start, count, _side):
        w = state.leaf(idx, start, count, o2[idx], d2[idx], mom2[idx])
        inst[w] = cur[w]

    def tlas_leaf(idx, ptr, _count, side):
        pend[idx, side] = ptr

    # Each round moves every ray by one step of its own walk, in the
    # kernel's order: a ray inside an instance makes one BLAS visit; a ray
    # whose BLAS walk has ended enters its next pending instance; a ray with
    # neither makes one TLAS visit.
    with np.errstate(all="ignore"):  # slab tests overflow to +-inf on purpose
        tst.start(np.nonzero(live)[0], 0)
        while True:
            idx = np.nonzero(~state.occ & (bst.sp > 0))[0]
            if len(idx):
                c["blas_visits"] += len(idx)
                b_vis[idx] += 1
                b_after[idx, t_vis[idx] - 1] += 1
                before = state.ray_pairs[idx]
                seen["blas_node_ids"].append(
                    visit(idx, bnodes, o2, inv2, state, bst, blas_leaf))
                log.add(idx, 3 * (t_vis[idx] - 1) + 1 + entry_side[idx], entry_turns[idx],
                        state.ray_pairs[idx] - before)
                entry_turns[idx] += 1
            idx = np.nonzero(~state.occ & (bst.sp == 0) & (pend >= 0).any(1))[0]
            if len(idx):
                side = np.where(pend[idx, 0] >= 0, 0, 1)
                s_id = pend[idx, side]
                pend[idx, side] = -1
                row = inst_rows[s_id]
                a = row[:, 0:9].reshape(-1, 3, 3)
                o2[idx] = (a * o_w[idx, None, :]).sum(-1) + row[:, 9:12]
                d2[idx] = (a * d_w[idx, None, :]).sum(-1)
                mom2[idx] = np.cross(o2[idx], d2[idx])
                inv2[idx] = safe_inv(d2[idx])
                cur[idx] = s_id
                entry_side[idx] = side
                entry_turns[idx] = 0
                bst.start(idx, row[:, root_col].astype(np.int64))
                c["instance_entries"] += len(idx)
                entries[idx] += 1
                seen["inst_ids"].append(s_id)
            idx = np.nonzero(~state.occ & (bst.sp == 0) & (pend < 0).all(1) & (tst.sp > 0))[0]
            if len(idx):
                c["tlas_visits"] += len(idx)
                log.add(idx, 3 * t_vis[idx], 0, np.zeros(len(idx), np.int64))
                t_vis[idx] += 1
                if t_vis[idx].max() > b_after.shape[1]:
                    b_after = np.concatenate([b_after, np.zeros_like(b_after)], 1)
                seen["tlas_node_ids"].append(
                    visit(idx, tnodes, o_w, inv_w, state, tst, tlas_leaf))
            if not (~state.occ & ((bst.sp > 0) | (pend >= 0).any(1) | (tst.sp > 0))).any():
                break

    counts = dict(c, slab_tests=state.slabs, pair_tests=state.pairs,
                  slot_ids=distinct(state.slots_seen),
                  **{k: distinct(v) for k, v in seen.items()},
                  max_stack={"tlas": int(tst.deepest.max(initial=0)),
                             "blas": int(bst.deepest.max(initial=0))},
                  ray_depth={"tlas": tst.deepest, "blas": bst.deepest},
                  turns=log.arrays(),
                  per_ray={"tlas_visits": t_vis, "instance_entries": entries,
                           "blas_visits": b_vis, "pair_tests": state.ray_pairs,
                           "blas_after_tlas": b_after[:, :max(int(t_vis.max(initial=0)), 1)]})
    result = state.result()
    if not occlusion:
        result["inst"] = inst
    return result, counts


def fat_walk2_numpy(tl: dict, origins, directions, t_min, t_max, cull: bool = False,
                    occlusion: bool = False) -> tuple[dict, dict]:
    """Host model of B6a's per-ray walk over ``tlasf_rows``,
    ``inst_rows_t``, ``blasf_rows`` and ``mt_rows`` (numpy arrays): the TLAS
    walk of ``ops/traverse.fat_walk_numpy``, where a hit instance leaf (meta
    1) is entered at once, child 0 before child 1 and before the node's
    pushes: the ray moves into object space (o' = A o + b, d' = A d) and
    walks the instance's BLAS from its fat root with the same rules, the
    running best t pruning both levels. Occlusion ends at the first hit;
    zero-direction occlusion rays are dead.

    Returns (result, counts): result {"hit", "t", "slot", "u", "v", "inst"}
    or {"occluded"}; counts {"tlas_visits", "instance_entries",
    "blas_visits", "slab_tests", "pair_tests", "tlas_node_ids",
    "inst_ids", "blas_node_ids", "slot_ids", "max_stack", "ray_depth",
    "turns", "per_ray"} (the distinct TLAS nodes, instances, BLAS nodes and
    leaf slots touched; the deepest stack of each level, of any ray and per
    ray; each ray's loop turns (``ops/traverse.TurnLog``: 3 j for its j-th
    TLAS turn, 3 j + 1 + side for the BLAS walk entered there); the per-ray
    counts ``warp_costs`` reads)."""
    return _walk2_numpy("fat", tl, origins, directions, t_min, t_max, cull, occlusion)


def binary_walk2_numpy(tl: dict, origins, directions, t_min, t_max, cull: bool = False,
                       occlusion: bool = False) -> tuple[dict, dict]:
    """Host model of the JAX kernel's per-ray binary two-level walk over
    ``tlas_rows``, ``inst_rows_t``, ``blas_rows`` and ``mt_rows`` (numpy
    arrays): ``ops/traverse.binary_visit`` on the TLAS, where a hit instance
    leaf is entered at once and its BLAS walked from the instance's binary
    root (column 12) with the same rules. Returns what ``fat_walk2_numpy``
    returns (one slab test per visit)."""
    return _walk2_numpy("binary", tl, origins, directions, t_min, t_max, cull, occlusion)


def warp_costs(per_ray: dict, live=None, warp: int = 32) -> dict:
    """Warp costs of a two-level walk from the host model's per-ray counts
    (``fat_walk2_numpy``'s ``counts["per_ray"]``), in node visits, over the
    warps of ``warp`` consecutive rays:

    - "nested" [W]: a TLAS walk whose leaf visit walks a BLAS, where the
      warp runs its TLAS iterations together and each waits for the lane
      with the most BLAS visits: the sum over TLAS iterations j of (1 + the
      warp's most BLAS visits after the j-th TLAS visit);
    - "single" [W]: one loop over both levels, where each lane visits one
      node of its own level a turn: the lane with the most visits;
    - "lane_visits" [W]: the visits the warp's rays make;
    - with ``live`` [R] bool (the rays that can hit), "single_queued" [W']:
      the single loop over warps of the live rays alone, packed in order
      (a queue of live rays), and "dead_share", the dead rays' share.

    The single loop's cost is never above the nested one's."""
    t = np.asarray(per_ray["tlas_visits"], np.int64)
    b = np.asarray(per_ray["blas_after_tlas"], np.int64)
    r = len(t)
    n_w = -(-r // warp)
    pad = n_w * warp - r
    tw = np.concatenate([t, np.zeros(pad, np.int64)]).reshape(n_w, warp)
    bw = np.concatenate([b, np.zeros((pad, b.shape[1]), np.int64)]).reshape(n_w, warp, -1)
    total = tw + bw.sum(2)
    out = {"nested": tw.max(1) + bw.max(1).sum(1), "single": total.max(1),
           "lane_visits": total.sum(1)}
    if live is not None:
        live = np.asarray(live, bool)
        packed = (t + b.sum(1))[live]
        n_q = -(-len(packed) // warp)
        packed = np.concatenate([packed, np.zeros(n_q * warp - len(packed), np.int64)])
        out["single_queued"] = packed.reshape(n_q, warp).max(1)
        out["dead_share"] = 1.0 - float(live.mean()) if r else 0.0
    return out


def turn_costs(turns: dict, n_rays: int, c_slab: float = 1.0, c_pair: float = 1.0) -> dict:
    """Leaf-weighted warp costs of a walk from its turn log (the host
    models' ``counts["turns"]``, ``ops/traverse.TurnLog``) over the warps
    of ``ops/traverse.WARP`` consecutive rays of the ``n_rays`` walked. A warp runs each
    loop turn once for all its lanes and each lane's turn costs one visit
    (c_slab) plus its leaf's pair tests (c_pair each), so a turn costs the
    warp c_slab + c_pair x its largest pair tests: a lane testing a leaf
    holds up the rest, and lanes testing leaves in different turns are paid
    for in turn. The lanes of a nested walk line up loop by loop (the
    ``loop`` key): a TLAS turn, then each BLAS walk entered at it.

    Returns per warp [W]: "turns" (loop turns), "pair_slots" (Σ over turns
    of the largest pair tests), "pairs" (the pair tests its lanes make),
    "cost" = c_slab turns + c_pair pair_slots (= Σ over turns of the
    warp's largest c_slab + c_pair pair tests). For a walk with leaf
    postponement (``parent_walk_numpy(..., postpone=True)``, whose log holds
    its warps' rounds), also "postponed_turns" (its traversal rounds), "postponed_slots" (Σ over its
    leaf phases of the largest held leaf's pair tests) and
    "postponed_cost"; the leaves and their order are unchanged."""
    ray, loop, turn, pairs = (np.asarray(turns[k], np.int64)
                              for k in ("ray", "loop", "turn", "pairs"))
    n_w = -(-n_rays // WARP)
    w = ray // WARP
    keys, inv = np.unique(np.stack([w, loop, turn]), axis=1, return_inverse=True)
    inv = inv.reshape(-1)
    top = np.zeros(keys.shape[1], np.int64)
    np.maximum.at(top, inv, pairs)
    out = {"turns": np.bincount(keys[0], minlength=n_w),
           "pair_slots": np.bincount(keys[0], weights=top, minlength=n_w).astype(np.int64),
           "pairs": np.bincount(w, weights=pairs, minlength=n_w).astype(np.int64)}
    out["cost"] = c_slab * out["turns"] + c_pair * out["pair_slots"]
    if "rounds" in turns:
        rd = turns["rounds"]
        p_turns = np.bincount(rd["warp"], weights=rd["traversal"], minlength=n_w).astype(np.int64)
        p_slots = np.bincount(rd["warp"], weights=rd["slots"], minlength=n_w).astype(np.int64)
        out.update(postponed_turns=p_turns, postponed_slots=p_slots,
                   postponed_cost=c_slab * p_turns + c_pair * p_slots)
    return out
