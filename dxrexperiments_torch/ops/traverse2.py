"""Two-level TLAS/BLAS traversal (B6a): the wrappers, the launch counts and a
host model of the walk.

Port of ``dxrexperiments_tpu.ops.traverse2_pallas``'s fat-node kernel
``_make_traverse2_fat_kernel`` (``traverse2_fat_closest``,
``traverse2_fat_any``). On CUDA tensors the wrappers launch the hand-written
kernel in ``csrc/traverse2_fat.cu`` (one thread per ray: a near-first walk
of the fat TLAS, and at each instance leaf the ray moved into object space
and a walk of that instance's BLAS) or raise; on CPU tensors they take the
plain versions, ``accel/tlas.two_level_closest_reference`` and
``two_level_any_reference``, which test every instance's triangles. There is
no fallback from the kernel to its plain version.

A stack overflow or an index outside the arrays sets the launch's error
flag, which ``ops.traverse.check_errors`` reads later, as for B4a.

``fat_walk2_numpy`` is a host model of the kernel's walk: it returns the
same hits and counts the TLAS visits, instance entries, BLAS visits and
pair tests, from which ``chip_smoke.py`` computes the kernel's bound.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..accel.tlas import two_level_any_reference, two_level_closest_reference
from .traverse import (
    COEF_LANES,
    MAX_STACK,
    WalkState,
    _on_cuda,
    check_rows,
    distinct,
    fat_visit,
    pack_rays,
    queue_error_check,
)

TLAS_STACK = 64  # per-ray TLAS stack entries (traverse2_pallas.TLAS_STACK)

# Kernel launches so far, one per traced batch. Callers reset them to 0 and
# read them back to show that a run went through the kernel.
CLOSEST_LAUNCHES = 0
ANY_LAUNCHES = 0

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from ..utils.cuda_build import load_library

        lib = load_library("traverse2_fat", ["traverse2_fat.cu"])
        lib.dxr_traverse2_fat.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 8)
        lib.dxr_traverse2_fat.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_tlas(tl: dict, device) -> tuple[torch.Tensor, ...]:
    """The kernel's two-level inputs, checked (``ops/traverse.check_rows``):
    (tlasf_rows [Ft, 16], inst_rows_t [I, 16], blasf_rows [Fb, 16],
    mt_rows [S, 128])."""
    if "tlasf_rows" not in tl:
        raise NotImplementedError(
            "a TLAS without fat nodes needs the binary two-level walk (kernel B6b, "
            "ROADMAP Queue B item 6)"
        )
    return check_rows(tl, {"tlasf_rows": 16, "inst_rows_t": 16, "blasf_rows": 16,
                           "mt_rows": 128}, device)


def prepare_launch(tl, origins, directions, t_min, t_max, cull: bool, occlusion: bool):
    """Pack the rays and allocate the outputs of one B6a launch. Returns
    (launch, outs, err): ``launch()`` enqueues the kernel and returns the
    CUDA error code; outs is (occ,) or (t, slot, u, v, inst). Timing
    ``launch`` alone measures the kernel without the wrapper's packing."""
    device = origins.device
    tlas, inst, blas, rows = check_tlas(tl, device)
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
    lib = _library()

    def launch() -> int:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            return lib.dxr_traverse2_fat(
                rays.data_ptr(), tlas.data_ptr(), inst.data_ptr(), blas.data_ptr(),
                rows.data_ptr(), r, tlas.shape[0], inst.shape[0], blas.shape[0], rows.shape[0],
                int(occlusion), int(cull), *ptrs, err.data_ptr(), stream)

    return launch, outs, err


def _launch(tl, origins, directions, t_min, t_max, cull: bool, occlusion: bool):
    global CLOSEST_LAUNCHES, ANY_LAUNCHES
    launch, outs, err = prepare_launch(tl, origins, directions, t_min, t_max, cull, occlusion)
    rc = launch()
    if rc != 0:
        raise RuntimeError(f"traverse2_fat kernel launch failed: cudaError {rc}")
    if occlusion:
        ANY_LAUNCHES += 1
    else:
        CLOSEST_LAUNCHES += 1
    with torch.cuda.device(origins.device):
        queue_error_check(err, "traverse2_fat kernel")
    if occlusion:
        return outs[0]
    t, slot, u, v, inst = outs
    hit = slot >= 0
    tri = torch.where(hit, tl["slot_tri"][slot.clamp(min=0).long()], -1).long()
    return {"hit": hit, "t": t, "tri": tri, "slot": slot.long(), "u": u, "v": v,
            "inst": inst.long()}


def traverse2_fat_closest(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                          t_min=1e-4, t_max=3.0e37, cull_backface: bool = False) -> dict:
    """Closest hit through the scene's two-level structure: {"hit" [R] bool,
    "t" [R] (-1 on a miss), "tri" [R] int64 (concatenated object-space
    triangle, -1), "slot" [R] int64 (BLAS leaf slot, -1), "u", "v" [R] (0 on
    a miss), "inst" [R] int64 (sorted instance slot, -1; map it through
    tlas["inst_orig"] for the user's instance index)}. t_min/t_max: scalars
    or [R]. CUDA rays -> one kernel launch; CPU rays -> the plain version."""
    if _on_cuda(origins):
        return _launch(scene["tlas"], origins, directions, t_min, t_max, cull_backface, False)
    return two_level_closest_reference(scene, origins, directions, t_min, t_max, cull_backface)


def traverse2_fat_any(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                      t_min=1e-4, t_max=3.0e37) -> torch.Tensor:
    """Occlusion through the two-level structure: [R] bool, True where a
    triangle of any instance blocks (t_min, t_max). Zero-direction rays are
    not occluded. CUDA rays -> one kernel launch; CPU rays -> the plain
    version."""
    if _on_cuda(origins):
        return _launch(scene["tlas"], origins, directions, t_min, t_max, False, True)
    return two_level_any_reference(scene, origins, directions, t_min, t_max)


def fat_walk2_numpy(tl: dict, origins, directions, t_min, t_max, cull: bool = False,
                    occlusion: bool = False) -> tuple[dict, dict]:
    """Host model of the kernel's per-ray walk over ``tlasf_rows``,
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
    "inst_ids", "blas_node_ids", "slot_ids"} (the last four: the distinct
    TLAS nodes, instances, BLAS nodes and leaf slots touched)."""
    tnodes = np.asarray(tl["tlasf_rows"], np.float32)
    inst_rows = np.asarray(tl["inst_rows_t"], np.float32)
    bnodes = np.asarray(tl["blasf_rows"], np.float32)
    o_w = np.asarray(origins, np.float32)
    d_w = np.asarray(directions, np.float32)
    r = len(o_w)
    state = WalkState(np.asarray(tl["mt_rows"], np.float32)[:, list(COEF_LANES)],
                      np.broadcast_to(np.asarray(t_min, np.float32), (r,)).copy(),
                      np.broadcast_to(np.asarray(t_max, np.float32), (r,)).copy(),
                      cull, occlusion)

    def safe_inv(d):
        return (1.0 / np.where(np.abs(d) > 1e-12, d, np.float32(1e-12))).astype(np.float32)

    inv_w = safe_inv(d_w)
    # each ray's current instance (object-space ray and its terms)
    o2, d2, inv2, mom2 = o_w.copy(), d_w.copy(), inv_w.copy(), np.zeros_like(o_w)
    cur = np.full(r, -1, np.int64)
    inst = np.full(r, -1, np.int64)
    tstack = np.zeros((r, TLAS_STACK), np.int64)
    tsp = np.ones(r, np.int64)
    bstack = np.zeros((r, MAX_STACK), np.int64)
    bsp = np.zeros(r, np.int64)
    pend = np.full((r, 2), -1, np.int64)  # instance leaves hit by the last TLAS visit
    if occlusion:
        tsp[np.abs(d_w).sum(axis=1) < 1e-30] = 0
    c = {"tlas_visits": 0, "instance_entries": 0, "blas_visits": 0}
    seen = {"tlas_node_ids": [], "inst_ids": [], "blas_node_ids": []}

    def blas_leaf(idx, start, count, _side):
        w = state.leaf(idx, start, count, o2[idx], d2[idx], mom2[idx])
        inst[w] = cur[w]

    def tlas_leaf(idx, ptr, _meta, side):
        pend[idx, side] = ptr

    # Each round moves every ray by one step of its own walk, in the
    # kernel's order: a ray inside an instance makes one BLAS visit; a ray
    # whose BLAS walk has ended enters its next pending instance; a ray with
    # neither makes one TLAS visit.
    with np.errstate(all="ignore"):  # slab tests overflow to +-inf on purpose
        while True:
            idx = np.nonzero(~state.occ & (bsp > 0))[0]
            if len(idx):
                c["blas_visits"] += len(idx)
                seen["blas_node_ids"].append(
                    fat_visit(idx, bnodes, o2, inv2, state, bstack, bsp, MAX_STACK, blas_leaf))
            idx = np.nonzero(~state.occ & (bsp == 0) & (pend >= 0).any(1))[0]
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
                bstack[idx, 0] = row[:, 15].astype(np.int64)
                bsp[idx] = 1
                c["instance_entries"] += len(idx)
                seen["inst_ids"].append(s_id)
            idx = np.nonzero(~state.occ & (bsp == 0) & (pend < 0).all(1) & (tsp > 0))[0]
            if len(idx):
                c["tlas_visits"] += len(idx)
                seen["tlas_node_ids"].append(
                    fat_visit(idx, tnodes, o_w, inv_w, state, tstack, tsp, TLAS_STACK, tlas_leaf))
            if not (~state.occ & ((bsp > 0) | (pend >= 0).any(1) | (tsp > 0))).any():
                break

    counts = dict(c, slab_tests=2 * (c["tlas_visits"] + c["blas_visits"]),
                  pair_tests=state.pairs, slot_ids=distinct(state.slots_seen),
                  **{k: distinct(v) for k, v in seen.items()})
    result = state.result()
    if not occlusion:
        result["inst"] = inst
    return result, counts
