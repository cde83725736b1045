"""Two-level TLAS/BLAS traversal: the wrappers of the fat walk (B6a) and the
binary walk (B6b), the launch counts and host models of the walks.

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
flag, which ``ops.traverse.check_errors`` reads later, as for B4a.

``fat_walk2_numpy`` and ``binary_walk2_numpy`` are host models of the
kernels' walks: they return the same hits and count the TLAS visits,
instance entries, BLAS visits and pair tests, from which ``chip_smoke.py``
computes the kernels' bounds.
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
    binary_visit,
    check_rows,
    distinct,
    fat_visit,
    pack_rays,
    queue_error_check,
    safe_inv,
)

TLAS_STACK = 64  # per-ray TLAS stack entries (traverse2_pallas.TLAS_STACK)

# Kernel launches so far, one per traced batch: B6a (fat) and B6b (binary).
# Callers reset them to 0 and read them back to show that a run went through
# the kernel.
CLOSEST_LAUNCHES = 0
ANY_LAUNCHES = 0
BINARY_CLOSEST_LAUNCHES = 0
BINARY_ANY_LAUNCHES = 0

# kind -> (library and source name, C entry point, the rows the walk reads
# and their widths, the instance row column of the BLAS root, (closest, any)
# launch counters)
WALKS = {
    "fat": ("traverse2_fat", "dxr_traverse2_fat",
            {"tlasf_rows": 16, "inst_rows_t": 16, "blasf_rows": 16, "mt_rows": 128}, 15,
            ("CLOSEST_LAUNCHES", "ANY_LAUNCHES")),
    "binary": ("traverse2_binary", "dxr_traverse2_binary",
               {"tlas_rows": 8, "inst_rows_t": 16, "blas_rows": 8, "mt_rows": 128}, 12,
               ("BINARY_CLOSEST_LAUNCHES", "BINARY_ANY_LAUNCHES")),
}

_LIBS: dict = {}


def _library(kind: str = "fat"):
    """The C entry point of walk ``kind`` (WALKS), built at first use."""
    if kind not in _LIBS:
        from ..utils.cuda_build import load_library

        name, entry = WALKS[kind][:2]
        fn = getattr(load_library(name, [f"{name}.cu"]), entry)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 8
        fn.restype = ctypes.c_int
        _LIBS[kind] = fn
    return _LIBS[kind]


def check_tlas(tl: dict, device, kind: str = "fat") -> tuple[torch.Tensor, ...]:
    """Walk ``kind``'s two-level inputs, checked (``ops/traverse.check_rows``):
    (tlasf_rows [Ft, 16], inst_rows_t [I, 16], blasf_rows [Fb, 16], mt_rows
    [S, 128]) for the fat walk, (tlas_rows [Mt, 8], inst_rows_t, blas_rows
    [Mb, 8], mt_rows) for the binary one."""
    return check_rows(tl, WALKS[kind][2], device)


def prepare_launch(tl, origins, directions, t_min, t_max, cull: bool, occlusion: bool,
                   kind: str = "fat"):
    """Pack the rays and allocate the outputs of one launch of walk ``kind``
    (WALKS: "fat" B6a, "binary" B6b). Returns (launch, outs, err):
    ``launch()`` enqueues the kernel and returns the CUDA error code; outs
    is (occ,) or (t, slot, u, v, inst). Timing ``launch`` alone measures the
    kernel without the wrapper's packing."""
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
    fn = _library(kind)

    def launch() -> int:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            return fn(rays.data_ptr(), tlas.data_ptr(), inst.data_ptr(), blas.data_ptr(),
                      rows.data_ptr(), r, tlas.shape[0], inst.shape[0], blas.shape[0],
                      rows.shape[0], int(occlusion), int(cull), *ptrs, err.data_ptr(), stream)

    return launch, outs, err


def _launch(tl, origins, directions, t_min, t_max, cull: bool, occlusion: bool,
            kind: str = "fat"):
    name = WALKS[kind][0]
    launch, outs, err = prepare_launch(tl, origins, directions, t_min, t_max, cull, occlusion,
                                       kind)
    rc = launch()
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    counter = WALKS[kind][4][int(occlusion)]
    globals()[counter] += 1
    with torch.cuda.device(origins.device):
        queue_error_check(err, f"{name} kernel")
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
    if _on_cuda(origins):
        return _launch(scene["tlas"], origins, directions, t_min, t_max, cull_backface, False)
    return two_level_closest_reference(scene, origins, directions, t_min, t_max, cull_backface)


def traverse2_fat_any(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                      t_min=1e-4, t_max=3.0e37) -> torch.Tensor:
    """Occlusion through the two-level structure's fat nodes (kernel B6a):
    [R] bool, True where a triangle of any instance blocks (t_min, t_max).
    Zero-direction rays are not occluded. CUDA rays -> one kernel launch;
    CPU rays -> the plain version."""
    if _on_cuda(origins):
        return _launch(scene["tlas"], origins, directions, t_min, t_max, False, True)
    return two_level_any_reference(scene, origins, directions, t_min, t_max)


def traverse2_closest(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                      t_min=1e-4, t_max=3.0e37, cull_backface: bool = False) -> dict:
    """Closest hit through the binary TLAS and BLAS (``tlas_rows``,
    ``blas_rows``; kernel B6b), the route of a TLAS without fat nodes. Same
    keys as ``traverse2_fat_closest``; CPU rays take the same plain
    version."""
    if _on_cuda(origins):
        return _launch(scene["tlas"], origins, directions, t_min, t_max, cull_backface, False,
                       "binary")
    return two_level_closest_reference(scene, origins, directions, t_min, t_max, cull_backface)


def traverse2_any(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                  t_min=1e-4, t_max=3.0e37) -> torch.Tensor:
    """Occlusion through the binary TLAS and BLAS (kernel B6b), as
    ``traverse2_fat_any``."""
    if _on_cuda(origins):
        return _launch(scene["tlas"], origins, directions, t_min, t_max, False, True, "binary")
    return two_level_any_reference(scene, origins, directions, t_min, t_max)


def _walk2_numpy(kind: str, tl: dict, origins, directions, t_min, t_max, cull: bool,
                 occlusion: bool) -> tuple[dict, dict]:
    """The two-level walk of ``kind`` ("fat": fat_visit on tlasf_rows and
    blasf_rows, the BLAS root in instance column 15; "binary": binary_visit
    on tlas_rows and blas_rows, the root in column 12)."""
    tname, _, bname = list(WALKS[kind][2])[:3]
    root_col = WALKS[kind][3]
    visit, slabs = (fat_visit, 2) if kind == "fat" else (binary_visit, 1)
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

    def tlas_leaf(idx, ptr, _count, side):
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
                    visit(idx, bnodes, o2, inv2, state, bstack, bsp, MAX_STACK, blas_leaf))
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
                bstack[idx, 0] = row[:, root_col].astype(np.int64)
                bsp[idx] = 1
                c["instance_entries"] += len(idx)
                seen["inst_ids"].append(s_id)
            idx = np.nonzero(~state.occ & (bsp == 0) & (pend < 0).all(1) & (tsp > 0))[0]
            if len(idx):
                c["tlas_visits"] += len(idx)
                seen["tlas_node_ids"].append(
                    visit(idx, tnodes, o_w, inv_w, state, tstack, tsp, TLAS_STACK, tlas_leaf))
            if not (~state.occ & ((bsp > 0) | (pend >= 0).any(1) | (tsp > 0))).any():
                break

    counts = dict(c, slab_tests=slabs * (c["tlas_visits"] + c["blas_visits"]),
                  pair_tests=state.pairs, slot_ids=distinct(state.slots_seen),
                  **{k: distinct(v) for k, v in seen.items()})
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
    "inst_ids", "blas_node_ids", "slot_ids"} (the last four: the distinct
    TLAS nodes, instances, BLAS nodes and leaf slots touched)."""
    return _walk2_numpy("fat", tl, origins, directions, t_min, t_max, cull, occlusion)


def binary_walk2_numpy(tl: dict, origins, directions, t_min, t_max, cull: bool = False,
                       occlusion: bool = False) -> tuple[dict, dict]:
    """Host model of B6b's per-ray walk over ``tlas_rows``, ``inst_rows_t``,
    ``blas_rows`` and ``mt_rows`` (numpy arrays): ``ops/traverse.binary_visit``
    on the TLAS, where a hit instance leaf is entered at once and its BLAS
    walked from the instance's binary root (column 12) with the same rules.
    Returns what ``fat_walk2_numpy`` returns (one slab test per visit)."""
    return _walk2_numpy("binary", tl, origins, directions, t_min, t_max, cull, occlusion)
