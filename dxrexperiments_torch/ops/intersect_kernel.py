"""Brute-force trace kernels (B3): the wrappers and the plain versions.

Port of ``dxrexperiments_tpu.ops.intersect_pallas`` (``_closest_kernel``,
``_any_kernel``; ``trace_closest``, ``trace_any``). ``trace_closest``
returns the hit with its attributes fused, as the JAX function does: hit,
t, tri, u, v, the unit shading normal, the position o + t d, mat_id and the
eight material fields. ``trace_any`` returns the occlusion flags.

On CUDA tensors both launch the hand-written kernels in
``csrc/intersect_brute.cu`` or raise; on CPU tensors they take the plain
versions, ``trace_closest_reference`` and ``trace_any_reference``: the
brute-force sweep of ``ops/intersect.py`` plus the integrator's attribute
gather (vertex normals by triangle, material rows by material id). There is
no fallback from a kernel to its plain version.

A miss gives what the kernel writes: t = -1, tri = -1, the position o - d
and zeros elsewhere. The kernel's t, u and v are the sweep's own (ts / |det|),
where the plain version recomputes them on the winner by classic
Möller–Trumbore, so the two agree to the hit gate, not bit for bit.

Scalar windows travel as launch arguments: a trace with a scalar t_min or
t_max copies nothing to the card (a per-frame host-to-card copy makes the
host wait for the card). A launch is two kernels: the first writes the dead
rays' outputs (an empty window or a zero direction) and queues the live ones
on the card, the second sweeps the queue; the kernels stage the scene's
``tri_records`` (``Scene.build`` builds them for flat scenes up to 4,096
rows; for a larger one, forced flat, the wrapper builds them at each trace).

Host models of the kernels' order rules and of where their lanes idle sit at
the end: ``queue_model``, ``ring_occlusion_model``, ``sweep_work`` and
``sweep_figures``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import vecmath as vm
from . import intersect, kernel
from .traverse import REC_WORDS, tri_records

MATERIAL_KEYS = ("albedo", "specular", "emissive", "emissive_strength", "reflectivity",
                 "roughness", "ior", "type")
# the closest kernel's outputs, each field one contiguous block: scalars
# [7, R], 3-vectors [5, R, 3] and ids [3, R] int64
SCALARS = ("t", "u", "v", "emissive_strength", "reflectivity", "roughness", "ior")
VECTORS = ("normal", "position", "albedo", "specular", "emissive")
IDS = ("tri", "mat_id", "type")

# int32 words ahead of the live-ray queue in its scratch (csrc/intersect_brute.cu
# kQueueHead: the live count and the persistent grid's cursor)
QUEUE_HEAD = 2

_WINDOW = [ctypes.c_void_p] * 4 + [ctypes.c_float] * 2
B3 = kernel.Kernel("B3", "intersect_brute", {
    "dxr_intersect_closest": _WINDOW + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 5,
    "dxr_intersect_any": _WINDOW + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
}, ("B3 closest", "B3 any"))


def trace_closest_reference(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                            t_min=intersect.RAY_EPSILON, t_max=intersect.RAY_MAX_T,
                            cull_backface: bool = False) -> dict:
    """Plain version of ``trace_closest``: ``intersect.intersect_closest``
    and the attribute gather of the hit triangle and its material."""
    hits = intersect.intersect_closest(scene, origins, directions, t_min, t_max,
                                       cull_backface=cull_backface)
    hit = hits["hit"]
    tri = hits["tri"].clamp(min=0)
    u, v = hits["u"], hits["v"]
    w = 1.0 - u - v
    n = (w[:, None] * scene["n0"][tri] + u[:, None] * scene["n1"][tri]
         + v[:, None] * scene["n2"][tri])
    mid = torch.where(hit, scene["mat_id"][tri], 0)
    out = dict(hits, normal=torch.where(hit[:, None], vm.normalize(n), 0.0),
               position=origins + hits["t"][:, None] * directions, mat_id=mid)
    for k in MATERIAL_KEYS:
        val = scene["materials"][k][mid]
        out[k] = torch.where(hit.reshape(-1, *[1] * (val.dim() - 1)), val, torch.zeros_like(val))
    return out


def trace_any_reference(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                        t_min=intersect.RAY_EPSILON, t_max=intersect.RAY_MAX_T) -> torch.Tensor:
    """Plain version of ``trace_any``: ``intersect.intersect_any``."""
    return intersect.intersect_any(scene, origins, directions, t_min, t_max)


def _window(x, r: int, device) -> tuple[torch.Tensor | None, float]:
    """A ray window for the kernel: (per-ray float32 [r] tensor, 0.0) or
    (None, the scalar). A scalar never becomes a device tensor, and a 0-d
    device tensor is broadcast on the card, not read back."""
    if not isinstance(x, torch.Tensor) or (x.dim() == 0 and x.device.type == "cpu"):
        return None, float(x)
    if x.dim() == 0:
        x = x.expand(r)
    if tuple(x.shape) != (r,) or x.device != device:
        raise ValueError(f"a per-ray window must be [{r}] on {device}, got "
                         f"{tuple(x.shape)} on {x.device}")
    return x.to(torch.float32).contiguous(), 0.0


def _rays(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"{name}: expected [R, 3], got {tuple(x.shape)}")
    return x.to(torch.float32).contiguous()


def _packs(scene: dict, device, attr: bool) -> tuple[torch.Tensor, ...]:
    """The scene's mt_pack [4, T, 16], its triangle records tri_records [T,
    20] (``ops/traverse.tri_records``; built here for a scene without them)
    and, for closest hits, attr_pack [32, T], checked."""
    mt = scene["mt_pack"]
    t_pad = int(mt.shape[1])
    rec = scene.get("tri_records")
    if rec is None and mt.dtype == torch.float32:
        rec = tri_records(mt)
    packs = [("mt_pack", mt, (4, t_pad, 16)), ("tri_records", rec, (t_pad, REC_WORDS))]
    if attr:
        packs.append(("attr_pack", scene["attr_pack"], (32, t_pad)))
    for name, t, shape in packs:
        if t is None or t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {None if t is None else t.dtype}")
        if tuple(t.shape) != shape or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 {shape} tensor on {device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if rec.data_ptr() % 16:
        raise ValueError("tri_records: expected a 16-byte aligned tensor")
    return tuple(p[1] for p in packs)


def prepare_launch(scene, origins, directions, t_min, t_max, cull: bool, occlusion: bool,
                   lib=None):
    """Check the inputs and allocate the outputs of one B3 launch. Returns
    (launch, outs, None): ``launch()`` enqueues the kernels (the live-ray
    queue, then the sweep) and returns the CUDA error code; outs is (occ,)
    or (scalars [7, R], vectors [5, R, 3], ids [3, R]); B3 has no error
    flag. Timing ``launch`` alone measures the kernels without the
    wrapper's checks and allocations. ``lib``: another build of the source,
    bound (``B3.bind``)."""
    device = origins.device
    o, d = _rays(origins, "origins"), _rays(directions, "directions")
    r = o.shape[0]
    if d.shape[0] != r or d.device != device:
        raise ValueError("origins and directions must be [R, 3] on one device")
    (tmin_t, tmin_s), (tmax_t, tmax_s) = _window(t_min, r, device), _window(t_max, r, device)
    mt, *packs = _packs(scene, device, not occlusion)  # the kernels read (rec[, attr])
    t_pad = int(mt.shape[1])
    t_count = min(int(scene.get("num_tris", t_pad)), t_pad)  # padding never hits
    lib = lib or B3.library()
    rays = (o, d, tmin_t, tmax_t)  # held by launch(): a timed relaunch reads them again
    queue = torch.empty(QUEUE_HEAD + r, dtype=torch.int32, device=device)
    if occlusion:
        outs = (torch.empty(r, dtype=torch.bool, device=device),)
        fn, tail = lib.dxr_intersect_any, (r, t_pad, t_count)
    else:
        outs = (torch.empty((len(SCALARS), r), dtype=torch.float32, device=device),
                torch.empty((len(VECTORS), r, 3), dtype=torch.float32, device=device),
                torch.empty((len(IDS), r), dtype=torch.int64, device=device))
        fn, tail = lib.dxr_intersect_closest, (r, t_pad, t_count, int(cull))

    def launch() -> int:
        return kernel.on_stream(fn, device, *(x.data_ptr() if x is not None else None
                                              for x in rays), tmin_s, tmax_s,
                                *(p.data_ptr() for p in packs), *tail, queue.data_ptr(),
                                *(x.data_ptr() for x in outs))

    return launch, outs, None


def _launch(scene, origins, directions, t_min, t_max, cull: bool, occlusion: bool):
    launch, outs, _ = prepare_launch(scene, origins, directions, t_min, t_max, cull, occlusion)
    r = int(origins.shape[0])
    if r:  # no rays, no launch
        B3.run(launch, "B3 any" if occlusion else "B3 closest", n=r)
    if occlusion:
        return outs[0]
    res = {k: x for names, block in zip((SCALARS, VECTORS, IDS), outs)
           for k, x in zip(names, block)}
    res["hit"] = res["tri"] >= 0
    return res


def trace_closest(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                  t_min=intersect.RAY_EPSILON, t_max=intersect.RAY_MAX_T,
                  cull_backface: bool = False) -> dict:
    """Closest hit of rays [R, 3] against every triangle of a brute-force
    scene, attributes fused: {"hit" [R] bool, "t" (-1 on a miss), "tri"
    int64 (-1), "u", "v", "normal" [R, 3], "position" [R, 3], "mat_id"
    int64, and the material fields (albedo, specular, emissive [R, 3];
    emissive_strength, reflectivity, roughness, ior [R]; type int64)}.
    t_min/t_max: Python scalars or [R] tensors. CUDA rays -> one launch of
    B3a; CPU rays -> the plain version."""
    if kernel.on_card(origins.device):
        return _launch(scene, origins, directions, t_min, t_max, cull_backface, False)
    return trace_closest_reference(scene, origins, directions, t_min, t_max, cull_backface)


def trace_any(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
              t_min=intersect.RAY_EPSILON, t_max=intersect.RAY_MAX_T) -> torch.Tensor:
    """Occlusion of rays [R, 3]: [R] bool, True where a triangle blocks
    (t_min, t_max); no culling. A zero direction is never occluded. CUDA
    rays -> one launch of B3b; CPU rays -> the plain version."""
    if kernel.on_card(origins.device):
        return _launch(scene, origins, directions, t_min, t_max, False, True)
    return trace_any_reference(scene, origins, directions, t_min, t_max)


# ---------------------------------------------------------------------------
# Host models of the kernels' order rules and of where their lanes idle
# ---------------------------------------------------------------------------

TILE = 256  # triangles a block stages at a time (csrc/intersect_brute.cu kTile)
WARP = 32


def live_rays(directions: torch.Tensor, t_min, t_max) -> torch.Tensor:
    """[R] bool: the rays B3 traces, the rest are dead (the queue kernel's
    rule): a non-empty window (t_max > t_min) and a non-zero direction."""
    r = directions.shape[0]
    tmin = intersect._ray_window(t_min, r, directions)
    tmax = intersect._ray_window(t_max, r, directions)
    return (tmax > tmin) & (directions.abs().sum(1) > 0)


def miss_outputs(origins: torch.Tensor, directions: torch.Tensor) -> dict:
    """What ``trace_closest`` gives a ray that hits nothing, as the kernels
    write it for a dead ray or a miss: t = -1, tri = -1, the position
    o - d, zeros elsewhere (``trace_closest``'s keys)."""
    r, dev = origins.shape[0], origins.device
    zero = torch.zeros(r, dtype=torch.float32, device=dev)
    out = {k: zero.clone() for k in SCALARS}
    out.update({k: torch.zeros((r, 3), dtype=torch.float32, device=dev) for k in VECTORS})
    out.update({k: torch.zeros(r, dtype=torch.int64, device=dev) for k in IDS})
    out["t"] = zero - 1.0
    out["tri"] = out["tri"] - 1
    out["position"] = origins + out["t"][:, None] * directions
    out["hit"] = torch.zeros(r, dtype=torch.bool, device=dev)
    return out


def queue_model(origins: torch.Tensor, directions: torch.Tensor, t_min, t_max,
                t_count: int, occlusion: bool) -> tuple[torch.Tensor, dict]:
    """Host model of B3's queue kernel (csrc/intersect_brute.cu
    queue_kernel): (queue, dead). queue [L] int64 holds the live rays
    (``live_rays``; none when t_count is 0), each warp's live lanes at
    consecutive slots in lane order; the card orders the warps as their
    atomics land, this model in index order. dead: the outputs the kernel
    writes for the dead rays, {"index": [D], and "occluded" (all False) or
    ``miss_outputs``' keys, [D] rows}."""
    live = live_rays(directions, t_min, t_max) & (t_count > 0)
    queue = torch.nonzero(live).reshape(-1)
    dead = torch.nonzero(~live).reshape(-1)
    if occlusion:
        return queue, {"index": dead, "occluded": torch.zeros(len(dead), dtype=torch.bool)}
    return queue, dict(miss_outputs(origins[dead], directions[dead]), index=dead)


def ring_occlusion_model(valid, live, lanes: int = 256, tile: int = TILE,
                         start_tile: int = 0) -> dict:
    """Host model of B3's occlusion sweep (csrc/intersect_brute.cu
    any_kernel) in one block of ``lanes`` lanes: the block streams the tiles
    of ``tile`` triangles round-robin from ``start_tile``; at each tile
    boundary every lane without a ray takes the next live ray of the queue,
    which starts at that tile; a ray ends at the tile of its first blocker
    or after one full ring. valid [R, T] bool: the pair tests' verdicts;
    live [R] bool. Returns {"occluded" [R] bool, "start" [R] (the ray's
    first tile, -1 for a dead ray), "tiles" [R] (tiles entered), "slots"
    [R] (lane slots held: the triangles of every tile entered),
    "block_tiles" (tiles the block streamed)}."""
    valid, live = np.asarray(valid, bool), np.asarray(live, bool)
    r, t_count = valid.shape
    n_tiles = -(-t_count // tile)
    occ = np.zeros(r, bool)
    start = np.full(r, -1, np.int64)
    tiles = np.zeros(r, np.int64)
    slots = np.zeros(r, np.int64)
    queue = np.nonzero(live)[0] if n_tiles else np.zeros(0, np.int64)
    lane_ray = np.full(lanes, -1, np.int64)
    lane_left = np.zeros(lanes, np.int64)
    cursor, cur, streamed = 0, start_tile % max(n_tiles, 1), 0
    while True:
        need = np.nonzero(lane_ray < 0)[0]
        take = queue[cursor:cursor + len(need)]
        cursor += len(take)
        lane_ray[need[:len(take)]] = take
        lane_left[need[:len(take)]] = n_tiles
        start[take] = cur
        busy = np.nonzero(lane_ray >= 0)[0]
        if not len(busy):
            break
        lo, hi = cur * tile, min(cur * tile + tile, t_count)
        rays = lane_ray[busy]
        tiles[rays] += 1
        slots[rays] += hi - lo
        hit = valid[rays, lo:hi].any(1)
        occ[rays] |= hit
        lane_left[busy] -= 1
        lane_ray[busy[hit | (lane_left[busy] == 0)]] = -1
        cur = (cur + 1) % n_tiles
        streamed += 1
    return {"occluded": occ, "start": start, "tiles": tiles, "slots": slots,
            "block_tiles": streamed}


def sweep_work(scene: dict, origins: torch.Tensor, directions: torch.Tensor, t_min, t_max,
               occlusion: bool, cull: bool = False, slice_rays: int = 65536) -> dict:
    """Per ray of a B3 launch, on the rays' device, from the plain sweep's
    pair verdicts: {"live" [R] bool, "pairs" [R] (the pair tests of a sweep
    in index order: every triangle for a live closest ray, up to the first
    blocker for occlusion, none for a dead ray), and for occlusion
    "tile_hits" [R, n_tiles] bool (a blocker in each tile of TILE)}."""
    r = origins.shape[0]
    t_count = min(int(scene.get("num_tris", scene["mt_pack"].shape[1])),
                  int(scene["mt_pack"].shape[1]))
    tris = {k: scene[k][:t_count] for k in ("pn", "c1", "c2", "e1", "e2", "d0")}
    live = live_rays(directions, t_min, t_max) & (t_count > 0)
    tmin = intersect._ray_window(t_min, r, origins)
    tmax = intersect._ray_window(t_max, r, origins)
    n_tiles = -(-t_count // TILE)
    pairs = torch.where(live, t_count, 0).to(torch.int64)
    hits = torch.zeros((r, n_tiles), dtype=torch.bool, device=origins.device)
    if occlusion:
        for s in range(0, r, slice_rays):
            i = slice(s, s + slice_rays)
            o, d = origins[i], directions[i]
            mom = torch.linalg.cross(o, d, dim=1)
            valid = intersect._valid_mask(*intersect._pair_terms(o, d, mom, tris), tmin[i],
                                          tmax[i], cull) & live[i, None]
            first = torch.where(valid.any(1), valid.to(torch.uint8).argmax(1) + 1, t_count)
            pairs[i] = torch.where(live[i], first, 0)
            pad = torch.zeros((len(o), n_tiles * TILE - t_count), dtype=torch.bool,
                              device=o.device)
            hits[i] = torch.cat([valid, pad], 1).reshape(len(o), n_tiles, TILE).any(2)
    out = {"live": live, "pairs": pairs}
    if occlusion:
        out["tile_hits"] = hits
    return out


def sweep_figures(work: dict, t_count: int, warp: int = WARP) -> dict:
    """Where a B3 launch's lanes idle, from ``sweep_work``: the live share;
    over the warps of ``warp`` consecutive rays, the mean of each warp's
    largest pair count over its mean ("warp_max_over_mean"); and lane slots
    (pair tests a lane waits or works through) of a thread per ray index
    sweeping in index order, where a warp runs as long as its slowest lane
    ("index_slots": the sum of each warp's largest count, times ``warp``),
    against the queue's and the ring's ("queue_slots"), where live rays are
    packed into full warps and an occlusion ray holds its lane for whole
    tiles from a start tile (averaged over every start) up to the tile of
    its first blocker. Their ratio predicts the sweep's time, if issue slots
    bound it."""
    live = work["live"].cpu()
    pairs = work["pairs"].cpu().to(torch.float64)
    r = len(live)
    n_warps = -(-r // warp)
    pw = torch.zeros(n_warps * warp, dtype=torch.float64)
    pw[:r] = pairs
    pw = pw.reshape(n_warps, warp)
    wmax, wmean = pw.max(1).values, pw.mean(1)
    busy = wmax > 0
    index_slots = float(wmax.sum()) * warp
    n_live = int(live.sum())
    if "tile_hits" in work:
        hits = work["tile_hits"].cpu()[live]
        n_tiles = hits.shape[1]
        size = torch.tensor([min(TILE, t_count - k * TILE) for k in range(n_tiles)],
                            dtype=torch.float64)
        per_ray = torch.zeros(len(hits), dtype=torch.float64)
        for s in range(n_tiles):  # each start tile in turn
            order = [(s + k) % n_tiles for k in range(n_tiles)]
            h = hits[:, order]
            first = torch.where(h.any(1), h.to(torch.uint8).argmax(1), n_tiles - 1)
            held = torch.cumsum(size[order], 0)
            per_ray += held[first]
        queue_slots = float(per_ray.sum()) / n_tiles
    else:
        queue_slots = float(-(-n_live // warp) * warp * t_count)
    return {"rays": r, "live": n_live, "live_share": n_live / max(r, 1),
            "warps": n_warps, "warps_with_live": int(busy.sum()),
            "warp_max_over_mean": float((wmax[busy] / wmean[busy]).mean()) if busy.any()
            else 0.0,
            "pairs": float(pairs.sum()), "index_slots": index_slots,
            "queue_slots": queue_slots,
            "predicted_ratio": queue_slots / index_slots if index_slots else 0.0}
