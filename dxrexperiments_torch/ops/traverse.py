"""BVH traversal: the packs, the four walk kernels' wrappers (B4a fat-node,
B4c grouped fat-node packets, B4b binary, B4d 8-wide), their plain versions
and host models of the walks.

Port of ``dxrexperiments_tpu.ops.traverse_pallas``'s host part and of its
kernels ``_make_traverse_fat_kernel`` (``traverse_fat_closest``,
``traverse_fat_any``), ``_make_traverse_fat_grouped_kernel`` (the same
entry points with ``group > 1``), ``_make_traverse_kernel``
(``traverse_closest``, ``traverse_any``) and ``_make_traverse8_kernel``
(``traverse8_closest``, ``traverse8_any``). ``pack_for_traversal`` and
``fat_nodes`` are copied line for line, so ``bvh_nodes``, ``bvhf_nodes``,
``bvh8_nodes``, ``mt_rows``, ``slot_tri`` and ``mt_attr_lanes`` equal the
JAX build's bit for bit.

On CUDA tensors the wrappers launch the hand-written kernels in
``csrc/traverse_fat.cu``, ``csrc/traverse_binary.cu`` and
``csrc/traverse8.cu`` (one thread per ray on its own stack, leaf tests
postponed per warp) or ``csrc/traverse_fat_grouped.cu`` (one packet of 32
rays per warp on a shared stack) or raise; every one reads its leaves from
the records ``ft_test``; on CPU tensors they take the plain versions, the
brute-force ``ops/intersect.py`` over the same triangles, which is what the
JAX package's jnp route computes for BVH scenes. There is no fallback from a
kernel to its plain version.

A stack overflow sets the launch's error flag. The wrapper does not wait to
read it: ``ops/kernel.check_errors`` raises for it at a later launch, once
the kernel has finished, or when the pipeline's ``get_output`` waits for
the card.

``fat_walk_numpy``, ``fat_packet_walk_numpy``, ``parent_walk_numpy`` and
``wide_walk_numpy`` are host models of the kernels' walks (with
``postpone=True`` the warps' leaf postponement of B4a, B4b and B4d; with
``packet=32`` B4c's warp packets), and
``binary_walk_numpy`` of the JAX kernel's binary walk: they return the same
hits and count the slab and pair tests a walk performs, from which
``chip_smoke.py`` computes the kernels' bounds, and log the work of each
loop turn of each ray (``TurnLog``), which ``traverse2.turn_costs`` weighs
per warp.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..accel.bvh import collapse_wide
from . import intersect, kernel
from .kernel import MAX_STACK  # per-ray stack entries; an overflow raises, it never truncates

BIG = 3.0e38
# mt_rows lanes of the 19 coefficients a pair test reads: det = D . [0:3];
# u*det = D . [16:19] + M . [19:22]; v*det = D . [32:35] + M . [35:38];
# t*det = O . [54:57] + [57]
COEF_LANES = (0, 1, 2, 16, 17, 18, 19, 20, 21, 32, 33, 34, 35, 36, 37, 54, 55, 56, 57)


def walk_kernel(ident: str, source: str, n_in: int = 3, n_int: int = 5,
                n_out: int = 7) -> kernel.Kernel:
    """A walk's kernel (B4a-B4d, B6a, B6b): its one entry point
    dxr_<source> takes ``n_in`` input pointers (the rays and the rows),
    ``n_int`` ints and ``n_out`` output pointers (the outputs, the
    occlusion flags and the error flag)."""
    argtypes = [ctypes.c_void_p] * n_in + [ctypes.c_int] * n_int + [ctypes.c_void_p] * n_out
    return kernel.Kernel(ident, source, {f"dxr_{source}": argtypes},
                         (f"{ident} closest", f"{ident} any"))


# kind -> (its kernel, the node rows it reads and their width, the leaf
# array it reads)
WALKS = {
    "fat": (walk_kernel("B4a", "traverse_fat"), "bvhf_rows", 16, "ft_test"),
    "binary": (walk_kernel("B4b", "traverse_binary"), "bvh_rows", 8, "ft_test"),
    "wide": (walk_kernel("B4d", "traverse8"), "bvh8_rows", 8, "ft_test"),
    # B4c takes tile, group and common_origin too
    "grouped": (walk_kernel("B4c", "traverse_fat_grouped", n_int=8), "bvhf_rows", 16, "ft_test"),
}
MAX_TILE = 2048  # the JAX kernel's largest packet (its TILE_R), which B4c's layouts keep


def pack_for_traversal(nodes: dict, scene: dict, leaf_size: int = 16) -> dict:
    """Regularize a node-array BVH (accel/bvh.py format) + the scene's
    ``mt_pack``/``attr_pack`` (numpy) into the kernels' arrays:

      bvh_nodes [8, M_pad] f32: rows lo_xyz, hi_xyz, left, right
        internal: left/right = child node ids (as exact floats)
        leaf:     left = -(slot_start+1), right = count
      bvhf_nodes [16, F_pad] f32: the fat nodes (see fat_nodes)
      bvhf_rows [F_pad, 16] f32: the same, one contiguous row per node (the
        CUDA kernels' layout: four float4 loads per visit)
      bvh_rows [M_pad, 8] f32: bvh_nodes, one row per node (B4b's layout)
      bvh8_nodes [W*8, 8] f32: the 8-wide tree (``accel/bvh.collapse_wide``),
        per wide node 8 child rows lo3, hi3, child, count: internal child =
        wide node id, count -1; leaf child = -(slot_start+1), count > 0;
        empty slot child 0, count 0, box at +BIG. Already row-major:
        ``bvh8_rows`` is the same array, B4d's device copy
      mt_rows [S_pad, 128] f32: the 64 Möller–Trumbore coefficients of each
        fixed-K leaf slot (4 groups x 16 lanes), lanes 64..73 its vertex
        normals n0/n1/n2 and material id, lanes 74..79 its corner UVs when
        the scene has ``uv0``; padded slots are zero (det 0, they never hit)
      slot_tri [S_pad] i32: slot -> original triangle index (-1 padding)
    """
    child = np.asarray(nodes["child"], np.int64)
    order = np.asarray(nodes["order"], np.int64)
    m = len(child)
    leaf_mask = child[:, 0] < 0
    leaf_ids = np.nonzero(leaf_mask)[0]
    n_leaves = len(leaf_ids)

    starts = -child[leaf_ids, 0] - 1
    counts = np.clip(child[leaf_ids, 1], 0, leaf_size)
    lane = np.arange(leaf_size)[None, :]
    src = np.clip(starts[:, None] + lane, 0, max(len(order) - 1, 0))
    vals = order[src] if len(order) else np.full_like(src, -1)
    in_count = lane < counts[:, None]
    slots2d = np.where(in_count & (vals >= 0), vals, -1)
    # compact valid tris to the front of each leaf (order[start:] may carry
    # -1 padding slots from the Morton builder)
    key = np.where(slots2d >= 0, 0, 1)
    sort_idx = np.argsort(key, axis=1, kind="stable")
    slots2d = np.take_along_axis(slots2d, sort_idx, axis=1)
    slot_tri = slots2d.reshape(-1) if n_leaves else np.full((leaf_size,), -1, np.int64)

    new_child = child.copy()
    new_child[leaf_ids, 0] = -(np.arange(n_leaves) * leaf_size + 1)
    new_child[leaf_ids, 1] = (slots2d >= 0).sum(axis=1)

    s = len(slot_tri)
    s_pad = max(-(-s // 128) * 128, 128)
    mt = np.asarray(scene["mt_pack"])  # [4, T, 16]
    mt_sorted = np.zeros((4, s_pad, 16), np.float32)
    valid = slot_tri >= 0
    src = np.where(valid, slot_tri, 0)
    mt_sorted[:, :s][:, valid] = mt[:, src][:, valid]
    mt_rows = np.zeros((s_pad, 128), np.float32)
    mt_rows[:, :64] = np.transpose(mt_sorted, (1, 0, 2)).reshape(s_pad, 64)
    attr_all = np.asarray(scene["attr_pack"])  # [32, T]
    mt_rows[:s, 64:74] = np.where(valid[:, None], attr_all[0:10, src].T, 0.0)
    # textured scenes: lanes 74..79 carry the corner UVs (uv0, uv1, uv2 x
    # (u, v)), from which the fused-traversal kernel interpolates hit UVs
    attr_lanes = 1
    if "uv0" in scene:
        uvs = np.concatenate([np.asarray(scene[k], np.float32) for k in ("uv0", "uv1", "uv2")],
                             axis=1)  # [T, 6]
        mt_rows[:s, 74:80] = np.where(valid[:, None], uvs[src], 0.0)
        attr_lanes = 2

    m_pad = max(-(-m // 128) * 128, 128)
    bvh_nodes = np.zeros((8, m_pad), np.float32)
    bvh_nodes[0:3, :m] = np.asarray(nodes["nodes_lo"], np.float32).T
    bvh_nodes[3:6, :m] = np.asarray(nodes["nodes_hi"], np.float32).T
    bvh_nodes[6, :m] = new_child[:, 0].astype(np.float32)
    bvh_nodes[7, :m] = new_child[:, 1].astype(np.float32)

    slot_tri_pad = np.full((s_pad,), -1, np.int32)
    slot_tri_pad[:s] = slot_tri.astype(np.int32)

    bvhf = fat_nodes(
        np.asarray(nodes["nodes_lo"], np.float32),
        np.asarray(nodes["nodes_hi"], np.float32),
        new_child,
    )

    # 8-wide collapse of the same tree (same regularized leaf ranges):
    # [W*8, 8], per wide node its 8 children's rows (lo3, hi3, child, count)
    wide = collapse_wide(
        np.asarray(nodes["nodes_lo"], np.float32),
        np.asarray(nodes["nodes_hi"], np.float32),
        new_child.astype(np.int64),
        width=8,
    )
    w = wide["w_lo"].shape[0]
    bvh8 = np.zeros((w * 8, 8), np.float32)
    bvh8[:, 0:3] = wide["w_lo"].reshape(w * 8, 3)
    bvh8[:, 3:6] = wide["w_hi"].reshape(w * 8, 3)
    bvh8[:, 6] = wide["w_child"].reshape(w * 8)
    bvh8[:, 7] = wide["w_count"].reshape(w * 8)
    return {
        "bvh_nodes": bvh_nodes,
        "bvh_rows": np.ascontiguousarray(bvh_nodes.T),
        "bvhf_nodes": bvhf,
        "bvhf_rows": np.ascontiguousarray(bvhf.T),
        "bvh8_nodes": bvh8,
        "bvh8_rows": bvh8,
        "mt_rows": mt_rows,
        "slot_tri": slot_tri_pad,
        # the JAX marker: 1 = mt_rows lanes 64..73 carry per-slot attributes,
        # 2 = lanes 74..79 carry the corner UVs too (textured scenes)
        "mt_attr_lanes": attr_lanes,
        "leaf_size": leaf_size,
    }


# A triangle record of the megakernels (csrc/common.cuh kRecWords): the
# coefficients at COEF_LANES, slot j in column j, then a zero pad, so that a
# pair test reads it as five 16-byte loads
REC_WORDS = 20


def coef_records(rows: torch.Tensor) -> torch.Tensor:
    """[N, REC_WORDS] float32 records of ``rows`` [N, >= 64] laid out as
    mt_rows' first 64 lanes (group g, column c at lane 16 g + c), on their
    device."""
    rec = torch.zeros((rows.shape[0], REC_WORDS), dtype=torch.float32, device=rows.device)
    rec[:, : len(COEF_LANES)] = rows[:, list(COEF_LANES)]
    return rec


# B1 (csrc/fused_sample.cu) stages at most this many triangle records in
# shared memory; a scene built with more rows gets no ``tri_records``
FUSED_MAX_TRIS = 256


def tri_records(mt_pack: torch.Tensor) -> torch.Tensor:
    """B1's triangle records [C, REC_WORDS] on mt_pack's device: triangle
    i's row of mt_pack [4, C, 16] (group g at lanes 16 g..16 g + 15, as in
    mt_rows) taken to a record (``coef_records``). Padding rows stay zero
    records, whose det is 0, so they never hit."""
    c = int(mt_pack.shape[1])
    return coef_records(mt_pack.permute(1, 0, 2).reshape(c, 64))


def leaf_records(mt_rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused-traversal kernel's leaf arrays from ``mt_rows`` [S, 128],
    on its device: ``ft_test`` [S, REC_WORDS], each slot's record
    (``coef_records``), and ``ft_attr`` [S, 16], its lanes 64..79 (vertex
    normals n0/n1/n2, material id, corner UVs). Derived arrays of the port:
    80 + 64 bytes a slot against mt_rows' 512."""
    return coef_records(mt_rows), mt_rows[:, 64:80].contiguous()


def fat_nodes(nodes_lo, nodes_hi, child) -> np.ndarray:
    """Collapse a regularized binary node array (leaf child[:,0] =
    -(slot_start+1), child[:,1] = count) into FAT nodes: each row stores its
    two children's AABBs, so a visit tests both subtrees and can descend
    near-child-first.

    Layout [16, F_pad] f32 per fat node (internal nodes only, remapped ids):
      rows 0-5  c0 lo/hi      rows 6-11 c1 lo/hi
      row 12/14 c0/c1 ptr: leaf -> slot_start, internal -> fat node id
      row 13/15 c0/c1 meta: leaf -> count (>0), internal -> -1, empty -> 0
    Empty children get a point box at +BIG (genuinely misses).
    """
    child = np.asarray(child, np.int64)
    m = len(child)
    is_leaf = child[:, 0] < 0
    internal = np.nonzero(~is_leaf)[0]
    f = len(internal)
    f_used = max(f, 1)
    f_pad = max(-(-f_used // 128) * 128, 128)
    fat = np.zeros((16, f_pad), np.float32)
    fat[0:3] = BIG
    fat[3:6] = BIG
    fat[6:9] = BIG
    fat[9:12] = BIG
    if f == 0:
        # root is a single leaf: one fat node, c0 = that leaf, c1 empty
        fat[0:3, 0] = nodes_lo[0]
        fat[3:6, 0] = nodes_hi[0]
        fat[12, 0] = float(-child[0, 0] - 1)
        fat[13, 0] = float(child[0, 1])
        return fat
    remap = np.zeros((m,), np.int64)
    remap[internal] = np.arange(f)
    for side in range(2):
        ids = child[internal, side]
        side_leaf = is_leaf[ids]
        ptr = np.where(side_leaf, -child[ids, 0] - 1, remap[ids])
        meta = np.where(side_leaf, child[ids, 1], -1)
        meta = np.where(side_leaf & (child[ids, 1] <= 0), 0, meta)
        base = 6 * side
        fat[base : base + 3, :f] = nodes_lo[ids].T
        fat[base + 3 : base + 6, :f] = nodes_hi[ids].T
        fat[12 + 2 * side, :f] = ptr.astype(np.float32)
        fat[13 + 2 * side, :f] = meta.astype(np.float32)
        # empty leaves: point box at +BIG
        empty = meta == 0
        fat[base : base + 6, :f][:, empty] = BIG
    return fat


def pack_rays(origins: torch.Tensor, directions: torch.Tensor, t_min, t_max) -> torch.Tensor:
    """The ray pack [R, 8] f32 (origin, direction, t_min, t_max per row):
    ``traverse_pallas._pack_rays`` transposed to one 32-byte row per ray, so
    a thread reads its ray with two float4 loads. Scalar windows broadcast;
    no tile padding (the kernel masks its ragged last block)."""
    r = origins.shape[0]

    def window(x):
        return torch.as_tensor(x, dtype=torch.float32, device=origins.device).expand(r)[:, None]

    return torch.cat([origins.float(), directions.float(), window(t_min), window(t_max)],
                     dim=1).contiguous()


def _slot_of_tri(bvh: dict, num_tris: int) -> torch.Tensor:
    """[T] int64 triangle -> its leaf slot (the inverse of slot_tri)."""
    st = bvh["slot_tri"].to(torch.int64)
    valid = st >= 0
    inv = torch.full((num_tris,), -1, dtype=torch.int64, device=st.device)
    inv[st[valid]] = torch.nonzero(valid)[:, 0]
    return inv


def traverse_fat_closest_reference(scene, origins, directions, t_min=1e-4, t_max=3.0e37,
                                   cull_backface: bool = False) -> dict:
    """Plain version: brute-force closest hit over every triangle
    (``ops/intersect.py``), with the winner's leaf slot. Same keys as
    ``traverse_fat_closest``."""
    hits = intersect.intersect_closest(scene, origins, directions, t_min, t_max,
                                       cull_backface=cull_backface)
    slot_of = _slot_of_tri(scene["bvh"], scene["v0"].shape[0])
    slot = torch.where(hits["hit"], slot_of[hits["tri"].clamp(min=0)], -1)
    return dict(hits, slot=slot)


def traverse_fat_any_reference(scene, origins, directions, t_min=1e-4, t_max=3.0e37):
    """Plain version: brute-force occlusion (``ops/intersect.py``)."""
    return intersect.intersect_any(scene, origins, directions, t_min, t_max)


def check_rows(tree: dict, widths: dict, device) -> tuple[torch.Tensor, ...]:
    """tree[name] for each name of ``widths``, checked: float32 [N, width],
    contiguous, 16-byte aligned (the kernels read float4s), on ``device``."""
    for name, width in widths.items():
        if name not in tree:
            raise ValueError(f"{name} missing: this walk reads it (a tree without fat nodes "
                             "takes the binary walk)")
        t = tree[name]
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != width:
            raise ValueError(f"{name}: expected float32 [N, {width}], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned tensor on {device}")
    return tuple(tree[name] for name in widths)


def check_records(tree: dict, name: str, device) -> torch.Tensor:
    """The leaf records tree[name] [S, REC_WORDS] (``coef_records`` of
    mt_rows: the BVH's ``ft_test``, the two-level ``blas_test``), checked as
    ``check_rows`` checks, and one record per mt_rows row."""
    if name not in tree:
        raise ValueError(f"{name} missing: the leaf records this walk reads "
                         "(ops/traverse.coef_records of mt_rows)")
    (rec,) = check_rows(tree, {name: REC_WORDS}, device)
    if "mt_rows" in tree and tree["mt_rows"].shape[0] != rec.shape[0]:
        raise ValueError(f"{name}: expected one record per mt_rows row "
                         f"({tree['mt_rows'].shape[0]}), got {rec.shape[0]}")
    return rec


def check_bvh(bvh: dict, device, kind: str = "fat") -> tuple[torch.Tensor, torch.Tensor]:
    """Walk ``kind``'s BVH inputs, checked: (node rows, leaf records), the
    node rows bvhf_rows [F, 16] (fat, grouped), bvh_rows [M, 8] (binary) or
    bvh8_rows [W*8, 8] (wide), and for every walk the records ft_test [S,
    REC_WORDS] (``check_records``; built by ``scene.bvh_to_device`` for
    every BVH): a BVH without them raises."""
    _, rows, width, records = WALKS[kind]
    return check_rows(bvh, {rows: width}, device)[0], check_records(bvh, records, device)


def prepare_launch(scene, origins, directions, t_min, t_max, cull: bool, occlusion: bool,
                   kind: str = "fat", packet: tuple = (), lib=None):
    """Pack the rays and allocate the outputs of one launch of walk ``kind``
    (WALKS: "fat" B4a, "grouped" B4c, "binary" B4b, "wide" B4d); B4c takes
    ``packet`` = (tile, group, common_origin), checked by
    ``check_grouping``. Returns (launch, outs, err): ``launch()`` enqueues
    the kernel and returns the CUDA error code; outs is (occ,) or (t, slot,
    u, v). Timing ``launch`` alone measures the kernel without the wrapper's
    packing and checks. ``lib``: another build of the walk's source, bound
    (``WALKS[kind][0].bind``)."""
    if (kind == "grouped") != bool(packet):
        raise ValueError("packet = (tile, group, common_origin) goes with the grouped walk only")
    if packet:
        check_grouping(*packet[:2])
    device = origins.device
    nodes, rows = check_bvh(scene["bvh"], device, kind)
    rays = pack_rays(origins, directions, t_min, t_max)
    r = rays.shape[0]
    err = torch.zeros(1, dtype=torch.int32, device=device)
    if occlusion:
        outs = (torch.empty(r, dtype=torch.bool, device=device),)
        ptrs = (None, None, None, None, outs[0].data_ptr())
    else:
        outs = (torch.empty(r, dtype=torch.float32, device=device),
                torch.empty(r, dtype=torch.int32, device=device),
                torch.empty(r, dtype=torch.float32, device=device),
                torch.empty(r, dtype=torch.float32, device=device))
        ptrs = (*(o.data_ptr() for o in outs), None)
    walk = WALKS[kind][0]
    fn = getattr(lib or walk.library(), f"dxr_{walk.source}")

    def launch() -> int:
        return kernel.on_stream(fn, device, rays.data_ptr(), nodes.data_ptr(), rows.data_ptr(),
                                r, nodes.shape[0], rows.shape[0], int(occlusion), int(cull),
                                *(int(x) for x in packet), *ptrs, err.data_ptr())

    return launch, outs, err


def _launch(scene, origins, directions, t_min, t_max, cull: bool, occlusion: bool,
            kind: str = "fat", packet: tuple = ()):
    launch, outs, err = prepare_launch(scene, origins, directions, t_min, t_max, cull, occlusion,
                                       kind, packet)
    walk = WALKS[kind][0]
    walk.run(launch, walk.counters[int(occlusion)], n=int(origins.shape[0]), err=err)
    if occlusion:
        return outs[0]
    t, slot, u, v = outs
    hit = slot >= 0
    tri = torch.where(hit, scene["bvh"]["slot_tri"][slot.clamp(min=0).long()], -1).long()
    return {"hit": hit, "t": t, "tri": tri, "slot": slot.long(), "u": u, "v": v}


def _closest(kind: str, scene, origins, directions, t_min, t_max, cull_backface: bool) -> dict:
    if kernel.on_card(origins.device):
        return _launch(scene, origins, directions, t_min, t_max, cull_backface, False, kind)
    return traverse_fat_closest_reference(scene, origins, directions, t_min, t_max,
                                          cull_backface)


def _any(kind: str, scene, origins, directions, t_min, t_max) -> torch.Tensor:
    if kernel.on_card(origins.device):
        return _launch(scene, origins, directions, t_min, t_max, False, True, kind)
    return traverse_fat_any_reference(scene, origins, directions, t_min, t_max)


def check_grouping(tile: int, group: int) -> None:
    """Raise ValueError unless (tile, group) is a packet layout B4c takes,
    the TPU kernel's limits (the CUDA entry point refuses the same): group >
    1 sub-packets of R = tile / group rays, R a multiple of 32 (whole warps),
    tile <= MAX_TILE, and above MAX_TILE / 2 (two rays a lane in the TPU
    kernel's layout) a multiple of 64."""
    tile, group = int(tile), int(group)
    if group <= 1:
        raise ValueError(f"group={group}: the grouped walk needs group > 1 (group <= 1 is B4a)")
    if tile < 1 or tile % group:
        raise ValueError(f"tile={tile}, group={group}: tile % group must be 0")
    if (tile // group) % 32:
        raise ValueError(f"tile={tile}, group={group}: the sub-packet R = tile / group = "
                         f"{tile // group} must be a multiple of 32 (whole warps)")
    if tile > MAX_TILE:
        raise ValueError(f"tile={tile}: at most {MAX_TILE} rays per packet (the TPU "
                         "kernel's TILE_R)")
    if tile > MAX_TILE // 2 and tile % 64:
        raise ValueError(f"tile={tile}: the TPU kernel lays a packet of more than "
                         f"{MAX_TILE // 2} rays out two a lane, so it must be a multiple of 64")


def traverse_fat_closest(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                         t_min=1e-4, t_max=3.0e37, cull_backface: bool = False,
                         tile: int = MAX_TILE, group: int = 0,
                         common_origin: bool = False) -> dict:
    """Closest hit through the scene's fat-node BVH: {"hit" [R] bool, "t" [R]
    (-1 on a miss), "tri" [R] int64 (original triangle, -1), "slot" [R]
    int64 (leaf slot, -1), "u", "v" [R] (0 on a miss)}. t_min/t_max:
    scalars or [R].

    group > 1 walks packets of rays on one shared stack, each leaf's pair
    test run only in the sub-packets with a live lane (kernel B4c; the JAX
    kernel's packet is ``tile`` rays in sub-packets of tile / group, the
    card's is a warp of 32 rays, which lies in one sub-packet, so the
    layout selects no other walk there; ``check_grouping`` says which
    layouts it takes, anything else raises ValueError); group <= 1 walks each ray on
    its own stack (kernel B4a), where ``tile``, the TPU packet size, has no
    meaning and is not used. ``common_origin``: the caller asserts that
    every ray starts at origins[0], and every route (the kernels and the
    plain version) uses origins[0] for all rays, as the JAX kernels'
    shared-origin scalars do. CUDA rays -> one kernel launch; CPU rays ->
    the plain version."""
    if common_origin:
        origins_all = origins[:1].expand_as(origins)
    else:
        origins_all = origins
    if group > 1:
        check_grouping(tile, group)
        if kernel.on_card(origins.device):
            return _launch(scene, origins, directions, t_min, t_max, cull_backface, False,
                           "grouped", (tile, group, common_origin))
        return traverse_fat_closest_reference(scene, origins_all, directions, t_min, t_max,
                                              cull_backface)
    return _closest("fat", scene, origins_all, directions, t_min, t_max, cull_backface)


def traverse_fat_any(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                     t_min=1e-4, t_max=3.0e37, tile: int = MAX_TILE,
                     group: int = 0) -> torch.Tensor:
    """Occlusion through the fat-node BVH: [R] bool, True where any triangle
    blocks (t_min, t_max). Rays with a zero direction are not occluded (the
    wavefront integrator zeroes the shadow rays of inactive lanes).
    group > 1 takes the packet walk B4c, group <= 1 the per-ray walk B4a,
    as in ``traverse_fat_closest``. CUDA rays -> one kernel launch; CPU
    rays -> the plain version."""
    if group > 1:
        check_grouping(tile, group)
        if kernel.on_card(origins.device):
            return _launch(scene, origins, directions, t_min, t_max, False, True, "grouped",
                           (tile, group, False))
        return traverse_fat_any_reference(scene, origins, directions, t_min, t_max)
    return _any("fat", scene, origins, directions, t_min, t_max)


def traverse_closest(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                     t_min=1e-4, t_max=3.0e37, cull_backface: bool = False) -> dict:
    """Closest hit through the scene's binary BVH (``bvh_rows``, kernel B4b),
    the route of a BVH without fat nodes. Same keys as
    ``traverse_fat_closest``; CPU rays take the same plain version."""
    return _closest("binary", scene, origins, directions, t_min, t_max, cull_backface)


def traverse_any(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                 t_min=1e-4, t_max=3.0e37) -> torch.Tensor:
    """Occlusion through the binary BVH (kernel B4b), as ``traverse_fat_any``."""
    return _any("binary", scene, origins, directions, t_min, t_max)


def traverse8_closest(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                      t_min=1e-4, t_max=3.0e37, cull_backface: bool = False) -> dict:
    """Closest hit through the 8-wide BVH (``bvh8_rows``, kernel B4d), as
    ``traverse_fat_closest``. No route of the integrator takes it (nor the
    JAX package's): it is a direct entry point."""
    return _closest("wide", scene, origins, directions, t_min, t_max, cull_backface)


def traverse8_any(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                  t_min=1e-4, t_max=3.0e37) -> torch.Tensor:
    """Occlusion through the 8-wide BVH (kernel B4d), as ``traverse_fat_any``."""
    return _any("wide", scene, origins, directions, t_min, t_max)


def leaf_terms(coef, start, count, o, d, mom, tmin, tmax, cull: bool):
    """The kernels' pair tests of n rays against one leaf each, on the host:
    coef [S, 19] (the COEF_LANES of mt_rows), start/count [n], the rays'
    o, d, mom = o x d [n, 3] and windows tmin, tmax [n]. Returns (valid, ts,
    det_abs, us, vs) [n, K] with the sign-folded terms, the slots s_idx
    [n, K] and the mask of slots inside the leaf [n, K]."""
    rows_k = np.arange(int(count.max()))
    s_idx = start[:, None] + rows_k[None, :]
    live = rows_k[None, :] < count[:, None]
    s_idx = np.where(live, s_idx, 0)
    if (start == start[0]).all():  # one leaf for every ray (a packet): no gather
        c = coef[s_idx[0]][None]  # [1, K, 19]
    else:
        c = coef[s_idx]  # [n, K, 19]

    def dot3(x, j):  # ((x0 c_j + x1 c_j+1) + x2 c_j+2), the order of a sum over 3 terms
        return (x[:, None, 0] * c[..., j] + x[:, None, 1] * c[..., j + 1]
                + x[:, None, 2] * c[..., j + 2])

    det = dot3(d, 0)
    u_d = dot3(d, 3) + dot3(mom, 6)
    v_d = dot3(d, 9) + dot3(mom, 12)
    t_d = dot3(o, 15) + c[..., 18]
    sgn = np.sign(det)
    da, us, vs, ts = det * sgn, u_d * sgn, v_d * sgn, t_d * sgn
    alive = det > 1e-12 if cull else da > 1e-12
    valid = (live & alive & (us >= 0) & (vs >= 0) & (us + vs <= da)
             & (ts > tmin[:, None] * da) & (ts < tmax[:, None] * da))
    return valid, ts, da, us, vs, s_idx, live


class WalkState:
    """The host models' per-ray results and counts: the running best hit
    (closest) or the occlusion flags, the pair tests made and the slots
    touched. coef: the COEF_LANES of mt_rows [S, 19]; tmin, tmax [R]."""

    def __init__(self, coef, tmin, tmax, cull: bool, occlusion: bool):
        r = len(tmin)
        self.coef, self.tmin, self.tmax = coef, tmin, tmax
        self.cull, self.occlusion = cull, occlusion
        self.best = np.full(r, BIG, np.float32)
        self.slot = np.full(r, -1, np.int64)
        self.u = np.zeros(r, np.float32)
        self.v = np.zeros(r, np.float32)
        self.occ = np.zeros(r, bool)
        self.pairs = 0
        self.slabs = 0  # slab tests, added by the visits
        self.ray_pairs = np.zeros(r, np.int64)  # pair tests, per ray
        self.ray_leaves = np.zeros(r, np.int64)  # leaf tests entered, per ray
        self.slots_seen: list[np.ndarray] = []
        self.leaf_log: list[tuple[np.ndarray, np.ndarray]] = []  # (rays, starts) per call

    def far(self, idx):
        """The far end of rays idx's windows: t_max, or the best hit so far."""
        return self.tmax[idx] if self.occlusion else np.minimum(self.tmax[idx], self.best[idx])

    def leaf(self, idx, start, count, o, d, mom) -> np.ndarray:
        """Test rays idx (their o, d, mom = o x d [n, 3]) against one leaf
        each (start, count [n]): the lowest row wins within a leaf, a strict
        '<' across leaves; an occluded ray tests no more. Returns the rays
        whose best hit this leaf improved."""
        if self.occlusion:
            keep = ~self.occ[idx]
            idx, start, count, o, d, mom = (x[keep] for x in (idx, start, count, o, d, mom))
            if len(idx) == 0:
                return idx
        valid, ts, da, us, vs, s_idx, live = leaf_terms(
            self.coef, start, count, o, d, mom, self.tmin[idx], self.tmax[idx], self.cull)
        self.ray_leaves[idx] += 1
        self.leaf_log.append((idx, start))
        self.slots_seen.append(s_idx[live])
        if self.occlusion:
            first = np.where(valid.any(1), valid.argmax(1) + 1, count)
            self.pairs += int(first.sum())
            self.ray_pairs[idx] += first
            self.occ[idx] |= valid.any(1)
            return idx[:0]
        self.pairs += int(count.sum())
        self.ray_pairs[idx] += count
        tp = np.where(valid, ts / np.maximum(da, np.float32(1e-12)), np.float32(BIG))
        row = tp.argmin(1)
        ct = tp[np.arange(len(idx)), row]
        better = ct < self.best[idx]
        w = idx[better]
        rb = row[better]
        inv_det = 1.0 / np.maximum(da[better, rb], np.float32(1e-12))
        self.best[w] = ct[better]
        self.slot[w] = start[better] + rb
        self.u[w] = us[better, rb] * inv_det
        self.v[w] = vs[better, rb] * inv_det
        return w

    def leaf_order(self) -> dict:
        """The leaves each ray tested, in its order: {"ray", "start"} [L],
        sorted by ray (stably, so each ray's leaves keep the order in which
        it tested them)."""
        if self.leaf_log:
            cols = [np.concatenate(c) for c in zip(*self.leaf_log)]
        else:
            cols = [np.zeros(0, np.int64)] * 2
        order = np.argsort(cols[0], kind="stable")
        return {k: c[order].astype(np.int64) for k, c in zip(("ray", "start"), cols)}

    def result(self) -> dict:
        if self.occlusion:
            return {"occluded": self.occ}
        hit = self.best < BIG
        return {"hit": hit, "t": np.where(hit, self.best, -1.0).astype(np.float32),
                "slot": self.slot, "u": np.where(hit, self.u, 0), "v": np.where(hit, self.v, 0)}


class RayStacks:
    """The host models' per-ray stacks: node ids [R, cap], each with the
    entry t of the slab test that pushed it ([R, cap]; only the
    children-at-the-parent walk reads it), the depths sp [R] and each
    ray's deepest stack so far [R]. A push past ``cap`` raises, as the
    kernels set their error flag."""

    def __init__(self, r: int, cap: int):
        self.ids = np.zeros((r, cap), np.int64)
        self.tn = np.zeros((r, cap), np.float32)
        self.sp = np.zeros(r, np.int64)
        self.deepest = np.zeros(r, np.int64)
        self.cap = cap

    def start(self, idx, node, tn=0.0) -> None:
        """Rays idx begin a walk at node ids ``node`` (an empty stack before)."""
        self.ids[idx, 0] = node
        self.tn[idx, 0] = tn
        self.sp[idx] = 1
        self.deepest[idx] = np.maximum(self.deepest[idx], 1)

    def pop(self, idx) -> tuple[np.ndarray, np.ndarray]:
        self.sp[idx] -= 1
        return self.ids[idx, self.sp[idx]], self.tn[idx, self.sp[idx]]

    def room(self, idx, pushes) -> None:
        """Raise unless rays idx can push ``pushes`` more entries."""
        if (self.sp[idx] + pushes > self.cap).any():
            raise RuntimeError(f"a ray's stack overflowed its {self.cap} entries")

    def push(self, idx, node, tn=0.0) -> None:
        self.room(idx, 1)
        self.ids[idx, self.sp[idx]] = node
        self.tn[idx, self.sp[idx]] = tn
        self.sp[idx] += 1
        self.deepest[idx] = np.maximum(self.deepest[idx], self.sp[idx])


def slab_test(box, o, inv, tmin, tf):
    """The kernels' slab test of boxes box [..., 6] (lo3, hi3) against the
    windows (tmin, tf] of rays o, inv [..., 3]: (hit, entry t) [...]. min
    and max are exact, so the order of the three axes does not matter."""
    t0 = (box[..., 0:3] - o) * inv
    t1 = (box[..., 3:6] - o) * inv
    tn = np.maximum(tmin, np.minimum(t0, t1).max(-1))
    return tn <= np.minimum(tf, np.maximum(t0, t1).min(-1)), tn


def fat_visit(idx, nodes, o, inv, state: WalkState, st: RayStacks, leaf_fn) -> np.ndarray:
    """One fat-node visit of rays idx (o, inv [R, 3]), as the kernels make
    it: pop, test both children's boxes against (t_min, state.far], call
    leaf_fn(idx, ptr, meta, side) for each hit leaf, child 0 first, then
    push the hit internal children far first (an occluded ray pushes
    nothing). Returns the visited node ids."""
    node = st.pop(idx)[0]
    f = nodes[node]
    tf_base = state.far(idx)
    state.slabs += 2 * len(idx)
    hits, enters = zip(*(slab_test(f[:, 6 * c : 6 * c + 6], o[idx], inv[idx], state.tmin[idx],
                                   tf_base) for c in range(2)))
    ptr = [f[:, 12].astype(np.int64), f[:, 14].astype(np.int64)]
    meta = [f[:, 13], f[:, 15]]
    for c in range(2):
        lf = hits[c] & (meta[c] > 0.5)
        if lf.any():
            leaf_fn(idx[lf], ptr[c][lf], meta[c][lf].astype(np.int64), c)
    int0 = hits[0] & (meta[0] < -0.5)
    int1 = hits[1] & (meta[1] < -0.5)
    if state.occlusion:
        keep = ~state.occ[idx]
        int0 &= keep
        int1 &= keep
    both = int0 & int1
    st.room(idx, both.astype(np.int64) + (int0 | int1))
    near0 = enters[0] <= enters[1]
    first = np.where(both, np.where(near0, ptr[1], ptr[0]), np.where(int0, ptr[0], ptr[1]))
    push1 = int0 | int1
    st.push(idx[push1], first[push1])
    st.push(idx[both], np.where(near0, ptr[0], ptr[1])[both])
    return node


def binary_visit(idx, nodes, o, inv, state: WalkState, st: RayStacks, leaf_fn) -> np.ndarray:
    """One binary-node visit of rays idx (o, inv [R, 3]), as the JAX kernel
    and B6b make it: pop, slab-test the node's own box against (t_min,
    state.far], call leaf_fn(idx, start, count, 0) for a hit leaf, push a
    hit internal node's left child, then its right one (so the right
    subtree is walked first). Returns the visited node ids."""
    node = st.pop(idx)[0]
    f = nodes[node]
    hit, _ = slab_test(f[:, 0:6], o[idx], inv[idx], state.tmin[idx], state.far(idx))
    state.slabs += len(idx)
    left, right = f[:, 6], f[:, 7]
    lf = hit & (left < 0.0)
    if lf.any():
        leaf_fn(idx[lf], (-left[lf] - 1.0).astype(np.int64), right[lf].astype(np.int64), 0)
    push = hit & (left >= 0.0)
    w = idx[push]
    st.room(w, 2)
    st.push(w, left[push].astype(np.int64))
    st.push(w, right[push].astype(np.int64))
    return node


def parent_visit(idx, nodes, o, inv, state: WalkState, st: RayStacks, leaf_fn) -> np.ndarray:
    """One turn of the binary walk with the children tested at the parent
    (B4b's kernel since its redesign), for rays idx: pop a
    node with the entry t its parent's slab test gave; go on only if that
    t is still <= state.far (the window only shrinks, so this is the
    node's own slab test against the window of now); for a leaf call
    leaf_fn(idx, start, count, 0); for an internal node slab-test both
    children's boxes and push those that hit with their entry t, the left
    first, so the right pops first: the JAX kernel's order, the same nodes
    visited in the same order. Returns the popped node ids."""
    node, tn = st.pop(idx)
    f = nodes[node]
    live = tn <= state.far(idx)
    left, right = f[:, 6], f[:, 7]
    lf = live & (left < 0.0)
    if lf.any():
        leaf_fn(idx[lf], (-left[lf] - 1.0).astype(np.int64), right[lf].astype(np.int64), 0)
    inner = live & (left >= 0.0)
    w = idx[inner]
    kids = (left[inner].astype(np.int64), right[inner].astype(np.int64))
    tf = state.far(w)
    state.slabs += 2 * len(w)
    (hl, tl), (hr, tr) = (slab_test(nodes[k, 0:6], o[w], inv[w], state.tmin[w], tf)
                          for k in kids)
    st.room(w, hl.astype(np.int64) + hr)
    st.push(w[hl], kids[0][hl], tl[hl])
    st.push(w[hr], kids[1][hr], tr[hr])
    return node


def root_test(idx, nodes, root, o, inv, state: WalkState) -> tuple[np.ndarray, np.ndarray]:
    """The children-at-the-parent walk's first step: rays idx test their
    root nodes' own boxes (node ids ``root``) as the JAX kernel's first
    visit does: (hit, entry t)."""
    state.slabs += len(idx)
    return slab_test(nodes[root, 0:6], o[idx], inv[idx], state.tmin[idx], state.far(idx))


def wide_visit(idx, rows, o, inv, state: WalkState, st: RayStacks, leaf_fn) -> np.ndarray:
    """One 8-wide visit of rays idx, as B4d makes it: pop, slab-test the 8
    child boxes (rows [W*8, 8]) against (t_min, state.far], then in child
    order 0..7 call leaf_fn(idx, start, count, c) for each hit leaf child
    (count > 0.5) and push each hit internal child (count < -0.5; an
    occluded ray pushes nothing), so child 7's subtree pops first. Returns
    the visited wide node ids."""
    node = st.pop(idx)[0]
    f = rows[node[:, None] * 8 + np.arange(8)]  # [n, 8 children, 8 fields]
    state.slabs += 8 * len(idx)
    hits, _ = slab_test(f[..., 0:6], o[idx][:, None, :], inv[idx][:, None, :],
                        state.tmin[idx][:, None], state.far(idx)[:, None])
    child, count = f[..., 6], f[..., 7]
    for c in range(8):
        lf = hits[:, c] & (count[:, c] > 0.5)
        if lf.any():
            leaf_fn(idx[lf], (-child[lf, c] - 1.0).astype(np.int64),
                    count[lf, c].astype(np.int64), c)
        push = hits[:, c] & (count[:, c] < -0.5)
        if state.occlusion:
            push &= ~state.occ[idx]
        st.push(idx[push], child[push, c].astype(np.int64))
    return node


def distinct(ids: list[np.ndarray]) -> np.ndarray:
    return np.unique(np.concatenate(ids)) if ids else np.zeros(0, int)


def safe_inv(d: np.ndarray) -> np.ndarray:
    """1 / d per axis with |d| <= 1e-12 replaced by +1e-12 (the kernels' rule)."""
    return (1.0 / np.where(np.abs(d) > 1e-12, d, np.float32(1e-12))).astype(np.float32)


WARP = 32  # the lanes of a warp: WARP consecutive rays of a launch


class TurnLog:
    """The work of each loop turn of each ray of a walk: one node visit
    (a pop and what follows it) plus the pair tests of any leaf tested in
    it. ``loop`` names the loop a turn belongs to, so that the lanes of a
    warp that run it together line up: 0 for a one-level walk; for a
    nested two-level walk 3 j for the j-th TLAS turn itself and 3 j + 1 +
    side for the BLAS walk entered at that turn's leaf child ``side``.
    ``turn`` counts the ray's turns within its loop. A walk with leaf
    postponement (``held_walk``) also logs its warps' rounds."""

    def __init__(self):
        self.parts: list[tuple[np.ndarray, ...]] = []
        self.rounds: list[tuple[np.ndarray, ...]] = []

    def add(self, idx, loop, turn, pairs) -> None:
        n = len(idx)
        self.parts.append((idx, np.broadcast_to(loop, (n,)), np.broadcast_to(turn, (n,)), pairs))

    def add_round(self, idx, pairs=None) -> None:
        """One round of a postponed walk for the warps of rays idx: a
        traversal turn (pairs None), or a leaf phase in which rays idx test
        leaves of ``pairs`` pair tests each, costing each warp its largest."""
        warps, inv = np.unique(idx // WARP, return_inverse=True)
        top = np.zeros(len(warps), np.int64)
        if pairs is not None:
            np.maximum.at(top, inv.reshape(-1), pairs)
        lanes = np.bincount(inv.reshape(-1), minlength=len(warps))
        self.rounds.append((warps, np.full(len(warps), pairs is None), top, lanes))

    def arrays(self) -> dict:
        """{"ray", "loop", "turn", "pairs"} [N] int64, one entry per turn,
        and for a postponed walk "rounds": {"warp", "traversal", "slots",
        "lanes"}, one entry per round of each warp (a traversal turn, or a
        leaf phase with its largest pair tests; the warp's rays that walk
        or test leaves in it)."""
        names = ("ray", "loop", "turn", "pairs")
        if not self.parts:
            out = {k: np.zeros(0, np.int64) for k in names}
        else:
            out = {k: np.concatenate(c).astype(np.int64) for k, c in zip(names, zip(*self.parts))}
        if self.rounds:
            out["rounds"] = {k: np.concatenate(c) for k, c in
                             zip(("warp", "traversal", "slots", "lanes"), zip(*self.rounds))}
        return out


def held_walk(nodes, visit, o, inv, state: WalkState, st: RayStacks, leaf_test, log: TurnLog,
              turn, hold: int = 2) -> list[np.ndarray]:
    """Walk every ray with a non-empty stack in ``st`` to its end with leaf
    postponement, as the warps of B4b (``postponed_walk`` in
    csrc/walk_binary.cuh), B4a and B5 (``postponed_fat_walk`` in
    csrc/rec_leaf.cuh) and B4d (``postponed_wide_walk`` in
    csrc/traverse8.cu) walk: each round every ray that neither holds a
    leaf nor has ended makes one turn of ``visit``, the leaves it hits held,
    not tested (up to ``hold``: one a binary visit, two a fat one, eight a
    wide one, in the order ``visit`` calls its leaf function); then each
    warp (WARP consecutive rays) in which no ray is still looking for a
    leaf tests its held leaves (``leaf_test(idx, start, count)``), each ray
    its own in order, no further leaf once one has occluded the ray. A
    ray's window changes only at its own leaf tests, so a held leaf is
    tested against the window it was found with. Each turn goes into
    ``log`` (loop 0) under the ray's turn counter ``turn`` [R] (advanced
    here), held leaves' pair tests under the turn that found them; each
    round's traversal turn and leaf phase go into ``log`` per warp
    (``TurnLog.add_round``: a leaf phase costs a warp its ray with the most
    pair tests over all its held leaves, which the kernels test as one run
    of slots), which ``traverse2.turn_costs`` sums. Returns the popped node
    ids of each round."""
    r = len(st.sp)
    n_held = np.zeros(r, np.int64)
    start, count = np.zeros((r, hold), np.int64), np.zeros((r, hold), np.int64)
    held_turn = np.zeros(r, np.int64)
    popped = []

    def hold_leaf(idx, s, c, _side):
        k = n_held[idx]
        start[idx, k], count[idx, k] = s, c
        n_held[idx] += 1

    while True:
        walking = np.nonzero((st.sp > 0) & (n_held == 0) & ~state.occ)[0]
        if len(walking):
            popped.append(visit(walking, nodes, o, inv, state, st, hold_leaf))
            new = n_held[walking] > 0
            log.add(walking[~new], 0, turn[walking[~new]],
                    np.zeros(int((~new).sum()), np.int64))
            held_turn[walking[new]] = turn[walking[new]]
            turn[walking] += 1
            log.add_round(walking)
        busy = np.zeros(-(-r // WARP), bool)
        busy[np.nonzero((st.sp > 0) & (n_held == 0) & ~state.occ)[0] // WARP] = True
        test = np.nonzero((n_held > 0) & ~busy[np.arange(r) // WARP])[0]
        if len(test):
            before = state.ray_pairs[test]
            for k in range(hold):
                sel = test[n_held[test] > k]
                if len(sel):
                    leaf_test(sel, start[sel, k], count[sel, k])
            n_held[test] = 0
            pairs = state.ray_pairs[test] - before
            log.add(test, 0, held_turn[test], pairs)
            log.add_round(test, pairs)
        if not len(walking) and not len(test):
            return popped


def _walk_numpy(nodes, visit, mt_rows, origins, directions, t_min, t_max,
                cull: bool, occlusion: bool, parent: bool = False,
                postpone: bool = False, hold: int = 2, live=None) -> tuple[dict, dict]:
    """Run ``visit`` (fat_visit, binary_visit, wide_visit or, with
    ``parent``, parent_visit after the root test) over ``nodes`` from node
    0 until every ray's stack is empty (or it is occluded); ``postpone``:
    with leaf postponement (``held_walk``, up to ``hold`` leaves a ray).
    ``live`` [R] bool: the rays that walk; the others make no visit (a miss,
    not occluded) and, in a postponed walk, no vote: lanes outside the mask
    of B5's walks."""
    nodes = np.asarray(nodes, np.float32)
    o = np.asarray(origins, np.float32)
    d = np.asarray(directions, np.float32)
    r = len(o)
    state = WalkState(np.asarray(mt_rows, np.float32)[:, list(COEF_LANES)],
                      np.broadcast_to(np.asarray(t_min, np.float32), (r,)).copy(),
                      np.broadcast_to(np.asarray(t_max, np.float32), (r,)).copy(),
                      cull, occlusion)
    inv = safe_inv(d)
    mom = np.cross(o, d).astype(np.float32)
    st = RayStacks(r, MAX_STACK)
    live = np.ones(r, bool) if live is None else np.asarray(live, bool).copy()
    if occlusion:
        live &= np.abs(d).sum(axis=1) >= 1e-30
    ray_visits = np.zeros(r, np.int64)
    seen_nodes: list[np.ndarray] = []
    log = TurnLog()

    def leaf(idx, start, count, _side):
        state.leaf(idx, start, count, o[idx], d[idx], mom[idx])

    with np.errstate(all="ignore"):  # slab tests overflow to +-inf on purpose
        idx = np.nonzero(live)[0]
        if parent:
            hit, tn = root_test(idx, nodes, np.zeros(len(idx), np.int64), o, inv, state)
            idx = idx[hit]
            st.start(idx, 0, tn[hit])
        else:
            st.start(idx, 0)
        if postpone:
            seen_nodes += held_walk(nodes, visit, o, inv, state, st,
                                    lambda i, s, c: leaf(i, s, c, 0), log, ray_visits, hold)
        while True:
            idx = np.nonzero((st.sp > 0) & ~state.occ)[0]
            if len(idx) == 0:
                break
            before = state.ray_pairs[idx]
            seen_nodes.append(visit(idx, nodes, o, inv, state, st, leaf))
            log.add(idx, 0, ray_visits[idx], state.ray_pairs[idx] - before)
            ray_visits[idx] += 1

    visits = int(ray_visits.sum())
    counts = {"visits": visits, "slab_tests": state.slabs,
              "pair_tests": state.pairs, "node_ids": distinct(seen_nodes),
              "slot_ids": distinct(state.slots_seen), "max_stack": int(st.deepest.max(initial=0)),
              "ray_visits": ray_visits, "ray_leaves": state.ray_leaves,
              "ray_depth": st.deepest, "turns": log.arrays(), "leaf_order": state.leaf_order()}
    return state.result(), counts


def fat_walk_numpy(bvh: dict, origins, directions, t_min, t_max, cull: bool = False,
                   occlusion: bool = False, postpone: bool = False,
                   live=None) -> tuple[dict, dict]:
    """Host model of the per-ray fat-node walk over ``bvhf_rows``/``mt_rows``
    (numpy arrays) of B4a and of B5's traces: near child first (the far one
    pushed first), both children's slab tests pruned by the running best t,
    a leaf tested at visit time (lowest row wins within a leaf, strict '<'
    across leaves), occlusion ending at the first hit, zero-direction
    occlusion rays dead. ``postpone``: B4a's and B5's warps, with leaf
    postponement (``held_walk``: a ray holds the up to two leaves a visit
    hits; its rounds go into counts["turns"]["rounds"]), which changes
    neither the hits nor the leaves each ray tests and their order.
    ``live`` [R] bool: the rays that walk (default all; B5's lanes that make
    the walk), the others neither visit nor vote.

    Returns (result, counts): result {"hit", "t", "slot", "u", "v"} or
    {"occluded"}; counts {"visits", "slab_tests", "pair_tests", "node_ids",
    "slot_ids", "max_stack", "ray_visits", "ray_leaves", "ray_depth",
    "turns", "leaf_order"} (node_ids, slot_ids: the distinct fat nodes and
    leaf slots touched; max_stack: the deepest stack of any ray;
    ray_visits, ray_leaves, ray_depth [R]: each ray's node visits, leaf
    tests and deepest stack; turns: the work of each loop turn of each ray
    (``TurnLog``), which ``traverse2.turn_costs`` weighs per warp;
    leaf_order: the leaves each ray tested, in order)."""
    return _walk_numpy(bvh["bvhf_rows"], fat_visit, bvh["mt_rows"], origins, directions,
                       t_min, t_max, cull, occlusion, postpone=postpone, live=live)


def binary_walk_numpy(bvh: dict, origins, directions, t_min, t_max, cull: bool = False,
                      occlusion: bool = False) -> tuple[dict, dict]:
    """Host model of the JAX kernel's per-ray binary walk over
    ``bvh_rows``/``mt_rows`` (numpy arrays; ``binary_visit``): one slab
    test per visit, pruned by the running best t. Returns what
    ``fat_walk_numpy`` returns, node_ids being binary node ids."""
    return _walk_numpy(bvh["bvh_rows"], binary_visit, bvh["mt_rows"], origins, directions,
                       t_min, t_max, cull, occlusion)


def parent_walk_numpy(bvh: dict, origins, directions, t_min, t_max, cull: bool = False,
                      occlusion: bool = False, postpone: bool = False) -> tuple[dict, dict]:
    """Host model of B4b's per-ray walk over ``bvh_rows``/``mt_rows`` (numpy
    arrays): the root's own box tested first, then ``parent_visit``, the
    children tested at the parent and pushed with their entry t. It tests
    the leaves ``binary_walk_numpy`` tests, in the same order, and returns
    the same hits; ``postpone`` walks the rays in warps with leaf
    postponement, as the kernel does (``held_walk``; its rounds go into
    counts["turns"]["rounds"]), which changes neither. Returns what
    ``fat_walk_numpy`` returns; visits are pops."""
    return _walk_numpy(bvh["bvh_rows"], parent_visit, bvh["mt_rows"], origins, directions,
                       t_min, t_max, cull, occlusion, parent=True, postpone=postpone)


def wide_walk_numpy(bvh: dict, origins, directions, t_min, t_max, cull: bool = False,
                    occlusion: bool = False, postpone: bool = False) -> tuple[dict, dict]:
    """Host model of B4d's per-ray walk over ``bvh8_rows``/``mt_rows`` (numpy
    arrays), in the JAX kernel's order (``wide_visit``): eight slab tests per
    visit. ``postpone``: B4d's warps, with leaf postponement (``held_walk``
    with a hold of eight: a ray holds the leaf children a visit hits, in
    child order; its rounds go into counts["turns"]["rounds"]), which
    changes neither the hits nor the leaves each ray tests and their order.
    Returns what ``fat_walk_numpy`` returns, node_ids being wide node
    ids."""
    return _walk_numpy(bvh["bvh8_rows"], wide_visit, bvh["mt_rows"], origins, directions,
                       t_min, t_max, cull, occlusion, postpone=postpone, hold=8)


def fat_packet_walk_numpy(bvh: dict, origins, directions, t_min, t_max, tile: int, group: int,
                          cull: bool = False, occlusion: bool = False,
                          common_origin: bool = False, lag: bool = False,
                          packet: int | None = None) -> tuple[dict, dict]:
    """Host model of the grouped packet walk over ``bvhf_rows``/``mt_rows``
    (numpy arrays), one stack per packet of ``packet`` consecutive rays
    (default ``tile``, the JAX kernel ``_make_traverse_fat_grouped_kernel``'s
    packet; 32, a warp, is B4c's on the card), with the JAX kernel's rules:

    - both children of a node are slab-tested for every lane against
      (t_min, min(t_max, best)] (in occlusion an occluded or zero-direction
      lane's window is empty), and a child is taken if any lane hits it;
    - hit leaves are handled child 0 first: the leaf box is re-tested per
      lane, and the pair test runs in every active lane of a sub-packet of
      min(packet, tile / group) rays that has a live lane (lowest row wins
      within a leaf, strict '<' across leaves; an occluded lane tests no
      more);
    - two internal children are pushed so that the child with the smaller
      packet-minimum entry t pops first, ties to child 0;
    - occlusion ends once every lane is occluded (or dead) and no leaf is
      pending.

    ``lag=True`` handles each leaf one enqueue late, as the TPU kernel's
    double-buffered leaf DMA does (a leaf is tested when the next one is
    enqueued, the last after the walk); the CUDA kernel tests a leaf at
    once (``lag=False``). The lag changes which nodes a stale best fails to
    prune, not the winner. ``common_origin`` uses origins[0] for every ray.
    Rays past the last whole packet form a shorter packet. The packets walk
    side by side, one step of each a round.

    Returns (result, counts) with ``fat_walk_numpy``'s keys: visits are
    packet steps; slab_tests 2 x lanes per step plus lanes per leaf
    re-test; pair_tests the rows each lane of a live sub-packet tests (an
    occlusion lane up to its first blocker); ray_visits [R] the steps of
    each ray's packet; ray_leaves [R] the leaf tests each ray took part
    in; warp_slots [W] per warp of WARP consecutive rays the pair slots it
    runs (over its leaf tests, its lane with the most pair tests)."""
    check_grouping(tile, group)
    packet = tile if packet is None else int(packet)
    if packet < 1 or packet % WARP or tile % packet:
        raise ValueError(f"packet={packet}: a whole number of warps that divides tile={tile}")
    nodes = np.asarray(bvh["bvhf_rows"], np.float32)
    o = np.asarray(origins, np.float32)
    d = np.asarray(directions, np.float32)
    r = len(d)
    if common_origin:
        o = np.broadcast_to(o[:1], (r, 3))
    state = WalkState(np.asarray(bvh["mt_rows"], np.float32)[:, list(COEF_LANES)],
                      np.broadcast_to(np.asarray(t_min, np.float32), (r,)).copy(),
                      np.broadcast_to(np.asarray(t_max, np.float32), (r,)).copy(),
                      cull, occlusion)
    inv = safe_inv(d)
    mom = np.cross(o, d).astype(np.float32)
    dead = (np.abs(d).sum(axis=1) < 1e-30) if occlusion else np.zeros(r, bool)
    sub = min(packet, tile // group)
    pk = np.arange(r) // packet  # each ray's packet
    grp = pk * packet + (np.arange(r) % packet) // sub  # each ray's sub-packet (a label)
    n_pk = -(-r // packet)
    stack = np.zeros((n_pk, MAX_STACK), np.int64)
    sp = np.ones(n_pk, np.int64)
    steps = np.zeros(n_pk, np.int64)
    pending = np.zeros(n_pk, bool)  # lag: a leaf enqueued, not yet tested
    p_start, p_count = np.zeros(n_pk, np.int64), np.zeros(n_pk, np.int64)
    p_box = np.zeros((n_pk, 6), np.float32)
    warp_slots = np.zeros(-(-r // WARP), np.int64)
    counts = {"slab_tests": 0}
    deepest = 0
    seen_nodes: list[np.ndarray] = []

    def far(idx):
        if occlusion:
            return np.where(state.occ[idx] | dead[idx], np.float32(-BIG), state.tmax[idx])
        return state.far(idx)

    def rays_of(packets):
        return np.nonzero(np.isin(pk, packets))[0]

    def process(packets, start, count, box):
        """The leaf re-test and the pair tests of the live sub-packets, one
        leaf per packet (start, count [n], box [n, 6])."""
        at = np.full(n_pk, -1, np.int64)
        at[packets] = np.arange(len(packets))
        idx = rays_of(packets)
        j = at[pk[idx]]
        counts["slab_tests"] += len(idx)
        live, _ = slab_test(box[j], o[idx], inv[idx], state.tmin[idx], far(idx))
        run = idx[np.isin(grp[idx], grp[idx][live]) & ~dead[idx]]
        if len(run):
            before = state.ray_pairs[run]
            j = at[pk[run]]
            # a few packets: one call per leaf, whose coefficients broadcast
            # over its rays (leaf_terms), instead of a gather per ray
            for part in (np.split(np.argsort(j, kind="stable"), np.unique(np.sort(j),
                                                                     return_index=True)[1][1:])
                         if len(packets) <= 8 else (slice(None),)):
                w = run[part]
                state.leaf(w, start[j[part]], count[j[part]], o[w], d[w], mom[w])
            top = np.zeros(len(warp_slots), np.int64)
            np.maximum.at(top, run // WARP, state.ray_pairs[run] - before)
            warp_slots[:] += top

    with np.errstate(all="ignore"):  # slab tests overflow to +-inf on purpose
        while True:
            act = np.nonzero(sp > 0)[0]
            if not len(act):
                break
            sp[act] -= 1
            node = stack[act, sp[act]]
            steps[act] += 1
            seen_nodes.append(node)
            f = nodes[node]  # [n, 16]
            idx = rays_of(act)
            at = np.full(n_pk, -1, np.int64)
            at[act] = np.arange(len(act))
            j = at[pk[idx]]
            tf = far(idx)
            hits, enters = [], []
            for c in range(2):
                h, tn = slab_test(f[j, 6 * c : 6 * c + 6], o[idx], inv[idx], state.tmin[idx], tf)
                hits.append(np.bincount(j, weights=h, minlength=len(act)) > 0)
                e = np.full(len(act), BIG, np.float32)
                np.minimum.at(e, j, np.where(h, tn, np.float32(BIG)))
                enters.append(e)
            counts["slab_tests"] += 2 * len(idx)
            entered = np.zeros(len(act), bool)
            for c in range(2):
                lf = hits[c] & (f[:, 13 + 2 * c] > 0.5)
                if not lf.any():
                    continue
                entered |= lf
                pl = act[lf]
                leaf = (f[lf, 12 + 2 * c].astype(np.int64), f[lf, 13 + 2 * c].astype(np.int64),
                        f[lf, 6 * c : 6 * c + 6])
                if lag:
                    was = pending[pl]
                    if was.any():
                        process(pl[was], p_start[pl[was]], p_count[pl[was]], p_box[pl[was]])
                    p_start[pl], p_count[pl], p_box[pl] = leaf
                    pending[pl] = True
                else:
                    process(pl, *leaf)
            int0 = hits[0] & (f[:, 13] < -0.5)
            int1 = hits[1] & (f[:, 15] < -0.5)
            if (sp[act] + int0 + int1 > MAX_STACK).any():
                raise RuntimeError(f"a packet's stack overflowed its {MAX_STACK} entries")
            ptr0, ptr1 = f[:, 12].astype(np.int64), f[:, 14].astype(np.int64)
            both = int0 & int1
            near0 = enters[0] <= enters[1]
            first = np.where(both, np.where(near0, ptr1, ptr0), np.where(int0, ptr0, ptr1))
            one = int0 | int1
            stack[act[one], sp[act[one]]] = first[one]
            sp[act[one]] += 1
            stack[act[both], sp[act[both]]] = np.where(near0, ptr0, ptr1)[both]
            sp[act[both]] += 1
            deepest = max(deepest, int(sp.max()))
            if occlusion:
                done = np.bincount(j, weights=~(state.occ[idx] | dead[idx]),
                                   minlength=len(act)) == 0
                if lag:
                    done &= ~entered
                sp[act[done]] = 0
            ended = act[(sp[act] == 0) & pending[act]]
            if len(ended):
                process(ended, p_start[ended], p_count[ended], p_box[ended])
                pending[ended] = False

    ray_visits = steps[pk]
    counts.update({"visits": int(steps.sum()), "pair_tests": state.pairs,
                   "node_ids": distinct(seen_nodes), "slot_ids": distinct(state.slots_seen),
                   "max_stack": deepest, "ray_visits": ray_visits,
                   "ray_leaves": state.ray_leaves, "warp_slots": warp_slots})
    return state.result(), counts
