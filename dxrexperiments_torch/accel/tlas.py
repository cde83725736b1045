"""Two-level acceleration structure: a TLAS over instances, one BLAS per
unique mesh (``dxrexperiments_tpu.accel.tlas``).

Each unique mesh gets one object-space BLAS, built once on the host; the
TLAS is an implicit-heap binary tree over the instances' world AABBs in
their Morton order at build time, and every instance stores its inverse
transform. A walk (kernel B6a, ``ops/traverse2.py``) transforms the ray at an
instance leaf and walks that instance's BLAS in object space; the map is
affine, so the object-space t equals the world-space one and hits of
different instances compare directly. A TLAS without fat nodes (no
``tlasf_nodes``) takes the binary walk (kernel B6b) over ``tlas_rows`` and
``blas_rows``.

The host half (``_mt_pack_rows``, ``_regularize_leaves``, the per-mesh BLAS
build through ``accel/bvh.build_nodes``, ``build_two_level``) is copied line
for line, so ``blas_nodes``, ``blasf_nodes``, ``mt_rows``, ``slot_tri`` and the
``TlasRefitContext`` equal the JAX build's bit for bit.

Animation is a TLAS refit (``refit_instances_arrays``), the analogue of a
D3D12 PERFORM_UPDATE build: the topology is frozen at build time and is
computed once on the host (``TlasRefitContext.on_device``); each refit
uploads the new transforms in one pinned non-blocking copy and recomputes,
as torch ops on the scene's device, only the instances' world boxes, the
heap's node boxes and the inverse and normal matrices. The inverse is the
closed-form 3x3 one: ``torch.linalg.inv`` would synchronise with the host to
check invertibility.

Arrays (``tl`` below, the scene's ``tlas`` sub-dict):
  tlas_nodes [8, Mt_pad] f32: the binary TLAS (lo3, hi3, left, right); a
    leaf has left = -(slot+1), right = 1, where slot indexes inst_rows
  tlasf_nodes [16, Ft_pad] f32: the fat TLAS (ops/traverse.fat_nodes
    layout); a child with meta 1 is instance slot ptr, meta 0 is padding
  tlasf_rows [Ft_pad, 16] f32: the same, one row per node (B6a's layout)
  tlas_rows [Mt_pad, 8] f32: tlas_nodes, one row per node (B6b's layout)
  inst_rows [32, Ipad] f32: per slot, rows 0-8 the inverse rotation A (row
    major, x_obj = A x_world + b), 9-11 b, 12 the binary BLAS root, 13 the
    material override (-1 none), 14 the original instance index, 15 the
    fat BLAS root
  inst_rows_t [Ipad, 16] f32: rows 0-15 of inst_rows, one row per slot
  inst_nm [Ipad, 3, 3] f32: normal matrices inv(R)^T
  inst_mat_override, inst_orig [Ipad] int32
  blas_nodes [8, Mb_pad], blasf_nodes [16, Fb_pad] f32 (host): every unique
    mesh's BLAS concatenated, ids rebased
  blasf_rows [Fb_pad, 16] f32: the fat BLAS nodes, one row per node (B6a)
  blas_rows [Mb_pad, 8] f32: the binary BLAS nodes, one row per node (B6b)
  mt_rows [S, 128] f32: object-space Möller–Trumbore rows in BLAS leaf-slot
    order (the ops/traverse.pack_for_traversal layout, lanes 0..63)
  blas_test [S, 20] f32: each slot's 19 coefficients in slot order and a
    zero (ops/traverse.coef_records of mt_rows), the records B6a's leaf
    tests read; a derived array of the port, built once here beside the
    rows it comes from (a refit moves no BLAS array)
  slot_tri [S] int32: leaf slot -> concatenated object-space triangle
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import setup_device
from ..ops import intersect
from ..ops.traverse import _slot_of_tri, coef_records, fat_nodes
from . import bvh as bvh_mod

BIG = 3.0e38
TLAS_PAD = 128  # column padding of the node and instance arrays


def _mt_pack_rows(v0, e1, e2):
    """Object-space Möller–Trumbore pack as kernel rows [T, 128] (the
    layout of ops/traverse.pack_for_traversal: group g coefficient c at lane
    g*16+c)."""
    pn = np.cross(e1, e2)
    c1 = np.cross(v0, e2)
    c2 = np.cross(v0, e1)
    d0 = np.sum(v0 * pn, axis=-1)
    t = len(v0)
    mt = np.zeros((4, t, 16), np.float32)
    mt[0, :, 0:3] = -pn
    mt[1, :, 0:3] = c1
    mt[1, :, 3:6] = e2
    mt[2, :, 0:3] = -c2
    mt[2, :, 3:6] = -e1
    mt[3, :, 6:9] = pn
    mt[3, :, 9] = -d0
    rows = np.zeros((t, 128), np.float32)
    rows[:, :64] = np.transpose(mt, (1, 0, 2)).reshape(t, 64)
    return rows


def _regularize_leaves(nodes: dict, leaf_size: int):
    """Rewrite variable leaf ranges to fixed-K slot ranges (the scheme of
    pack_for_traversal). Returns (new_child [M,2] i64, slot_tri [S] i64)."""
    child = np.asarray(nodes["child"], np.int64)
    order = np.asarray(nodes["order"], np.int64)
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
    key = np.where(slots2d >= 0, 0, 1)
    sort_idx = np.argsort(key, axis=1, kind="stable")
    slots2d = np.take_along_axis(slots2d, sort_idx, axis=1)
    slot_tri = (
        slots2d.reshape(-1) if n_leaves else np.full((leaf_size,), -1, np.int64)
    )
    new_child = child.copy()
    new_child[leaf_ids, 0] = -(np.arange(n_leaves) * leaf_size + 1)
    new_child[leaf_ids, 1] = (slots2d >= 0).sum(axis=1)
    return new_child, slot_tri


def _aabb_corners(lo, hi) -> np.ndarray:
    """[I, 8, 3] corners of per-instance AABBs lo, hi [I, 3]."""
    picks = np.array([[(c >> a) & 1 for a in range(3)] for c in range(8)], lo.dtype)
    return lo[:, None, :] * (1 - picks)[None] + hi[:, None, :] * picks[None]


@dataclasses.dataclass
class TlasRefitContext:
    """Host statics of the refit, frozen at build time."""

    inst_order: np.ndarray  # [I] original index per sorted slot
    slot_mesh_lo: np.ndarray  # [I, 3] object AABB of each slot's mesh
    slot_mesh_hi: np.ndarray  # [I, 3]
    slot_blas_root: np.ndarray  # [I] f32
    slot_blas_fat_root: np.ndarray  # [I] f32 (root into blasf_nodes)
    slot_mat_override: np.ndarray  # [I] f32 (-1 = none)
    levels: int  # TLAS depth (2**levels leaf slots)
    num_instances: int
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def on_device(self, device) -> dict:
        """The frozen topology and per-slot constants as tensors on
        ``device``, computed on the host once per device."""
        device = torch.device(device)
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = {
                k: torch.as_tensor(v).to(device) if isinstance(v, np.ndarray) else v
                for k, v in _topology(self).items()
            }
        return self._on_device[key]


def _topology(ctx: TlasRefitContext) -> dict:
    """What a refit does not change, as numpy: the heap's left/right rows,
    the fat TLAS's ptr/meta rows and the heap ids of each fat node's two
    children, the instance table's constant rows, and each slot's mesh box
    corners."""
    i = ctx.num_instances
    n_leaves = 1 << ctx.levels
    mt = 2 * n_leaves - 1
    mt_pad = max(-(-mt // TLAS_PAD) * TLAS_PAD, TLAS_PAD)
    first_leaf = n_leaves - 1
    ids = np.arange(mt)
    lr = np.zeros((2, mt_pad), np.float32)
    lr[0, :mt] = np.where(ids >= first_leaf, -(ids - first_leaf + 1), 2 * ids + 1)
    lr[1, :mt] = np.where(ids >= first_leaf, 1, 2 * ids + 2)

    # Fat TLAS: internal heap ids are fat node ids (0..first_leaf-1); a child
    # id >= first_leaf is an instance leaf whose slot is id - first_leaf.
    # Index mt of the extended box arrays is a point box at +BIG (empty).
    fcount = max(first_leaf, 1)
    f_pad = max(-(-fcount // TLAS_PAD) * TLAS_PAD, TLAS_PAD)
    meta_rows = np.zeros((4, f_pad), np.float32)
    if first_leaf == 0:
        # single-instance TLAS: one fat node, c0 = instance 0, c1 empty
        cids = np.array([[0], [mt]], np.int64)
        meta_rows[1, 0] = 1.0
    else:
        fids = np.arange(first_leaf)
        cids = np.stack([2 * fids + 1, 2 * fids + 2])
        for side in range(2):
            is_inst = cids[side] >= first_leaf
            slot = cids[side] - first_leaf
            meta_rows[2 * side, :first_leaf] = np.where(is_inst, slot, cids[side])
            meta_rows[2 * side + 1, :first_leaf] = np.where(
                is_inst, np.where(slot < i, 1.0, 0.0), -1.0
            )

    i_pad = max(-(-n_leaves // TLAS_PAD) * TLAS_PAD, TLAS_PAD)
    inst_const = np.zeros((20, i_pad), np.float32)  # rows 12-31 of inst_rows
    inst_const[0, :i] = ctx.slot_blas_root
    inst_const[1, :i] = ctx.slot_mat_override
    inst_const[2, :i] = ctx.inst_order.astype(np.float32)
    inst_const[3, :i] = ctx.slot_blas_fat_root
    override = np.full((i_pad,), -1, np.int32)
    override[:i] = ctx.slot_mat_override.astype(np.int32)
    orig = np.zeros((i_pad,), np.int32)
    orig[:i] = ctx.inst_order
    return {
        "inst_order": np.asarray(ctx.inst_order, np.int64),
        "corners": _aabb_corners(ctx.slot_mesh_lo, ctx.slot_mesh_hi).astype(np.float32),
        "tlas_lr": lr,
        "fat_cids": cids,
        "fat_meta": meta_rows,
        "inst_const": inst_const,
        "inst_mat_override": override,
        "inst_orig": orig,
        "n_leaves": n_leaves,
        "mt_pad": mt_pad,
        "f_pad": f_pad,
        "i_pad": i_pad,
    }


def build_two_level(
    meshes: list,  # list of (v0 [T,3], e1, e2) object-space triangle arrays
    inst_mesh: np.ndarray,  # [I] mesh index per instance
    transforms: np.ndarray,  # [I, 4, 4]
    mat_override: np.ndarray | None = None,  # [I] int (-1 = keep mesh ids)
    leaf_size: int = 16,
    device: str | torch.device = "cuda",
) -> tuple[dict, TlasRefitContext]:
    """Build the two-level structure: (tl, refit context). The BLAS arrays
    the kernels read (``blasf_rows``, ``blas_rows``, ``mt_rows``,
    ``blas_test``, ``slot_tri``) and the refit's outputs live on ``device``
    (default the card; without one it raises); the JAX layouts
    ``blas_nodes`` and ``blasf_nodes``, which no kernel reads, stay host
    tensors."""
    device = setup_device(device)
    inst_mesh = np.asarray(inst_mesh, np.int64)
    transforms = np.asarray(transforms, np.float32)
    num_inst = len(inst_mesh)
    if mat_override is None:
        mat_override = np.full((num_inst,), -1, np.int64)
    mat_override = np.asarray(mat_override, np.int64)

    # ---- per-mesh BLAS, concatenated with rebased ids ---------------------
    blas_cols = []  # [8, m] blocks
    blasf_cols = []  # [16, f_pad] fat blocks
    mt_blocks = []
    slot_blocks = []
    mesh_root = np.zeros((len(meshes),), np.int64)
    mesh_fat_root = np.zeros((len(meshes),), np.int64)
    mesh_lo = np.zeros((len(meshes), 3), np.float32)
    mesh_hi = np.zeros((len(meshes), 3), np.float32)
    node_base = 0
    fat_base = 0
    row_base = 0
    tri_base = 0
    for k, (v0, e1, e2) in enumerate(meshes):
        v0 = np.asarray(v0, np.float32)
        e1 = np.asarray(e1, np.float32)
        e2 = np.asarray(e2, np.float32)
        nodes = bvh_mod.build_nodes(v0, e1, e2, len(v0), leaf_size)[0]  # SAH, else Morton
        new_child, slot_tri = _regularize_leaves(nodes, leaf_size)
        m = len(new_child)
        mesh_root[k] = node_base
        mesh_fat_root[k] = fat_base
        mesh_lo[k] = np.asarray(nodes["nodes_lo"], np.float32)[0]
        mesh_hi[k] = np.asarray(nodes["nodes_hi"], np.float32)[0]

        # fat twin of this BLAS, rebased: leaf ptrs by the concatenated
        # mt-row base, internal ptrs by fat_base
        fat = fat_nodes(
            np.asarray(nodes["nodes_lo"], np.float32),
            np.asarray(nodes["nodes_hi"], np.float32),
            new_child,
        )
        for side in range(2):
            meta = fat[13 + 2 * side]
            fat[12 + 2 * side] += np.where(
                meta > 0.5, float(row_base),
                np.where(meta < -0.5, float(fat_base), 0.0),
            )
        blasf_cols.append(fat)
        fat_base += fat.shape[1]

        is_leaf = new_child[:, 0] < 0
        child = new_child.copy()
        child[is_leaf, 0] -= row_base  # -(start+1) -> -(start+row_base+1)
        child[~is_leaf, 0] += node_base
        child[~is_leaf, 1] += node_base

        cols = np.zeros((8, m), np.float32)
        cols[0:3] = np.asarray(nodes["nodes_lo"], np.float32).T
        cols[3:6] = np.asarray(nodes["nodes_hi"], np.float32).T
        cols[6] = child[:, 0].astype(np.float32)
        cols[7] = child[:, 1].astype(np.float32)
        blas_cols.append(cols)

        # mt rows in slot order (padded slots zero: det 0, they never hit)
        s = len(slot_tri)
        s_pad = max(-(-s // 128) * 128, 128)
        tri_rows = _mt_pack_rows(v0, e1, e2)
        rows = np.zeros((s_pad, 128), np.float32)
        valid = slot_tri >= 0
        rows[:s][valid] = tri_rows[slot_tri[valid]]
        mt_blocks.append(rows)

        slot_pad = np.full((s_pad,), -1, np.int64)
        slot_pad[:s][valid] = slot_tri[valid] + tri_base
        slot_blocks.append(slot_pad)

        node_base += m
        row_base += s_pad
        tri_base += len(v0)

    m_total = node_base
    m_pad = max(-(-m_total // TLAS_PAD) * TLAS_PAD, TLAS_PAD)
    blas_nodes = np.zeros((8, m_pad), np.float32)
    blas_nodes[:, :m_total] = np.concatenate(blas_cols, axis=1)
    blasf_nodes = np.concatenate(blasf_cols, axis=1)  # pads are 128-aligned
    mt_rows = np.concatenate(mt_blocks, axis=0)
    slot_tri_all = np.concatenate(slot_blocks).astype(np.int32)

    # ---- TLAS over instance world AABBs (implicit heap; Morton order) -----
    lo_w, hi_w = _world_aabbs_numpy(
        mesh_lo[inst_mesh], mesh_hi[inst_mesh], transforms
    )
    centroid = (lo_w + hi_w) * 0.5
    codes = bvh_mod.morton_codes(centroid, lo_w.min(0), hi_w.max(0))
    inst_order = np.argsort(codes, kind="stable").astype(np.int32)

    levels = 0
    while (1 << levels) < num_inst:
        levels += 1

    ctx = TlasRefitContext(
        inst_order=inst_order,
        slot_mesh_lo=mesh_lo[inst_mesh][inst_order],
        slot_mesh_hi=mesh_hi[inst_mesh][inst_order],
        slot_blas_root=mesh_root[inst_mesh][inst_order].astype(np.float32),
        slot_blas_fat_root=mesh_fat_root[inst_mesh][inst_order].astype(
            np.float32
        ),
        slot_mat_override=mat_override[inst_order].astype(np.float32),
        levels=levels,
        num_instances=num_inst,
    )
    dyn = refit_instances_arrays(ctx, transforms, device)
    mt_dev = torch.as_tensor(mt_rows).to(device)
    tl = {
        "blas_nodes": torch.as_tensor(blas_nodes),
        "blasf_nodes": torch.as_tensor(blasf_nodes),
        "blasf_rows": torch.as_tensor(np.ascontiguousarray(blasf_nodes.T)).to(device),
        "blas_rows": torch.as_tensor(np.ascontiguousarray(blas_nodes.T)).to(device),
        "mt_rows": mt_dev,
        "blas_test": coef_records(mt_dev),
        "slot_tri": torch.as_tensor(slot_tri_all).to(device),
        **dyn,
    }
    return tl, ctx


def _world_aabbs_numpy(mesh_lo, mesh_hi, transforms):
    corners = _aabb_corners(mesh_lo, mesh_hi)
    rot = transforms[:, :3, :3]
    trans = transforms[:, :3, 3]
    world = np.einsum("ikj,icj->ick", rot, corners) + trans[:, None, :]
    return world.min(axis=1), world.max(axis=1)


def _upload(transforms, device: torch.device) -> torch.Tensor:
    """[I, 4, 4] float32 on ``device``: a host array travels in one
    non-blocking copy from pinned memory, so a refit inside a frame does not
    wait for the card."""
    if isinstance(transforms, torch.Tensor):
        if transforms.device == device:
            return transforms.to(torch.float32)
        host = transforms.detach().to("cpu", torch.float32)
    else:
        host = torch.from_numpy(np.ascontiguousarray(transforms, np.float32))
    if device.type != "cuda":
        return host.to(device)
    pinned = torch.empty(host.shape, dtype=torch.float32, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


def _inverse3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [I, 3, 3] matrices: the columns of inv(M) are
    the cross products of M's rows over det(M). No host synchronisation."""
    r0, r1, r2 = m[:, 0], m[:, 1], m[:, 2]
    c0 = torch.linalg.cross(r1, r2)
    c1 = torch.linalg.cross(r2, r0)
    c2 = torch.linalg.cross(r0, r1)
    det = (r0 * c0).sum(-1)
    return torch.stack([c0, c1, c2], dim=-1) / det[:, None, None]


def refit_instances_arrays(ctx: TlasRefitContext, transforms, device=None) -> dict:
    """Refit: new [I, 4, 4] transforms (original instance order; a numpy
    array or a tensor) -> fresh TLAS and instance arrays on ``device`` (by
    default the transforms' device, the host for a numpy array). No
    triangle work: the D3D12 PERFORM_UPDATE analogue."""
    if device is None:
        device = transforms.device if isinstance(transforms, torch.Tensor) else "cpu"
    device = torch.device(device)
    topo = ctx.on_device(device)
    i = ctx.num_instances
    tf = _upload(transforms, device)[topo["inst_order"]]
    rot = tf[:, :3, :3]
    trans = tf[:, :3, 3]
    a = _inverse3(rot)
    b = -(a * trans[:, None, :]).sum(-1)
    world = (rot[:, None, :, :] * topo["corners"][:, :, None, :]).sum(-1) + trans[:, None, :]

    # implicit heap reduce; padding leaves start inverted (+BIG, -BIG), which
    # reduces correctly into parents, and are then emitted as a point box at
    # +BIG, which misses (an inverted box passes the per-axis slab test)
    n_leaves = topo["n_leaves"]
    pad = torch.full((n_leaves - i, 3), BIG, dtype=torch.float32, device=device)
    los = [torch.cat([world.amin(1), pad])]
    his = [torch.cat([world.amax(1), -pad])]
    for _ in range(ctx.levels):
        los.append(torch.minimum(los[-1][0::2], los[-1][1::2]))
        his.append(torch.maximum(his[-1][0::2], his[-1][1::2]))
    his[0] = torch.cat([his[0][:i], pad])
    nodes_lo = torch.cat(list(reversed(los)))  # [Mt, 3]
    nodes_hi = torch.cat(list(reversed(his)))

    def cols(x, width, fill=0.0):  # [n, 3] -> [3, width]
        return torch.nn.functional.pad(x.T, (0, width - x.shape[0]), value=fill)

    tlas = torch.cat([cols(nodes_lo, topo["mt_pad"]), cols(nodes_hi, topo["mt_pad"]),
                      topo["tlas_lr"]])
    empty = torch.full((1, 3), BIG, dtype=torch.float32, device=device)
    lo_ext, hi_ext = torch.cat([nodes_lo, empty]), torch.cat([nodes_hi, empty])
    c0, c1 = topo["fat_cids"][0], topo["fat_cids"][1]
    f_pad = topo["f_pad"]
    tlasf = torch.cat([cols(lo_ext[c0], f_pad, BIG), cols(hi_ext[c0], f_pad, BIG),
                       cols(lo_ext[c1], f_pad, BIG), cols(hi_ext[c1], f_pad, BIG),
                       topo["fat_meta"]])
    i_pad = topo["i_pad"]
    dyn_rows = torch.cat([a.reshape(i, 9).T, b.T])  # [12, I]
    inst_rows = torch.cat([torch.nn.functional.pad(dyn_rows, (0, i_pad - i)),
                           topo["inst_const"]])
    inst_nm = torch.nn.functional.pad(a.transpose(1, 2), (0, 0, 0, 0, 0, i_pad - i))
    return {
        "tlas_nodes": tlas,
        "tlas_rows": tlas.T.contiguous(),
        "tlasf_nodes": tlasf,
        "tlasf_rows": tlasf.T.contiguous(),
        "inst_rows": inst_rows,
        "inst_rows_t": inst_rows[:16].T.contiguous(),
        "inst_nm": inst_nm,
        "inst_mat_override": topo["inst_mat_override"],
        "inst_orig": topo["inst_orig"],
    }


# --------------------------------------------------------------------------- #
# Plain versions of kernel B6a: brute force over every instance
# --------------------------------------------------------------------------- #
_OBJ_KEYS = ("v0", "e1", "e2", "pn", "c1", "c2", "d0")


def _instances(scene: dict):
    """(slot, A [3, 3], b [3], object-space triangles of the slot's mesh,
    first triangle index) for every instance, in slot order."""
    meta = scene["tlas_meta"]
    tl = scene["tlas"]
    i = meta["num_instances"]
    a_all = tl["inst_rows"][0:9, :i].T.reshape(i, 3, 3)
    b_all = tl["inst_rows"][9:12, :i].T
    subs = {}
    for slot in range(i):
        mesh = int(meta["slot_mesh"][slot])
        if mesh not in subs:
            lo_t, hi_t = meta["mesh_tri_ranges"][mesh]
            subs[mesh] = ({k: scene[f"{k}_obj"][lo_t:hi_t] for k in _OBJ_KEYS}, lo_t)
        yield (slot, a_all[slot], b_all[slot], *subs[mesh])


def two_level_closest_reference(scene: dict, origins, directions, t_min=1e-4, t_max=3.0e37,
                                cull_backface: bool = False) -> dict:
    """Plain version of the two-level closest hit (``two_level_closest_jnp``):
    per instance, transform the rays into object space with float32 products
    and test them against the mesh's triangles (``ops/intersect.py``).
    Returns {"hit", "t" (-1 on a miss), "tri" (concatenated object-space
    index), "slot" (BLAS leaf slot), "u", "v", "inst" (sorted slot)}, -1 or
    0 on a miss."""
    n = origins.shape[0]
    dev = origins.device
    best_t = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_inst = torch.full((n,), -1, dtype=torch.int64, device=dev)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    for slot, a, b, sub, lo_t in _instances(scene):
        o2 = origins @ a.T + b
        d2 = directions @ a.T
        h = intersect.intersect_closest(sub, o2, d2, t_min, torch.minimum(t_max, best_t),
                                        cull_backface=cull_backface)
        better = h["hit"] & (h["t"] < best_t)
        best_t = torch.where(better, h["t"], best_t)
        best_tri = torch.where(better, h["tri"] + lo_t, best_tri)
        best_u = torch.where(better, h["u"], best_u)
        best_v = torch.where(better, h["v"], best_v)
        best_inst = torch.where(better, slot, best_inst)
    hit = best_tri >= 0
    slot_of = _slot_of_tri(scene["tlas"], int(scene["v0_obj"].shape[0]))
    return {
        "hit": hit,
        "t": torch.where(hit, best_t, -1.0),
        "tri": best_tri,
        "slot": torch.where(hit, slot_of[best_tri.clamp(min=0)], -1),
        "u": best_u,
        "v": best_v,
        "inst": best_inst,
    }


def two_level_any_reference(scene: dict, origins, directions, t_min=1e-4,
                            t_max=3.0e37) -> torch.Tensor:
    """Plain version of the two-level occlusion query (``two_level_any_jnp``):
    [R] bool, True where a triangle of any instance blocks (t_min, t_max).
    Zero-direction rays are never occluded."""
    occ = torch.zeros((origins.shape[0],), dtype=torch.bool, device=origins.device)
    for _, a, b, sub, _ in _instances(scene):
        occ = occ | intersect.intersect_any(sub, origins @ a.T + b, directions @ a.T,
                                            t_min, t_max)
    return occ
