"""Host BVH builds (``dxrexperiments_tpu.accel.bvh``, numpy parts).

Two builders emit one explicit node-array format that
``ops.traverse.pack_for_traversal`` turns into the kernels' arrays:

  * ``build_bvh`` + ``to_node_arrays``: Morton sort of the triangle
    centroids and the implicit complete binary tree over that order
    (node k's children are 2k+1/2k+2, leaves are K consecutive sorted
    triangles);
  * ``build_bvh_sah``: the binned-SAH builder in ``csrc/sah_bvh.cpp``,
    compiled with g++ at first use (``utils/native.py``).

``build_nodes`` picks the SAH build and falls back to the Morton build when
no C++ compiler is there, as the JAX package's ``Scene.build`` does.
``collapse_wide`` turns the binary tree into the 8-wide tree of kernel B4d.
``traverse_numpy`` and ``traverse_nodes_numpy`` (with ``ray_aabb``) walk
either format one ray at a time on the host: the tests' oracles.
The numpy code is copied line for line, so every build equals the JAX
package's. ``build_bvh_device`` is the same Morton build in torch on the
tensors' device, for per-frame rebuilds of re-baked geometry
(``scene/dynamic.bake_instances``); its ``order`` equals ``build_bvh``'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.profiling import annotate


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd bit (for 30-bit 3D Morton codes)."""
    v = v.astype(np.uint32)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(centroids: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """30-bit Morton code of each centroid within [lo, hi]."""
    extent = np.maximum(hi - lo, 1e-12)
    q = np.clip((centroids - lo) / extent, 0.0, 1.0)
    q = np.minimum((q * 1024.0).astype(np.uint32), 1023)
    return (
        (_expand_bits(q[:, 0]) << 2)
        | (_expand_bits(q[:, 1]) << 1)
        | _expand_bits(q[:, 2])
    )


@dataclasses.dataclass
class BVHLayout:
    """Static description of an implicit BVH (shapes only)."""

    levels: int  # leaf level depth; 2**levels leaves
    leaf_size: int  # triangles per leaf

    @property
    def num_leaves(self) -> int:
        return 1 << self.levels

    @property
    def num_nodes(self) -> int:
        return (1 << (self.levels + 1)) - 1

    @property
    def padded_tris(self) -> int:
        return self.num_leaves * self.leaf_size


def choose_layout(num_tris: int, leaf_size: int = 8, max_levels: int = 16) -> BVHLayout:
    levels = 0
    while (1 << levels) * leaf_size < num_tris and levels < max_levels:
        levels += 1
    return BVHLayout(levels=levels, leaf_size=leaf_size)


def build_bvh(
    v0: np.ndarray,
    e1: np.ndarray,
    e2: np.ndarray,
    num_tris: int,
    leaf_size: int = 8,
) -> dict:
    """Build the implicit Morton BVH on the host. Inputs may include padding
    (degenerate) triangles beyond num_tris; they are ignored.

    Returns {"order" [P] int32 (sorted triangle permutation, padded entries
    -1), "nodes_lo"/"nodes_hi" [M, 3] f32 (heap order), "levels",
    "leaf_size"}.
    """
    v0 = np.asarray(v0, np.float32)[:num_tris]
    e1 = np.asarray(e1, np.float32)[:num_tris]
    e2 = np.asarray(e2, np.float32)[:num_tris]
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)
    centroid = (tri_lo + tri_hi) * 0.5

    layout = choose_layout(max(num_tris, 1), leaf_size)
    P = layout.padded_tris

    if num_tris > 0:
        codes = morton_codes(centroid, tri_lo.min(0), tri_hi.max(0))
        order = np.argsort(codes, kind="stable").astype(np.int32)
    else:
        order = np.zeros((0,), np.int32)

    order_p = np.full((P,), -1, np.int32)
    order_p[:num_tris] = order

    # Leaf AABBs: per leaf, min/max over its K sorted triangles.
    INF = np.float32(np.inf)
    slot_lo = np.full((P, 3), INF, np.float32)
    slot_hi = np.full((P, 3), -INF, np.float32)
    slot_lo[:num_tris] = tri_lo[order]
    slot_hi[:num_tris] = tri_hi[order]
    leaf_lo = slot_lo.reshape(layout.num_leaves, leaf_size, 3).min(1)
    leaf_hi = slot_hi.reshape(layout.num_leaves, leaf_size, 3).max(1)

    # Bottom-up heap fit.
    nodes_lo = np.full((layout.num_nodes, 3), INF, np.float32)
    nodes_hi = np.full((layout.num_nodes, 3), -INF, np.float32)
    first_leaf = layout.num_leaves - 1
    nodes_lo[first_leaf:] = leaf_lo
    nodes_hi[first_leaf:] = leaf_hi
    for level in range(layout.levels - 1, -1, -1):
        start = (1 << level) - 1
        end = (1 << (level + 1)) - 1
        child = 2 * np.arange(start, end) + 1
        nodes_lo[start:end] = np.minimum(nodes_lo[child], nodes_lo[child + 1])
        nodes_hi[start:end] = np.maximum(nodes_hi[child], nodes_hi[child + 1])

    return {
        "order": order_p,
        "nodes_lo": nodes_lo,
        "nodes_hi": nodes_hi,
        "levels": layout.levels,
        "leaf_size": leaf_size,
    }


def _expand_bits_int64(v: torch.Tensor) -> torch.Tensor:
    """``_expand_bits`` on int64 tensors. The uint32 version wraps in its
    multiplies; here the products stay exact and each mask keeps only bits
    below 2^32, so (x mod 2^32) & m == x & m and the codes are the same."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def build_bvh_device(v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor, num_tris: int,
                     leaf_size: int = 8) -> dict:
    """``build_bvh`` in torch on the tensors' device: the Morton sort (stable,
    so ``order`` equals the host build's) and log2(N) pairwise min/max
    reductions, for per-frame rebuilds of deforming or re-baked geometry
    (the analogue of a D3D12 BLAS rebuild). Returns the same keys as
    ``build_bvh``: "order" [P] int32 (-1 in empty slots), "nodes_lo" /
    "nodes_hi" [M, 3] float32 in heap order (tensors), "levels" and
    "leaf_size" (ints)."""
    v0, e1, e2 = (x[:num_tris].to(torch.float32) for x in (v0, e1, e2))
    device = v0.device
    p1, p2 = v0 + e1, v0 + e2
    tri_lo = torch.minimum(torch.minimum(v0, p1), p2)
    tri_hi = torch.maximum(torch.maximum(v0, p1), p2)
    centroid = (tri_lo + tri_hi) * 0.5

    layout = choose_layout(max(num_tris, 1), leaf_size)
    P = layout.padded_tris

    if num_tris > 0:
        lo = tri_lo.amin(0)
        extent = torch.clamp(tri_hi.amax(0) - lo, min=1e-12)
        q = torch.clamp((centroid - lo) / extent, 0.0, 1.0)
        q = torch.clamp((q * 1024.0).to(torch.int64), max=1023)
        codes = ((_expand_bits_int64(q[:, 0]) << 2) | (_expand_bits_int64(q[:, 1]) << 1)
                 | _expand_bits_int64(q[:, 2]))
        order = torch.argsort(codes, stable=True)
    else:
        order = torch.zeros((0,), dtype=torch.int64, device=device)

    slot_lo = torch.full((P, 3), float("inf"), dtype=torch.float32, device=device)
    slot_hi = torch.full((P, 3), float("-inf"), dtype=torch.float32, device=device)
    slot_lo[:num_tris] = tri_lo[order]
    slot_hi[:num_tris] = tri_hi[order]
    order_p = torch.full((P,), -1, dtype=torch.int32, device=device)
    order_p[:num_tris] = order.to(torch.int32)

    los = [slot_lo.reshape(layout.num_leaves, leaf_size, 3).amin(1)]
    his = [slot_hi.reshape(layout.num_leaves, leaf_size, 3).amax(1)]
    for _ in range(layout.levels):
        los.append(torch.minimum(los[-1][0::2], los[-1][1::2]))
        his.append(torch.maximum(his[-1][0::2], his[-1][1::2]))
    # heap order: the root's level last in the lists
    return {
        "order": order_p,
        "nodes_lo": torch.cat(list(reversed(los))),
        "nodes_hi": torch.cat(list(reversed(his))),
        "levels": layout.levels,
        "leaf_size": leaf_size,
    }


# Explicit node-array format, emitted by both builders:
#   nodes_lo/hi [M, 3] f32; child [M, 2] i32
#     internal: child[m] = {left, right}
#     leaf:     child[m] = {-(start+1), count}   (range into `order`)
#   order [T] i32 (contiguous leaf runs)
def to_node_arrays(bvh: dict) -> dict:
    """Convert the implicit heap BVH to explicit node arrays (leaves become
    ranges of `leaf_size` slots; empty padding slots are dropped per leaf)."""
    levels, leaf_size = bvh["levels"], bvh["leaf_size"]
    num_leaves = 1 << levels
    num_nodes = 2 * num_leaves - 1
    first_leaf = num_leaves - 1
    order = bvh["order"]
    child = np.zeros((num_nodes, 2), np.int32)
    internal = np.arange(first_leaf)
    child[internal, 0] = 2 * internal + 1
    child[internal, 1] = 2 * internal + 2
    leaf_ids = np.arange(num_leaves)
    starts = leaf_ids * leaf_size
    counts = np.minimum(
        np.maximum((order >= 0).sum() - starts, 0), leaf_size
    ).astype(np.int32)
    child[first_leaf:, 0] = -(starts + 1)
    child[first_leaf:, 1] = counts
    return {
        "nodes_lo": np.asarray(bvh["nodes_lo"], np.float32),
        "nodes_hi": np.asarray(bvh["nodes_hi"], np.float32),
        "child": child,
        "order": np.asarray(order, np.int32),
    }


def build_bvh_sah(
    v0: np.ndarray,
    e1: np.ndarray,
    e2: np.ndarray,
    num_tris: int,
    leaf_size: int = 8,
) -> dict | None:
    """Binned-SAH build via the native builder (``csrc/sah_bvh.cpp``),
    object splits only (the JAX package's default: its SBVH spatial splits
    are opt-in and not ported). Returns explicit node arrays, or None when
    g++ is missing."""
    from ..utils import native

    res = native.build_sah_native(
        np.asarray(v0, np.float32)[:num_tris],
        np.asarray(e1, np.float32)[:num_tris],
        np.asarray(e2, np.float32)[:num_tris],
        leaf_size,
    )
    if res is None:
        return None
    nodes_lo, nodes_hi, child, order = res
    return {"nodes_lo": nodes_lo, "nodes_hi": nodes_hi, "child": child, "order": order}


def build_nodes(v0, e1, e2, num_tris: int, leaf_size: int) -> tuple[dict, str]:
    """Explicit node arrays from the SAH build, or from the Morton build when
    there is no C++ compiler. Returns (nodes, builder name: "sah" or
    "morton")."""
    with annotate("scene.bvh", int(num_tris)):
        nodes = build_bvh_sah(v0, e1, e2, num_tris, leaf_size)
        if nodes is not None:
            return nodes, "sah"
        return to_node_arrays(build_bvh(v0, e1, e2, num_tris, leaf_size)), "morton"


def collapse_wide(
    nodes_lo: np.ndarray,
    nodes_hi: np.ndarray,
    child: np.ndarray,
    width: int = 8,
) -> dict:
    """Collapse explicit binary node arrays into WIDTH-wide nodes.

    Starting at each wide root, the largest-surface-area internal slot is
    expanded until `width` slots are filled, so one node visit tests 8
    subtrees' boxes (kernel B4d, ``csrc/traverse8.cu``). Binary leaves are
    kept verbatim (same slot ranges), so the wide tree shares its triangle
    layout with the binary one. Copied line for line from the JAX package,
    so the wide tree is bit-equal to its build.

    Returns {"w_lo"/"w_hi" [W, width, 3] f32, "w_child" [W, width] f32,
    "w_count" [W, width] f32} with the encoding:
      internal slot: w_child = wide child id,  w_count = -1
      leaf slot:     w_child = -(start+1),     w_count = tri count
      empty slot:    w_child = 0,              w_count = 0, box at +BIG
    """
    big = np.float32(3.0e38)
    m = len(child)
    if m == 0:
        return {
            "w_lo": np.full((1, width, 3), big, np.float32),
            "w_hi": np.full((1, width, 3), big, np.float32),
            "w_child": np.zeros((1, width), np.float32),
            "w_count": np.zeros((1, width), np.float32),
        }
    ext = np.maximum(nodes_hi - nodes_lo, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    is_leaf = child[:, 0] < 0

    w_lo, w_hi, w_child, w_count = [], [], [], []
    # (wide_id, slot, binary_node) patches for internal slots filled after
    # their subtree's wide id is known.
    wide_of_binary: dict[int, int] = {}
    todo = [0]
    while todo:
        b_root = todo.pop()
        slots = [int(b_root)]
        while len(slots) < width:
            cand = [s for s in slots if not is_leaf[s]]
            if not cand:
                break
            s = max(cand, key=lambda n: area[n])
            slots.remove(s)
            slots.extend((int(child[s, 0]), int(child[s, 1])))
        wid = len(w_lo)
        wide_of_binary[int(b_root)] = wid
        lo = np.full((width, 3), big, np.float32)
        hi = np.full((width, 3), big, np.float32)
        cv = np.zeros((width,), np.float32)
        cn = np.zeros((width,), np.float32)
        for k, s in enumerate(slots):
            lo[k] = nodes_lo[s]
            hi[k] = nodes_hi[s]
            if is_leaf[s]:
                cv[k] = float(child[s, 0])  # already -(start+1)
                cn[k] = float(child[s, 1])
            else:
                cv[k] = float(s)  # patched to wide id below
                cn[k] = -1.0
                todo.append(int(s))
        w_lo.append(lo)
        w_hi.append(hi)
        w_child.append(cv)
        w_count.append(cn)

    w_child = np.stack(w_child)
    w_count = np.stack(w_count)
    internal = w_count < -0.5
    w_child[internal] = np.vectorize(
        lambda b: float(wide_of_binary[int(b)])
    )(w_child[internal]) if internal.any() else w_child[internal]
    return {
        "w_lo": np.stack(w_lo),
        "w_hi": np.stack(w_hi),
        "w_child": w_child,
        "w_count": w_count,
    }


# --------------------------------------------------------------------------- #
# Host traversal (numpy): the correctness oracles of the JAX package's tests
# --------------------------------------------------------------------------- #
def ray_aabb(o, inv_d, lo, hi, t_min, t_max) -> bool:
    """Slab test of one ray against one box: whether [t_min, t_max] meets it."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = np.minimum(t0, t1).max()
    tf = np.maximum(t0, t1).min()
    return max(tn, t_min) <= min(tf, t_max)


def traverse_numpy(bvh: dict, tri_test, o, d, t_min, t_max) -> tuple:
    """Scalar host walk of the implicit heap BVH of ``build_bvh``: returns
    (t, tri_index) or (inf, -1). tri_test(global_tri_idx, o, d) -> t or None."""
    inv_d = 1.0 / np.where(np.abs(d) > 1e-12, d, 1e-12)
    levels = bvh["levels"]
    leaf_size = bvh["leaf_size"]
    first_leaf = (1 << levels) - 1
    best = (np.inf, -1)
    stack = [0]
    while stack:
        node = stack.pop()
        if not ray_aabb(
            o, inv_d, bvh["nodes_lo"][node], bvh["nodes_hi"][node], t_min, min(t_max, best[0])
        ):
            continue
        if node >= first_leaf:
            leaf = node - first_leaf
            for s in range(leaf * leaf_size, (leaf + 1) * leaf_size):
                tri = bvh["order"][s]
                if tri < 0:
                    continue
                t = tri_test(int(tri), o, d)
                if t is not None and t_min < t < min(t_max, best[0]):
                    best = (t, int(tri))
        else:
            stack.append(2 * node + 1)
            stack.append(2 * node + 2)
    return best


def traverse_nodes_numpy(nodes: dict, tri_test, o, d, t_min, t_max) -> tuple:
    """Scalar host walk of explicit node arrays (``to_node_arrays``,
    ``build_bvh_sah``): returns (t, tri_index) or (inf, -1)."""
    inv_d = 1.0 / np.where(np.abs(d) > 1e-12, d, 1e-12)
    best = (np.inf, -1)
    if len(nodes["child"]) == 0:
        return best
    stack = [0]
    while stack:
        node = stack.pop()
        if not ray_aabb(
            o, inv_d, nodes["nodes_lo"][node], nodes["nodes_hi"][node], t_min,
            min(t_max, best[0]),
        ):
            continue
        left, right = nodes["child"][node]
        if left < 0:  # leaf
            start, count = -left - 1, right
            for s in range(start, start + count):
                tri = nodes["order"][s]
                if tri < 0:
                    continue
                t = tri_test(int(tri), o, d)
                if t is not None and t_min < t < min(t_max, best[0]):
                    best = (t, int(tri))
        else:
            stack.append(int(left))
            stack.append(int(right))
    return best
