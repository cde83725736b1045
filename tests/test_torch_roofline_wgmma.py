"""The overlap probe's warpgroup-MMA layout and schedules (B7, csrc/roofline.cu).

The kernel takes each product transposed, D^T [64 columns, 1024 rows] =
B^T [64, 16] x mt^T [16, 1024]: mt, split once per block into TF32 hi and
lo parts, is wgmma's shared-memory operand (a descriptor per 8 x N tile),
and the scaled rays B^T are its register fragments. The host models below
(``mt_smem_offset``, ``mt_descriptor``, ``tile_schedule``,
``product_schedule``) restate what the kernel encodes, with the layout
constants read from csrc/roofline.cu; these tests hold them to the PTX
ISA's layouts (K-major core matrices without swizzle; the m64nNk8 TF32
register fragments of A and of the accumulator) and to
benchmarks/roofline.py's schedule, and hold the
kernel's split product (a software ``cvt.rna``, three passes per k step in
the kernel's order) to roofline.py's HIGHEST product within 2 K float32
ulps of the sum of |terms|, both directly and through roofline.py's own
overlap kernel in interpret mode (``roofline_kernels``). The card runs the
kernel itself (tests/test_torch_cuda.py, chip_smoke.py phase 37).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dxrexperiments_torch.ops import roofline as rf
from test_torch_roofline import GRID, M_ITERS, input_set, roofline_kernels  # noqa: F401

CU = (Path(__file__).resolve().parents[1] / "dxrexperiments_torch" / "csrc"
      / "roofline.cu").read_text()


def cu_int(name):
    """The value of ``constexpr int|uint32_t name = <literal>;`` in roofline.cu."""
    return int(re.search(rf"constexpr (?:int|uint32_t) {name} = (\d+);", CU).group(1))


# the overlap kernel's layout: blocks of OV_GROUPS warpgroups, each taking
# TILE_COLS columns at a time (wgmma's M); a product is taken transposed,
# mt's rows as wgmma's N: rows 0..Z_ROWS-1 in one tile, the rest in tiles of
# X_ROWS; SBO bytes between the core matrices of 8 rows, LBO between the
# 4-wide k chunks
TILE_COLS, OV_GROUPS, Z_ROWS, X_ROWS, SBO = (
    cu_int(n) for n in ("kTileCols", "kOvGroups", "kZRows", "kXRows", "kSBO"))
ROWS = 4 * rf.C_TRIS
LBO = (ROWS // 8) * SBO
assert "constexpr uint32_t kLBO = (kRows / 8) * kSBO;" in CU
ULP_GATE = 2 * rf.K * 2.0**-23  # 2 K float32 ulps of sum |terms|
X_TILES = (ROWS - Z_ROWS) // X_ROWS
# (first row, N) of each row tile of a product: rows 0..63, then the n160 tiles
ROW_TILES = [(0, Z_ROWS)] + [(Z_ROWS + x * X_ROWS, X_ROWS) for x in range(X_TILES)]


def mt_smem_offset(n, k):
    """Float offset of mt[n][k] within one TF32 part (hi or lo) of the
    kernel's shared memory (its ``mt_offset``): K-major core matrices
    without swizzle, 8 rows x 4 k (16 bytes a row, 128 bytes together), the
    ROWS / 8 row groups of one 4-wide k chunk one after another, the K / 4
    chunks LBO bytes apart. Takes ints or numpy arrays."""
    return ((k >> 2) * (ROWS // 8) + (n >> 3)) * 32 + (n & 7) * 4 + (k & 3)


def mt_descriptor(part_addr, n0, ks):
    """The 64-bit wgmma matrix descriptor (the kernel's ``mt_desc``) of the
    8 x N operand of mt rows n0.. and k 8 ks.. in the part at shared address
    part_addr: start address >> 4 in bits 0-13, LBO >> 4 in 16-29, SBO >> 4
    in 32-45, base offset 0, layout type 0 (no swizzle)."""
    addr = part_addr + 4 * int(mt_smem_offset(n0, 8 * ks))
    return ((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) | ((SBO >> 4) << 32)


def tile_schedule(grid, sms):
    """The column tiles each warpgroup takes, in order, indexed blockIdx.x *
    OV_GROUPS + warpgroup (``dxr_roofline_overlap`` launches min(sms,
    pairs) blocks): block x walks the tile pairs x, x + blocks, ..., its
    warpgroup w the pair's tile w. Tile t is columns t * TILE_COLS.. of the
    [SUB, LANES * grid] outputs."""
    pairs = rf.LANES * grid // TILE_COLS // OV_GROUPS
    blocks = min(sms, pairs)
    return [[pair * OV_GROUPS + w for pair in range(x, pairs, blocks)]
            for x in range(blocks) for w in range(OV_GROUPS)]


def product_schedule(m_iters, vector_scale):
    """The kernel's loop of one warpgroup, as events: group g of
    max(vector_scale, 1) iterations issues its product with the group's
    first iteration (reading tacc as it stands), runs the group's FMA steps
    while the wgmmas are in flight, then waits and folds rows 0..7 into
    tacc. Returns (iteration, products in tacc when it was read) of each
    product and the FMA steps taken."""
    steps, folded, fma_steps, issued = max(vector_scale, 1), 0, 0, []
    for g in range(m_iters):
        issued.append((g * steps, folded))
        fma_steps += steps * rf.V_UNROLL
        folded += 1  # wgmma_wait, then tacc += rows 0..7 * 1e-30
    return issued, fma_steps


def tf32(x):
    """cvt.rna.tf32.f32: round float32 to 10 mantissa bits, ties away from zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """x = hi + lo, both TF32 (the kernel's ``split``)."""
    x = np.asarray(x, np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def smem_parts(mt):
    """The block's shared memory as the kernel writes it: [2 parts, K * ROWS]
    float32, hi then lo, each element at ``mt_smem_offset``."""
    hi, lo = split(mt)
    n, k = np.meshgrid(np.arange(ROWS), np.arange(rf.K), indexing="ij")
    out = np.full((2, ROWS * rf.K), np.nan, np.float32)
    out[0, mt_smem_offset(n, k)] = hi
    out[1, mt_smem_offset(n, k)] = lo
    return out


def read_operand(smem_bytes, desc, n_rows):
    """The [n_rows, 8] K-major operand a descriptor names, read by the PTX
    ISA's canonical layout without swizzle: row n, k at start + (n // 8) SBO
    + (n % 8) 16 + (k // 4) LBO + (k % 4) 4 bytes."""
    start = (desc & 0x3FFF) << 4
    lbo, sbo = ((desc >> 16) & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4
    assert (desc >> 49) & 7 == 0 and desc >> 62 == 0  # base offset 0, no swizzle
    n, k = np.meshgrid(np.arange(n_rows), np.arange(8), indexing="ij")
    addr = start + (n // 8) * sbo + (n % 8) * 16 + (k // 4) * lbo + (k % 4) * 4
    return smem_bytes.view(np.float32)[addr // 4]


def fragment_a(tid, ks, r):
    """(column, k) of B^T entry [ks][r] of thread tid (the kernel's ``ray``)."""
    warp, lane = tid // 32, tid % 32
    return 16 * warp + lane // 4 + 8 * (r & 1), 8 * ks + lane % 4 + 4 * (r >> 1)


def fragment_d(tid, e):
    """(column, product row) of accumulator entry e of thread tid."""
    warp, lane = tid // 32, tid % 32
    return 16 * warp + lane // 4 + 8 * ((e >> 1) & 1), 8 * (e >> 2) + 2 * (lane % 4) + (e & 1)


def split_product(mt, bt):
    """The kernel's product D^T = bt [C, 16] x mt^T: per k step of 8 the
    passes B_hi mt_lo, B_lo mt_hi, B_hi mt_hi, each wgmma's dot of TF32
    values exact and added to the float32 accumulator with one rounding.
    Returns D = its transpose, [ROWS, C]."""
    (m_hi, m_lo), (b_hi, b_lo) = split(mt), split(bt)
    d = np.zeros((bt.shape[0], mt.shape[0]), np.float32)
    for ks in range(2):
        sl = slice(8 * ks, 8 * ks + 8)
        for b_part, m_part in ((b_hi, m_lo), (b_lo, m_hi), (b_hi, m_hi)):
            dot = b_part[:, sl].astype(np.float64) @ m_part[:, sl].astype(np.float64).T
            d = (d.astype(np.float64) + dot).astype(np.float32)
    return d.T


def test_mt_layout_lands_every_element_once():
    n, k = np.meshgrid(np.arange(ROWS), np.arange(rf.K), indexing="ij")
    off = mt_smem_offset(n, k).ravel()
    assert sorted(off.tolist()) == list(range(ROWS * rf.K))
    # core matrices: 8 rows of 16 bytes contiguous, row groups SBO apart, k chunks LBO apart
    assert mt_smem_offset(8, 0) * 4 == SBO and mt_smem_offset(0, 4) * 4 == LBO
    assert LBO >> 4 < 1 << 14 and SBO % 16 == 0


@pytest.mark.parametrize("part", [0, 1], ids=["hi", "lo"])
@pytest.mark.parametrize("ks", [0, 1])
@pytest.mark.parametrize("n0,n_rows", ROW_TILES)
def test_descriptor_reads_mt_tile(n0, n_rows, ks, part):
    mt = input_set("seeded")[2]
    smem = smem_parts(mt)
    assert not np.isnan(smem).any()
    base = 1024  # a 16-byte aligned shared address of the hi part
    space = np.zeros(base + smem.nbytes, np.uint8)
    space[base:] = smem.view(np.uint8).ravel()
    desc = mt_descriptor(base + part * ROWS * rf.K * 4, n0, ks)
    got = read_operand(space, desc, n_rows)
    want = split(mt)[part][n0:n0 + n_rows, 8 * ks:8 * ks + 8]
    np.testing.assert_array_equal(got, want)


def test_register_fragments_cover_the_tile():
    seen_a = np.zeros((TILE_COLS, rf.K), int)
    for tid in range(128):
        for ks in range(2):
            for r in range(4):
                col, k = fragment_a(tid, ks, r)
                # the PTX ISA's m64nNk8 TF32 A fragment: a0 (g, t), a1 (g + 8, t),
                # a2 (g, t + 4), a3 (g + 8, t + 4) in each warp's 16 rows
                warp, lane = tid // 32, tid % 32
                ptx_row = 16 * warp + lane // 4 + (8 if r in (1, 3) else 0)
                ptx_col = lane % 4 + (4 if r in (2, 3) else 0)
                assert (col, k - 8 * ks) == (ptx_row, ptx_col)
                seen_a[col, k] += 1
    assert (seen_a == 1).all()
    for n_rows in (Z_ROWS, X_ROWS):
        seen_d = np.zeros((TILE_COLS, n_rows), int)
        for tid in range(128):
            for e in range(n_rows // 2):
                seen_d[fragment_d(tid, e)] += 1
        assert (seen_d == 1).all()
    # entries 0..3 of the rows-0..63 tile are tacc: rows 0..7 of every column once,
    # and row 0 of a thread's columns sits in entries 0 and 2 of lane & ~3
    seen_t = np.zeros((rf.SUB, TILE_COLS), int)
    for tid in range(128):
        for e in range(4):
            col, row = fragment_d(tid, e)
            seen_t[row, col] += 1
            holder = tid & ~3
            assert fragment_d(holder, 2 * (e >> 1)) == (col, 0)
    assert (seen_t == 1).all()


@pytest.mark.parametrize("which", ["roofline", "seeded", "product_visible"])
def test_split_product_matches_highest(which):
    import jax
    import jax.numpy as jnp

    _, _, mt, rays = input_set(which)
    bt = np.ascontiguousarray(rays.T[:3 * TILE_COLS])
    got = split_product(mt, bt)
    want = np.asarray(jax.lax.dot_general(jnp.asarray(mt), jnp.asarray(bt.T),
                                          (((1,), (0,)), ((), ())),
                                          precision=jax.lax.Precision.HIGHEST,
                                          preferred_element_type=jnp.float32))
    scale = np.abs(mt).astype(np.float64) @ np.abs(bt.T).astype(np.float64)
    assert (np.abs(got - want) <= ULP_GATE * scale).all()
    exact = mt.astype(np.float64) @ bt.T.astype(np.float64)
    assert (np.abs(got - exact) <= ULP_GATE * scale).all()


def test_split_product_through_roofline_kernel(roofline_kernels):  # noqa: F811
    """roofline.py's matrix-alone kernel in interpret mode on inputs whose
    product shows in t (b = 0, mt and rays ~ 1e15): t against the kernel's
    schedule of split products, each fed back as the kernel does."""
    import jax.numpy as jnp

    kernels, real = roofline_kernels
    kernel, specs = kernels[(False, True, 1)]
    a, b, mt, rays = input_set("product_visible")
    _, t = (np.asarray(x) for x in real(kernel, **specs)(*(jnp.asarray(x)
                                                           for x in (a, b, mt, rays))))
    tacc = np.tile(b, (1, GRID))
    rays_g = np.tile(rays, (1, GRID))
    for _ in range(M_ITERS):
        bt = (rays_g * (np.float32(1.0) + tacc[0:1] * np.float32(1e-30))).T
        tacc = tacc + split_product(mt, np.ascontiguousarray(bt))[0:rf.SUB] * np.float32(1e-30)
    scale = np.tile(np.abs(mt[:rf.SUB]).astype(np.float64) @ np.abs(rays).astype(np.float64),
                    (1, GRID)) * 1e-30
    assert float(np.abs(t).max()) > 1.0  # the products do show
    assert (np.abs(tacc - t) <= M_ITERS * ULP_GATE * scale).all()


@pytest.mark.parametrize("grid,sms", [(rf.GRID, 132), (rf.GRID, 114), (rf.SMOKE_GRID, 132),
                                      (3, 7), (1, 1)])
def test_tile_schedule_covers_every_column_once(grid, sms):
    sched = tile_schedule(grid, sms)
    assert len(sched) == OV_GROUPS * min(sms, rf.LANES * grid // TILE_COLS // OV_GROUPS)
    cols = np.zeros(rf.LANES * grid, int)
    for tiles in sched:
        for t in tiles:
            cols[t * TILE_COLS:(t + 1) * TILE_COLS] += 1
    assert (cols == 1).all()
    for x in range(0, len(sched), OV_GROUPS):  # a block's warpgroups loop together
        block = sched[x:x + OV_GROUPS]
        assert len({len(tiles) for tiles in block}) == 1
        # grid block 0's tiles (keep_product) come in whole pairs
        for pair in zip(*block):
            assert len({t < rf.LANES // TILE_COLS for t in pair}) == 1


@pytest.mark.parametrize("m_iters,scale", [(2, 1), (2, 2), (3, 4), (M_ITERS, 0),
                                           (rf.M_ITERS, 4), (rf.M_ITERS, 25)])
def test_product_schedule_matches_roofline(m_iters, scale):
    """roofline.py's body: iteration i issues a product when vpu_scale <= 1
    or i % vpu_scale == 0, reading tacc with every earlier product in it."""
    want, folded = [], 0
    for i in range(m_iters * max(scale, 1)):
        if scale <= 1 or i % scale == 0:
            want.append((i, folded))
            folded += 1
    assert product_schedule(m_iters, scale) == (want, m_iters * max(scale, 1) * rf.V_UNROLL)


def test_overlap_wrapper_keeps_its_checks():
    a, b, mt, rays = rf.probe_inputs("cpu", seed=1)
    with pytest.raises(ValueError):
        rf.prepare_overlap(a, b, mt[:-1].contiguous(), rays, True, True, 1)
    got = rf.overlap(a, b, mt, rays, True, True, 1, 1, 1)
    assert tuple(got["product"].shape) == (ROWS, rf.LANES) and got["t"].dtype == torch.float32
