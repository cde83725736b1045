"""The roofline probes (B7): wrappers and plain versions.

Port of the three probes of ``benchmarks/roofline.py`` (``fma_kernel``,
``mix_kernel``, ``make_ov_kernel``), with its shapes and iteration counts:
a and b are [SUB, LANES] blocks that every one of ``grid`` blocks reads,
each block writing its own [SUB, LANES] of an [SUB, LANES * grid] output.

- ``fma_peak``: the float32 FMA issue peak, CHAINS independent chains
  acc = acc * a + b per element, UNROLL steps per loop iteration;
- ``pair_mix``: the pair test's instruction mix (19 FMAs and about 10
  compare / min / select ops per step, MIX_UNROLL steps per iteration);
- ``overlap``: an FMA loop (V_UNROLL steps of CHAINS chains per iteration)
  beside a [4 C_TRIS, 16] x [16, LANES] float32 product every
  ``vector_scale``-th iteration, on the tensor cores in split TF32 (the
  TPU's HIGHEST precision), to see whether the two units overlap. The
  kernel runs the product on asynchronous warpgroup MMA from a copy of mt
  split once per block into shared memory (tests/test_torch_roofline_wgmma.py
  models its layout and schedules on the host).

On CUDA tensors the wrappers launch the hand-written kernels in
``csrc/roofline.cu`` or raise; on CPU tensors they take the plain versions
(``*_reference``), the same loops in PyTorch. Each FMA of a plain version
is rounded once, as the kernels' ``fmaf`` is (the product and sum are taken
in float64, then rounded to float32): a multiply and an add rounded apart
drift from the fused chain by up to 4e-4 relative over the 8,192 steps of
roofline.py's full size. There is no fallback from a kernel to its plain
version. ``chip_smoke.py`` runs them at roofline.py's
size and prints the card's rates beside its data sheet.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel

LANES = 1024
SUB = 8
CHAINS = 8  # independent FMA accumulator chains
UNROLL = 16  # FMA steps per loop iteration
MIX_UNROLL = 4  # pair-mix steps per loop iteration
V_UNROLL = 8  # FMA steps per overlap iteration
C_TRIS = 256  # the product's rows are 4 * C_TRIS
K = 16  # the product's depth
ITERS, GRID, M_ITERS = 512, 64, 128  # roofline.py's full size
SMOKE_ITERS, SMOKE_GRID, SMOKE_M_ITERS = 2, 2, 2  # its --interpret size
MIX_FMAS, MIX_OPS = 19, 29  # per step: the FMAs, and all ops as roofline.py counts them
# the a at which the mix step's linear part neither grows nor shrinks (its
# dominant eigenvalue is 1): the chains stay finite over ITERS * MIX_UNROLL
# steps only near it (roofline.py's a = 1.000001 overflows them to inf)
MIX_NEUTRAL_A = 0.6384133529

B7 = kernel.Kernel("B7", "roofline", {
    "dxr_roofline_vector": [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p],
    "dxr_roofline_overlap": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}, ("B7 fma", "B7 mix", "B7 overlap"))


def probe_inputs(device, seed: int | None = None) -> tuple[torch.Tensor, ...]:
    """(a, b [SUB, LANES], mt [4 C_TRIS, K], rays [K, LANES]) float32:
    roofline.py's constants (a = 1.000001, b = 1e-7, mt = 1e-3, rays = 1)
    without a seed, else values drawn from ``seed`` so that every element
    differs: a in [0.999, 1.001) and b in [0, 1e-3) (near roofline.py's, so
    the chains neither vanish nor cancel), mt and rays in [-1, 1)."""
    if seed is None:
        return (torch.full((SUB, LANES), 1.000001, device=device),
                torch.full((SUB, LANES), 1e-7, device=device),
                torch.full((4 * C_TRIS, K), 1e-3, device=device),
                torch.ones((K, LANES), device=device))
    g = torch.Generator().manual_seed(seed)

    def uniform(shape, lo, hi):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(device)

    return (uniform((SUB, LANES), 0.999, 1.001), uniform((SUB, LANES), 0.0, 1e-3),
            uniform((4 * C_TRIS, K), -1.0, 1.0), uniform((K, LANES), -1.0, 1.0))


def mix_inputs(device, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b [SUB, LANES]) float32 drawn from ``seed`` on which the mix
    stays finite and moves at full length: a in [MIX_NEUTRAL_A, MIX_NEUTRAL_A
    * 1.001), where the chains grow by up to 0.3% a step (e^6 over 2,048
    steps, so one step more or less changes most results by more than
    1e-4), and b in [0, 1e-3)."""
    g = torch.Generator().manual_seed(seed)
    a = MIX_NEUTRAL_A * (1.0 + 1e-3 * torch.rand((SUB, LANES), generator=g))
    return a.to(device), (1e-3 * torch.rand((SUB, LANES), generator=g)).to(device)


def max_rel_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| / |want| over the finite elements of want;
    inf where got and want differ in which elements are finite or in their
    non-finite values (roofline.py's own inputs overflow the mix to inf)."""
    finite = want.isfinite()
    if not torch.equal(finite, got.isfinite()):
        return float("inf")
    g, w = got[~finite], want[~finite]
    if not bool(((g == w) | (g.isnan() & w.isnan())).all()):
        return float("inf")
    if not bool(finite.any()):
        return 0.0
    return float(((got - want).abs() / want.abs())[finite].max())


def _fma(x: torch.Tensor, a64: torch.Tensor, b64: torch.Tensor) -> torch.Tensor:
    """fmaf(x, a, b) of float32 x, with a and b given in float64: the
    product of two float32 values is exact in float64, so the one rounding
    that matters is the last (two roundings differ from one only where the
    float64 sum lies on a float32 tie, at about 2^-29 of operations)."""
    return torch.addcmul(b64, x.double(), a64).float()


def _tiled(x: torch.Tensor, grid: int) -> torch.Tensor:
    """[SUB, LANES] -> [SUB, LANES * grid]: every grid block reads the same block."""
    return x.repeat(1, grid)


def fma_peak_reference(a, b, iters: int = ITERS, grid: int = GRID) -> torch.Tensor:
    """Plain version of ``fma_peak``."""
    a, b = _tiled(a, grid), _tiled(b, grid)
    a64, b64 = a.double(), b.double()
    accs = [a + float(k) for k in range(CHAINS)]
    for _ in range(iters * UNROLL):
        accs = [_fma(acc, a64, b64) for acc in accs]
    out = accs[0]
    for acc in accs[1:]:
        out = out + acc
    return out


def pair_mix_reference(a, b, iters: int = ITERS, grid: int = GRID) -> torch.Tensor:
    """Plain version of ``pair_mix``: roofline.py's mix_kernel step."""
    a, b = _tiled(a, grid), _tiled(b, grid)
    a64, b64, nb64 = a.double(), b.double(), -b.double()
    det, u, v, t, best = a, a + 1.0, a + 2.0, a + 3.0, b + 30.0
    for _ in range(iters * MIX_UNROLL):
        m0 = _fma(u, a64, b64)
        m1 = _fma(v, a64, nb64)
        m2 = _fma(t, a64, b64)
        det = _fma(det, a64, m0.double())
        det = _fma(det, a64, m1.double())
        det = _fma(det, a64, m2.double())
        u = _fma(u, a64, m0.double())
        u = _fma(u, a64, m1.double())
        u = _fma(u, a64, m2.double())
        u = _fma(u, a64, b64)
        v = _fma(v, a64, m0.double())
        v = _fma(v, a64, m1.double())
        v = _fma(v, a64, m2.double())
        v = _fma(v, a64, b64)
        t = _fma(t, a64, m0.double())
        t = _fma(t, a64, m1.double())
        t = _fma(t, a64, m2.double())
        t = _fma(t, a64, b64)
        det = _fma(det, a64, b64)
        s = torch.sign(det)
        da, us, vs = det * s, u * s, v * s
        soft = torch.minimum(torch.minimum(us, vs), da - (us + vs))
        strict = t * s - da
        ok = (soft >= 0.0) & (strict > 0.0)
        best = torch.where(ok & (t < best), t, best)
    return det + u + v + t + best


def overlap_reference(a, b, mt, rays, do_vector: bool, do_matrix: bool, vector_scale: int,
                      m_iters: int = M_ITERS, grid: int = GRID) -> dict:
    """Plain version of ``overlap``: the product in full float32."""
    at, bt = _tiled(a, grid), _tiled(b, grid)
    a64, b64 = at.double(), bt.double()
    accs = [at + float(k) for k in range(CHAINS)]
    tacc = bt.reshape(SUB, grid, LANES).transpose(0, 1).clone()  # [grid, SUB, LANES]
    product = None
    for i in range(m_iters * max(vector_scale, 1)):
        if do_vector:
            for _ in range(V_UNROLL):
                accs = [_fma(acc, a64, b64) for acc in accs]
        if do_matrix and (vector_scale <= 1 or i % vector_scale == 0):
            terms = mt @ (rays * (1.0 + tacc[:, 0:1, :] * 1e-30))  # [grid, 4C, LANES]
            tacc = tacc + terms[:, 0:SUB, :] * 1e-30
            product = terms[0]
    o = accs[0]
    for acc in accs[1:]:
        o = o + acc
    return {"o": o, "t": tacc.transpose(0, 1).reshape(SUB, grid * LANES), "product": product}


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor on {device}")


def prepare_vector(probe: str, a, b, iters: int = ITERS, grid: int = GRID):
    """(launch, out, None) of one launch of probe "fma" or "mix" on CUDA
    tensors: ``launch()`` enqueues the kernel and returns the CUDA error
    code; the probes have no error flag."""
    for name, x in (("a", a), ("b", b)):
        _check(name, x, (SUB, LANES), a.device)
    out = torch.empty((SUB, LANES * grid), dtype=torch.float32, device=a.device)
    fn = B7.library().dxr_roofline_vector
    code = {"fma": 0, "mix": 1}[probe]

    def launch() -> int:
        return kernel.on_stream(fn, a.device, code, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                iters, grid)

    return launch, out, None


def _vector(probe: str, a, b, iters: int, grid: int) -> torch.Tensor:
    launch, out, _ = prepare_vector(probe, a, b, iters, grid)
    B7.run(launch, f"B7 {probe}")
    return out


def fma_peak(a, b, iters: int = ITERS, grid: int = GRID) -> torch.Tensor:
    """The FMA-peak probe: [SUB, LANES * grid] float32, the sum of CHAINS
    chains of iters * UNROLL steps acc = acc * a + b from acc = a + k. CUDA
    tensors -> one kernel launch; CPU tensors -> the plain version."""
    if kernel.on_card(a.device):
        return _vector("fma", a, b, iters, grid)
    return fma_peak_reference(a, b, iters, grid)


def pair_mix(a, b, iters: int = ITERS, grid: int = GRID) -> torch.Tensor:
    """The pair-mix probe: [SUB, LANES * grid] float32, det + u + v + t +
    best after iters * MIX_UNROLL steps of roofline.py's mix. CUDA tensors
    -> one kernel launch; CPU tensors -> the plain version."""
    if kernel.on_card(a.device):
        return _vector("mix", a, b, iters, grid)
    return pair_mix_reference(a, b, iters, grid)


def prepare_overlap(a, b, mt, rays, do_vector: bool, do_matrix: bool, vector_scale: int,
                    m_iters: int = M_ITERS, grid: int = GRID, keep_product: bool = False):
    """(launch, outs, None) of one overlap launch on CUDA tensors; outs
    {"o", "t", "product"} ("product": grid block 0's last product [4
    C_TRIS, LANES] when keep_product, else None)."""
    device = a.device
    for name, x, shape in (("a", a, (SUB, LANES)), ("b", b, (SUB, LANES)),
                           ("mt", mt, (4 * C_TRIS, K)), ("rays", rays, (K, LANES))):
        _check(name, x, shape, device)
    outs = {k: torch.empty((SUB, LANES * grid), dtype=torch.float32, device=device)
            for k in ("o", "t")}
    outs["product"] = (torch.zeros((4 * C_TRIS, LANES), dtype=torch.float32, device=device)
                       if keep_product else None)
    prod_ptr = None if outs["product"] is None else outs["product"].data_ptr()
    fn = B7.library().dxr_roofline_overlap

    def launch() -> int:
        return kernel.on_stream(fn, device, a.data_ptr(), b.data_ptr(), mt.data_ptr(),
                                rays.data_ptr(), outs["o"].data_ptr(), outs["t"].data_ptr(),
                                prod_ptr, m_iters, grid, vector_scale, int(do_vector),
                                int(do_matrix))

    return launch, outs, None


def overlap(a, b, mt, rays, do_vector: bool, do_matrix: bool, vector_scale: int,
            m_iters: int = M_ITERS, grid: int = GRID, keep_product: bool = False) -> dict:
    """The overlap probe: m_iters * max(vector_scale, 1) iterations, each
    V_UNROLL steps of the FMA chains (do_vector) and, every vector_scale-th,
    the product mt @ (rays * (1 + t[0] * 1e-30)) whose rows 0..SUB-1, times
    1e-30, add to the accumulator t (do_matrix). Returns {"o": the chains'
    sum, "t": the accumulator, both [SUB, LANES * grid]; "product": grid
    block 0's last product with keep_product (the plain version always
    returns it)}. CUDA tensors -> one kernel launch; CPU tensors -> the
    plain version."""
    if not kernel.on_card(a.device):
        return overlap_reference(a, b, mt, rays, do_vector, do_matrix, vector_scale, m_iters,
                                 grid)
    launch, outs, _ = prepare_overlap(a, b, mt, rays, do_vector, do_matrix, vector_scale,
                                      m_iters, grid, keep_product)
    B7.run(launch, "B7 overlap")
    return outs
