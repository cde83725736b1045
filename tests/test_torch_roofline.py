"""Port the roofline probes (B7) vs benchmarks/roofline.py.

The probes of benchmarks/roofline.py are closures inside its ``main()``
(``fma_kernel`` :68-80, ``mix_kernel`` :88-128, ``make_ov_kernel``
:138-170), so they cannot be imported, and benchmarks/ stays as it is. The
first test reaches them all the same: it runs ``main()`` at its
``--interpret`` size with ``pallas_call`` replaced by a spy that records
each kernel and its grid and block specs (and returns zeros, so that the
script's own timing loops cost nothing), then runs every recorded kernel
through the real ``pallas_call`` in interpret mode, on roofline.py's inputs,
on seeded ones where every element differs, and on one whose product shows
in the accumulator t. The port's plain versions (``ops/roofline.py``, the
wrappers on CPU tensors) are held to those outputs: relative 1e-5, since the
port rounds each FMA once (as the card's ``fmaf`` does) where the
interpreter rounds the multiply and the add apart, a float32 ulp a step at
most over the 32 steps of this size.

The other tests state the kernel bodies in numpy, each FMA rounded once
(the product and sum in float64), and check the plain versions' layout and
the product against them at the same size: relative 1e-6 for the FMA chains
and the mix, the product in float64 against float32 relative to the sum of
|terms|, 1e-6.

The CUDA kernels (``csrc/roofline.cu``) are held to the plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py phase 37.
"""

import numpy as np
import pytest
import torch

from dxrexperiments_torch.ops import roofline as rf
from dxrexperiments_torch.ops.kernel import launch_counts

ITERS, GRID, M_ITERS = rf.SMOKE_ITERS, rf.SMOKE_GRID, rf.SMOKE_M_ITERS
f32 = np.float32


def inputs(seed):
    return tuple(x.numpy() for x in rf.probe_inputs("cpu", seed))


def fma(x, a, b):
    """x * a + b rounded once to float32 (the product is exact in float64)."""
    return (x.astype(np.float64) * a.astype(np.float64) + b.astype(np.float64)).astype(f32)


def tiled(x):
    return np.tile(x, (1, GRID))  # every grid block reads the same [8, 1024] block


def np_fma(a, b):
    """roofline.py:68-80, each FMA rounded once"""
    a, b = tiled(a), tiled(b)
    accs = tuple(a + f32(k) for k in range(rf.CHAINS))
    for _ in range(ITERS):
        for _u in range(rf.UNROLL):
            accs = tuple(fma(acc, a, b) for acc in accs)
    out = accs[0]
    for acc in accs[1:]:
        out = out + acc
    return out


def np_mix(a, b):
    """roofline.py:88-128, each FMA rounded once"""
    a, b = tiled(a), tiled(b)
    det, u, v, t, best = a, a + f32(1.0), a + f32(2.0), a + f32(3.0), b + f32(30.0)
    for _ in range(ITERS * rf.MIX_UNROLL):
        m0 = fma(u, a, b)
        m1 = fma(v, a, -b)
        m2 = fma(t, a, b)
        det = fma(det, a, m0)
        det = fma(det, a, m1)
        det = fma(det, a, m2)
        u = fma(u, a, m0)
        u = fma(u, a, m1)
        u = fma(u, a, m2)
        u = fma(u, a, b)
        v = fma(v, a, m0)
        v = fma(v, a, m1)
        v = fma(v, a, m2)
        v = fma(v, a, b)
        t = fma(t, a, m0)
        t = fma(t, a, m1)
        t = fma(t, a, m2)
        t = fma(t, a, b)
        det = fma(det, a, b)
        s = np.sign(det)
        da = det * s
        us = u * s
        vs = v * s
        soft = np.minimum(np.minimum(us, vs), da - (us + vs))
        strict = t * s - da
        ok = (soft >= 0.0) & (strict > 0.0)
        best = np.where(ok & (t < best), t, best)
    return det + u + v + t + best


def np_overlap(a, b, mt, rays, do_vpu, do_mxu, vpu_scale):
    """roofline.py:138-170, one grid block at a time, each FMA rounded once;
    the HIGHEST product in float64. Returns (o, t, the last product of grid
    block 0)."""
    os_, ts, last = [], [], None
    for g in range(GRID):
        accs = tuple(a + f32(k) for k in range(rf.CHAINS))
        tacc = b.copy()
        for i in range(M_ITERS * max(vpu_scale, 1)):
            if do_vpu:
                for _u in range(rf.V_UNROLL):
                    accs = tuple(fma(acc, a, b) for acc in accs)
            if do_mxu and (vpu_scale <= 1 or i % vpu_scale == 0):
                scaled = rays * (f32(1.0) + tacc[0:1, :] * f32(1e-30))
                terms = mt.astype(np.float64) @ scaled.astype(np.float64)
                tacc = tacc + terms[0:rf.SUB, :].astype(f32) * f32(1e-30)
                if g == 0:
                    last = terms
        o = accs[0]
        for acc in accs[1:]:
            o = o + acc
        os_.append(o)
        ts.append(tacc)
    return np.concatenate(os_, axis=1), np.concatenate(ts, axis=1), last


@pytest.fixture(scope="module")
def roofline_kernels():
    """{"fma": (kernel, specs), "mix": ..., (do_vpu, do_mxu, vpu_scale): ...}:
    every kernel that benchmarks/roofline.py's main() hands to pallas_call
    at its --interpret size, with the keyword arguments it hands over."""
    import importlib.util
    import inspect
    import os

    import jax.numpy as jnp
    from jax.experimental import pallas

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmarks", "roofline.py")
    spec = importlib.util.spec_from_file_location("_roofline_probe_script", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.SMOKE = True  # its --interpret size: iters 2, grid 2, m_iters 2
    recorded = []

    def spy(kernel, **specs):
        recorded.append((kernel, specs))
        shapes = specs["out_shape"]

        def zeros(*_args):
            if isinstance(shapes, (list, tuple)):
                return [jnp.zeros(x.shape, x.dtype) for x in shapes]
            return jnp.zeros(shapes.shape, shapes.dtype)

        return zeros

    real = pallas.pallas_call
    pallas.pallas_call = spy
    try:
        script.main()
    finally:
        pallas.pallas_call = real
    kernels = {}
    for kernel, specs in recorded:
        assert specs["interpret"] is True and specs["grid"] == (GRID,)
        if kernel.__name__ in ("fma_kernel", "mix_kernel"):
            kernels[kernel.__name__[:3]] = (kernel, specs)
        else:
            cells = inspect.getclosurevars(kernel).nonlocals
            kernels[cells["do_vpu"], cells["do_mxu"], cells["vpu_scale"]] = (kernel, specs)
    # roofline.py's cases: mxu alone, then vpu alone and both at scales 1, 2, 4
    assert len(recorded) == 9 and len(kernels) == 9
    return kernels, real


def product_visible():
    """Inputs on which the product shows in the accumulator: b = 0 and
    mt, rays ~ 1e15, so that terms * 1e-30 is of order 1 and t sums rows 0..7
    of the product over the iterations (the injection 1 + t * 1e-30 stays 1)."""
    g = np.random.default_rng(11)
    a, _, mt, rays = inputs(11)
    return (a, np.zeros_like(a), (mt * 1e15).astype(f32),
            (g.uniform(-1.0, 1.0, rays.shape) * 1e15).astype(f32))


INPUT_SETS = ["roofline", "seeded", "product_visible"]


def input_set(name):
    return {"roofline": lambda: inputs(None), "seeded": lambda: inputs(13),
            "product_visible": product_visible}[name]()


OVERLAP_CASES = [(False, True, 1)] + [(v, m, k) for k in (1, 2, 4)
                                       for v, m in ((True, False), (True, True))]
CASES = ([(probe, which) for probe in ("fma", "mix") for which in ("roofline", "seeded")]
         + [(case, which) for case in OVERLAP_CASES for which in INPUT_SETS])


@pytest.mark.parametrize("case,which", CASES, ids=str)
def test_plain_probes_match_roofline_kernels(roofline_kernels, case, which):
    import jax.numpy as jnp

    kernels, real = roofline_kernels
    kernel, specs = kernels[case]
    a, b, mt, rays = input_set(which)
    if case in ("fma", "mix"):
        want = np.asarray(real(kernel, **specs)(jnp.asarray(a), jnp.asarray(b)))
        fn = rf.fma_peak if case == "fma" else rf.pair_mix
        got = fn(torch.as_tensor(a), torch.as_tensor(b), ITERS, GRID).numpy()
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        return
    o, t = (np.asarray(x) for x in real(kernel, **specs)(*(jnp.asarray(x)
                                                           for x in (a, b, mt, rays))))
    got = rf.overlap(*(torch.as_tensor(x) for x in (a, b, mt, rays)), *case, M_ITERS, GRID)
    np.testing.assert_allclose(got["o"].numpy(), o, rtol=1e-5)
    if which != "product_visible":
        np.testing.assert_allclose(got["t"].numpy(), t, rtol=1e-5)
        return
    # t = sum over the products of rows 0..7 times 1e-30: within float32
    # rounding of the sum of |terms| (the port's float32 product against the
    # interpreter's HIGHEST one)
    n_products = M_ITERS if case[1] else 0
    scale = (np.abs(mt[:rf.SUB]).astype(np.float64) @ np.abs(rays).astype(np.float64)) * 1e-30
    assert n_products == 0 or float(np.abs(t).max()) > 1.0  # the product does show
    assert (np.abs(got["t"].numpy() - t) <= 1e-5 * n_products * np.tile(scale, (1, GRID))).all()


@pytest.mark.parametrize("seed", [None, 5])
def test_vector_probes_match_roofline(seed):
    a, b = inputs(seed)[:2]
    before = launch_counts()
    got_fma = rf.fma_peak(torch.as_tensor(a), torch.as_tensor(b), ITERS, GRID)
    got_mix = rf.pair_mix(torch.as_tensor(a), torch.as_tensor(b), ITERS, GRID)
    assert launch_counts() == before  # the CPU path launches no kernel
    for got, want in ((got_fma, np_fma(a, b)), (got_mix, np_mix(a, b))):
        assert got.dtype == torch.float32 and tuple(got.shape) == (rf.SUB, rf.LANES * GRID)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    if seed is not None:  # the elements differ: the layout is checked
        assert len(np.unique(got_fma.numpy())) > rf.SUB * rf.LANES // 2


@pytest.mark.parametrize("do_vector,do_matrix,scale", [
    (True, True, 1), (True, True, 2), (True, False, 4), (False, True, 1)])
def test_overlap_matches_roofline(do_vector, do_matrix, scale):
    a, b, mt, rays = inputs(7)
    before = launch_counts()["B7 overlap"]
    got = rf.overlap(*(torch.as_tensor(x) for x in (a, b, mt, rays)), do_vector, do_matrix,
                     scale, M_ITERS, GRID)
    assert launch_counts()["B7 overlap"] == before
    o, t, last = np_overlap(a, b, mt, rays, do_vector, do_matrix, scale)
    np.testing.assert_allclose(got["o"].numpy(), o, rtol=1e-6)
    np.testing.assert_allclose(got["t"].numpy(), t, rtol=1e-6)
    if do_matrix:
        scale_of = np.abs(mt).astype(np.float64) @ np.abs(rays).astype(np.float64)
        assert (np.abs(got["product"].numpy() - last) <= 1e-6 * scale_of).all()
    else:
        assert got["product"] is None
        np.testing.assert_array_equal(got["t"].numpy(), tiled(b))  # no product: t stays b


def test_probe_inputs_are_roofline_constants():
    a, b, mt, rays = inputs(None)
    assert (a == f32(1.000001)).all() and (b == f32(1e-7)).all()
    assert (mt == f32(1e-3)).all() and (rays == 1.0).all()
    assert mt.shape == (4 * rf.C_TRIS, rf.K) and rays.shape == (rf.K, rf.LANES)
