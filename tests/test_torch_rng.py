"""Port RNG vs dxrexperiments_tpu.core.rng: bit-exact (tolerance 0).

The port carries uint32 seeds in int64 tensors with 32-bit masks; every
draw decision downstream depends on these bits, so nothing is allowed to
differ.
"""

import jax.numpy as jnp
import numpy as np
import torch

from dxrexperiments_torch.core import rng as trng
from dxrexperiments_tpu.core import rng as jrng

N = 100_000


def _pairs():
    r = np.random.default_rng(1234)
    a = r.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    b = r.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    # make sure the high half of the range (>= 2^31) and the edges are in
    a[:4] = [0, 2**31, 2**32 - 1, 2**31 - 1]
    b[:4] = [2**32 - 1, 0, 2**31, 7]
    assert (a >= 2**31).mean() > 0.4 and (b >= 2**31).mean() > 0.4
    return a, b


def _t(x):
    return torch.as_tensor(x.astype(np.int64))


def test_init_rand_bit_exact():
    a, b = _pairs()
    want = np.asarray(jrng.init_rand(jnp.asarray(a), jnp.asarray(b)))
    got = trng.init_rand(_t(a), _t(b)).numpy()
    assert got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_next_rand_chain_bit_exact():
    a, _ = _pairs()
    js, ts = jnp.asarray(a), _t(a)
    for _ in range(5):
        js, ju = jrng.next_rand(js)
        ts, tu = trng.next_rand(ts)
        np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    js, j0, j1 = jrng.next_rand2(js)
    ts, t0, t1 = trng.next_rand2(ts)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))


def test_pixel_seeds_bit_exact():
    for fc in (0, 7, 2**31 + 5):
        want = np.asarray(jrng.pixel_seeds(19, 11, jnp.asarray(fc, jnp.uint32)))
        got = trng.pixel_seeds(19, 11, fc).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), want)
