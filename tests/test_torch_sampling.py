"""Port trace/sampling.py and core/vecmath.py vs the JAX package on seeded
inputs. Both run float32 elementwise math in another framework, so values
agree to atol 1e-6 (a few ulps of unit vectors); the seeds are bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.core import vecmath as tvm
from dxrexperiments_torch.trace import sampling as tsa
from dxrexperiments_tpu.core import vecmath as jvm
from dxrexperiments_tpu.trace import sampling as jsa

N = 2048


def _inputs():
    r = np.random.default_rng(42)
    n = r.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    seeds = r.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    expo = np.exp((1.0 - r.random(N)) * 12.0).astype(np.float32)
    f0 = r.random((N, 3)).astype(np.float32)
    return n, seeds, expo, f0


@pytest.mark.parametrize("name", ["cos_hemisphere_sample", "uniform_hemisphere_sample"])
def test_hemisphere_samplers(name):
    n, seeds, _, _ = _inputs()
    js, jd = getattr(jsa, name)(jnp.asarray(seeds), jnp.asarray(n))
    ts, td = getattr(tsa, name)(torch.as_tensor(seeds.astype(np.int64)), torch.as_tensor(n))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


def test_phong_lobe_and_fresnel():
    n, seeds, expo, f0 = _inputs()
    js, jd, jpdf, jbrdf = jsa.phong_lobe_sample(jnp.asarray(seeds), jnp.asarray(n), jnp.asarray(expo))
    ts, td, tpdf, tbrdf = tsa.phong_lobe_sample(
        torch.as_tensor(seeds.astype(np.int64)), torch.as_tensor(n), torch.as_tensor(expo)
    )
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tbrdf.numpy(), np.asarray(jbrdf), rtol=1e-4, atol=1e-6)
    d = np.roll(n, 1, axis=0)
    want = jsa.fresnel_schlick(jnp.asarray(d), jnp.asarray(n), jnp.asarray(f0))
    got = tsa.fresnel_schlick(torch.as_tensor(d), torch.as_tensor(n), torch.as_tensor(f0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_vecmath_frame():
    n, _, _, _ = _inputs()
    jt, jb = jvm.orthonormal_basis(jnp.asarray(n))
    tt, tb = tvm.orthonormal_basis(torch.as_tensor(n))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    d = np.roll(n, 3, axis=0)
    np.testing.assert_allclose(
        tvm.normalize(tvm.reflect(torch.as_tensor(d), torch.as_tensor(n))).numpy(),
        np.asarray(jvm.normalize(jvm.reflect(jnp.asarray(d), jnp.asarray(n)))),
        atol=1e-6,
    )
