"""Port scene/envmap.py vs the JAX package, on the CPU.

Both sides get the same seeded numpy textures and directions. Gates: the
port's four-tap footprints bit-equal to the JAX package's quad packs; the
lat-long and cube uv within 1e-6 and the cube
faces equal, on 4,096 seeded unit directions plus the hazards (the lat-long
u seam at d.x = +-0 with d.z > 0, both poles, exact major-axis ties); the
bilinear lookups and ``sample_environment`` (kinds 0-3, textures in [0, 2))
within 1e-5. The CUDA megakernels' lookup (csrc/common.cuh) is held against
``sample_environment`` on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.scene import envmap as te
from dxrexperiments_tpu.scene import envmap as je

# the seam (d.x = +0 and -0, d.z > 0), the poles, and exact ties of the
# major axis (x vs y, y vs z, x vs z, all three), each with both signs
HAZARDS = np.array([
    [0.0, 0.3, 0.95], [-0.0, 0.3, 0.95], [0.0, 0.0, 1.0], [-0.0, 0.0, 1.0],
    [0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 1.0, -0.0], [-0.0, -1.0, 0.0],
    [1.0, 1.0, 0.0], [-1.0, 1.0, 0.0], [0.0, 1.0, 1.0], [0.0, -1.0, -1.0],
    [1.0, 0.0, 1.0], [-1.0, 0.0, -1.0], [1.0, 1.0, 1.0], [-1.0, -1.0, -1.0],
    [1.0, -1.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
], np.float32)


def directions(n=4096, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d = np.concatenate([d, HAZARDS])
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def textures(seed=3):
    rs = np.random.default_rng(seed)
    return (rs.uniform(0, 2, (16, 32, 3)).astype(np.float32),
            rs.uniform(0, 2, (6, 8, 8, 3)).astype(np.float32))


@pytest.mark.parametrize("shape", [(8, 16, 3), (1, 1, 3), (5, 7, 3)])
def test_quad_packs_bit_equal(shape):
    """The four texels the port reads at every texel origin (x wraps and y
    clamps on the lat-long, both clamp inside a cube face) are the JAX
    package's quad-packed rows, bit for bit."""
    rs = np.random.default_rng(len(shape) + shape[0])
    img = rs.uniform(0, 2, shape).astype(np.float32)
    h, w = shape[:2]
    y, x = (t.reshape(-1) for t in torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij"))
    lat = te.latlong_env(img)
    got = te._footprint_latlong(lat["latlong"], x, y)
    np.testing.assert_array_equal(got.numpy(), je._quad_pack_latlong(img))
    faces = rs.uniform(0, 2, (6, h, h, 3)).astype(np.float32)
    f, y, x = (t.reshape(-1) for t in torch.meshgrid(torch.arange(6), torch.arange(h),
                                                      torch.arange(h), indexing="ij"))
    cube = te.cubemap_env(faces)
    got = te._footprint_cube(cube["cube"], f, x, y)
    np.testing.assert_array_equal(got.numpy(), je._quad_pack_cube(faces))
    assert lat["kind"] == 2 and cube["kind"] == 3
    assert set(lat) - set(te.constant_env()) == {"latlong"}  # no quad-packed copy
    assert set(cube) - set(te.constant_env()) == {"cube"}


def test_latlong_uv_matches_jax():
    d = directions()
    ju, jv = (np.asarray(x) for x in je.dir_to_latlong_uv(jnp.asarray(d)))
    tu, tv = (x.numpy() for x in te.dir_to_latlong_uv(torch.as_tensor(d)))
    np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    # the seam: atan2 gives +pi and -pi, u = 1 and 0
    assert tu[4096] == 1.0 and tu[4097] == 0.0 and ju[4096] == 1.0 and ju[4097] == 0.0
    assert tv[4100] == 0.0 and abs(tv[4101] - 1.0) < 1e-6  # the poles


def test_cube_face_uv_matches_jax():
    d = directions()
    jf, ju, jv = (np.asarray(x) for x in je.dir_to_cube_face_uv(jnp.asarray(d)))
    tf, tu, tv = (x.numpy() for x in te.dir_to_cube_face_uv(torch.as_tensor(d)))
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    # ties: x wins over y and z (>=), y over z; +-0 counts as >= 0
    assert list(tf[4096 + 8:4096 + 17]) == [0, 1, 2, 3, 0, 1, 0, 1, 0]
    assert set(range(6)) <= set(tf[:4096].tolist())


@pytest.mark.parametrize("quad", [False, True], ids=["four_taps", "quad"])
def test_bilinear_lookups_match_jax(quad):
    """The port's four-tap lookups against JAX's four taps and its
    quad-packed gather."""
    img, faces = textures()
    d = directions(seed=5)
    lat_j, lat_t = je.latlong_env(img), te.latlong_env(img)
    u, v = je.dir_to_latlong_uv(jnp.asarray(d))
    want = je._bilinear_wrap_u(lat_j["latlong"], u, v, lat_j["latlong_quad"] if quad else None)
    tu, tv = te.dir_to_latlong_uv(torch.as_tensor(d))
    got = te._bilinear_wrap_u(lat_t["latlong"], tu, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    cube_j, cube_t = je.cubemap_env(faces), te.cubemap_env(faces)
    f, cu, cv = je.dir_to_cube_face_uv(jnp.asarray(d))
    want = je._bilinear_cube(cube_j["cube"], f, cu, cv, cube_j["cube_quad"] if quad else None)
    tf, tcu, tcv = te.dir_to_cube_face_uv(torch.as_tensor(d))
    got = te._bilinear_cube(cube_t["cube"], tf, tcu, tcv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_seam_taps_agree():
    """Both sides of the u seam (d.x = +0 and -0) sample the texel pair
    (w - 1, 0) at fx = 0.5, so the radiance is the same, equal to the mean
    of those two texels; with u just inside either edge it stays
    continuous."""
    img, _ = textures()
    env = te.latlong_env(img, strength=1.3)
    d = torch.as_tensor(HAZARDS[:4])
    d = d / d.norm(dim=1, keepdim=True)
    out = te.sample_environment(env, d)
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    torch.testing.assert_close(out[2], out[3], rtol=0, atol=0)
    tu, tv = te.dir_to_latlong_uv(d)
    assert float(tu[0]) == 1.0 and float(tu[1]) == 0.0
    y = int(torch.floor(tv[0] * img.shape[0] - 0.5))
    pair = (env["latlong"][y, -1] + env["latlong"][y, 0]) * 0.5
    fy = float(tv[0] * img.shape[0] - 0.5 - y)
    pair_next = (env["latlong"][y + 1, -1] + env["latlong"][y + 1, 0]) * 0.5
    want = (pair * (1 - fy) + pair_next * fy) * env["strength"]
    torch.testing.assert_close(out[0], want, rtol=0, atol=1e-6)
    eps = torch.tensor([[1e-6, 0.3, 0.95], [-1e-6, 0.3, 0.95]])
    near = te.sample_environment(env, eps / eps.norm(dim=1, keepdim=True))
    assert float((near - out[0]).abs().max()) < 1e-3


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_sample_environment_matches_jax(kind):
    img, faces = textures()
    d = directions(seed=7)
    make = {
        0: lambda m: m.constant_env((0.05, 0.1, 0.2), strength=1.5),
        1: lambda m: m.gradient_env(strength=0.7),
        2: lambda m: m.latlong_env(img, strength=1.3),
        3: lambda m: m.cubemap_env(faces, strength=1.3),
    }[kind]
    want = np.asarray(je.sample_environment(make(je), jnp.asarray(d), static_kind=kind))
    got = te.sample_environment(make(te), torch.as_tensor(d)).numpy()
    assert got.shape == want.shape == (len(d), 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_env_placement():
    img, _ = textures()
    env = te.latlong_env(img, strength=1.3)
    placed = te.place(env, "cpu")
    assert placed["kind"] == 2 and placed["latlong"].device.type == "cpu"
    on = te.on_device(placed, "cpu")
    assert on["latlong"] is placed["latlong"]  # used where it lies, never copied
    meta = te.place(env, "meta")
    assert meta["latlong"].device.type == "meta" and meta["strength"].device.type == "cpu"
    with pytest.raises(ValueError, match="lies on"):
        te.on_device(meta, "cpu")
    assert "latlong" not in te.constant_env() and te.check_env_kind(3) == 3
    with pytest.raises(ValueError, match="unknown env kind"):
        te.check_env_kind(4)
    with pytest.raises(ValueError, match="texture leaf"):
        te.sample_environment(te.constant_env(), torch.zeros(2, 3), static_kind=2)
    with pytest.raises(ValueError, match=r"\[6, S, S, 3\]"):
        te.cubemap_env(np.zeros((6, 4, 5, 3), np.float32))
