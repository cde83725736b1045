"""Port scene/textures.py vs the JAX package's, on the CPU.

The port keeps a flat texel table [R, 3] where JAX keeps quad-packed rows
[R, 12]; the four taps the port reads must be JAX's quad row bit for bit,
for every texel. ``sample_albedo`` is float32 arithmetic in two frameworks
(the same operations in the same order): within 1e-6 on seeded UVs in
[-3, 4], which wrap on both axes. The numpy helpers (``checker_texture``,
``planar_uvs``) are copied, so bit-equal. ``quad_pack_wrap`` is JAX's
layout, which the port does not build: a copy here packs the port's table
image by image for the comparison.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.scene import textures as ttex
from dxrexperiments_torch.scene.materials import Material as TMaterial
from dxrexperiments_torch.scene.mesh import Mesh as TMesh
from dxrexperiments_torch.utils.image import write_hdr
from dxrexperiments_tpu.scene import textures as jtex
from dxrexperiments_tpu.scene.materials import Material as JMaterial
from dxrexperiments_tpu.scene.mesh import Mesh as JMesh


def images(seed=5):
    rs = np.random.default_rng(seed)
    return [rs.uniform(0, 1, (7, 5, 3)).astype(np.float32),
            rs.uniform(0, 2, (3, 4)).astype(np.float32),  # grey: repeated to 3 channels
            jtex.checker_texture(4, size=8)]


def material_lists():
    a, b, c = images()
    layout = [a, None, b, None, c]
    return ([JMaterial(albedo_texture=t) for t in layout],
            [TMaterial(albedo_texture=t) for t in layout])


def quad_pack_wrap(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] -> [H*W, 12] quad-packed rows (c00, c10, c01, c11) with
    WRAP addressing on both axes: the JAX package's texture layout."""
    img = np.asarray(img, np.float32)
    right = np.roll(img, -1, axis=1)
    down = np.roll(img, -1, axis=0)
    down_right = np.roll(right, -1, axis=0)
    quad = np.concatenate([img, right, down, down_right], axis=-1)
    return np.ascontiguousarray(quad.reshape(-1, 12), dtype=np.float32)


def test_quad_pack_wrap_bit_equal():
    """Each image of the port's table, quad-packed, is JAX's rows for it."""
    for img in images():
        img3 = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=-1)
        np.testing.assert_array_equal(quad_pack_wrap(img3), jtex.quad_pack_wrap(img3))
    jm, tm = material_lists()
    rows = np.asarray(jtex.pack_texture_table(jm)["rows"])
    table = ttex.pack_texture_table(tm)
    for base, w, h in table["meta"]:
        if w:
            img = table["texels"][base:base + w * h].reshape(h, w, 3)
            np.testing.assert_array_equal(quad_pack_wrap(img), rows[base:base + w * h])


def test_pack_texture_table_matches_jax():
    jm, tm = material_lists()
    want, got = jtex.pack_texture_table(jm), ttex.pack_texture_table(tm)
    np.testing.assert_array_equal(got["meta"], np.asarray(want["meta"]))
    assert got["meta"].dtype == np.int32 and got["texels"].dtype == np.float32
    rows = np.asarray(want["rows"])
    assert got["texels"].shape == (rows.shape[0], 3)  # a quarter of JAX's bytes
    np.testing.assert_array_equal(got["texels"], rows[:, 0:3])
    assert ttex.pack_texture_table([TMaterial(), TMaterial()]) is None
    assert jtex.pack_texture_table([JMaterial(), JMaterial()]) is None
    # JAX's own mixed-size case (tests/test_textures.py)
    a, b = np.zeros((4, 8, 3), np.float32), np.ones((2, 2, 3), np.float32)
    t = ttex.pack_texture_table([TMaterial(albedo_texture=a), TMaterial(),
                                 TMaterial(albedo_texture=b)])
    np.testing.assert_array_equal(t["meta"], [[0, 8, 4], [0, 0, 0], [32, 2, 2]])
    assert t["texels"].shape == (36, 3)


def test_four_taps_equal_jax_quad_rows():
    jm, tm = material_lists()
    rows = np.asarray(jtex.pack_texture_table(jm)["rows"])
    table = ttex.pack_texture_table(tm)
    texels = table["texels"]
    seen = 0
    for base, w, h in table["meta"]:
        if w == 0:
            continue
        for y in range(h):
            for x in range(w):
                taps = [texels[base + yy * w + xx] for yy, xx in
                        ((y, x), (y, (x + 1) % w), ((y + 1) % h, x), ((y + 1) % h, (x + 1) % w))]
                np.testing.assert_array_equal(np.concatenate(taps), rows[base + y * w + x])
                seen += 1
    assert seen == rows.shape[0]


def test_sample_albedo_matches_jax():
    jm, tm = material_lists()
    want_table, got_table = jtex.pack_texture_table(jm), ttex.pack_texture_table(tm)
    rs = np.random.default_rng(9)
    n = 4096
    uv = rs.uniform(-3.0, 4.0, (n, 2)).astype(np.float32)
    uv[:8] = [[0.0, 0.0], [1.0, 1.0], [-1.0, 0.5], [0.5, -1e-7], [2.0, -3.0], [-0.25, 3.75],
              [0.999999, 0.0], [-2.5, -2.5]]  # texel edges, the wrap, below 0 and above 1
    mid = rs.integers(0, len(tm), n).astype(np.int32)
    want = np.asarray(jtex.sample_albedo(want_table, jnp.asarray(mid), jnp.asarray(uv)))
    got = ttex.sample_albedo({k: torch.as_tensor(v) for k, v in got_table.items()},
                             torch.as_tensor(mid), torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    untextured = np.isin(mid, (1, 3))
    assert untextured.any() and (got[untextured] == 1.0).all()
    assert (got[~untextured] != 1.0).any()


def test_meta_gather_pins_jax_meta_select():
    """The port's plain meta[mid] gives what JAX's compare-select chain does."""
    jm, tm = material_lists()
    meta = ttex.pack_texture_table(tm)["meta"]
    mid = np.random.default_rng(1).integers(0, len(tm), 500).astype(np.int32)
    want = np.asarray(jtex._meta_select(jnp.asarray(meta), jnp.asarray(mid)))
    np.testing.assert_array_equal(torch.as_tensor(meta)[torch.as_tensor(mid).long()].numpy(), want)


@pytest.mark.parametrize("args", [(), (8, (1.0, 1.0, 1.0), (0.35, 0.3, 0.25)),
                                  (16, (1.0, 1.0, 1.0), (0.45, 0.42, 0.38), 128)])
def test_checker_texture_equal(args):
    np.testing.assert_array_equal(ttex.checker_texture(*args), jtex.checker_texture(*args))


def test_planar_uvs_equal():
    rs = np.random.default_rng(4)
    pos = rs.uniform(-40, 40, (30, 3)).astype(np.float32)
    idx = rs.integers(0, 30, (20, 3)).astype(np.int32)
    tm, jm = TMesh(pos, None, idx), JMesh(pos, None, idx)
    ttex.planar_uvs(tm, scale=40.0)
    jtex.planar_uvs(jm, scale=40.0)
    assert tm.uv_corners.shape == (20, 3, 2) and tm.uv_corners.dtype == np.float32
    np.testing.assert_array_equal(tm.uv_corners, jm.uv_corners)
    ttex.planar_uvs(tm, scale=2.0, axes=(0, 1))
    jtex.planar_uvs(jm, scale=2.0, axes=(0, 1))
    np.testing.assert_array_equal(tm.uv_corners, jm.uv_corners)


def test_load_texture_image(tmp_path):
    img = np.random.default_rng(2).uniform(0, 1, (6, 5, 3)).astype(np.float32)
    np.save(tmp_path / "t.npy", img)
    with open(tmp_path / "t.ppm", "wb") as f:
        f.write(b"P6\n# a comment\n5 6\n255\n")
        f.write((img * 255).astype(np.uint8).tobytes())
    write_hdr(str(tmp_path / "t.hdr"), img)
    (tmp_path / "t.tga").write_bytes(b"\0" * 32)
    for name in ("t.npy", "t.ppm", "t.hdr"):
        got = ttex.load_texture_image(str(tmp_path / name))
        want = jtex.load_texture_image(str(tmp_path / name))
        assert got.shape == (6, 5, 3) and got.dtype == np.float32, name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_array_equal(ttex.load_texture_image(str(tmp_path / "t.npy")), img)
    assert ttex.load_texture_image(str(tmp_path / "t.tga")) is None
    assert ttex.load_texture_image(str(tmp_path / "missing.ppm")) is None
