"""Port the env readers (utils/image.py's Radiance reader, utils/dds.py) and
the CLI's texture envs vs the JAX package, on files the tests write.

Gates: the decoded arrays bit-equal to the JAX readers' on the same file
(RLE and flat .hdr scanlines; DX10 f16 and f32 cubemaps with a mip chain,
legacy 24- and 32-bit RGB(A)); the writers' round trip within the format's
precision; bad inputs raise. ``parse_env`` for ``latlong:`` and ``cubemap:``
gives the JAX env's kind, strength and texture leaves bit for bit. The CLI
renders with ``--env latlong:PATH`` and ``cubemap:PATH`` on the CPU.
"""

import struct

import numpy as np
import pytest
import torch

from dxrexperiments_torch.app import headless as thead
from dxrexperiments_torch.ops import fused_sample as tfs
from dxrexperiments_torch.ops import fused_traverse as tft
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.utils import dds as tdds
from dxrexperiments_torch.utils import image as timage
from dxrexperiments_tpu.app import headless as jhead
from dxrexperiments_tpu.utils import dds as jdds
from dxrexperiments_tpu.utils import image as jimage


def radiance(h=24, w=40, seed=0):
    """Sky-like HDR radiance: a gradient, a bright patch, flat rows (long
    runs) and seeded noise (literals), with exact zeros."""
    rs = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    img = (0.2 + 0.8 * y) * np.array([0.4, 0.6, 1.0], np.float32) + np.zeros((h, w, 3), np.float32)
    img = img + rs.uniform(0.0, 0.05, (h, w, 3)).astype(np.float32)
    img[2:5, 7:11] = 50.0
    img[h - 3:] = 0.125  # flat rows
    img[0, :4] = 0.0
    return img


@pytest.mark.parametrize("rle", [True, False], ids=["rle", "flat"])
def test_read_hdr_bit_equal(tmp_path, rle):
    img = radiance()
    path = str(tmp_path / "sky.hdr")
    timage.write_hdr(path, img, rle=rle)
    got, want = timage.read_hdr(path), jimage.read_hdr(path)
    assert got.dtype == np.float32 and got.shape == (24, 40, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timage.read_image(path), want)
    # RGBE keeps 8 bits of mantissa of the brightest channel
    assert (np.abs(got - img) <= img.max(axis=-1, keepdims=True) / 128).all()
    assert (got[0, :4] == 0).all() and float(got[3, 8, 0]) == pytest.approx(50.0, rel=1e-2)
    if rle:  # the flat rows compress into run packets
        assert len(open(path, "rb").read()) < 24 * 40 * 4


def test_hdr_bad_inputs_raise(tmp_path):
    bad = tmp_path / "bad.hdr"
    bad.write_bytes(b"P6\n4 4\n255\n" + bytes(48))
    with pytest.raises(ValueError, match="not a Radiance"):
        timage.read_hdr(str(bad))
    flipped = tmp_path / "flipped.hdr"
    flipped.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 2 +X 2\n" + bytes(16))
    with pytest.raises(ValueError, match="orientation"):
        timage.read_hdr(str(flipped))


def test_read_ldr_through_pil(tmp_path):
    from PIL import Image

    arr = np.random.default_rng(1).integers(0, 256, (6, 9, 3), dtype=np.uint8)
    path = str(tmp_path / "env.png")
    Image.fromarray(arr, "RGB").save(path)
    for lin in (True, False):
        got, want = timage.read_image(path, lin), jimage.read_image(path, lin)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    c = np.linspace(-0.1, 1.1, 50)
    np.testing.assert_array_equal(timage.srgb_to_linear(c), jimage.srgb_to_linear(c))


@pytest.mark.parametrize("fmt,mips", [("rgba16f", 4), ("rgba32f", 3), ("rgba8", 1), ("rgb8", 2)])
def test_read_dds_bit_equal(tmp_path, fmt, mips):
    rs = np.random.default_rng(2)
    faces = rs.uniform(0, 1 if fmt.endswith("8") else 8, (6, 8, 8, 3)).astype(np.float32)
    path = str(tmp_path / f"cube_{fmt}.dds")
    tdds.write_dds(path, faces, fmt, mips=mips)
    got, want = tdds.read_dds(path), jdds.read_dds(path)
    assert got["is_cubemap"] and want["is_cubemap"] and got["mips"] == want["mips"] == mips
    np.testing.assert_array_equal(got["faces"], want["faces"])
    np.testing.assert_array_equal(tdds.load_cubemap(path), jdds.load_cubemap(path))
    tol = {"rgba16f": 8 / 1024, "rgba32f": 0.0}.get(fmt, 0.5 / 255)
    np.testing.assert_allclose(got["faces"], faces, rtol=0, atol=tol)


def test_dds_bad_inputs_raise(tmp_path):
    path = str(tmp_path / "bc.dds")
    tdds.write_dds(path, np.zeros((6, 4, 4, 3), np.float32), "rgba8")
    data = bytearray(open(path, "rb").read())
    data[80:84] = struct.pack("<I", tdds.DDPF_FOURCC)  # pixel format: fourcc DXT1 (BC1)
    data[84:88] = b"DXT1"
    open(path, "wb").write(bytes(data))
    for reader in (tdds.read_dds, jdds.read_dds):
        with pytest.raises(ValueError, match="block-compressed"):
            reader(path)
    flat = str(tmp_path / "flat.dds")
    tdds.write_dds(flat, np.zeros((1, 4, 4, 3), np.float32), "rgba32f", cube=False)
    assert not tdds.read_dds(flat)["is_cubemap"]
    with pytest.raises(ValueError, match="6-face cubemap"):
        tdds.load_cubemap(flat)
    other = tmp_path / "x.dds"
    other.write_bytes(b"PNG0" + bytes(200))
    with pytest.raises(ValueError, match="not a DDS"):
        tdds.read_dds(str(other))


@pytest.mark.parametrize("kind", ["latlong", "cubemap"])
def test_parse_env_matches_jax(tmp_path, kind):
    if kind == "latlong":
        path = str(tmp_path / "sky.hdr")
        timage.write_hdr(path, radiance())
    else:
        path = str(tmp_path / "cube.dds")
        tdds.write_dds(path, np.random.default_rng(4).uniform(0, 4, (6, 4, 4, 3)), mips=3)
    spec = f"{kind}:{path} x1.5"
    got, want = thead.parse_env(spec), jhead.parse_env(spec)
    assert got["kind"] == int(np.asarray(want["kind"]))
    assert float(got["strength"]) == float(np.asarray(want["strength"])) == 1.5
    k = "latlong" if kind == "latlong" else "cube"
    assert got[k].dtype == torch.float32
    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert f"{k}_quad" not in got  # the four-tap lookups read the texture itself


@pytest.mark.parametrize("kind", ["latlong", "cubemap"])
def test_cli_texture_env(tmp_path, capsys, kind):
    if kind == "latlong":
        env = tmp_path / "sky.hdr"
        timage.write_hdr(str(env), radiance(16, 32))
        args = ["--scene", "cornell-glossy"]
    else:
        env = tmp_path / "cube.dds"
        tdds.write_dds(str(env), np.random.default_rng(5).uniform(0, 2, (6, 4, 4, 3)))
        args = ["--scene", "instanced:1", "--pipeline", "realtime", "--denoise"]
    out = tmp_path / "env.png"
    before = launch_counts()
    assert thead.main([*args, "--env", f"{kind}:{env}", "--size", "32x32", "--spp", "2",
                       "--device", "cpu", "-o", str(out)]) == 0
    assert launch_counts() == before
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 100
    text = capsys.readouterr().out
    assert ("progressive (cpu): 2 spp at 32x32" if kind == "latlong"
            else "realtime+denoise (cpu): 32x32") in text
