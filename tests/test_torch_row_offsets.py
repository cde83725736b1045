"""Row-block renders of the port against the JAX package, on the CPU.

A row block renders rows [row0, row0 + h) of a full_height-tall image with
the full image's NDC and TEA pixel seeds (multi-GPU row sharding). Held
here: ``rng.pixel_seeds(row0=)`` bit for bit and ``primary_ray_grid(row0=,
full_height=)`` to 1e-6 against JAX's; row blocks put together equal the
full render bit for bit (the seeds, the rays, the integrator in both modes,
an area light's draw chain); ``render_sample(row0=, full_height=)`` and the
plain versions of B1 and B5 with ``py0``/``full_height`` against JAX's
jnp path and its kernels in interpret mode (<= 1,024 pixels), on the gate of
tests/test_torch_fused_sample.py (at most 0.5% of pixels off by more than
1e-3, median |difference| < 1e-5: knife-edge pairs may resolve differently
once float32 sums are reassociated). The kernels' own row-block launches
are held to the full launch on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.core import rng as trng
from dxrexperiments_torch.core.camera import primary_ray_grid as t_primary_ray_grid
from dxrexperiments_torch.ops import fused_sample as tfs
from dxrexperiments_torch.ops import fused_traverse as tft
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene.convert import (
    camera_from_numpy,
    options_from_numpy,
    scene_from_numpy,
)
from dxrexperiments_torch.trace.integrator import render_sample as t_render_sample
from dxrexperiments_tpu.app.headless import build_scene as j_build_scene
from dxrexperiments_tpu.core import rng as jrng
from dxrexperiments_tpu.core.camera import camera_params, primary_ray_grid
from dxrexperiments_tpu.ops import fused_sample_pallas as jfs
from dxrexperiments_tpu.ops import fused_traverse_pallas as jft
from dxrexperiments_tpu.trace import default_options
from dxrexperiments_tpu.trace.integrator import render_sample

W, FULL_H = 32, 32
BLOCKS = ((0, 8), (8, 24), (24, 32))  # uneven row blocks [row0, row1) of the full image


def npy(tree):
    return jax.tree.map(np.asarray, tree)


def both_sides(name="cornell-glossy", accel="auto", frames=(5,), width=W, height=FULL_H):
    """(JAX scene, options, stacked cameras) and the port's copies."""
    sc, cam = j_build_scene(name)
    cam.set_aspect(width, height)
    jscene = sc.build(accel=accel)
    jit = [(0.3 / width, -0.2 / height), (-0.15 / width, 0.35 / height)]
    cams = [camera_params(cam, jitter=jit[i % 2], frame_count=f) for i, f in enumerate(frames)]
    jcams = jax.tree.map(lambda *x: jnp.stack(x), *cams)
    jopts = default_options()
    port = (scene_from_numpy(npy(jscene), "cpu"), options_from_numpy(npy(jopts)),
            camera_from_numpy(npy(jcams)))
    return (jscene, jopts, jcams), port


def assert_images_match(got, want, frac=0.005):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    if diff.ndim == 3:
        diff = diff.max(axis=-1)
    bad = (diff > 1e-3).mean()
    assert bad <= frac, f"{bad:.4%} pixels differ by more than 1e-3"
    assert float(np.median(diff)) < 1e-5


@pytest.mark.parametrize("row0", [0, 7, 24])
def test_pixel_seeds_row0_bit_exact(row0):
    for frame in (3, 2**32 - 2):
        got = trng.pixel_seeds(W, 8, frame, row0=row0).numpy().astype(np.uint32)
        want = np.asarray(jrng.pixel_seeds(W, 8, jnp.uint32(frame), row0=row0))
        np.testing.assert_array_equal(got, want)
        full = trng.pixel_seeds(W, FULL_H, frame)
        assert torch.equal(trng.pixel_seeds(W, 8, frame, row0=row0), full[row0:row0 + 8])


def test_primary_ray_grid_row0_matches_jax_and_full_grid():
    _, (_, _, tcams) = both_sides()
    cam = {k: v[0] for k, v in tcams.items()}
    jcam = {k: jnp.asarray(v.numpy()) for k, v in cam.items()}
    full_o, full_d = t_primary_ray_grid(cam, W, FULL_H, 30.0)
    for r0, r1 in BLOCKS:
        o, d = t_primary_ray_grid(cam, W, r1 - r0, 30.0, row0=r0, full_height=FULL_H)
        jo, jd = primary_ray_grid(jcam, W, r1 - r0, 30.0, row0=r0, full_height=FULL_H)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
        assert torch.equal(d, full_d[r0:r1]) and torch.equal(o, full_o[r0:r1])


@pytest.mark.parametrize("name,mode", [("cornell-glossy", "progressive"),
                                       ("cornell-glossy", "realtime"),
                                       ("cornell-tex", "progressive")])
def test_render_sample_row_blocks(name, mode):
    """Row blocks put together equal the full render bit for bit (cornell-tex:
    an area light, whose draw chain is seeded from the pixel's TEA seed),
    and each block matches JAX's render_sample with the same row0."""
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(name)
    cam = {k: v[0] for k, v in tcams.items()}
    jcam = {k: v[0] for k, v in jcams.items()}
    scale = 10.0 if mode == "realtime" else 30.0
    ek = int(jscene["env"]["kind"])
    full = t_render_sample(tscene, topts, cam, W, FULL_H, mode=mode, jitter_scale=scale,
                           env_kind=ek)
    r0, r1 = BLOCKS[1]
    want = render_sample(jscene, jopts, jcam, W, r1 - r0, mode=mode, jitter_scale=scale,
                         impl="jnp", env_kind=ek, row0=r0, full_height=FULL_H)
    for a, b in BLOCKS:
        got = t_render_sample(tscene, topts, cam, W, b - a, mode=mode, jitter_scale=scale,
                              env_kind=ek, row0=a, full_height=FULL_H)
        for k, v in got.items():
            assert torch.equal(v, full[k][a:b]), k
        if (a, b) == (r0, r1):
            for k in got:
                assert_images_match(got[k].numpy(), want[k])


def test_plain_b1_row_block_matches_pallas_interpret():
    """B1's plain version at py0 against JAX's kernel in interpret mode: the
    progressive sum (S = 2) and the realtime AOVs of rows 16..31 of 32^2
    (512 pixels each)."""
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(frames=(5, 6))
    ek, py0, h = int(jscene["env"]["kind"]), 16, 16
    want = jfs.fused_progressive_sum(jscene, jopts, jcams, W, h, ek, interpret=True, py0=py0,
                                     full_height=FULL_H)
    before = launch_counts()["B1"]
    got = tfs.fused_progressive_sum(tscene, topts, tcams, W, h, ek, py0=py0, full_height=FULL_H)
    assert launch_counts()["B1"] == before  # the CPU path launches no kernel
    assert_images_match(got.numpy(), want)
    full = tfs.fused_progressive_sum(tscene, topts, tcams, W, FULL_H, ek)
    assert torch.equal(got, full[py0:])
    jcam = {k: v[1] for k, v in jcams.items()}
    want = jfs.fused_realtime_outputs(jscene, jopts, jcam, W, h, ek, interpret=True, py0=py0,
                                      full_height=FULL_H)
    got = tfs.fused_realtime_outputs(tscene, topts, {k: v[1] for k, v in tcams.items()}, W, h,
                                     ek, py0=py0, full_height=FULL_H)
    for k in ("direct", "indirect_specular", "albedo", "roughness", "color"):
        assert_images_match(got[k].numpy(), want[k])


def test_plain_b5_row_block_matches_pallas_interpret():
    """B5's plain version at py0 (the Cornell box through its BVH) against
    JAX's fused-traversal kernel in interpret mode: rows 8..15 of 32 x 32,
    progressive S = 1 (B5's realtime plain version is B1's, held above)."""
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(accel="bvh")
    assert tft.supports_fused_traverse(tscene, "progressive", False)
    ek, py0, h = int(jscene["env"]["kind"]), 8, 8
    want = jft.fused_traverse_progressive_sum(jscene, jopts, jcams, W, h, ek, interpret=True,
                                              py0=py0, full_height=FULL_H)
    got = tft.fused_traverse_progressive_sum(tscene, topts, tcams, W, h, ek, py0=py0,
                                             full_height=FULL_H)
    assert_images_match(got.numpy(), want)
    assert tft.fused_traverse_realtime_outputs_reference is tfs.fused_realtime_outputs_reference


@pytest.mark.parametrize("realtime", [False, True])
def test_pack_cameras_row_lanes(realtime):
    (_, _, jcams), (_, _, tcams) = both_sides(frames=(5, 6))
    np.testing.assert_array_equal(tfs.pack_cameras(tcams, realtime).numpy(),
                                  np.asarray(jfs.pack_cameras(jcams, realtime)))
    got = tfs.pack_cameras(tcams, realtime, py0=540, full_height=1080).numpy()
    want = np.asarray(jfs.pack_cameras(jcams, realtime, py0=540))
    np.testing.assert_array_equal(got[:, :13], want[:, :13])  # lane 12: the row offset
    assert (got[:, 13] == 1080.0).all() and not got[:, 14:].any()


def test_row_block_outside_the_image_raises():
    _, (tscene, topts, tcams) = both_sides()
    for py0, full_height in ((24, FULL_H), (-1, FULL_H), (4, 0)):
        with pytest.raises(ValueError):
            tfs.fused_progressive_sum(tscene, topts, tcams, W, 16, 0, py0=py0,
                                      full_height=full_height)
    tfs.check_rows(16, 16, FULL_H)  # the last block fits
