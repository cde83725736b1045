"""Port B1's opt-ins (``FUSED_CLUSTERS``, ``FUSED_BLOCK_W``) vs the JAX package.

- ``ops/fused_sample.cluster_aabbs`` equals JAX's ``_cluster_aabbs`` bit for
  bit for 8, 16 and 24 rows per cluster, on the Cornell box (36 triangles
  padded to 40 rows) and on a 256-row soup;
- ``knobs`` reads ``FUSED_CLUSTERS`` and ``FUSED_BLOCK_W`` at each call, and
  the keyword arguments override them; ``opt_in_args`` gives the kernel
  clusters only where C > cluster_rows, as JAX does;
- the blocked pixel order (``block_pixels`` below states the kernel's
  mapping, ``csrc/fused_sample.cu`` ``pixel_index``) renders every pixel
  exactly once, equals JAX's permutation where JAX's tile is the CUDA
  block's THREADS pixels, and falls back to raster by ``block_order``, JAX's
  rule;
- the port's progressive sum on the CPU (the plain version, which takes no
  knob) against JAX's B1 in interpret mode with ``FUSED_CLUSTERS=16``
  (``_any_hit_clustered``), on the image gate of tests/test_fused_sample.py,
  as tests/test_fused_sample.py:444-455 holds JAX's clustered kernel to its
  flat one.

The CUDA instantiations (CLUSTERED, BLOCKED) are held bit-equal to the base
kernel on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.ops import fused_sample as tfs
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene.convert import scene_from_numpy
from dxrexperiments_tpu.ops import fused_sample_pallas as jfs
from dxrexperiments_tpu.scene import Scene
from dxrexperiments_tpu.scene.procedural import random_triangle_soup
from test_torch_fused_sample import H, W, assert_images_match, both_sides, jax_scene


def block_pixels(width: int, height: int, block_w: int) -> torch.Tensor:
    """[H * W] int64: the raster pixel each thread renders, thread j of the
    launch being thread j % THREADS of CUDA block j // THREADS, as the
    kernel's pixel_index maps them (``block_order`` decides; 0 is raster)."""
    j = torch.arange(width * height, dtype=torch.int64)
    bw = tfs.block_order(width, height, block_w)
    if not bw:
        return j
    b, t = j // tfs.THREADS, j % tfs.THREADS
    wb = width // bw
    px = (b % wb) * bw + t % bw
    py = (b // wb) * (tfs.THREADS // bw) + t // bw
    return py * width + px


def soup256():
    sc = Scene()
    sc.add_model(random_triangle_soup(250, seed=3, extent=2.0))
    return sc.build()


@pytest.mark.parametrize("kind", ["cornell", "soup256"])
@pytest.mark.parametrize("rows", [8, 16, 24])
def test_cluster_aabbs_equal_jax(kind, rows):
    jscene = jax_scene() if kind == "cornell" else soup256()
    c = int(jscene["mt_pack"].shape[1])
    assert c == (40 if kind == "cornell" else 256)
    tscene = scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    want = np.asarray(jfs._cluster_aabbs(jscene, rows))
    got = tfs.cluster_aabbs(tscene, rows)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (-(-c // rows), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # the padded rows are out of every box; a cluster of padding alone never hits
    n = int(jscene["num_tris"])
    if n % rows == 0 or -(-n // rows) < got.shape[0]:
        assert (got[-1, 0:3] > got[-1, 3:6]).all()


def test_knobs_read_the_environment(monkeypatch):
    monkeypatch.delenv("FUSED_CLUSTERS", raising=False)
    monkeypatch.delenv("FUSED_BLOCK_W", raising=False)
    assert tfs.knobs() == (0, 0)
    monkeypatch.setenv("FUSED_CLUSTERS", "16")
    monkeypatch.setenv("FUSED_BLOCK_W", "8")
    assert tfs.knobs() == (16, 8)  # read at each call
    assert tfs.knobs(cluster_rows=24) == (24, 8)
    assert tfs.knobs(block_w=0) == (16, 0)
    monkeypatch.setenv("FUSED_TILE", "512")  # a TPU tile: not carried
    assert tfs.knobs(0, 32) == (0, 32)


def test_opt_in_args(monkeypatch):
    """Clusters reach the kernel only where C > cluster_rows (JAX's rule);
    the block width only where the block order applies."""
    _, (tscene, _, _) = both_sides({}, "const")  # Cornell: C = 40
    monkeypatch.setenv("FUSED_CLUSTERS", "16")
    monkeypatch.setenv("FUSED_BLOCK_W", "16")
    (ptr, k, rows, bw), boxes = tfs.opt_in_args(tscene, 64, 64, None, None)
    assert ptr == boxes.data_ptr() and (k, rows, bw) == (3, 16, 16)
    torch.testing.assert_close(boxes, tfs.cluster_aabbs(tscene, 16), rtol=0, atol=0)
    (ptr, k, rows, bw), boxes = tfs.opt_in_args(tscene, 60, 64, 40, None)  # C = 40: off
    assert (ptr, k, rows, bw, boxes) == (None, 0, 0, 0, None)  # 60 % 16: raster
    assert tfs.opt_in_args(tscene, 64, 64, 0, 0)[0] == (None, 0, 0, 0)


@pytest.mark.parametrize("width,height,block_w,blocked", [
    (32, 32, 8, True), (64, 48, 16, True), (128, 8, 128, True), (512, 512, 32, True),
    (30, 32, 8, False),  # the width
    (32, 30, 8, False),  # the height: 8-pixel blocks are THREADS / 8 rows
    (48, 48, 48, False),  # 48 does not divide the THREADS-thread block
    (32, 32, 0, False),  # off
])
def test_block_order_covers_every_pixel(width, height, block_w, blocked):
    perm = block_pixels(width, height, block_w)
    n = width * height
    assert torch.equal(torch.sort(perm).values, torch.arange(n))  # each pixel once
    assert tfs.block_order(width, height, block_w) == (block_w if blocked else 0)
    if not blocked:
        assert torch.equal(perm, torch.arange(n))
        return
    # JAX's permutation (fused_sample_pallas._fused_dispatch) at tile_r = THREADS
    block_h = tfs.THREADS // block_w
    pys, pxs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    want = ((pys * width + pxs).reshape(height // block_h, block_h, width // block_w, block_w)
            .transpose(0, 2, 1, 3).reshape(-1))
    np.testing.assert_array_equal(perm.numpy(), want)
    # a CUDA block's THREADS pixels form one block_w x block_h rectangle
    first = perm[: tfs.THREADS]
    assert len(set((first % width).tolist())) == block_w
    assert len(set((first // width).tolist())) == block_h


def test_plain_matches_pallas_clustered(monkeypatch):
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides({}, "const")
    monkeypatch.setenv("FUSED_CLUSTERS", "16")
    ek = int(jscene["env"]["kind"])
    want = jfs.fused_progressive_sum(jscene, jopts, jcams, W, H, ek, interpret=True)
    before = launch_counts()["B1"]
    got = tfs.fused_progressive_sum(tscene, topts, tcams, W, H, ek)
    assert launch_counts()["B1"] == before  # the CPU path launches no kernel
    assert_images_match(got.numpy(), want, frac=0.005)
    # the keyword argument reaches the same plain version
    again = tfs.fused_progressive_sum(tscene, topts, tcams, W, H, ek, cluster_rows=8, block_w=8)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    assert jnp.isfinite(want).all()
