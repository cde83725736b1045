"""The megakernels' triangle records vs the JAX package's packs, bit for bit.

- B1 (``ops/traverse.tri_records``, built by ``Scene.build`` and
  ``scene_from_numpy`` as the scene's ``tri_records``): row i, column j is
  coefficient slot j of triangle i (``csrc/common.cuh``: det = D . s[0:3],
  u*det = D . s[3:6] + M . s[6:9], v*det = D . s[9:12] + M . s[12:15],
  t*det = O . s[15:18] + s[18]), read from the JAX build's ``mt_pack``
  [4, C, 16] at group lane // 16, column lane % 16 of the slot's mt_rows
  lane (the ``coef_lane`` map); column 19 is zero, and so is every row
  after ``num_tris``. On Cornell-glossy (36 triangles in 40 rows) and a
  seeded 256-triangle soup. B1's wrapper raises on a scene without them.
- B5 (``ops/traverse.leaf_records``, built by ``Scene.build`` into the BVH
  as ``ft_test`` and ``ft_attr``): ``ft_test`` column j is the JAX build's
  ``mt_rows`` lane ``coef_lane(j)`` and column 19 zero, ``ft_attr`` its
  lanes 64..79; and the keys the port's BVH shares with JAX's
  ``pack_for_traversal`` stay bit-equal to JAX's. On 'instanced:1' (962
  triangles, accel='bvh'), a seeded 600-triangle soup and the textured
  Cornell box (its corner-UV lanes).
- B6a (``blas_test``, ``ops/traverse.coef_records`` of the two-level
  build's ``mt_rows``, built by ``Scene.build_two_level`` and
  ``scene_from_numpy``): column j is the JAX two-level build's ``mt_rows``
  lane ``coef_lane(j)`` and column 19 zero; a refit leaves it as it was.
  B3 stages ``tri_records`` too: a flat scene has them up to the BVH
  threshold (4,096 rows).
"""

import jax
import numpy as np
import pytest
import torch

from dxrexperiments_torch.app.headless import build_scene as t_build_scene
from dxrexperiments_torch.ops import fused_sample as tfs
from dxrexperiments_torch.ops import traverse as ttv
from dxrexperiments_torch.scene import Scene as TScene
from dxrexperiments_torch.scene.convert import scene_from_numpy
from dxrexperiments_torch.scene.dynamic import refit_scene_instances
from dxrexperiments_torch.scene.materials import Material as TMaterial
from dxrexperiments_torch.scene.scene import BVH_THRESHOLD
from dxrexperiments_torch.scene.procedural import random_triangle_soup as t_soup
from dxrexperiments_tpu.app.headless import build_scene as j_build_scene
from dxrexperiments_tpu.scene import Scene as JScene
from dxrexperiments_tpu.scene.materials import Material as JMaterial
from dxrexperiments_tpu.scene.procedural import random_triangle_soup as j_soup

SLOTS = 19


def coef_lane(j: int) -> int:
    """csrc/common.cuh coef_lane: the mt_rows lane of coefficient slot j."""
    if j < 3:
        return j
    if j < 9:
        return 16 + (j - 3)
    if j < 15:
        return 32 + (j - 9)
    return 54 + (j - 15)


LANES = [coef_lane(j) for j in range(SLOTS)]


def npy(x):
    return np.asarray(jax.device_get(x))


def scene_pair(kind):
    """(JAX Scene, port Scene) of the same triangles and materials."""
    if not kind.startswith("soup"):
        return j_build_scene(kind)[0], t_build_scene(kind)[0]
    n, seed = (int(v) for v in kind.split(":")[1:])
    out = []
    for sc_cls, soup, mat in ((JScene, j_soup, JMaterial), (TScene, t_soup, TMaterial)):
        sc = sc_cls()
        sc.add_material(mat.reference_default())
        sc.add_model(soup(n, seed=seed, extent=3.0))
        out.append(sc)
    return tuple(out)


def test_coef_lanes_are_the_kernels():
    assert tuple(LANES) == ttv.COEF_LANES
    assert len(set(LANES)) == SLOTS and max(LANES) < 64


@pytest.mark.parametrize("kind", ["cornell-glossy", "soup:256:21"])
def test_tri_records_equal_jax_mt_pack(kind):
    jsc, tsc = scene_pair(kind)
    jmt = npy(jsc.build(accel="none")["mt_pack"])  # [4, C, 16]
    tscene = tsc.build("cpu", accel="none")
    rec = tscene["tri_records"].numpy()
    c = jmt.shape[1]
    assert rec.shape == (c, ttv.REC_WORDS) and rec.dtype == np.float32
    want = np.stack([jmt[lane // 16, :, lane % 16] for lane in LANES], axis=1)
    np.testing.assert_array_equal(rec[:, :SLOTS].view(np.int32), want.view(np.int32))
    assert not rec[:, SLOTS:].any()
    n = int(tscene["num_tris"])
    assert not rec[n:].any() and rec[n - 1].any()  # the kernel's sweeps stop after num_tris
    np.testing.assert_array_equal(ttv.tri_records(tscene["mt_pack"]).numpy().view(np.int32),
                                  rec.view(np.int32))


@pytest.mark.parametrize("kind,rows", [("soup:250:3", 256), ("soup:300:5", 304),
                                       ("soup:4100:5", 4608)])
def test_tri_records_only_where_b1_stages_them(kind, rows):
    """B1 stages a flat scene's records up to FUSED_MAX_TRIS rows, and B3
    (the brute-force traces) up to the BVH threshold: Scene.build gives a
    flat scene its records up to there."""
    _, tsc = scene_pair(kind)
    scene = tsc.build("cpu", accel="none")
    assert int(scene["mt_pack"].shape[1]) == rows
    assert ttv.FUSED_MAX_TRIS == tfs.MAX_TRIS < BVH_THRESHOLD
    assert ("tri_records" in scene) == (rows <= BVH_THRESHOLD)


def test_scene_from_numpy_carries_tri_records():
    jsc, tsc = scene_pair("cornell-glossy")
    got = scene_from_numpy(jax.tree_util.tree_map(npy, jsc.build(accel="none")), "cpu")
    want = tsc.build("cpu", accel="none")
    assert got["num_tris"] == want["num_tris"] == 36
    assert torch.equal(got["tri_records"].view(torch.int32), want["tri_records"].view(torch.int32))


def test_fused_launch_raises_without_tri_records():
    _, tsc = scene_pair("cornell-glossy")
    scene = tsc.build("cpu", accel="none")
    del scene["tri_records"]
    cams = {"eye": torch.zeros(1, 3), "frame_count": torch.zeros(1, dtype=torch.int32)}
    with pytest.raises(ValueError, match="tri_records"):
        tfs.prepare_launch(scene, {}, cams, 8, 8, 0, False)


@pytest.mark.parametrize("kind", ["instanced:1", "soup:600:11", "cornell-tex"])
def test_leaf_records_equal_jax_mt_rows(kind):
    jsc, tsc = scene_pair(kind)
    jbvh = jsc.build(accel="bvh")["bvh"]
    tbvh = tsc.build("cpu", accel="bvh")["bvh"]
    for k in ("bvh_nodes", "bvhf_nodes", "bvh8_nodes", "mt_rows", "slot_tri"):  # shared keys
        np.testing.assert_array_equal(tbvh[k].numpy(), npy(jbvh[k]), err_msg=k)
    rows = npy(jbvh["mt_rows"])
    test, attr = tbvh["ft_test"].numpy(), tbvh["ft_attr"].numpy()
    assert test.shape == (rows.shape[0], 20) and attr.shape == (rows.shape[0], 16)
    assert test.dtype == attr.dtype == np.float32
    np.testing.assert_array_equal(test[:, :SLOTS].view(np.int32),
                                  rows[:, LANES].view(np.int32))
    assert not test[:, SLOTS:].any()
    np.testing.assert_array_equal(attr.view(np.int32), rows[:, 64:80].view(np.int32))
    if kind == "cornell-tex":  # the corner UVs ride in columns 10..15
        assert int(tbvh["mt_attr_lanes"]) == 2 and attr[:, 10:16].any()
    # the port's derived arrays only: every other key is JAX's
    assert set(tbvh) - set(jbvh) <= {"ft_test", "ft_attr", "bvhf_rows", "bvh_rows",
                                     "bvh8_rows", "builder"}


@pytest.mark.parametrize("kind", ["instanced:2", "five"])
def test_blas_records_equal_jax_mt_rows(kind):
    from test_torch_cuda import port_five, tf
    from test_torch_tlas import MOVED, scenes

    jd = scenes(kind)[0].build_two_level()
    want = npy(jd["tlas"]["mt_rows"])
    tsc = port_five() if kind == "five" else t_build_scene(kind)[0]
    built = tsc.build_two_level("cpu")
    converted = scene_from_numpy(jax.tree.map(np.asarray, jd), "cpu")
    for scene in (built, converted):
        rec = scene["tlas"]["blas_test"].numpy()
        assert rec.shape == (want.shape[0], 20) and rec.dtype == np.float32
        np.testing.assert_array_equal(rec[:, :SLOTS].view(np.int32),
                                      want[:, LANES].view(np.int32))
        assert not rec[:, SLOTS:].any()
    n = built["tlas_meta"]["num_instances"]
    moved = (np.stack(MOVED) if kind == "five"
             else np.stack([tf((0.1 * i, 0.0, 0.0), yaw=0.2 * i) for i in range(n)]))
    refit = refit_scene_instances(built, moved)
    assert refit["tlas"]["blas_test"] is built["tlas"]["blas_test"]  # a refit moves no BLAS array
