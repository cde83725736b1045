"""Port accel/tlas.py, Scene.build_two_level, the refit and ops/traverse2.py
vs the JAX package.

Both packages build tests/test_tlas.py's 5-instance, 2-mesh scene (turns,
a 1.4 scale, material overrides) and the 'instanced:2' grid two-level:

- the BLAS arrays, the slot map, the refit context and the frozen topology
  rows (the TLAS's left/right, the fat TLAS's ptr/meta, the instance
  table's constant rows) are equal to the last bit; the boxes and the
  inverse and normal matrices, float32 products summed in another order,
  within rtol 1e-6, atol 1e-6 (refits to new transforms as well);
- a refit equals a fresh build at transforms that keep the Morton order;
- the plain two-level trace (on the CPU, what the B6a wrappers run) equals
  ``two_level_closest_jnp``/``_any_jnp`` and the JAX fat two-level kernel
  in interpret mode on 512 rays: hits, triangles and instances equal, t and
  u within rtol 2e-4, atol 2e-4 (tests/test_tlas.py's tolerance: the two
  sides recompute u differently on grazing hits);
- ``fat_walk2_numpy``, the host model of the CUDA walk, equals the plain
  version on the same rays, so the walk's order, pruning and both stacks
  are checked here although the kernel runs only on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.accel import tlas as ttlas
from dxrexperiments_torch.app import headless as thead
from dxrexperiments_torch.ops import traverse2 as tt2
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene import Scene as TScene
from dxrexperiments_torch.scene.convert import scene_from_numpy
from dxrexperiments_torch.scene.dynamic import refit_scene_instances
from dxrexperiments_torch.scene.procedural import sphere_mesh as t_sphere
from dxrexperiments_torch.trace import integrator as tint
from dxrexperiments_tpu.accel import tlas as jtlas
from dxrexperiments_tpu.app.headless import build_scene as j_build_scene
from dxrexperiments_tpu.ops import traverse2_pallas as jt2
from dxrexperiments_tpu.scene import Scene as JScene
from dxrexperiments_tpu.scene.materials import Material as JMaterial
from dxrexperiments_tpu.scene.procedural import box_mesh as j_box
from dxrexperiments_tpu.scene.procedural import sphere_mesh as j_sphere
from test_torch_cuda import chain_two_level, five_instance_scene, port_five, probe_rays, tf

KINDS = ("five", "instanced:2")
STATIC = ("blas_nodes", "blasf_nodes", "mt_rows", "slot_tri")
CTX_FIELDS = ("inst_order", "slot_mesh_lo", "slot_mesh_hi", "slot_blas_root",
              "slot_blas_fat_root", "slot_mat_override")
MOVED = [tf((0.3, 0.1, -0.2), yaw=0.3), tf((2.0, 0.4, 0.3), yaw=1.1),
         tf((-2.8, 0.2, 0.7), yaw=-0.9, scale=1.2), tf((0.4, 0, 2.9), scale=0.9),
         tf((-0.3, 1.8, -2.2), yaw=2.4)]


def scenes(kind):
    """(JAX Scene, port Scene) holding the same instances."""
    if kind == "five":
        return five_instance_scene(JScene, JMaterial, j_box, j_sphere), port_five()
    return j_build_scene(kind)[0], thead.build_scene(kind)[0]


def npy(x):
    return np.asarray(x)


def assert_refit_equal(got: dict, want: dict):
    """Topology rows bit-equal, boxes and matrices within 1e-6."""
    g = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(g["tlas_nodes"][6:], npy(want["tlas_nodes"])[6:])
    np.testing.assert_array_equal(g["tlasf_nodes"][12:], npy(want["tlasf_nodes"])[12:])
    np.testing.assert_array_equal(g["inst_rows"][12:], npy(want["inst_rows"])[12:])
    for k in ("inst_mat_override", "inst_orig"):
        np.testing.assert_array_equal(g[k], npy(want[k]), err_msg=k)
    for k, rows in (("tlas_nodes", slice(0, 6)), ("tlasf_nodes", slice(0, 12)),
                    ("inst_rows", slice(0, 12))):
        np.testing.assert_allclose(g[k][rows], npy(want[k])[rows], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(g["inst_nm"], npy(want["inst_nm"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(g["tlasf_rows"], g["tlasf_nodes"].T)
    np.testing.assert_array_equal(g["tlas_rows"], g["tlas_nodes"].T)
    np.testing.assert_array_equal(g["inst_rows_t"], g["inst_rows"][:16].T)


@pytest.mark.parametrize("kind", KINDS)
def test_build_equals_jax(kind):
    jsc, tsc = scenes(kind)
    jd, td = jsc.build_two_level(), tsc.build_two_level("cpu")
    for k in STATIC:
        np.testing.assert_array_equal(td["tlas"][k].numpy(), npy(jd["tlas"][k]), err_msg=k)
    np.testing.assert_array_equal(td["tlas"]["blasf_rows"].numpy(), npy(jd["tlas"]["blasf_nodes"]).T)
    assert_refit_equal(td["tlas"], jd["tlas"])
    jm, tm = jd["tlas_meta"].value, td["tlas_meta"]
    assert tm["num_instances"] == jm["num_instances"]
    np.testing.assert_array_equal(tm["slot_mesh"], jm["slot_mesh"])
    assert tm["mesh_tri_ranges"] == jm["mesh_tri_ranges"]
    for f in CTX_FIELDS:
        np.testing.assert_array_equal(getattr(tm["refit_ctx"], f), getattr(jm["refit_ctx"], f))
    assert tm["refit_ctx"].levels == jm["refit_ctx"].levels
    for k in ("v0", "e1", "e2", "pn", "c1", "c2", "d0", "n0", "n1", "n2", "mat_id"):
        np.testing.assert_array_equal(td[f"{k}_obj"].numpy(), npy(jd[f"{k}_obj"]), err_msg=k)
    assert td["num_tris"] == int(jd["num_tris"])
    for k, v in jd["materials"].items():
        np.testing.assert_array_equal(td["materials"][k].numpy(), npy(v), err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_refit_equals_jax(kind):
    jsc, tsc = scenes(kind)
    jd, td = jsc.build_two_level(), tsc.build_two_level("cpu")
    base = np.stack([i.transform for i in tsc.instances])
    moved = (np.stack(MOVED) if kind == "five"
             else np.einsum("ij,njk->nik", tf((0.2, 0.1, 0.0), yaw=0.6, scale=1.3), base))
    want = jtlas.refit_instances_arrays(jd["tlas_meta"].value["refit_ctx"], jnp.asarray(moved))
    got = ttlas.refit_instances_arrays(td["tlas_meta"]["refit_ctx"], moved)
    assert_refit_equal(got, want)
    # a tensor on the scene's device takes the same path as the host array
    again = refit_scene_instances(td, torch.as_tensor(moved))["tlas"]
    for k, v in got.items():
        assert torch.equal(again[k], v), k


def test_refit_matches_fresh_build():
    tsc = port_five()
    built = tsc.build_two_level("cpu")
    transforms = np.stack([i.transform for i in tsc.instances])
    transforms[:, 0, 3] += 0.75  # a shift in x keeps the Morton order
    refit = refit_scene_instances(built, transforms)["tlas"]
    for inst, t in zip(tsc.instances, transforms):
        inst.transform = t
    fresh = tsc.build_two_level("cpu")
    np.testing.assert_array_equal(fresh["tlas_meta"]["refit_ctx"].inst_order,
                                  built["tlas_meta"]["refit_ctx"].inst_order)
    for k in ("tlas_nodes", "tlasf_nodes", "tlasf_rows", "inst_rows", "inst_rows_t", "inst_nm"):
        torch.testing.assert_close(refit[k], fresh["tlas"][k], rtol=0, atol=1e-5, msg=k)


def test_single_instance_tlas_equals_jax():
    jsc, tsc = JScene(), TScene()
    m = tf((0.3, 0, 0), yaw=0.4, scale=1.2)
    jsc.add_model(j_sphere((0.0, 0.0, 0.0), 1.0), transform=m)
    tsc.add_model(t_sphere((0.0, 0.0, 0.0), 1.0), transform=m)
    jd, td = jsc.build_two_level(), tsc.build_two_level("cpu")
    assert td["tlas_meta"]["refit_ctx"].levels == 0
    assert_refit_equal(td["tlas"], jd["tlas"])
    assert td["tlas"]["tlasf_rows"][0, 12:].tolist() == [0.0, 1.0, 0.0, 0.0]
    o, d = probe_rays(256, 2, spread=0.8)
    got = tt2.fat_walk2_numpy({k: v.numpy() for k, v in td["tlas"].items()}, o, d, 1e-4, 3.0e37)[0]
    want = tt2.traverse2_fat_closest(td, torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(got["hit"], want["hit"].numpy())
    assert 0.2 < got["hit"].mean() < 1.0 and (got["inst"][got["hit"]] == 0).all()


def both(kind):
    """(JAX two-level pytree, the port's conversion of it)."""
    jd = scenes(kind)[0].build_two_level()
    return jd, scene_from_numpy(jax.tree.map(np.asarray, jd), "cpu")


def rays_for(kind, seed):
    if kind == "five":
        return probe_rays(512, seed)
    return probe_rays(512, seed, radius=12.0, spread=3.0)


def assert_hits_equal(got, want, inst_key="inst"):
    h = np.asarray(want["hit"])
    np.testing.assert_array_equal(np.asarray(got["hit"]), h)
    np.testing.assert_array_equal(np.asarray(got["tri"])[h], np.asarray(want["tri"])[h])
    np.testing.assert_array_equal(np.asarray(got["inst"])[h], np.asarray(want[inst_key])[h])
    for k in ("t", "u"):
        np.testing.assert_allclose(np.asarray(got[k])[h], np.asarray(want[k])[h], rtol=2e-4,
                                   atol=2e-4, err_msg=k)
    assert 0.1 < h.mean() < 0.95


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cull", [False, True])
def test_plain_matches_jnp_closest(kind, cull):
    jd, td = both(kind)
    o, d = rays_for(kind, 3)
    want = jtlas.two_level_closest_jnp(jd, jnp.asarray(o), jnp.asarray(d), 1e-4, 3.0e37, cull)
    before = launch_counts()["B6a closest"]
    got = tt2.traverse2_fat_closest(td, torch.as_tensor(o), torch.as_tensor(d), 1e-4, 3.0e37,
                                    cull_backface=cull)
    assert launch_counts()["B6a closest"] == before  # the CPU path launches no kernel
    assert_hits_equal({k: v.numpy() for k, v in got.items()}, want)
    np.testing.assert_array_equal(
        td["tlas"]["slot_tri"].numpy()[got["slot"].numpy()[got["hit"].numpy()]],
        got["tri"].numpy()[got["hit"].numpy()])


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jnp_any(kind):
    jd, td = both(kind)
    o, d = rays_for(kind, 4)
    tmax = np.where(np.arange(512) % 2 == 0, 3.0e37, 7.5).astype(np.float32)
    d[::7] = 0.0  # dead lanes: zero directions are never occluded
    want = np.asarray(jtlas.two_level_any_jnp(jd, jnp.asarray(o), jnp.asarray(d), 1e-4,
                                              jnp.asarray(tmax)))
    got = tt2.traverse2_fat_any(td, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                                torch.as_tensor(tmax)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.95 and not got[::7].any()


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_pallas_fat_interpret(kind):
    jd, td = both(kind)
    o, d = rays_for(kind, 5)
    want = jt2.traverse2_fat_closest(jd["tlas"], jnp.asarray(o), jnp.asarray(d), 1e-4, 3.0e37,
                                     leaf_size=32, interpret=True)
    got = tt2.traverse2_fat_closest(td, torch.as_tensor(o), torch.as_tensor(d), 1e-4, 3.0e37)
    assert_hits_equal({k: v.numpy() for k, v in got.items()}, want)
    occ_want = np.asarray(jt2.traverse2_fat_any(jd["tlas"], jnp.asarray(o), jnp.asarray(d), 1e-4,
                                                6.0, leaf_size=32, interpret=True))
    occ = tt2.traverse2_fat_any(td, torch.as_tensor(o), torch.as_tensor(d), 1e-4, 6.0).numpy()
    np.testing.assert_array_equal(occ, occ_want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cull", [False, True])
def test_walk2_model_matches_plain(kind, cull):
    _, tsc = scenes(kind)
    td = tsc.build_two_level("cpu")
    tl_np = {k: v.numpy() for k, v in td["tlas"].items()}
    o, d = rays_for(kind, 6)
    want = tt2.two_level_closest_reference(td, torch.as_tensor(o), torch.as_tensor(d),
                                           cull_backface=cull)
    got, counts = tt2.fat_walk2_numpy(tl_np, o, d, 1e-4, 3.0e37, cull=cull)
    tri = np.where(got["hit"], tl_np["slot_tri"][np.maximum(got["slot"], 0)], -1)
    assert_hits_equal(dict(got, tri=tri), {k: v.numpy() for k, v in want.items()})
    n_inst = td["tlas_meta"]["num_instances"]
    assert 0 < counts["instance_entries"] < 512 * n_inst  # the TLAS prunes
    assert counts["slab_tests"] == 2 * (counts["tlas_visits"] + counts["blas_visits"])
    assert len(counts["inst_ids"]) <= n_inst and len(counts["slot_ids"]) > 0
    tmax = np.where(np.arange(512) % 2 == 0, 3.0e37, 7.5).astype(np.float32)
    d[::7] = 0.0
    occ, occ_counts = tt2.fat_walk2_numpy(tl_np, o, d, 1e-4, tmax, occlusion=True)
    want_occ = tt2.two_level_any_reference(td, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                                           torch.as_tensor(tmax)).numpy()
    np.testing.assert_array_equal(occ["occluded"], want_occ)
    assert occ_counts["pair_tests"] < counts["pair_tests"]


def test_walk2_model_stack_overflow_raises():
    o = np.zeros((2, 3), np.float32)
    d = np.array([[0.0, 0.0, 1.0]] * 2, np.float32)

    def tl_np(levels):
        return {k: v.numpy() for k, v in chain_two_level(levels)["tlas"].items()}

    with pytest.raises(RuntimeError, match="stack overflowed"):
        tt2.fat_walk2_numpy(tl_np(120), o, d, 0.0, 1e38)
    got, _ = tt2.fat_walk2_numpy(tl_np(40), o, d, 0.0, 1e38)
    assert got["hit"].all() and np.allclose(got["t"], 5.0)
    plain = tt2.traverse2_fat_closest(chain_two_level(40), torch.as_tensor(o), torch.as_tensor(d),
                                      0.0, 1e38)
    assert bool(plain["hit"].all()) and torch.allclose(plain["t"], torch.full((2,), 5.0))


def test_check_tlas_needs_fat_rows():
    """B6a's check needs the fat rows; a TLAS without them passes the binary
    walk's check (B6b), and the integrator routes it there, keyed on
    ``"tlasf_nodes" in tlas`` as the JAX integrator is."""
    cpu = torch.device("cpu")
    td = port_five().build_two_level("cpu")
    assert len(tt2.check_tlas(td["tlas"], cpu)) == 4
    fatless = {k: v for k, v in td["tlas"].items() if k not in ("tlasf_nodes", "tlasf_rows")}
    with pytest.raises(ValueError, match="tlasf_rows"):
        tt2.check_tlas(fatless, cpu)
    got = tt2.check_tlas(fatless, cpu, "binary")  # B6b reads the records blas_test too
    assert [tuple(t.shape[1:]) for t in got] == [(8,), (16,), (8,), (20,)]
    assert tint.walk_functions(td, "cuda") == (tt2.traverse2_fat_closest, tt2.traverse2_fat_any)
    assert tint.walk_functions(dict(td, tlas=fatless), "cuda") == (tt2.traverse2_closest,
                                                                  tt2.traverse2_any)
    with pytest.raises(ValueError, match="inst_rows_t"):
        tt2.check_tlas(dict(td["tlas"], inst_rows_t=td["tlas"]["inst_rows"]), cpu)
