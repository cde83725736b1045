"""Port ``scene.dynamic``'s instance re-bake and the refit's PRIME update
against the JAX package on the same numpy inputs.

``bake_instances`` (16 boxes of 16 padded rows, with and without material
overrides): every output array within atol 1e-5 of JAX's (``pn`` also
rtol 1e-5), ``inst_id`` and ``mat_id`` equal, ``num_tris`` a Python int,
``tri_records`` equal to ``ops/traverse.tri_records(mt_pack)``; a JAX bake
carried across by ``scene_from_numpy`` keeps that layout. A 32^2
``render_sample`` of a baked scene through the port's plain path against
JAX's jnp one within atol 2e-5 (tests/test_golden.py's tolerance), and
the padding rows of the base mesh never hit. The two-level refit's PRIME
table against JAX's within rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.core import camera as tcam
from dxrexperiments_torch.ops import intersect as tintersect
from dxrexperiments_torch.ops.traverse import tri_records
from dxrexperiments_torch.scene import Material as TMaterial
from dxrexperiments_torch.scene import Scene as TScene
from dxrexperiments_torch.scene import dynamic as tdyn
from dxrexperiments_torch.scene import envmap as tenv
from dxrexperiments_torch.scene.convert import scene_from_numpy
from dxrexperiments_torch.scene.lights import default_lights as t_default_lights
from dxrexperiments_torch.scene.mesh import Mesh as TMesh
from dxrexperiments_torch.scene.procedural import box_mesh as t_box
from dxrexperiments_torch.scene.procedural import sphere_mesh as t_sphere
from dxrexperiments_torch.trace import integrator as tint
from dxrexperiments_tpu.core import camera as jcam
from dxrexperiments_tpu.scene import Scene as JScene
from dxrexperiments_tpu.scene import dynamic as jdyn
from dxrexperiments_tpu.scene import envmap as jenv
from dxrexperiments_tpu.scene.lights import default_lights as j_default_lights
from dxrexperiments_tpu.scene.materials import Material as JMaterial
from dxrexperiments_tpu.scene.mesh import Mesh as JMesh
from dxrexperiments_tpu.scene.procedural import box_mesh as j_box
from dxrexperiments_tpu.scene.procedural import sphere_mesh as j_sphere
from dxrexperiments_tpu.trace import default_options, render_sample
from test_torch_cuda import bake_base_scene, grid_scene, one_thread, yaw_grid  # noqa: F401

N_INST = 16
ARRAYS = ("v0", "e1", "e2", "n0", "n1", "n2", "pn", "c1", "c2", "d0", "mt_pack", "attr_pack")
OVERRIDE = np.array([-1, 1, 0, -1] * 4, np.int32)


pytestmark = pytest.mark.usefixtures("one_thread")


def bakes(override, yaw0=0.0, **extra):
    """(JAX bake, port bake) of N_INST boxes on the same transforms."""
    tfs = yaw_grid(N_INST, yaw0=yaw0)
    jbase = jdyn.prepare_base(bake_base_scene(JScene, JMaterial, j_box), N_INST)
    tbase = tdyn.prepare_base(bake_base_scene(TScene, TMaterial, t_box, "cpu"), N_INST)
    jover = None if override is None else jnp.asarray(override)
    jx = {k: v[0] for k, v in extra.items()}
    tx = {k: v[1] for k, v in extra.items()}
    return (jdyn.bake_instances(jbase, jnp.asarray(tfs), jover, **jx),
            tdyn.bake_instances(tbase, tfs, override, **tx))


@pytest.mark.parametrize("override", [None, OVERRIDE], ids=["mesh_ids", "overrides"])
def test_bake_matches_jax(override):
    jd, td = bakes(override)
    assert isinstance(td["num_tris"], int) and td["num_tris"] == int(jd["num_tris"]) == 256
    for k in ARRAYS:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), atol=1e-5, err_msg=k)
    np.testing.assert_allclose(td["pn"].numpy(), np.asarray(jd["pn"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(td["mat_id"].numpy(), np.asarray(jd["mat_id"]))
    np.testing.assert_array_equal(td["inst_id"].numpy(), np.asarray(jd["inst_id"]))
    assert torch.equal(td["tri_records"], tri_records(td["mt_pack"]))
    assert td["materials"] is not None and "lights" not in td and "env" not in td
    # a JAX bake carried across keeps the baked layout, records included
    conv = scene_from_numpy(jax.tree.map(np.asarray, jd), "cpu")
    assert conv["num_tris"] == 256 and "bvh" not in conv
    np.testing.assert_array_equal(conv["inst_id"].numpy(), np.asarray(jd["inst_id"]))
    assert torch.equal(conv["tri_records"], tri_records(conv["mt_pack"]))


def test_baked_render_matches_jax():
    """A 32^2 progressive sample of 16 baked boxes: the port's plain path
    against JAX's jnp path; the padding rows (12-15 of each box) never hit."""
    size = 32
    jenv_, tenv_ = jenv.constant_env((0.1, 0.2, 0.3)), tenv.constant_env((0.1, 0.2, 0.3))
    jd, td = bakes(OVERRIDE, yaw0=0.4, lights=(j_default_lights(), t_default_lights()),
                   env=(jenv_, tenv_))
    cams = []
    for mod in (jcam, tcam):
        cam = mod.Camera()
        cam.set_eye_at_up((22.0, 9.0, 18.0), (22.0, 2.0, 0.0), (0.0, 1.0, 0.0))
        cam.set_aspect(size, size)
        cams.append(mod.camera_params(cam, jitter=(0.2 / size, -0.1 / size), frame_count=5))
    want = np.asarray(render_sample(jd, default_options(), cams[0], size, size,
                                    impl="jnp")["color"])
    got = tint.render_sample(td, tint.default_options(), cams[1], size, size, impl="torch")["color"]
    assert float(want.max()) > 0.01
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    o, d = tcam.primary_ray_grid(cams[1], size, size, 30.0)
    hits = tintersect.intersect_closest(td, o.reshape(-1, 3), d.reshape(-1, 3), 0.0, 1e30)
    assert bool(hits["hit"].any()) and bool((hits["tri"][hits["hit"]] % 16 < 12).all())


def test_refit_prime_matches_jax():
    """The two-level grid's PRIME table: built, then refit to new
    transforms, equal to JAX's (rtol 1e-6), its sources carried across."""
    jsc = grid_scene(JScene, JMaterial, JMesh, j_sphere)
    tsc = grid_scene(TScene, TMaterial, TMesh, t_sphere)
    jd, td = jsc.build_two_level(), tsc.build_two_level("cpu")
    src_j, src_t = jd["tlas_meta"].value["prime_src"], td["tlas_meta"]["prime_src"]
    for k in ("v0", "e1", "e2", "inst"):
        np.testing.assert_array_equal(src_t[k].numpy(), src_j[k], err_msg=k)
    conv = scene_from_numpy(jax.tree.map(np.asarray, jd), "cpu")
    for k in ("v0", "e1", "e2", "inst"):
        np.testing.assert_array_equal(conv["tlas_meta"]["prime_src"][k].numpy(), src_j[k])
    tfs = np.stack([inst.transform for inst in tsc.instances]).copy()
    tfs[:, 0, 3] += 3.0
    tfs[:, 1, 3] += 0.5
    tfs[1, :3, :3] = yaw_grid(2)[1, :3, :3]
    jr = jdyn.refit_scene_instances(jd, jnp.asarray(tfs))
    for scene in (td, conv):
        tr = tdyn.refit_scene_instances(scene, tfs)
        for k in ("prime_v0", "prime_e1", "prime_e2"):
            np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        assert not np.allclose(tr["prime_v0"].numpy(), scene["prime_v0"].numpy())
