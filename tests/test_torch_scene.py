"""Port scene lowering vs the JAX build.

The numpy lowering is copied, so the packs must be bit-equal (tolerance 0).
primary_ray_grid is float32 arithmetic in two frameworks: atol 1e-6 on unit
directions allows a last-place difference in the normalisation.
"""

import jax
import numpy as np
import pytest
import torch

from dxrexperiments_torch.core import camera as tcam
from dxrexperiments_torch.scene import Scene as TScene
from dxrexperiments_torch.scene import cornell_box as t_cornell
from dxrexperiments_torch.scene import envmap as tenv
from dxrexperiments_torch.scene.convert import (
    camera_from_numpy,
    options_from_numpy,
    scene_from_numpy,
)
from dxrexperiments_torch.scene.lights import directional_light as t_dir
from dxrexperiments_torch.scene.lights import point_light as t_point
from dxrexperiments_tpu.core import camera as jcam
from dxrexperiments_tpu.scene import Scene as JScene
from dxrexperiments_tpu.scene import cornell_box as j_cornell
from dxrexperiments_tpu.scene import envmap as jenv
from dxrexperiments_tpu.scene.lights import directional_light as j_dir
from dxrexperiments_tpu.scene.lights import point_light as j_point
from dxrexperiments_tpu.trace import default_options as j_default_options

PACKS = ("mt_pack", "attr_pack", "v0", "e1", "e2", "n0", "n1", "n2", "pn", "c1", "c2", "d0")


def _build(scene_cls, cornell, dl, pl, env, glossy):
    mesh, mats = cornell(glossy_tall_box=glossy)
    sc = scene_cls()
    for m in mats:
        sc.add_material(m)
    sc.add_model(mesh)
    sc.lights = {
        "dir": dl((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
        "point": pl((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
    }
    sc.environment = env.gradient_env()
    return sc.build()


def jax_scene(glossy=True):
    return jax.tree.map(np.asarray, _build(JScene, j_cornell, j_dir, j_point, jenv, glossy))


def port_scene(glossy=True):
    return _build(TScene, t_cornell, t_dir, t_point, tenv, glossy)


@pytest.mark.parametrize("glossy", [True, False])
def test_packs_bit_equal(glossy):
    want = jax_scene(glossy)
    got = port_scene(glossy)
    assert got["num_tris"] == int(want["num_tris"]) == 36
    assert tuple(got["mt_pack"].shape) == (4, 40, 16)
    for k in PACKS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(got["mat_id"].numpy(), want["mat_id"])
    for k, v in want["materials"].items():
        np.testing.assert_array_equal(got["materials"][k].numpy(), v, err_msg=k)


def test_scene_from_numpy_round_trip():
    want = jax_scene()
    got = scene_from_numpy(want)
    ref = port_scene()
    for k in PACKS:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(got["mat_id"].numpy(), want["mat_id"])
    assert got["env"]["kind"] == ref["env"]["kind"] == 1
    for k in ("strength", "grad_horizon", "grad_zenith"):
        np.testing.assert_array_equal(got["env"][k].numpy(), ref["env"][k].numpy())
    for group in ("dir", "point"):
        for k, v in ref["lights"][group].items():
            np.testing.assert_array_equal(got["lights"][group][k].numpy(), v.numpy())
    opts = options_from_numpy(jax.tree.map(np.asarray, j_default_options(debug=2)))
    assert opts["debug"] == 2 and opts["cosine_hemisphere_sampling"] is True


def test_unported_scene_keys_raise():
    with pytest.raises(NotImplementedError):
        scene_from_numpy(dict(jax_scene(), bvh={}))


def test_primary_ray_grid_matches():
    w, h = 24, 16
    jc = jcam.Camera()
    jc.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    jc.set_aspect(w, h)
    tc = tcam.Camera()
    tc.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    tc.set_aspect(w, h)
    np.testing.assert_array_equal(tc.view_proj_matrix(), jc.view_proj_matrix())
    jp = jcam.camera_params(jc, jitter=(0.3 / w, -0.2 / h), frame_count=5)
    tp = tcam.camera_params(tc, jitter=(0.3 / w, -0.2 / h), frame_count=5)
    cp = camera_from_numpy(jax.tree.map(np.asarray, jp))
    for k in ("eye", "u", "v", "w", "jitter"):
        np.testing.assert_array_equal(tp[k].numpy(), cp[k].numpy())
    assert int(tp["frame_count"]) == int(cp["frame_count"]) == 5
    jo, jd = jcam.primary_ray_grid(jp, w, h, 30.0)
    to, td = tcam.primary_ray_grid(tp, w, h, 30.0)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
