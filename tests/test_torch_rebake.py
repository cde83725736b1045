"""Port ``scene.scene.rebake_material`` (the viewer's live material edit)
against the JAX package's and against a fresh build.

The derived arrays are numpy-copied lowerings, so they must be bit-equal
(tolerance 0): the rebaked scene's ``materials``, ``attr_pack`` and
``material_pack`` equal a fresh build's with the edited material, every
other tensor is shared with the scene it came from. A 16^2 render of the
rebaked Cornell box through the port's plain path is held against JAX's
jnp render of JAX's rebaked scene at tests/test_torch_progressive.py's
cross-framework gate (>= 99% of pixels within 1e-3, mean |d| <= 1e-4).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dxrexperiments_torch.app import headless as thead
from dxrexperiments_torch.core import camera as tcam
from dxrexperiments_torch.scene import Scene as TScene
from dxrexperiments_torch.scene import cornell_box as t_cornell
from dxrexperiments_torch.scene.scene import rebake_material as t_rebake
from dxrexperiments_torch.trace import integrator as tint
from dxrexperiments_tpu.core import camera as jcam
from dxrexperiments_tpu.scene import Scene as JScene
from dxrexperiments_tpu.scene import cornell_box as j_cornell
from dxrexperiments_tpu.scene.scene import rebake_material as j_rebake
from dxrexperiments_tpu.trace import default_options as j_default_options
from dxrexperiments_tpu.trace import render_sample as j_render_sample

N = 16


def edit(material):
    return dataclasses.replace(material, albedo=(0.1, 0.9, 0.3, 1.0), roughness=0.25,
                               reflectivity=0.4, specular=(0.6, 0.5, 0.4, 1.0),
                               emissive=(0.3, 0.2, 0.1, 1.5), type=1)


def cornell(scene_cls, cornell_box, materials=None, accel="auto"):
    mesh, mats = cornell_box(glossy_tall_box=True)
    sc = scene_cls()
    for m in materials or mats:
        sc.add_material(m)
    sc.add_model(mesh)
    if scene_cls is TScene:
        return sc.build("cpu", accel=accel)
    return sc.build()


def leaves(tree, path=""):
    """(path, leaf) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def assert_trees_equal(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif k != "/tlas_meta/refit_ctx":
            assert a == b, k


def test_rebake_matches_jax():
    _, jmats = j_cornell(glossy_tall_box=True)
    _, tmats = t_cornell(glossy_tall_box=True)
    for index in (0, 4):
        got = t_rebake(cornell(TScene, t_cornell), index, edit(tmats[index]))
        want = j_rebake(cornell(JScene, j_cornell), index, edit(jmats[index]))
        np.testing.assert_array_equal(got["attr_pack"].numpy(), np.asarray(want["attr_pack"]))
        for k in want["materials"]:
            np.testing.assert_array_equal(got["materials"][k].numpy(),
                                          np.asarray(want["materials"][k]), err_msg=k)


@pytest.mark.parametrize("scene_name", ["cornell-glossy", "instanced:1"])
def test_rebake_equals_fresh_build(scene_name):
    """Every tensor of the rebaked scene equals a fresh build's with the
    edited material: the Cornell box (B1's route: attr_pack, tri_records)
    and instanced:1 with a BVH (B5's route: material_pack, ft_test,
    ft_attr); the geometry arrays are the base scene's own tensors."""
    sc, _ = thead.build_scene(scene_name)
    accel = "bvh" if scene_name.startswith("instanced") else "auto"
    base = sc.build("cpu", accel=accel)
    sc.materials[1] = edit(sc.materials[1])
    fresh = sc.build("cpu", accel=accel)
    got = t_rebake(base, 1, sc.materials[1])
    assert_trees_equal(got, fresh)
    if accel == "bvh":
        assert "material_pack" in got and got["bvh"] is base["bvh"]
        assert got["bvh"]["ft_attr"] is base["bvh"]["ft_attr"]
    else:
        assert got["tri_records"] is base["tri_records"]
    assert got["mt_pack"] is base["mt_pack"]
    # the input scene is left as it was
    assert not torch.equal(base["attr_pack"], got["attr_pack"])


def test_rebake_two_level_raises_as_jax():
    """A two-level scene has no mat_id / attr_pack: both packages raise."""
    sc, _ = thead.build_scene("instanced:1")
    with pytest.raises(KeyError):
        t_rebake(sc.build_two_level("cpu"), 0, edit(sc.materials[0]))
    from dxrexperiments_tpu.app.headless import build_scene as j_build_scene

    jsc, _ = j_build_scene("instanced:1")
    with pytest.raises(KeyError):
        j_rebake(jsc.build_two_level(), 0, edit(jsc.materials[0]))


def test_rebaked_render_matches_jax():
    _, jmats = j_cornell(glossy_tall_box=True)
    _, tmats = t_cornell(glossy_tall_box=True)
    jscene = j_rebake(cornell(JScene, j_cornell), 0, edit(jmats[0]))
    tscene = t_rebake(cornell(TScene, t_cornell), 0, edit(tmats[0]))
    jcamera, tcamera = jcam.Camera(), tcam.Camera()
    for c in (jcamera, tcamera):
        c.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
        c.set_aspect(N, N)
    want = j_render_sample(jscene, j_default_options(), jcam.camera_params(
        jcamera, jitter=(0.2 / N, -0.1 / N), frame_count=3), N, N, mode="progressive",
        impl="jnp", env_kind=int(jscene["env"]["kind"]))["color"]
    got = tint.render_sample(tscene, tint.default_options(), tcam.camera_params(
        tcamera, jitter=(0.2 / N, -0.1 / N), frame_count=3), N, N, mode="progressive",
        impl="torch")["color"]
    diff = np.abs(got.numpy() - np.asarray(jax.device_get(want)))
    assert np.isfinite(got.numpy()).all()
    assert (diff <= 1e-3).all(axis=-1).mean() >= 0.99
    assert diff.mean() <= 1e-4
    # the edit shows: the same render of the unedited scene differs
    plain = tint.render_sample(cornell(TScene, t_cornell), tint.default_options(),
                               tcam.camera_params(tcamera, jitter=(0.2 / N, -0.1 / N),
                                                  frame_count=3), N, N, impl="torch")["color"]
    assert float((plain - got).abs().max()) > 0.05
