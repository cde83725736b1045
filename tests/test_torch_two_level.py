"""Port the two-level path end to end vs the JAX package: the integrator's
two-level branches, the pipelines on a two-level scene, the refit through
``set_instance_transforms`` and the CLI's ``--accel two-level
--animate-instances``.

A JAX ``Scene.build_two_level()`` scene, converted with
``scene_from_numpy``, renders one 32^2 progressive sample and one realtime
frame through the port's integrator (plain traces on the CPU), held against
JAX ``render_sample(impl="jnp")`` on the same scene, cameras and seeds with
the image gate of benchmarks/kernel_parity.py: at most 1% of pixels differ
by more than 1e-3 and the median |difference| is at most 1e-5, on every
realtime AOV (roughness as a one-channel image).
"""

import os

import jax
import numpy as np
import pytest
import torch

from dxrexperiments_torch.app import headless as thead
from dxrexperiments_torch.core.camera import Camera as TCamera
from dxrexperiments_torch.models.base import select_route
from dxrexperiments_torch.models.progressive import ProgressiveRaytracingPipeline
from dxrexperiments_torch.models.realtime import RealtimeRaytracingPipeline
from dxrexperiments_torch.ops import traverse2 as tt2
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene.convert import camera_from_numpy, options_from_numpy, scene_from_numpy
from dxrexperiments_torch.trace import integrator as tint
from dxrexperiments_tpu.core.camera import Camera, camera_params
from dxrexperiments_tpu.trace import default_options, render_sample
from test_torch_cuda import port_five, tf
from test_torch_tlas import scenes

SIZE = 32
AOVS = ("direct", "indirect_specular", "albedo", "roughness", "color")


def image_gate(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if got.ndim == 2:
        got, want = got[..., None], want[..., None]
    diff = np.abs(got - want)
    assert (diff > 1e-3).any(axis=-1).mean() <= 0.01
    assert float(np.median(diff)) <= 1e-5


def both_sides(kind, opts, realtime=False):
    jd = scenes(kind)[0].build_two_level()
    cam = Camera()
    cam.set_eye_at_up((6.0, 4.0, 6.0) if kind == "five" else (5.0, 3.0, 5.0), (0.0, 0.3, 0.0),
                      (0.0, 1.0, 0.0))
    cam.set_aspect(SIZE, SIZE)
    jcam = camera_params(cam, jitter=(0.3 / SIZE, -0.2 / SIZE), frame_count=3)
    jopts = default_options(**opts)
    npy = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    port = (scene_from_numpy(npy(jd), "cpu"), options_from_numpy(npy(jopts)), camera_from_numpy(npy(jcam)))
    return (jd, jopts, jcam), port


@pytest.mark.parametrize("kind,opts", [("five", {}), ("instanced:2", {}),
                                       ("instanced:2", {"debug": 2})])
def test_progressive_sample_matches_jnp(kind, opts):
    (jd, jopts, jcam), (td, topts, tcam) = both_sides(kind, opts)
    ek = int(jd["env"]["kind"])
    want = render_sample(jd, jopts, jcam, SIZE, SIZE, mode="progressive", impl="jnp",
                         env_kind=ek)["color"]
    got = tint.render_sample(td, topts, tcam, SIZE, SIZE, mode="progressive", impl="torch",
                             env_kind=ek)["color"]
    image_gate(got.numpy(), want)
    assert float(got.mean()) > 0.0


@pytest.mark.parametrize("kind", ["five", "instanced:2"])
def test_realtime_frame_matches_jnp(kind):
    (jd, jopts, jcam), (td, topts, tcam) = both_sides(kind, {})
    ek = int(jd["env"]["kind"])
    want = render_sample(jd, jopts, jcam, SIZE, SIZE, mode="realtime", jitter_scale=10.0,
                         impl="jnp", env_kind=ek)
    got = tint.render_sample(td, topts, tcam, SIZE, SIZE, mode="realtime", jitter_scale=10.0,
                             impl="torch", env_kind=ek)
    for k in AOVS:
        image_gate(got[k].numpy(), want[k])


def test_route_and_converted_scene():
    jd, td = scenes("instanced:2")[0].build_two_level(), None
    td = scene_from_numpy(jax.tree.map(np.asarray, jd), "cpu")
    built = scenes("instanced:2")[1].build_two_level("cpu")
    assert set(td) == set(built) and set(td["tlas"]) == set(built["tlas"])
    for k in ("blasf_rows", "mt_rows", "slot_tri", "tlasf_rows", "inst_rows_t", "inst_orig"):
        np.testing.assert_array_equal(td["tlas"][k].numpy(), built["tlas"][k].numpy(), err_msg=k)
    assert td["tlas"]["blas_nodes"].device.type == "cpu"
    for mode in ("progressive", "realtime"):
        assert select_route(td, mode) == select_route(built, mode) == "wavefront"


def _pipeline(scene_data, cam_eye=(6.0, 4.0, 6.0)):
    cam = TCamera()
    cam.set_eye_at_up(cam_eye, (0.0, 0.3, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(16, 16)
    pipe = ProgressiveRaytracingPipeline(16, 16, seed=0, samples_per_frame=2, device="cpu")
    pipe.set_camera(cam)
    pipe.set_scene_data(scene_data)
    return pipe


def test_set_instance_transforms_restarts_and_keeps_step():
    sc = port_five()
    pipe = _pipeline(sc.build_two_level("cpu"))
    assert not pipe.owns_lights
    pipe.update(0.0, 0)
    pipe.render()
    pipe.update(0.0, 1)
    pipe.render()
    assert pipe.accum_count == 4
    step0 = pipe._step
    moved = np.stack([i.transform for i in sc.instances])
    moved[:, 0, 3] += 0.75
    pipe.set_instance_transforms(moved)
    pipe.update(0.0, 2)
    img = pipe.render()
    assert pipe._step is step0, "a TLAS refit must not rebuild the step"
    assert pipe.accum_count == 2  # the refit restarted accumulation
    assert bool(torch.isfinite(img).all())
    # the step rendered the refit scene: the same as a pipeline on a fresh build
    for inst, t in zip(sc.instances, moved):
        inst.transform = t
    fresh = _pipeline(sc.build_two_level("cpu"))
    fresh.rng = np.random.default_rng(0)
    fresh.rng.random(8)  # the jitter draws of the first pipeline's frames 0 and 1
    fresh.update(0.0, 2)
    torch.testing.assert_close(fresh.render(), img, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="two-level"):
        _pipeline(thead.build_scene("cornell")[0].build("cpu")).set_instance_transforms(moved)


def test_realtime_pipeline_on_two_level_scene():
    sc, cam = thead.build_scene("instanced:2")
    cam.set_aspect(16, 16)
    rt = RealtimeRaytracingPipeline(16, 16, seed=0, device="cpu")
    rt.set_camera(cam)
    rt.set_scene_data(sc.build_two_level("cpu"))
    rt.update(0.0, 0)
    direct, spec = rt.render()
    assert tuple(direct.shape) == (16, 16, 3) and bool(torch.isfinite(direct + spec).all())
    assert float(direct.mean()) > 0.0


def test_cli_two_level_animated(tmp_path, capsys):
    before = launch_counts()
    out = tmp_path / "two.png"
    assert thead.main(["--scene", "instanced:2", "--accel", "two-level", "--animate-instances",
                       "--size", "16x16", "--spp", "2", "--device", "cpu", "-o", str(out)]) == 0
    assert out.exists() and "progressive (cpu): 2 spp" in capsys.readouterr().out
    assert launch_counts() == before
    # realtime renders the flattened scene and says it ignored the flag, as the
    # JAX CLI renders it
    rt = ["--pipeline", "realtime", "--scene", "instanced:2", "--size", "16x16", "--device", "cpu"]
    flagged, flat = tmp_path / "flagged.npy", tmp_path / "flat.npy"
    assert thead.main(rt + ["--accel", "two-level", "-o", str(flagged)]) == 0
    assert "realtime: ignoring --accel two-level" in capsys.readouterr().out
    assert thead.main(rt + ["-o", str(flat)]) == 0
    assert np.array_equal(np.load(flagged), np.load(flat))


def test_two_level_prime_raises(monkeypatch):
    """DXR_PRIME=1 no longer raises: the two-level build carries the PRIME
    table wherever the JAX build does (the five-instance scene has no
    dominating triangle, instanced:2 its floor)."""
    monkeypatch.setenv("DXR_PRIME", "1")
    assert "prime_v0" not in port_five().build_two_level("cpu")
    jd = scenes("instanced:2")[0].build_two_level()
    td = scenes("instanced:2")[1].build_two_level("cpu")
    for k in ("prime_v0", "prime_e1", "prime_e2"):
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]), err_msg=k)
    monkeypatch.delenv("DXR_PRIME")
    assert "DXR_PRIME" not in os.environ


def test_refit_uploads_into_the_scene_device():
    sc = port_five()
    scene = sc.build_two_level("cpu")
    moved = np.stack([tf((0.1 * k, 0.0, 0.0)) for k in range(5)])
    pipe = _pipeline(scene)
    pipe.set_instance_transforms(torch.as_tensor(moved))
    tl = pipe.scene_data["tlas"]
    assert tl["inst_rows"].device.type == "cpu" and tl["blasf_rows"] is scene["tlas"]["blasf_rows"]
    np.testing.assert_allclose(tl["inst_rows"][9, :5].numpy(),
                               -moved[pipe.scene_data["tlas_meta"]["refit_ctx"].inst_order, 0, 3],
                               atol=1e-7)
