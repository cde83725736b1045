"""Port progressive pipeline on the CPU (the plain PyTorch path).

Whole-image check against tests/golden_cornell_16spp.npz, which the JAX
jnp path rendered (64^2, 16 spp, seed 7, the rig of tests/test_pipelines.py).
That golden's own atol of 2e-5 holds within one backend only; across
frameworks the gate is: >= 99% of pixels within 1e-3 and a mean |difference|
<= 1e-4 (beauty), and >= 99.5% of pixels within 1e-5 (albedo, which has no
Monte-Carlo term).
"""

import os

import numpy as np
import pytest
import torch

from dxrexperiments_torch.app import headless
from dxrexperiments_torch.core.camera import Camera
from dxrexperiments_torch.models.progressive import ProgressiveRaytracingPipeline
from dxrexperiments_torch.scene import Scene, cornell_box, envmap
from dxrexperiments_torch.scene.lights import directional_light, point_light
from dxrexperiments_torch.trace.integrator import render_sample

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_cornell_16spp.npz")


def make_pipeline(n=24, **kw):
    mesh, materials = cornell_box(glossy_tall_box=True)
    sc = Scene()
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh)
    sc.lights = {
        "dir": directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
        "point": point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
    }
    sc.environment = envmap.constant_env((0, 0, 0))
    cam = Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0, 1, 0))
    cam.set_aspect(1, 1)
    pipe = ProgressiveRaytracingPipeline(n, n, seed=7, device="cpu", **kw)
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    return pipe


def run_frames(pipe, n, start=0):
    for f in range(start, start + n):
        pipe.update(elapsed_time=f / 60.0, elapsed_frames=f)
        pipe.render()
    return pipe.get_output().numpy()


def test_cornell_matches_golden():
    img = run_frames(make_pipeline(64), 16)
    want = np.load(GOLDEN)["img"]
    diff = np.abs(img - want)
    assert (diff <= 1e-3).all(axis=-1).mean() >= 0.99
    assert diff.mean() <= 1e-4


def test_albedo_matches_golden():
    pipe = make_pipeline(64)
    pipe.options["show_gbuffer_albedo_only"] = True
    img = run_frames(pipe, 1)
    want = np.load(GOLDEN)["albedo"]
    assert (np.abs(img - want) <= 1e-5).all(axis=-1).mean() >= 0.995


def test_reset_on_camera_move_and_dirty():
    pipe = make_pipeline()
    run_frames(pipe, 3)
    assert pipe.accum_count == 3
    pipe.camera.position = pipe.camera.position + np.array([0.05, 0, 0], np.float32)
    pipe.update(elapsed_time=0.1, elapsed_frames=3)
    assert pipe.accum_count == 1
    pipe.render()
    pipe.mark_dirty()
    pipe.update(elapsed_time=0.1, elapsed_frames=4)
    assert pipe.accum_count == 1


def test_stops_at_max_iterations():
    pipe = make_pipeline()
    pipe.max_iterations = 2
    frozen = run_frames(pipe, 2).copy()
    after = run_frames(pipe, 2, start=2)
    np.testing.assert_array_equal(after, frozen)


@pytest.mark.parametrize("spf", [1, 2])
def test_running_mean_is_sample_mean(spf):
    pipe = make_pipeline(samples_per_frame=spf)
    samples = []
    for f in range(3):
        pipe.update(elapsed_time=0.0, elapsed_frames=f)
        cams = pipe._camera_params
        for k in range(spf):
            cam = {key: v[k] for key, v in cams.items()}
            samples.append(render_sample(pipe.scene_data, pipe.options, cam, 24, 24)["color"])
        pipe.render()
    assert pipe.accum_count == 3 * spf
    want = torch.stack(samples).mean(dim=0)
    torch.testing.assert_close(pipe.get_output(), want, rtol=1e-5, atol=1e-6)


def test_checkpoint_round_trip_is_bit_identical(tmp_path):
    path = str(tmp_path / "state.npz")
    a = make_pipeline()
    run_frames(a, 2)
    a.save_checkpoint(path, frames_done=2)
    full = run_frames(a, 2, start=2)

    b = make_pipeline()
    assert b.load_checkpoint(path) == 2
    resumed = run_frames(b, 2, start=2)
    np.testing.assert_array_equal(resumed, full)


def test_headless_cpu_writes_png(tmp_path, capsys):
    out = tmp_path / "out.png"
    rc = headless.main(["--scene", "cornell-glossy", "--size", "32x32", "--spp", "2",
                        "--device", "cpu", "--tonemap", "-o", str(out)])
    assert rc == 0
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 100
    assert "progressive (cpu)" in capsys.readouterr().out


def test_headless_save_and_resume_continue_bit_identically(tmp_path, capsys):
    common = ["--scene", "cornell", "--size", "16x16", "--device", "cpu", "--seed", "3"]
    state = str(tmp_path / "state.npz")
    headless.main(common + ["--spp", "2", "--save-state", state, "-o", str(tmp_path / "a.png")])
    headless.main(common + ["--spp", "4", "--resume", state, "-o", str(tmp_path / "b.png")])
    headless.main(common + ["--spp", "4", "-o", str(tmp_path / "c.png")])
    assert "continuing at frame 2" in capsys.readouterr().out
    assert (tmp_path / "b.png").read_bytes() == (tmp_path / "c.png").read_bytes()
