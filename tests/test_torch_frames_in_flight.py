"""The frames-in-flight batch of the port (K realtime frames in one dispatch)
against K sequential calls and against the JAX package, on the CPU, and the
CLI's --frames-in-flight and --shard 1x1.

Against sequential calls (the same port code on the same inputs) the
batch is held bit for bit: ``render_frames`` against K update() + render(),
``denoise_composite_frames`` against K ``denoise_composite`` calls,
``DenoiseCompositor.dispatch_frames`` (temporal, across two batches)
against K ``dispatch`` calls, ``make_realtime_denoise_frames_step`` against
the two-call chain. Against JAX (tests/test_frames_in_flight.py's cases):
the ray-traced AOVs on the gate of tests/test_torch_realtime.py (at most
0.5% of pixels off by more than 1e-3, median |difference| < 1e-5), the
denoiser at atol 2e-5 (tests/test_torch_denoise.py's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.app import headless
from dxrexperiments_torch.core.camera import stack_cameras
from dxrexperiments_torch.models import denoise as tden
from dxrexperiments_torch.models.realtime import RealtimeRaytracingPipeline as TPipeline
from dxrexperiments_torch.models.realtime import (
    make_realtime_denoise_frames_step,
    realtime_frames,
)
from dxrexperiments_torch.ops import bilateral, fused_sample
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_tpu.app.headless import build_scene as j_build_scene
from dxrexperiments_tpu.models import denoise as jden
from dxrexperiments_tpu.models.realtime import RealtimeRaytracingPipeline as JPipeline

W = H = 32
ATOL = 2e-5


def pipelines(name="cornell-glossy", seed=7):
    """The port's and JAX's realtime pipelines on the same scene and seed."""
    out = []
    for make, build in ((TPipeline, headless.build_scene), (JPipeline, j_build_scene)):
        sc, cam = build(name)
        cam.set_aspect(W, H)
        p = make(W, H, seed=seed, **({"device": "cpu"} if make is TPipeline else {}))
        p.set_camera(cam)
        p.set_scene(sc)
        out.append(p)
    return out


def assert_images_match(got, want, frac=0.005):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    assert (diff > 1e-3).mean() <= frac
    assert float(np.median(diff)) < 1e-5


@pytest.mark.parametrize("name", ["cornell-glossy", "instanced:1"])
def test_render_frames_matches_sequential_and_jax(name):
    """cornell-glossy takes B1's route, instanced:1 (962 triangles, brute
    force) the wavefront route: K = 3 frames in one call equal three
    update() + render() calls, and JAX's render_frames."""
    tp, jp = pipelines(name)
    seq, _ = pipelines(name)
    d_k, s_k = tp.render_frames(0, 3)
    jd, js = jp.render_frames(0, 3)
    assert tuple(d_k.shape) == (3, H, W, 3)
    for f in range(3):
        seq.update(0.0, f)
        d, s = seq.render()
        assert torch.equal(d, d_k[f]) and torch.equal(s, s_k[f])
        assert_images_match(d_k[f].numpy(), np.asarray(jd)[f])
        assert_images_match(s_k[f].numpy(), np.asarray(js)[f])
    assert torch.equal(tp.direct, d_k[-1]) and torch.equal(tp.indirect_specular, s_k[-1])


def test_frame_cameras_draw_as_sequential_updates():
    tp, jp = pipelines()
    seq, _ = pipelines()
    cams = tp.frame_cameras(4, 3)
    jcams = jp.frame_cameras(4, 3)
    for f in range(3):
        seq.update(0.0, 4 + f)
        for k, v in seq._camera_params.items():
            assert torch.equal(cams[k][f], v), k
        np.testing.assert_array_equal(cams["jitter"][f].numpy(), np.asarray(jcams["jitter"])[f])
        assert int(cams["frame_count"][f]) == int(jcams["frame_count"][f]) == 4 + f


def frames(k, h=12, w=20, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.random((k, h, w, 3), dtype=np.float32), rng.random((k, h, w, 3), dtype=np.float32))


def test_denoise_composite_frames():
    d, s = frames(2, 16, 24, seed=3)
    params = tden.default_denoise_params()
    out = tden.denoise_composite_frames(torch.from_numpy(d), torch.from_numpy(s), params)
    want = jden.denoise_composite_frames(jnp.asarray(d), jnp.asarray(s),
                                         jden.default_denoise_params(), impl="jnp")
    for i in range(2):
        single = tden.denoise_composite(torch.from_numpy(d[i]), torch.from_numpy(s[i]), params)
        assert torch.equal(out[i], single)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_one_frame_batch_is_a_view():
    """A batch of one frame costs what the frame costs: stack_frames and
    the one-frame composite add no copy of the frame."""
    d, s = (torch.from_numpy(x) for x in frames(1))
    x = d[0].clone()
    assert tden.stack_frames([x]).data_ptr() == x.data_ptr()
    two = tden.stack_frames([x, x])
    assert two.shape == (2, *x.shape) and two.data_ptr() != x.data_ptr()
    params = tden.default_denoise_params()
    out = tden.denoise_composite_frames(d, s, params)
    assert torch.equal(out[0], tden.denoise_composite(d[0], s[0], params))
    comp = tden.DenoiseCompositor(temporal_alpha=0.3, device="cpu")
    got = comp.dispatch_frames(d, s)
    assert got.data_ptr() == comp._history.data_ptr()


def test_dispatch_frames_temporal_matches_sequential():
    """The history advances as K sequential dispatch() calls: seeded by the
    first frame, carried across two batches (3 + 2), and against JAX's."""
    d, s = (torch.from_numpy(x) for x in frames(5))
    seq = tden.DenoiseCompositor(temporal_alpha=0.3, device="cpu")
    bat = tden.DenoiseCompositor(temporal_alpha=0.3, device="cpu")
    jbat = jden.DenoiseCompositor(temporal_alpha=0.3)
    want = [seq.dispatch(d[i], s[i]).clone() for i in range(5)]
    got = list(bat.dispatch_frames(d[:3], s[:3])) + list(bat.dispatch_frames(d[3:], s[3:]))
    jgot = list(np.asarray(jbat.dispatch_frames(jnp.asarray(d[:3].numpy()),
                                                jnp.asarray(s[:3].numpy()))))
    jgot += list(np.asarray(jbat.dispatch_frames(jnp.asarray(d[3:].numpy()),
                                                 jnp.asarray(s[3:].numpy()))))
    for i in range(5):
        assert torch.equal(want[i], got[i]), i
        np.testing.assert_allclose(got[i].numpy(), jgot[i], atol=ATOL, rtol=0)
    assert torch.equal(seq._history, bat._history)
    plain = tden.DenoiseCompositor(device="cpu")
    out = plain.dispatch_frames(d[:2], s[:2])
    assert torch.equal(out[0], tden.denoise_composite(d[0], s[0], plain.params))


def test_realtime_denoise_frames_step():
    """The one-dispatch step: K = 2 frames' AOVs and their composites equal
    realtime_frames then the per-frame denoiser, and JAX's step."""
    tp, jp = pipelines()
    cams = tp.frame_cameras(0, 2)
    scene = tp.scene_data
    params = tden.default_denoise_params()
    step = make_realtime_denoise_frames_step(scene, W, H, 2)
    aovs, img = step(tp.options, cams, scene["lights"], scene["env"], params)
    assert tuple(img.shape) == (2, H, W, 3)
    want = realtime_frames(scene, tp.options, cams, W, H)
    for i in range(2):
        assert torch.equal(aovs["direct"][i], want["direct"][i])
        ref = tden.denoise_composite(aovs["direct"][i], aovs["indirect_specular"][i], params)
        assert torch.equal(img[i], ref)
    jstep_cams = jp.frame_cameras(0, 2)
    from dxrexperiments_tpu.models.realtime import make_realtime_denoise_frames_step as jmake

    jaovs, jimg = jmake(jp.scene_data, W, H, 2, impl="jnp", denoise_impl="jnp")(
        jp.options, jstep_cams, jp.scene_data["lights"], jp.scene_data["env"],
        jden.default_denoise_params())
    for i in range(2):
        assert_images_match(aovs["direct"][i].numpy(), np.asarray(jaovs["direct"])[i])
        assert_images_match(img[i].numpy(), np.asarray(jimg)[i])
    with pytest.raises(ValueError):
        step(tp.options, tp.frame_cameras(2, 3), scene["lights"], scene["env"], params)


def test_frames_step_counts_no_kernel_on_the_cpu():
    tp, _ = pipelines()
    before = launch_counts()
    make_realtime_denoise_frames_step(tp.scene_data, W, H, 2)(
        tp.options, stack_cameras([tp._frame_camera_params(f, 0, tp.rng) for f in range(2)]),
        tp.scene_data["lights"], tp.scene_data["env"], tden.default_denoise_params())
    assert launch_counts() == before


@pytest.mark.parametrize("args", [
    ["--pipeline", "realtime", "--denoise", "--frames-in-flight", "3"],
    ["--pipeline", "realtime", "--denoise", "--temporal", "0.3", "--frames-in-flight", "2"],
    ["--pipeline", "realtime", "--frames-in-flight", "2"],
    ["--shard", "1x1", "--spp", "2"],
    ["--shard", "auto", "--pipeline", "realtime", "--denoise"],
])
def test_cli_frames_in_flight_and_shard(args, tmp_path, capsys):
    out = tmp_path / "x.png"
    assert headless.main(["--scene", "cornell-glossy", "--size", "16x16", "--device", "cpu",
                          "-o", str(out), *args]) == 0
    assert out.exists()
    if "--frames-in-flight" in args:
        assert "frames a dispatch" in capsys.readouterr().out


def test_cli_frames_in_flight_last_frame_is_sequential(tmp_path):
    """--frames-in-flight 3 writes the third frame, as three sequential
    frames of the same pipeline give it."""
    out = tmp_path / "k.png"
    assert headless.main(["--pipeline", "realtime", "--frames-in-flight", "3", "--scene",
                          "cornell-glossy", "--size", "16x16", "--device", "cpu",
                          "-o", str(out)]) == 0
    sc, cam = headless.build_scene("cornell-glossy")
    cam.set_aspect(16, 16)
    p = TPipeline(16, 16, seed=0, device="cpu")
    p.set_camera(cam)
    p.set_scene(sc)
    for f in range(3):
        p.update(0.0, f)
        d, s = p.render()
    want = tmp_path / "w.png"
    headless.write_png(str(want), np.clip((d + s).numpy(), 0.0, 1.0))
    assert out.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("args", [
    ["--frames-in-flight", "0", "--pipeline", "realtime"],
    ["--frames-in-flight", "2"],  # progressive
    ["--shard", "1x1", "--save-state", "s"],
    ["--shard", "1x1", "--resume", "s"],
    ["--shard", "1x1", "--pipeline", "realtime", "--frames-in-flight", "2"],
])
def test_cli_rejects(args, tmp_path):
    with pytest.raises(SystemExit) as e:
        headless.main(["--device", "cpu", "-o", str(tmp_path / "x.png"), *args])
    assert e.value.code == 2


def test_cli_shard_needs_its_ranks(tmp_path):
    assert headless.main(["--shard", "2x1", "--device", "cpu", "--size", "16x16",
                          "-o", str(tmp_path / "x.png")]) == 2
