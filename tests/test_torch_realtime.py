"""Port realtime path (plain integrator, megakernel wrapper, pipeline) vs the
JAX package, on the CPU.

The port's realtime ``render_sample`` is held against the JAX jnp path, its
``fused_realtime_outputs`` (the plain version on the CPU) against the JAX
Pallas kernel in interpret mode, and ``RealtimeRaytracingPipeline`` against
the JAX pipeline, on Cornell-glossy at 32^2. Gate (that of
tests/test_torch_fused_sample.py): at most 0.5% of pixels differ by more
than 1e-3 and the median |difference| is below 1e-5, for each of the five
outputs (roughness as a one-channel image); knife-edge pairs may resolve
differently once the float32 sums are reassociated. The "emissive" case
makes every wall glow, so that the Phong bounce sees emissive surfaces,
which the realtime shade must leave out.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.app import headless
from dxrexperiments_torch.core.camera import Camera as TCamera
from dxrexperiments_torch.models.realtime import RealtimeRaytracingPipeline as TPipeline
from dxrexperiments_torch.ops import fused_sample as tfs
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene import Scene as TScene
from dxrexperiments_torch.scene import cornell_box as t_cornell_box
from dxrexperiments_torch.scene import envmap as t_envmap
from dxrexperiments_torch.scene.convert import (
    camera_from_numpy,
    options_from_numpy,
    scene_from_numpy,
)
from dxrexperiments_torch.trace.integrator import render_sample as t_render_sample
from dxrexperiments_tpu.core.camera import Camera, camera_params
from dxrexperiments_tpu.models.realtime import RealtimeRaytracingPipeline as JPipeline
from dxrexperiments_tpu.ops import fused_sample_pallas as jfs
from dxrexperiments_tpu.scene import Scene, cornell_box, envmap
from dxrexperiments_tpu.scene.lights import directional_light, point_light
from dxrexperiments_tpu.trace import default_options
from dxrexperiments_tpu.trace.integrator import render_sample

W = H = 32
OUTPUTS = ("color", "direct", "indirect_specular", "albedo", "roughness")
RIG = {
    "dir": ((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
    "point": ((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
}
OPTION_CASES = [
    ("defaults", {}, "const"),
    ("debug2", {"debug": 2}, "const"),
    ("no_indirect_diffuse", {"no_indirect_diffuse": True}, "const"),
    ("gradient_env", {}, "gradient"),
    ("emissive", {}, "emissive"),
]
GLOW = (0.2, 0.3, 0.4, 2.0)


def jax_scene(env="const"):
    mesh, materials = cornell_box(glossy_tall_box=True)
    sc = Scene()
    for m in materials:
        sc.add_material(dataclasses.replace(m, emissive=GLOW) if env == "emissive" else m)
    sc.add_model(mesh)
    sc.lights = {"dir": directional_light(*RIG["dir"]), "point": point_light(*RIG["point"])}
    if env in ("const", "emissive"):
        sc.environment = envmap.constant_env((0.05, 0.1, 0.2), strength=1.5)
    else:
        sc.environment = envmap.gradient_env()
    return sc.build()


def jax_camera(frame, jitter):
    cam = Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(W, H)
    return camera_params(cam, jitter=jitter, frame_count=frame)


def npy(tree):
    return jax.tree.map(np.asarray, tree)


def both_sides(opts, env, frames=((7, (0.3 / W, -0.2 / H)),)):
    """(JAX scene, options, stacked cameras) and the port's copies."""
    scene = jax_scene(env)
    options = default_options(**opts)
    cams = [jax_camera(f, j) for f, j in frames]
    cams = jax.tree.map(lambda *x: jnp.stack(x), *cams)
    port = (
        scene_from_numpy(npy(scene), "cpu"),
        options_from_numpy(npy(options)),
        camera_from_numpy(npy(cams)),
    )
    return (scene, options, cams), port


def assert_images_match(got, want, frac=0.005):
    got = np.asarray(got)
    want = np.asarray(want)
    if got.ndim == 2:  # roughness: a one-channel image
        got, want = got[..., None], want[..., None]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    bad = (diff > 1e-3).any(axis=-1).mean()
    assert bad <= frac, f"{bad:.4%} pixels differ by more than 1e-3"
    assert float(np.median(diff)) < 1e-5


def assert_aovs_match(got: dict, want: dict):
    for k in OUTPUTS:
        assert_images_match(got[k], want[k])


@pytest.mark.parametrize("name,opts,env", OPTION_CASES, ids=[c[0] for c in OPTION_CASES])
def test_plain_realtime_matches_jnp(name, opts, env):
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(opts, env)
    jcam = jax.tree.map(lambda x: x[0], jcams)
    tcam = {k: v[0] for k, v in tcams.items()}
    want = render_sample(jscene, jopts, jcam, W, H, mode="realtime", jitter_scale=10.0,
                         impl="jnp")
    got = t_render_sample(tscene, topts, tcam, W, H, mode="realtime", jitter_scale=10.0)
    assert set(got) == set(OUTPUTS)
    assert tuple(got["roughness"].shape) == (H, W)
    assert_aovs_match({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("name,opts,env", [OPTION_CASES[i] for i in (0, 1, 3, 4)],
                         ids=["defaults", "debug2", "gradient_env", "emissive"])
def test_fused_realtime_matches_pallas_interpret(name, opts, env):
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(opts, env)
    ek = int(jscene["env"]["kind"])
    jcam = jax.tree.map(lambda x: x[0], jcams)
    tcam = {k: v[0] for k, v in tcams.items()}
    want = jfs.fused_realtime_outputs(jscene, jopts, jcam, W, H, ek, interpret=True)
    before = launch_counts()["B1 realtime"]
    got = tfs.fused_realtime_outputs(tscene, topts, tcam, W, H, ek)
    assert launch_counts()["B1 realtime"] == before  # the CPU path launches no kernel
    assert tuple(got["direct"].shape) == (H, W, 3) and got["direct"].dtype == torch.float32
    assert_aovs_match({k: v.numpy() for k, v in got.items()}, want)


def test_batch_equals_single_frames():
    frames = ((3, (0.1 / W, 0.2 / H)), (2**31 + 4, (-0.4 / W, 0.15 / H)))
    _, (tscene, topts, tcams) = both_sides({"debug": 2}, "gradient", frames)
    batch = tfs.fused_realtime_outputs_batch(tscene, topts, tcams, W, H, 1)
    for s in range(2):
        single = tfs.fused_realtime_outputs(
            tscene, topts, {k: v[s] for k, v in tcams.items()}, W, H, 1
        )
        for k in OUTPUTS:
            torch.testing.assert_close(batch[k][s], single[k], rtol=0, atol=0)
        torch.testing.assert_close(
            batch["color"][s], batch["direct"][s] + batch["indirect_specular"][s],
            rtol=0, atol=0,
        )


def test_realtime_pack_matches_jax():
    (_, _, jcams), (_, _, tcams) = both_sides({}, "const", ((5, (0.25 / W, -0.1 / H)),))
    for realtime in (False, True):
        np.testing.assert_array_equal(
            tfs.pack_cameras(tcams, realtime).numpy(),
            np.asarray(jfs.pack_cameras(jcams, realtime)),
        )


def test_realtime_scope():
    _, (tscene, topts, tcams) = both_sides({}, "const")
    assert tfs.supports_fused(tscene, "realtime", False)
    assert not tfs.supports_fused(tscene, "realtime", True)
    # a lat-long env runs in the realtime megakernel's scope (ROADMAP item 9);
    # its misses route the env into the direct AOV
    img = np.full((4, 8, 3), 0.25, np.float32)
    lat = dict(tscene, env=t_envmap.latlong_env(img, strength=2.0))
    assert tfs.supports_fused(lat, "realtime", False)
    out = tfs.fused_realtime_outputs_batch(lat, topts, tcams, W, H, 2)
    miss = out["albedo"].abs().sum(-1) == 0
    assert bool(miss.any())
    torch.testing.assert_close(out["direct"][miss], torch.full_like(out["direct"][miss], 0.5))
    with pytest.raises(NotImplementedError, match="unknown"):
        t_render_sample(tscene, topts, {k: v[0] for k, v in tcams.items()}, W, H, mode="ao")


def _pipelines(owns_lights):
    jsc = Scene()
    tsc = TScene()
    for sc, box in ((jsc, cornell_box), (tsc, t_cornell_box)):
        mesh, materials = box(glossy_tall_box=True)
        for m in materials:
            sc.add_material(m)
        sc.add_model(mesh)
    if not owns_lights:
        from dxrexperiments_torch.scene.lights import directional_light as tdl
        from dxrexperiments_torch.scene.lights import point_light as tpl

        jsc.lights = {"dir": directional_light(*RIG["dir"]), "point": point_light(*RIG["point"])}
        tsc.lights = {"dir": tdl(*RIG["dir"]), "point": tpl(*RIG["point"])}
    jpipe = JPipeline(W, H, seed=11)
    tpipe = TPipeline(W, H, seed=11, device="cpu")
    for pipe, cam_cls, sc in ((jpipe, Camera, jsc), (tpipe, TCamera, tsc)):
        cam = cam_cls()
        cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
        cam.set_aspect(W, H)
        pipe.set_camera(cam)
        pipe.set_scene(sc)
        pipe.animation_paused = False  # animate the owned rig
    return jpipe, tpipe


@pytest.mark.parametrize("owns_lights", [True, False], ids=["owns_lights", "scene_rig"])
def test_pipeline_matches_jax(owns_lights):
    jpipe, tpipe = _pipelines(owns_lights)
    assert tpipe.owns_lights == jpipe.owns_lights == owns_lights
    assert tpipe.num_outputs == jpipe.num_outputs == 2
    for f in range(3):
        for pipe in (jpipe, tpipe):
            pipe.update(elapsed_time=0.5 * f, elapsed_frames=f)
        jc, tc = npy(jpipe._camera_params), tpipe._camera_params
        np.testing.assert_array_equal(tc["jitter"].numpy(), jc["jitter"])
        assert int(tc["frame_count"]) == int(jc["frame_count"]) == f
        assert float(tc["accum_count"]) == float(jc["accum_count"]) == 0.0
        np.testing.assert_allclose(
            tpipe.scene_data["lights"]["dir"]["forward"].numpy(),
            np.asarray(jpipe.scene_data["lights"]["dir"]["forward"]), rtol=1e-6, atol=1e-7,
        )
        jd, js = jpipe.render()
        td, ts = tpipe.render()
        assert_images_match(td.numpy(), jd)
        assert_images_match(ts.numpy(), js)
        assert tpipe.get_output(0) is td and tpipe.get_output(1) is ts


def test_headless_realtime_cpu_writes_png(tmp_path, capsys):
    out = tmp_path / "rt.png"
    rc = headless.main(["--pipeline", "realtime", "--denoise", "--temporal", "0.5",
                        "--scene", "cornell-glossy", "--size", "24x16", "--device", "cpu",
                        "-o", str(out)])
    assert rc == 0
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 100
    assert "realtime+denoise (cpu): 24x16" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        headless.main(["--pipeline", "realtime", "--resume", str(tmp_path / "x"),
                       "--device", "cpu"])


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: covered by tests/test_torch_cuda.py")
    with pytest.raises(RuntimeError, match="cuda"):
        TPipeline(8, 8, seed=0, device="cuda")
