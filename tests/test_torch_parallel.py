"""The port's multi-GPU rendering (``parallel/``) on gloo CPU ranks, against
the single-process port and JAX's sharded steps on the 8-device virtual CPU
mesh (tests/test_parallel.py's cases), at the same mesh shapes and seeds.

Two spawned worlds (``parallel.launch.spawn``, torch-only workers, gloo on
the CPU) run every sharded render once: a world of 2 ranks (progressive
2x1 and 1x2 on Cornell-glossy, B1's route; progressive 2x1 on soup:5000,
B5's route; realtime + denoise 2x1 at 16 x 64, 32-row blocks, the halo
path) and a world of 4 (progressive 2x2; realtime + denoise 4x1 at 16 x 64,
16-row blocks, the short-block path; 4x1 at 8 x 104, 26-row blocks, the
halo path with two middle blocks).

Gates: against the single-process port, bit for bit where only rows are
sharded (the same float operations on the same integers) and atol 1e-5
where samples are split (tests/test_parallel.py's bound: the spp sum is
reassociated); against JAX's sharded steps, the image gate of
tests/test_torch_fused_sample.py (at most 0.5% of pixels off by more than
1e-3, median |difference| < 1e-5) and the denoised display at atol 2e-5
(tests/test_torch_denoise.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dxrexperiments_torch.app.headless import build_scene
from dxrexperiments_torch.core.camera import camera_params as t_camera_params
from dxrexperiments_torch.core.camera import stack_cameras as t_stack_cameras
from dxrexperiments_torch.models.denoise import default_denoise_params, denoise_composite
from dxrexperiments_torch.models.progressive import make_progressive_step
from dxrexperiments_torch.models.realtime import realtime_frames
from dxrexperiments_torch.parallel import launch, render
from dxrexperiments_torch.trace.integrator import default_options
from dxrexperiments_tpu.app.headless import build_scene as j_build_scene
from dxrexperiments_tpu.core.camera import camera_params
from dxrexperiments_tpu.models.denoise import default_denoise_params as j_denoise_params
from dxrexperiments_tpu.parallel import (
    make_render_mesh,
    make_sharded_progressive_step,
    make_sharded_realtime_step,
    stack_cameras,
)
from dxrexperiments_tpu.trace.integrator import default_options as j_default_options

PW = PH = 16  # progressive size
S = 2  # samples a step
STEPS = launch.camera_steps(np.random.default_rng(5), PW, PH, 2, S)
RT_CAMERA = (0.01, -0.02, 3)  # jitter x, y, frame

PROGRESSIVE = {"2x1": ("cornell-glossy", (2, 1)), "1x2": ("cornell-glossy", (1, 2)),
               "2x1 soup": ("soup:5000", (2, 1)), "2x2": ("cornell-glossy", (2, 2))}
REALTIME = {"2x1 halo": (16, 64, 2), "4x1 short": (16, 64, 4), "4x1 halo": (8, 104, 4)}


def progressive_spec(scene, mesh):
    return {"scene": scene, "width": PW, "height": PH, "mesh": mesh, "steps": STEPS,
            "max_iterations": 64, "device": "cpu"}


def realtime_spec(width, height, n_tile):
    return {"scene": "cornell-glossy", "width": width, "height": height, "mesh": (n_tile, 1),
            "camera": RT_CAMERA, "denoise": True, "device": "cpu"}


@pytest.fixture(scope="module")
def sharded():
    """Every sharded render, run once: {case: rank 0's result}."""
    out = {}
    for world in (2, 4):
        jobs = [(k, launch.progressive_job, progressive_spec(*v)) for k, v in PROGRESSIVE.items()
                if v[1][0] * v[1][1] == world]
        jobs += [(k, launch.realtime_job, realtime_spec(*v)) for k, v in REALTIME.items()
                 if v[2] == world]
        ranks = launch.spawn(launch.run_jobs, world, ([(fn, spec) for _, fn, spec in jobs],),
                             device="cpu")
        assert [r[0]["rank"] for r in ranks] == list(range(world))
        out.update({k: res for (k, _, _), res in zip(jobs, ranks[0])})
    return out


def single_progressive(scene_name):
    """The single-process port's accumulation over STEPS."""
    sc, cam = build_scene(scene_name)
    cam.set_aspect(PW, PH)
    scene = sc.build("cpu")
    step = make_progressive_step(scene, PW, PH, samples_per_step=S)
    accum = torch.zeros((PH, PW, 3))
    for cams in STEPS:
        cameras = t_stack_cameras([t_camera_params(cam, jitter=(jx, jy), frame_count=fc,
                                                   accum_count=ac) for jx, jy, fc, ac in cams])
        accum = step(accum, default_options(), cameras, scene["lights"], scene["env"], 64)
    return accum.numpy()


def jax_progressive(mesh_shape):
    """JAX's sharded progressive step on the virtual mesh (the jnp route)."""
    sc, cam = j_build_scene("cornell-glossy")
    cam.set_aspect(PW, PH)
    scene = sc.build()
    mesh = make_render_mesh(*mesh_shape, devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    step = make_sharded_progressive_step(scene, PW, PH, mesh, samples_per_step=S, impl="jnp")
    accum = jax.device_put(jnp.zeros((PH, PW, 3), jnp.float32),
                           NamedSharding(mesh, P("tile", None, None)))
    for cams in STEPS:
        cameras = stack_cameras([camera_params(cam, jitter=(jx, jy), frame_count=fc,
                                               accum_count=ac) for jx, jy, fc, ac in cams])
        accum = step(accum, j_default_options(), cameras, scene["lights"], scene["env"],
                     jnp.asarray(64, jnp.int32))
    return np.asarray(accum)


def assert_images_match(got, want, frac=0.005):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert np.isfinite(got).all()
    if diff.ndim == 3:
        diff = diff.max(axis=-1)
    assert (diff > 1e-3).mean() <= frac
    assert float(np.median(diff)) < 1e-5


@pytest.mark.parametrize("case", list(PROGRESSIVE))
def test_sharded_progressive_matches_single_process_and_jax(sharded, case):
    scene_name, mesh_shape = PROGRESSIVE[case]
    got = sharded[case]["image"]
    want = single_progressive(scene_name)
    assert got.shape == (PH, PW, 3) and got.mean() > 0
    if mesh_shape[1] == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if scene_name == "cornell-glossy":
        assert_images_match(got, jax_progressive(mesh_shape))
    assert len(sharded[case]["step_ms"]) == len(STEPS)


@pytest.mark.parametrize("case", list(REALTIME))
def test_sharded_realtime_denoise_matches_single_process(sharded, case):
    """Row-sharded realtime + the halo-exchange denoiser against the
    single-process frame and denoiser, on the halo path (blocks of at least
    25 rows; edge blocks only, and with middle blocks) and the short-block
    path; against JAX's sharded step where its tests run the same shape."""
    width, height, n_tile = REALTIME[case]
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(width, height)
    scene = sc.build("cpu")
    jx, jy, fc = RT_CAMERA
    camera = t_camera_params(cam, jitter=(jx, jy), frame_count=fc)
    want = {k: v[0] for k, v in realtime_frames(
        scene, default_options(), {k: v[None] for k, v in camera.items()}, width, height).items()}
    want["display"] = denoise_composite(want["direct"], want["indirect_specular"],
                                        default_denoise_params())
    got = sharded[case]["outputs"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    if width == 16:
        jsc, jcam = j_build_scene("cornell-glossy")
        jcam.set_aspect(width, height)
        jscene = jsc.build()
        mesh = make_render_mesh(n_tile, 1, devices=jax.devices()[:n_tile])
        jout = make_sharded_realtime_step(jscene, width, height, mesh, impl="jnp")(
            j_default_options(), camera_params(jcam, jitter=(jx, jy), frame_count=fc),
            jscene["lights"], jscene["env"], j_denoise_params())
        np.testing.assert_allclose(got["display"], np.asarray(jout["display"]), atol=2e-5, rtol=0)
        assert_images_match(got["color"], jout["color"])


def test_mesh_without_process_group():
    """Without a process group a 1x1 mesh runs the sharded code in one
    process; a larger mesh raises; the halo and gather helpers are the
    identity on one rank."""
    mesh = render.make_render_mesh(device="cpu")
    assert mesh.shape == {"tile": 1, "spp": 1} and not mesh.distributed
    assert (mesh.tile, mesh.spp, mesh.device.type) == (0, 0, "cpu")
    for shape in ((2, 1), (1, 2)):
        with pytest.raises(ValueError):
            render.make_render_mesh(*shape, device="cpu")
    x = torch.arange(12.0).reshape(4, 3)
    assert render.gather_rows(x, mesh) is x
    scene = {"a": x}
    assert render.replicate_scene(scene, mesh) is scene


def test_spawn_raises_for_a_failing_rank():
    spec = progressive_spec("cornell-glossy", (3, 1))  # 3 tiles on 2 ranks
    with pytest.raises(RuntimeError, match="does not cover"):
        launch.spawn(launch.progressive_job, 2, (spec,), device="cpu")


def test_sharded_steps_reject_bad_shapes():
    mesh = render.make_render_mesh(device="cpu")
    sc, _ = build_scene("cornell-glossy")
    scene = sc.build("cpu")
    mesh.n_tile = 3  # a mesh whose tile axis does not divide the height
    with pytest.raises(ValueError):
        render.make_sharded_progressive_step(scene, PW, PH, mesh)
    mesh.n_tile, mesh.n_spp = 1, 2
    with pytest.raises(ValueError):
        render.make_sharded_realtime_step(scene, PW, PH, mesh)
    with pytest.raises(ValueError):
        render.make_sharded_progressive_step(scene, PW, PH, mesh, samples_per_step=3)


def test_render_samples_sharded_one_rank():
    """The wavefront mean of S samples and its accumulation step on a 1x1
    mesh equal the single-process integrator's (tests/test_parallel.py's
    render_samples_sharded and progressive_step_sharded)."""
    from dxrexperiments_torch.trace.integrator import render_sample

    mesh = render.make_render_mesh(device="cpu")
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(PW, PH)
    scene = sc.build("cpu")
    cams = [t_camera_params(cam, jitter=(jx, jy), frame_count=fc, accum_count=2)
            for jx, jy, fc, _ in STEPS[0]]
    cameras = t_stack_cameras(cams)
    mean = render.render_samples_sharded(scene, default_options(), cameras, PW, PH, mesh)
    want = sum(render_sample(scene, default_options(), c, PW, PH)["color"] for c in cams) / S
    torch.testing.assert_close(mean, want, rtol=0, atol=1e-7)
    accum = torch.full((PH, PW, 3), 0.25)
    got = render.progressive_step_sharded(scene, default_options(), cameras, accum, PW, PH, mesh)
    torch.testing.assert_close(got, (2.0 * accum + S * mean) / (2.0 + S), rtol=0, atol=0)


def test_launch_counts_cover_every_kernel_counter(monkeypatch):
    """launch_counts names every counter of every kernel that the ops
    modules declare once, and reset_launch_counts zeroes each."""
    import importlib
    import pkgutil

    import dxrexperiments_torch.ops as ops
    from dxrexperiments_torch.ops import kernel

    declared_here = set(kernel.kernels())
    for info in pkgutil.iter_modules(ops.__path__):
        importlib.import_module(f"dxrexperiments_torch.ops.{info.name}")
    assert set(kernel.KERNELS) == declared_here  # kernels() imports every wrapper
    assert sorted(kernel.KERNELS) == ["B1", "B2", "B3", "B4a", "B4b", "B4c", "B4d", "B5", "B6a",
                                      "B6b", "B7"]
    declared = [name for k in kernel.KERNELS.values() for name in k.counters]
    assert len(declared) == len(set(declared)) == 24
    assert set(launch.launch_counts()) == set(declared)
    monkeypatch.setattr(kernel, "_COUNTS", dict.fromkeys(declared, 0))  # this test's own
    kernel.KERNELS["B1"].run(lambda: 0, "B1", "B1 blocked")
    kernel.KERNELS["B1"].run(lambda: 0, "B1")
    assert {k: v for k, v in launch.launch_counts().items() if v} == {"B1": 2, "B1 blocked": 1}
    launch.reset_launch_counts()
    assert set(launch.launch_counts().values()) == {0}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_run_tiles_row_blocks_equal_the_whole_frame(n):
    """The sharded denoiser's row blocks as threads of one process
    (``launch.run_tiles``): ``_denoise_local`` on 52- and 26-row blocks
    (the halo path) and 13-row blocks (the short-block path) equals the
    whole frame's denoise_composite bit for bit, and ``_halo_rows`` pads
    each block with its neighbours' rows, zeros at the image's edges."""
    rng = np.random.default_rng(n)
    h_full, w = 104, 8
    direct, spec = (torch.from_numpy(rng.random((h_full, w, 3), dtype=np.float32))
                    for _ in range(2))
    params = default_denoise_params()
    h, r = h_full // n, render.MAX_EXTENT

    def job(mesh):
        a, b = mesh.tile * h, (mesh.tile + 1) * h
        padded = render._halo_rows([direct[a:b]], r, mesh)[0] if h >= r else None
        return padded, render._denoise_local(direct[a:b], spec[a:b], params, mesh, h)

    tiles = launch.run_tiles(n, job, "cpu")
    assert torch.equal(torch.cat([t[1] for t in tiles]), denoise_composite(direct, spec, params))
    if h >= r:
        framed = torch.cat([torch.zeros(r, w, 3), direct, torch.zeros(r, w, 3)])
        for t, (padded, _) in enumerate(tiles):
            assert torch.equal(padded, framed[t * h:(t + 1) * h + 2 * r])


def test_run_tiles_raises_a_threads_error():
    def job(mesh):
        if mesh.tile == 1:
            raise ValueError("tile 1 failed")
        return mesh.sum_tile(torch.ones(2))

    with pytest.raises(ValueError, match="tile 1 failed"):
        launch.run_tiles(3, job, "cpu")
    assert [x.tolist() for x in launch.run_tiles(3, lambda m: m.sum_tile(torch.ones(2)), "cpu")] \
        == [[3.0, 3.0]] * 3


def test_gather_rows_gives_contiguous_full_tensors():
    """gather_rows of several tensors on an n x 1 mesh: each full tensor,
    contiguous, as the B2 kernel takes it on the short-block path."""
    rng = np.random.default_rng(9)
    full = [torch.from_numpy(rng.random((12, 5, 3), dtype=np.float32)),
            torch.from_numpy(rng.random((12, 5), dtype=np.float32))]
    got = launch.run_tiles(3, lambda m: render.gather_rows(
        [x[m.tile * 4:(m.tile + 1) * 4] for x in full], m), "cpu")
    for rank in got:
        for g, want in zip(rank, full):
            assert g.is_contiguous() and torch.equal(g, want)
