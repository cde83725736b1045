"""Entry points of the port (the counterparts of the repository's
``__graft_entry__.py``): one progressive step to call, and a dry run of the
multi-GPU render paths over spawned ranks.

    fn, args = entry()            # on the card; entry("cpu") on the CPU
    accum = fn(*args)
    dryrun_multichip(2)           # 2 gloo ranks on the CPU

``entry`` needs a card unless the caller asks for the CPU, as every entry
point of the port does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .core.camera import Camera, camera_params, stack_cameras
from .core.device import setup_device
from .models.denoise import default_denoise_params
from .models.progressive import progressive_step
from .parallel.launch import spawn
from .parallel.render import (
    gather_rows,
    make_render_mesh,
    make_sharded_progressive_step,
    make_sharded_realtime_step,
    progressive_step_sharded,
    replicate_scene,
)
from .scene import Scene, cornell_box, envmap
from .scene.lights import directional_light, point_light
from .trace.integrator import default_options


def _cornell_setup(width: int, height: int, spp_cameras: int = 1, device="cuda"):
    """(scene, options, CameraParams list, zero accumulator) of the
    Cornell-glossy box with the 1 directional + 1 point rig and a black
    env, framed as the CLI frames it; as JAX's ``_cornell_setup``."""
    device = setup_device(device)
    mesh_geo, materials = cornell_box(glossy_tall_box=True)
    sc = Scene()
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh_geo)
    sc.lights = {
        "dir": directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
        "point": point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
    }
    sc.environment = envmap.constant_env((0.0, 0.0, 0.0))
    scene = sc.build(device)

    cam = Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(width, height)
    cams = [camera_params(cam, jitter=(0.1 / width, -0.1 / height), frame_count=s)
            for s in range(spp_cameras)]
    accum = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    return scene, default_options(), cams, accum


def entry(device="cuda"):
    """(fn, example_args): one progressive accumulation step on the
    Cornell-glossy box at 128^2 (``models.progressive.progressive_step``,
    the scene an argument). On the card its traces launch kernel B3; with
    ``device="cpu"`` they are the plain versions."""
    width = height = 128
    scene, options, cams, accum = _cornell_setup(width, height, 1, device)
    fn = functools.partial(progressive_step, width=width, height=height)
    return fn, (scene, options, cams[0], accum, 1024)


def _check(name: str, img: np.ndarray, shape: tuple) -> str:
    if img.shape != shape or not np.isfinite(img).all() or not img.max() > 0.0:
        raise RuntimeError(f"dryrun {name}: image {img.shape} (want {shape}) is not finite "
                           f"with a positive maximum")
    return f"dryrun {name} OK: image {shape[0]}x{shape[1]}, mean={img.mean():.4f}"


def _dryrun_rank(n_devices: int) -> list:
    """One rank's part of ``dryrun_multichip``; rank 0 returns the report
    lines (the others None)."""
    n_spp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_tile = n_devices // n_spp
    mesh = make_render_mesh(n_tile, n_spp, device="cpu")
    lines = []

    # 1. the wavefront progressive step: rows over "tile", samples over "spp"
    w1, h1 = 64, 8 * n_tile
    scene, options, cams, _ = _cornell_setup(w1, h1, n_spp, mesh.device)
    scene = replicate_scene(scene, mesh)
    accum = torch.zeros((h1 // n_tile, w1, 3), dtype=torch.float32, device=mesh.device)
    out = gather_rows(progressive_step_sharded(scene, options, stack_cameras(cams), accum, w1,
                                               h1, mesh), mesh)
    lines.append(_check(f"1 (wavefront progressive, mesh {n_tile}x{n_spp})",
                        out.cpu().numpy(), (h1, w1, 3)))

    # 2. the sharded progressive step through the megakernel route (B1 on a card)
    w2 = h2 = 32
    scene2, options2, cams2, _ = _cornell_setup(w2, h2, n_spp, mesh.device)
    scene2 = replicate_scene(scene2, mesh)
    step = make_sharded_progressive_step(scene2, w2, h2, mesh, samples_per_step=n_spp)
    accum2 = torch.zeros((h2 // n_tile, w2, 3), dtype=torch.float32, device=mesh.device)
    out2 = gather_rows(step(accum2, options2, stack_cameras(cams2), scene2["lights"],
                            scene2["env"], 64), mesh)
    lines.append(_check("2 (sharded megakernel progressive)", out2.cpu().numpy(), (h2, w2, 3)))

    # 3. the realtime frame and the denoiser with its 25-row halo exchange
    mesh_rt = make_render_mesh(n_devices, 1, device="cpu")
    w3, h3 = 64, 32 * n_devices  # 32 rows a rank >= the 25-row filter halo
    scene3, options3, cams3, _ = _cornell_setup(w3, h3, 1, mesh_rt.device)
    scene3 = replicate_scene(scene3, mesh_rt)
    step_rt = make_sharded_realtime_step(scene3, w3, h3, mesh_rt, denoise=True)
    outs = step_rt(options3, cams3[0], scene3["lights"], scene3["env"],
                   default_denoise_params())
    disp = gather_rows(outs["display"], mesh_rt)
    lines.append(_check(f"3 (realtime + halo denoise over {n_devices} row blocks)",
                        disp.cpu().numpy(), (h3, w3, 3)))
    return lines if mesh.rank == 0 else None


def dryrun_multichip(n_devices: int) -> None:
    """Run the three multi-GPU render paths once each on ``n_devices``
    spawned CPU ranks of one process group (``parallel/launch.spawn``,
    gloo), at small shapes, as JAX's dry run does on its virtual CPU mesh:

    1. the wavefront progressive step (``progressive_step_sharded``) over
       an (n / 2) x 2 ("tile", "spp") mesh (n x 1 for odd n);
    2. the sharded progressive step through the megakernel route
       (``make_sharded_progressive_step``: B1 per rank on a card, its plain
       version on the CPU);
    3. the sharded realtime frame and the row-sharded denoiser, whose
       vertical pass takes a 25-row halo from each neighbour.

    Each gathered image must be finite with a positive maximum; a failing
    rank raises here."""
    lines = spawn(_dryrun_rank, n_devices, (n_devices,), device="cpu")[0]
    for line in lines:
        print(line)
    print(f"dryrun_multichip OK: {n_devices} ranks, 3 paths green")
