"""Headless CLI renderer of the port (``dxrexperiments_tpu.app.headless``,
progressive pipeline).

Builds a Cornell scene, accumulates --spp progressive samples (one per
frame), writes a PNG and prints spp/s and primary rays/s.

Usage:
    python -m dxrexperiments_torch.app.headless --scene cornell-glossy \
        --size 512x512 --spp 32 --device cuda -o out.png

--device defaults to cuda and fails without a card; pass --device cpu for
the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..core.camera import Camera
from ..models.denoise import linear_to_srgb, reinhard_tonemap
from ..models.progressive import ProgressiveRaytracingPipeline
from ..scene import Scene, cornell_box, envmap
from ..scene.lights import directional_light, point_light
from ..utils.image import write_png
from ..utils.stats import FrameStats

SCENES = ("cornell", "cornell-glossy")
AOV_OPTIONS = {
    "albedo": "show_gbuffer_albedo_only",
    "direct": "show_direct_lighting_only",
    "indirect-diffuse": "show_indirect_diffuse_only",
    "indirect-specular": "show_indirect_specular_only",
    "fresnel": "show_fresnel_term",
}


def build_scene(name: str) -> tuple[Scene, Camera]:
    """The Cornell box (glossy tall box for 'cornell-glossy') with the
    1 directional + 1 point rig, a black constant env and the default
    framing. Other scenes of the JAX CLI wait for later ROADMAP items."""
    if name not in SCENES:
        raise NotImplementedError(
            f"scene {name!r} is not ported yet (supported: {', '.join(SCENES)}; "
            "mesh files: ROADMAP Queue A item 15, soups and instancing: items 11 and 13)"
        )
    sc = Scene()
    mesh, materials = cornell_box(glossy_tall_box=(name == "cornell-glossy"))
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh)
    sc.lights = {
        "dir": directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
        "point": point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
    }
    sc.environment = envmap.constant_env((0.0, 0.0, 0.0))
    cam = Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    return sc, cam


def parse_env(spec: str) -> dict:
    """--env: gradient | constant:R,G,B, with an optional ' xStrength' suffix."""
    strength = 1.0
    if " x" in spec:
        spec, s = spec.rsplit(" x", 1)
        strength = float(s)
    kind, _, arg = spec.partition(":")
    if kind == "gradient":
        return envmap.gradient_env(strength=strength)
    if kind == "constant":
        rgb = tuple(float(v) for v in arg.split(",")) if arg else (0.0, 0.0, 0.0)
        return envmap.constant_env(rgb, strength=strength)
    if kind in ("latlong", "cubemap"):
        raise NotImplementedError(f"--env {kind} is not ported yet (ROADMAP Queue A item 9)")
    raise ValueError(f"unknown env spec {spec!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", default="cornell", choices=SCENES)
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--spp", type=int, default=16, help="progressive samples (one per frame)")
    ap.add_argument("--pipeline", choices=["progressive"], default="progressive",
                    help="the realtime pipeline waits for ROADMAP Queue A item 8")
    ap.add_argument("--aov", default=None, choices=sorted(AOV_OPTIONS), help="debug AOV view")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--env", default=None,
                    help="environment override: gradient | constant:R,G,B [xStrength]")
    ap.add_argument("--tonemap", action="store_true", help="Reinhard + gamma the output")
    ap.add_argument("--save-state", default=None, metavar="PATH",
                    help="write the accumulation checkpoint to PATH.npz at the end")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="resume from a --save-state checkpoint (bit-identical continuation)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu (plain PyTorch path)")
    ap.add_argument("-o", "--output", default="out.png")
    args = ap.parse_args(argv)

    args.spp = max(args.spp, 1)
    width, height = (int(x) for x in args.size.lower().split("x"))
    if width < 1 or height < 1:
        ap.error(f"invalid --size {args.size!r}")
    scene, camera = build_scene(args.scene)
    if args.env:
        scene.environment = parse_env(args.env)
    camera.set_aspect(width, height)
    stats = FrameStats(width, height)

    pipe = ProgressiveRaytracingPipeline(width, height, seed=args.seed, device=args.device)
    pipe.max_iterations = args.spp
    if args.aov:
        pipe.options[AOV_OPTIONS[args.aov]] = True
    pipe.set_camera(camera)
    pipe.set_scene(scene)

    start_frame = 0
    if args.resume:
        done = pipe.load_checkpoint(args.resume)
        start_frame = done if done is not None else pipe.accum_count
        print(f"resumed {args.resume}: {pipe.accum_count} accumulated samples, "
              f"continuing at frame {start_frame}")

    out = pipe.accum
    t0 = time.perf_counter()
    for frame in range(start_frame, args.spp):
        pipe.update(elapsed_time=frame / 60.0, elapsed_frames=frame)
        out = pipe.render()
        stats.frame()
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    dt = time.perf_counter() - t0
    if args.save_state:
        pipe.save_checkpoint(args.save_state, frames_done=args.spp)
    if args.tonemap:
        out = linear_to_srgb(reinhard_tonemap(out), 2.2)
    img = out.detach().cpu().numpy()
    frames = max(args.spp - start_frame, 1)
    print(
        f"progressive ({pipe.device.type}): {frames} spp at {width}x{height} in {dt:.2f}s "
        f"({frames / dt:.2f} spp/s, ~{width * height * frames / dt / 1e6:.1f} Mprimary-rays/s)"
    )
    img = np.clip(img, 0.0, 1.0)
    write_png(args.output, img)
    print(f"wrote {args.output} (mean {img.mean():.4f}, max {img.max():.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
