"""Headless CLI renderer of the port (``dxrexperiments_tpu.app.headless``,
progressive and realtime pipelines).

Builds a scene (the Cornell box, with a glass pane as ``cornell-glass`` or
with a checker-textured floor and an area light as ``cornell-tex``, a
random triangle soup ``soup:N``, a K x K grid of sphere instances
``instanced:K``, BASELINE config 2 as written (``config2``: its model and
probe files under ``assets/``), or a mesh file: .obj, .ply, .gltf, .glb,
.fbx or .dae; above 4,096 triangles through a BVH) and writes a PNG, or
with ``-o PATH.npy`` the float32 image before clipping.
Progressive: accumulates --spp samples (one per frame) and prints spp/s and
primary rays/s; --ao-only renders the AO view, --refraction adds the
transmission bounce through glass. Realtime: renders one 1-spp frame,
optionally through the DenoiseCompositor.

Usage:
    python -m dxrexperiments_torch.app.headless --scene cornell-glossy \
        --size 512x512 --spp 32 --device cuda -o out.png
    python -m dxrexperiments_torch.app.headless --pipeline realtime --denoise \
        --scene cornell-glossy --size 1920x1080 --device cuda -o out.png
    python -m dxrexperiments_torch.app.headless --scene instanced:32 \
        --size 512x512 --spp 16 --device cuda -o out.png
    python -m dxrexperiments_torch.app.headless --scene instanced:32 \
        --accel two-level --animate-instances --size 512x512 --spp 16 -o out.png
    python -m dxrexperiments_torch.app.headless --scene cornell-glass --refraction \
        --size 512x512 --spp 16 -o out.png
    python -m dxrexperiments_torch.app.headless --scene cornell-tex \
        --size 512x512 --spp 16 -o out.png
    python -m dxrexperiments_torch.app.headless --scene cornell-glossy \
        --env latlong:sky.hdr --size 1920x1080 --spp 1024 -o out.png
    python -m dxrexperiments_torch.app.headless --scene model.glb \
        --size 512x512 --spp 16 -o out.png
    python -m dxrexperiments_torch.app.headless --scene model.obj --spp 64 \
        --save-state ck --checkpoint-every 16 -o out.png

A mesh file is loaded with ``scene.mesh.load_mesh(path, on_error="raise")``
(a file that does not load fails the run; the JAX CLI renders a fallback
triangle instead) and rendered with the reference framing: the red glossy
reference material, the default rig, the gradient env, the camera at
center + (0.3, 0.35, 1.0) x the AABB's diagonal looking at its center.

--env sets the environment: gradient, constant:R,G,B, latlong:PATH (a
Radiance .hdr, or an LDR image through PIL) or cubemap:PATH (an
uncompressed .dds cubemap), each with an optional ' xStrength' suffix; a
texture env on a small scene routes it through a BVH (``Scene.build``'s
tex_autoroute), and the megakernels look the texture up at every miss.
--accel two-level renders the scene as one BLAS per unique mesh under a
TLAS over its instances; --animate-instances turns the instances each frame
by a TLAS refit (progressive pipeline). With --pipeline realtime, --accel
two-level, --animate-instances, --ao-only and --refraction are ignored and
the flattened scene renders, as in the JAX CLI; a line names the ignored
flags. --checkpoint-every N (with --save-state) also writes the checkpoint
every N frames, so a long render survives the process; --resume continues
it bit for bit. --device defaults to cuda and fails without a card; pass
--device cpu for the plain PyTorch path.

--frames-in-flight K (realtime) renders K frames in one dispatch: one B1 or
B5 launch for the K frames, then their K denoiser chains; the image written
is the last frame's. --shard TILExSPP renders over a (tile, spp) grid of
ranks (``parallel/render.py``): image rows over TILE ranks and each step's
samples over SPP, one process per card, under torchrun with WORLD_SIZE =
TILE x SPP; 1x1 runs the sharded code in one process:
    torchrun --nproc-per-node 4 -m dxrexperiments_torch.app.headless \
        --shard 4x1 --pipeline realtime --denoise --size 1920x1080 -o out.png
    python -m dxrexperiments_torch.app.headless --shard 1x1 --device cpu \
        --size 32x32 --spp 2 -o out.png
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..core.camera import Camera
from ..models.denoise import DenoiseCompositor, linear_to_srgb, reinhard_tonemap
from ..models.progressive import ProgressiveRaytracingPipeline
from ..models.realtime import RealtimeRaytracingPipeline
from ..ops.kernel import check_errors
from ..scene import Material, Scene, cornell_box, envmap
from ..scene.lights import area_light, default_lights, directional_light, point_light
from ..scene.materials import MATERIAL_GLASS
from ..scene.mesh import Mesh, load_mesh
from ..scene.procedural import random_triangle_soup, sphere_mesh
from ..scene.textures import checker_texture, planar_uvs
from ..utils.dds import load_cubemap
from ..utils.image import read_image, write_png
from ..utils.stats import FrameStats

SCENES = ("cornell", "cornell-glossy", "cornell-glass", "cornell-tex", "soup:N", "instanced:K",
          "config2")
MESH_EXTENSIONS = (".obj", ".ply", ".gltf", ".glb", ".fbx", ".dae")
SCENE_HELP = " | ".join(SCENES) + f" | a mesh file ({', '.join(MESH_EXTENSIONS)})"
# config 2's files, as the reference app names them, under the repository's assets/
ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")
CONFIG2_FILES = ("models/susanne.obj", "models/ground.fbx", "textures/CathedralRadiance.dds")
# realtime renders the flattened scene; these progressive-only flags are ignored there
REALTIME_IGNORED = (("accel", "two-level", "--accel two-level"),
                    ("animate_instances", True, "--animate-instances"),
                    ("ao_only", True, "--ao-only"), ("refraction", True, "--refraction"))
AOV_OPTIONS = {
    "albedo": "show_gbuffer_albedo_only",
    "direct": "show_direct_lighting_only",
    "indirect-diffuse": "show_indirect_diffuse_only",
    "indirect-specular": "show_indirect_specular_only",
    "fresnel": "show_fresnel_term",
}


def build_scene(name: str) -> tuple[Scene, Camera]:
    """The JAX CLI's procedural scenes: the Cornell box (glossy tall box for
    'cornell-glossy'; 'cornell-glass' adds a glass pane in front of the
    boxes, for --refraction) with the 1 directional + 1 point rig, a black
    constant env and the default framing; 'cornell-tex', BASELINE config
    2's features on the Cornell box: a checker-textured floor and a rig of
    1 directional + 1 area light (soft shadows), which Scene.build routes
    through a BVH tagged tex_autoroute; 'soup:N', N random triangles;
    'instanced:K',
    a K x K grid of 960-triangle spheres on a floor with alternating glossy
    and white materials (BASELINE config 5 at K = 32, 983,042 triangles,
    flattened). Soups and instances take the default rig and the gradient
    env. 'config2': BASELINE config 2 as written (``config2_scene``). Any
    other name is a mesh file path (``mesh_scene``)."""
    if name.startswith("soup:"):
        sc, cam = Scene(), Camera()
        sc.add_model(random_triangle_soup(int(name.split(":", 1)[1]), seed=0, extent=10.0))
        sc.lights = default_lights()
        sc.environment = envmap.gradient_env()
        cam.set_eye_at_up((25.0, 18.0, 25.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
        return sc, cam
    if name.startswith("instanced:"):
        return _instanced_scene(int(name.split(":", 1)[1]))
    if name == "config2":
        return config2_scene()
    if name not in SCENES:
        if os.path.splitext(name)[1].lower() not in MESH_EXTENSIONS:
            raise ValueError(f"unknown scene {name!r} (supported: {SCENE_HELP})")
        return mesh_scene(load_mesh(name, on_error="raise"))
    sc = Scene()
    mesh, materials = cornell_box(glossy_tall_box=(name in ("cornell-glossy", "cornell-glass")),
                                  textured_floor=(name == "cornell-tex"))
    for m in materials:
        sc.add_material(m)
    if name == "cornell-glass":
        # a thin glass pane: one interface per ray, which the depth-1 bounce
        # of --refraction renders (a solid volume would need an exit bounce)
        glass = sc.add_material(Material(albedo=(0.02, 0.02, 0.02, 1.0),
                                         specular=(0.04, 0.04, 0.04, 1.0), reflectivity=1.0,
                                         roughness=0.0, ior=1.5, type=MATERIAL_GLASS))
        pane = np.array([[-0.85, 0.15, 0.55], [-0.85, 1.55, 0.55], [0.15, 1.55, 0.55],
                         [0.15, 0.15, 0.55]], np.float32)
        sc.add_model(Mesh(pane, None, np.array([[0, 2, 1], [0, 3, 2]], np.int32)),
                     material=glass)
    sc.add_model(mesh)
    if name == "cornell-tex":
        sc.lights = {
            "dir": [directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.3))],
            "point": [],
            "area": [area_light((-0.4, 1.96, -0.4), (0.8, 0, 0), (0, 0, 0.8),
                                (1.0, 0.9, 0.7, 4.0))],
        }
    else:
        sc.lights = {
            "dir": directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
            "point": point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
        }
    sc.environment = envmap.constant_env((0.0, 0.0, 0.0))
    cam = Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    return sc, cam


def mesh_scene(mesh: Mesh) -> tuple[Scene, Camera]:
    """A mesh file's scene as the CLI frames it (the JAX CLI's, after the
    reference app's default framing): the mesh under the red glossy
    reference material, the default rig, the gradient env, the camera at
    center + (0.3, 0.35, 1.0) x |AABB diagonal| looking at the AABB's
    center."""
    sc, cam = Scene(), Camera()
    sc.add_model(mesh, material=Material.reference_default())
    sc.lights = default_lights()
    sc.environment = envmap.gradient_env()
    lo, hi = mesh.aabb()
    center = (lo + hi) / 2
    extent = float(np.linalg.norm(hi - lo))
    eye = center + np.array([0.3, 0.35, 1.0]) * extent
    cam.set_eye_at_up(eye, center, (0.0, 1.0, 0.0))
    return sc, cam


def config2_scene(assets: str | None = None) -> tuple[Scene, Camera]:
    """BASELINE config 2 as written (the JAX CLI's 'config2'): the susanne
    OBJ (x4, at y = 4.2, the glossy reference material) on the ground FBX
    (planar UVs x40, a 16 x 16 checker albedo texture), 1 directional + 1
    area light, the cathedral radiance cubemap. Its three files
    (CONFIG2_FILES under ``assets``, default ASSETS_DIR) are not in the
    repository; a missing one raises FileNotFoundError naming it (the JAX
    CLI's load_mesh would render a fallback triangle for a missing model)."""
    assets = ASSETS_DIR if assets is None else assets
    paths = [os.path.join(assets, f) for f in CONFIG2_FILES]
    for path in paths:
        if not os.path.exists(path):
            raise FileNotFoundError(f"config2 needs {path}, which is missing (config 2's "
                                    "model and probe files are not in the repository)")
    sus = load_mesh(paths[0], on_error="raise")
    gnd = load_mesh(paths[1], on_error="raise")
    planar_uvs(gnd, scale=40.0)
    sc, cam = Scene(), Camera()
    glossy = sc.add_material(Material.reference_default())
    floor = sc.add_material(Material(
        albedo=(0.85, 0.85, 0.85, 1.0), roughness=0.9,
        albedo_texture=checker_texture(16, (1.0, 1.0, 1.0), (0.45, 0.42, 0.38), size=128),
    ))
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] *= 4.0
    t[1, 3] = 4.2
    sc.add_model(sus, transform=t, material=glossy)
    sc.add_model(gnd, material=floor)
    sc.lights = {
        "dir": [directional_light((0.3, -0.75, -0.6), (1.0, 0.96, 0.9, 1.2))],
        "point": [],
        "area": [area_light((-6.0, 14.0, 6.0), (4.0, 0, 0), (0, 0, -4.0), (1.0, 0.95, 0.85, 3.0))],
    }
    sc.environment = envmap.cubemap_env(load_cubemap(paths[2]))
    cam.set_eye_at_up((8.0, 7.0, 16.0), (0.0, 4.0, 0.0), (0.0, 1.0, 0.0))
    return sc, cam


def _instanced_scene(k: int) -> tuple[Scene, Camera]:
    sc, cam = Scene(), Camera()
    base = sphere_mesh((0.0, 0.0, 0.0), 1.0, lat=16, lon=32)
    glossy = sc.add_material(Material.reference_default())
    white = sc.add_material(Material(albedo=(0.73, 0.73, 0.73, 1.0)))
    for i in range(k):
        for j in range(k):
            t = np.eye(4, dtype=np.float32)
            t[0, 3] = (i - k / 2) * 2.5
            t[2, 3] = (j - k / 2) * 2.5
            t[1, 3] = 1.0
            sc.add_model(base, transform=t, material=glossy if (i + j) % 2 else white)
    ext = k * 2.5
    floor = Mesh(
        np.array([[-ext, 0, -ext], [-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext]], np.float32),
        None,
        np.array([[0, 1, 2], [0, 2, 3]], np.int32),
    )
    sc.add_model(floor, material=white)
    sc.lights = default_lights()
    sc.environment = envmap.gradient_env()
    cam.set_eye_at_up((ext * 0.9, ext * 0.5, ext * 0.9), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    return sc, cam


def yaw_matrix(yaw: float) -> np.ndarray:
    """4x4 float32 rotation by `yaw` radians about the y axis through the
    origin (--animate-instances turns every instance by 0.05 * frame)."""
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.eye(4, dtype=np.float32)
    rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = c, s, -s, c
    return rot


def parse_env(spec: str) -> dict:
    """--env: gradient | constant:R,G,B | latlong:PATH | cubemap:PATH, with an
    optional ' xStrength' suffix."""
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
    if kind == "latlong":
        return envmap.latlong_env(read_image(arg), strength=strength)
    if kind == "cubemap":
        return envmap.cubemap_env(load_cubemap(arg), strength=strength)
    raise ValueError(f"unknown env spec {spec!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", default="cornell", help=SCENE_HELP)
    ap.add_argument("--accel", default="auto", choices=["auto", "two-level"],
                    help="auto: flattened world-space build, with a BVH above 4096 "
                         "triangles; two-level: one BLAS per unique mesh and a refittable "
                         "TLAS over the instances (progressive pipeline; needed by "
                         "--animate-instances)")
    ap.add_argument("--animate-instances", action="store_true",
                    help="progressive, two-level: turn the instances about the origin by "
                         "0.05 rad per frame through a TLAS refit (no re-bake)")
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--spp", type=int, default=16, help="progressive samples (one per frame)")
    ap.add_argument("--pipeline", choices=["progressive", "realtime"], default="progressive")
    ap.add_argument("--denoise", action="store_true", help="realtime: run DenoiseCompositor")
    ap.add_argument("--temporal", type=float, default=None, metavar="ALPHA",
                    help="realtime: temporal accumulation blend factor (e.g. 0.2); a "
                         "single frame has no history, so it blends the frames of "
                         "--frames-in-flight")
    ap.add_argument("--frames-in-flight", type=int, default=1, metavar="K",
                    help="realtime: render K frames (ray tracing + denoise) in one "
                         "dispatch, at K frames of input latency; writes the last frame")
    ap.add_argument("--shard", default=None, metavar="TILExSPP",
                    help="multi-GPU: image rows over TILE ranks x each step's samples "
                         "over SPP, one process per card under torchrun (WORLD_SIZE = "
                         "TILE x SPP), or 1x1 in one process; 'auto' puts every rank on "
                         "the tile axis. Progressive steps take SPP samples; realtime "
                         "shards the rows through the denoiser (SPP 1)")
    ap.add_argument("--ao-only", action="store_true",
                    help="progressive: the ambient-occlusion view (4 AO rays per sample)")
    ap.add_argument("--refraction", action="store_true",
                    help="progressive: trace a transmission bounce through glass materials "
                         "(pair with --scene cornell-glass)")
    ap.add_argument("--aov", default=None, choices=sorted(AOV_OPTIONS),
                    help="debug AOV view (progressive pipeline)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--env", default=None,
                    help="environment override: gradient | constant:R,G,B | latlong:PATH "
                         "(.hdr or LDR) | cubemap:PATH (.dds), each [xStrength]")
    ap.add_argument("--tonemap", action="store_true", help="Reinhard + gamma the output")
    ap.add_argument("--save-state", default=None, metavar="PATH",
                    help="write the accumulation checkpoint to PATH.npz at the end")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="progressive: also write --save-state every N frames, so a long "
                         "render survives a process death mid-run")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="resume from a --save-state checkpoint (bit-identical continuation)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu (plain PyTorch path)")
    ap.add_argument("-o", "--output", default="out.png",
                    help="the image: a .png, or a .npy (the float32 image before clipping)")
    args = ap.parse_args(argv)

    if (args.save_state or args.resume) and args.pipeline != "progressive":
        ap.error("--save-state/--resume checkpoint the progressive accumulation state; "
                 "use --pipeline progressive")
    if (args.save_state or args.resume) and args.shard:
        ap.error("--save-state/--resume is the single-process path; it does not combine "
                 "with --shard")
    if args.checkpoint_every and not args.save_state:
        ap.error("--checkpoint-every needs --save-state PATH")
    if args.frames_in_flight < 1:
        ap.error(f"--frames-in-flight must be >= 1 (got {args.frames_in_flight})")
    if args.frames_in_flight > 1 and args.pipeline != "realtime":
        ap.error("--frames-in-flight is the realtime frames-in-flight batch; it has no "
                 "effect on --pipeline progressive")
    if args.shard and (args.frames_in_flight > 1 or args.refraction or args.aov
                       or args.animate_instances or args.temporal is not None):
        ap.error("--shard renders without --frames-in-flight, --refraction, --aov, "
                 "--animate-instances and --temporal")
    if args.pipeline == "realtime" and not args.shard:
        ignored = [flag for key, on, flag in REALTIME_IGNORED if getattr(args, key) == on]
        if ignored:
            print(f"realtime: ignoring {', '.join(ignored)} (progressive flags; the realtime "
                  f"pipeline renders the flattened scene)")
        args.accel, args.animate_instances, args.ao_only, args.refraction = (
            "auto", False, False, False)
    if args.animate_instances:
        args.accel = "two-level"
    args.spp = max(args.spp, 1)
    width, height = (int(x) for x in args.size.lower().split("x"))
    if width < 1 or height < 1:
        ap.error(f"invalid --size {args.size!r}")
    scene, camera = build_scene(args.scene)
    if args.env:
        scene.environment = parse_env(args.env)
    camera.set_aspect(width, height)
    if args.shard:
        return _main_sharded(args, width, height)
    if args.pipeline == "realtime":
        img = _render_realtime(args, scene, camera, width, height)
    else:
        img = _render_progressive(args, scene, camera, width, height)
    write_image(args.output, img)
    return 0


def write_image(path: str, img: np.ndarray) -> None:
    """A .npy path gets the float32 image as rendered; any other path a PNG
    of the image clipped to [0, 1]."""
    if path.lower().endswith(".npy"):
        np.save(path, np.asarray(img, np.float32))
    else:
        img = np.clip(img, 0.0, 1.0)
        write_png(path, img)
    print(f"wrote {path} (mean {img.mean():.4f}, max {img.max():.4f})")


def _render_realtime(args, scene, camera, width, height) -> np.ndarray:
    """One realtime frame, or with --frames-in-flight K the last of K frames
    rendered in one dispatch, denoised with --denoise; returns the image."""
    pipe = RealtimeRaytracingPipeline(width, height, seed=args.seed, device=args.device)
    pipe.set_camera(camera)
    pipe.set_scene(scene)
    denoiser = (DenoiseCompositor(temporal_alpha=args.temporal, device=args.device)
                if args.denoise else None)
    k = args.frames_in_flight
    t0 = time.perf_counter()
    if k > 1:
        direct, indirect = pipe.render_frames(0, k)
        final = denoiser.dispatch_frames(direct, indirect)[-1] if denoiser else (
            direct[-1] + indirect[-1])
    else:
        pipe.update(elapsed_time=0.0, elapsed_frames=0)
        direct, indirect = pipe.render()
        final = denoiser.dispatch(direct, indirect) if denoiser else direct + indirect
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
        check_errors()
    dt = time.perf_counter() - t0
    suffix = "+denoise" if args.denoise else ""
    if k > 1:
        suffix += f" ({k} frames a dispatch, {dt / k * 1e3:.1f} ms a frame)"
    print(f"realtime{suffix} ({pipe.device.type}): {width}x{height} in {dt:.2f}s")
    return final.detach().cpu().numpy()


def _main_sharded(args, width, height) -> int:
    """--shard: the sharded renders of ``parallel/launch.py`` on this rank
    (torchrun's RANK and WORLD_SIZE; one rank without them). Rank 0 writes
    the image."""
    import os

    import torch.distributed as dist

    from ..parallel import launch

    rank, world = int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))
    if args.shard == "auto":
        n_tile, n_spp = world, 1
    else:
        try:
            n_tile, n_spp = (int(x) for x in args.shard.lower().split("x"))
        except ValueError:
            print(f"invalid --shard {args.shard!r} (want TILExSPP or auto)")
            return 2
    if n_tile * n_spp != world:
        print(f"--shard {n_tile}x{n_spp} needs {n_tile * n_spp} ranks (torchrun "
              f"--nproc-per-node {n_tile * n_spp}), have {world}")
        return 2
    if world > 1:
        launch.init_ranks(rank, world, "env://", args.device)
    spec = {"scene": args.scene, "width": width, "height": height, "mesh": (n_tile, n_spp),
            "device": args.device, "env": args.env, "accel": args.accel,
            "ao_only": args.ao_only}
    rng = np.random.default_rng(args.seed)
    try:
        t0 = time.perf_counter()
        if args.pipeline == "progressive":
            steps = -(-args.spp // n_spp)
            res = launch.progressive_job(dict(
                spec, steps=launch.camera_steps(rng, width, height, steps, n_spp),
                max_iterations=args.spp))
            img = res["image"]
            if rank == 0 and args.tonemap:
                img = linear_to_srgb(reinhard_tonemap(torch.from_numpy(img)), 2.2).numpy()
            what = f"progressive sharded {n_tile}x{n_spp}: {steps * n_spp} spp"
        else:
            jitter = ((rng.random() - 0.5) / width, (rng.random() - 0.5) / height)
            res = launch.realtime_job(dict(spec, camera=(*jitter, 0), denoise=args.denoise))
            out = res["outputs"]
            img = None if rank != 0 else (out["display"] if args.denoise else
                                          out["direct"] + out["indirect_specular"])
            what = f"realtime sharded {n_tile}x{n_spp}{'+denoise' if args.denoise else ''}"
        dt = time.perf_counter() - t0
        if args.device != "cpu":
            check_errors()
    finally:
        if world > 1:
            dist.destroy_process_group()
    if rank == 0:
        print(f"{what} at {width}x{height} in {dt:.2f}s")
        write_image(args.output, img)
    return 0


def _render_progressive(args, scene, camera, width, height) -> np.ndarray:
    """--spp accumulated progressive samples; returns the image."""
    stats = FrameStats(width, height)
    pipe = ProgressiveRaytracingPipeline(width, height, seed=args.seed, device=args.device)
    pipe.max_iterations = args.spp
    pipe.ao_only = args.ao_only
    pipe.refraction = args.refraction
    if args.aov:
        pipe.options[AOV_OPTIONS[args.aov]] = True
    pipe.set_camera(camera)
    if args.accel == "two-level":
        pipe.set_scene_data(scene.build_two_level(pipe.device))
    else:
        pipe.set_scene(scene)
    base_tf = np.stack([inst.transform for inst in scene.instances])

    start_frame = 0
    if args.resume:
        done = pipe.load_checkpoint(args.resume)
        start_frame = done if done is not None else pipe.accum_count
        print(f"resumed {args.resume}: {pipe.accum_count} accumulated samples, "
              f"continuing at frame {start_frame}")

    out = pipe.accum
    t0 = time.perf_counter()
    for frame in range(start_frame, args.spp):
        if args.animate_instances:
            pipe.set_instance_transforms(np.einsum("ij,njk->nik", yaw_matrix(0.05 * frame), base_tf))
        pipe.update(elapsed_time=frame / 60.0, elapsed_frames=frame)
        out = pipe.render()
        stats.frame()
        if (args.save_state and args.checkpoint_every
                and (frame + 1) % args.checkpoint_every == 0 and frame + 1 < args.spp):
            pipe.save_checkpoint(args.save_state, frames_done=frame + 1)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
        check_errors()
    dt = time.perf_counter() - t0
    if args.save_state:
        pipe.save_checkpoint(args.save_state, frames_done=args.spp)
    if args.tonemap:
        out = linear_to_srgb(reinhard_tonemap(out), 2.2)
    frames = max(args.spp - start_frame, 1)
    print(
        f"progressive ({pipe.device.type}): {frames} spp at {width}x{height} in {dt:.2f}s "
        f"({frames / dt:.2f} spp/s, ~{width * height * frames / dt / 1e6:.1f} Mprimary-rays/s)"
    )
    return out.detach().cpu().numpy()


if __name__ == "__main__":
    sys.exit(main())
