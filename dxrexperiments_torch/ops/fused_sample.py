"""The brute-force megakernel (B1): wrappers and plain versions.

Port of ``dxrexperiments_tpu.ops.fused_sample_pallas``, progressive and
realtime modes. On CUDA scene tensors, ``fused_progressive_sum``,
``realtime_aovs`` and ``fused_realtime_outputs(_batch)`` launch the
hand-written kernels in
``csrc/fused_sample.cu`` or raise; on CPU scene tensors they take the plain
versions, ``fused_progressive_sum_reference`` and
``fused_realtime_outputs_reference``, loops over the wavefront integrator.
There is no fallback from a kernel to its plain version.

Env kinds 0-3: a texture env (lat-long or cubemap, the JAX kernel's
env-deferred mode) is looked up inside the kernel at every miss, from the
texture the scene holds on its device (``env_args``); nothing is written
out for a resolve pass.

Two opt-ins of the JAX kernel, off by default, read from the environment
at each call as JAX's ``_env_knobs`` reads them (``knobs``), or passed as
the keyword arguments ``cluster_rows`` and ``block_w``, which override it:

- ``FUSED_CLUSTERS=N``: every shadow sweep of the direct lighting gates
  each N-row window of the triangles behind a slab test of the window's
  box (``cluster_aabbs``) and skips the rows a ray cannot reach, once C > N
  (the kernel's separate CLUSTERED instantiation; the JAX kernel's
  ``_any_hit_clustered``). Occlusion is the flat sweep's, bit for bit.
- ``FUSED_BLOCK_W=W``: a block of the kernel's 256 threads renders a W x
  (256 / W) pixel block instead of 256 pixels of a raster row (the BLOCKED
  instantiation), where W divides 256, the width and the height divides by
  256 / W; otherwise the order stays raster, as JAX's raster rule
  (``block_order``). JAX's block is a TPU tile of tile_r / W rows; the
  port's is the CUDA block. The image is the same.

Row-block launches (``py0``, ``full_height``, as JAX's): a launch of
height h renders rows [py0, py0 + h) of a full_height-tall image, with the
full image's NDC and TEA pixel seeds, so the row blocks of a sharded render
(``parallel/render.py``) put together are the full launch's image.

``FUSED_TILE``, the JAX kernel's TPU tile of pixels, is not carried: a CUDA
block is 256 threads, one pixel each. The plain versions take no knob:
neither changes the image.

Triangle records: the scene's ``tri_records`` [C, 20] float32
(``ops/traverse.tri_records``, built with ``mt_pack`` by ``Scene.build``
and ``scene_from_numpy``) hold each triangle's 19 Möller–Trumbore
coefficient slots of ``csrc/common.cuh`` in slot order and a zero pad, so
that the kernel reads a triangle as five 16-byte loads. Its sweeps stop
after the scene's ``num_tris`` rows: the rest are padding, which never hits.

Packs: ``pack_cameras`` gives [S, 16] (origin with the jitter folded in at
the mode's scale, 30 progressive or 10 realtime, then U, V, W, lane 12 the
row offset py0 and lane 13 the full image's height, 0 for the launch's
own); ``pack_consts`` gives [2, 16] (lights, env colours
and strength in row 0; the runtime option flags and env colour 1 in row 1),
the same layout as the TPU kernel's.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..scene import envmap
from ..scene.lights import light_counts, normalize_lights
from ..trace.integrator import progressive_sample_sum, render_sample
from ..utils.profiling import annotate
from . import kernel
from .traverse import FUSED_MAX_TRIS, REC_WORDS

BIG = 3.0e38
MAX_TRIS = FUSED_MAX_TRIS  # the kernel stages at most 256 triangles in shared memory
THREADS = 256  # pixels per CUDA block (csrc/fused_sample.cu kThreads)
JITTER_SCALE = 30.0  # progressive pipeline jitter scale
REALTIME_JITTER_SCALE = 10.0  # realtime pipeline jitter scale

_ENV = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # texture, width, height
# cluster boxes, their count, rows per cluster, block width
_OPT_INS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
# "B1" counts progressive dispatches (S samples each), "B1 realtime" realtime
# dispatches (S frames each); of those, "B1 clustered" and "B1 blocked" the
# launches of the CLUSTERED and of the BLOCKED instantiations (both opt-ins)
B1 = kernel.Kernel("B1", "fused_sample", {
    "dxr_fused_progressive_sum": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + _ENV + _OPT_INS
    + [ctypes.c_void_p],
    "dxr_fused_realtime_outputs": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + _ENV + _OPT_INS
    + [ctypes.c_void_p],
}, ("B1", "B1 realtime", "B1 clustered", "B1 blocked"))

_FLAG_OPTIONS = (
    "cosine_hemisphere_sampling",
    "no_indirect_diffuse",
    None,  # debug == 2 (the MC light pick)
    "show_direct_lighting_only",
    "show_gbuffer_albedo_only",
    "show_fresnel_term",
    "show_indirect_specular_only",
    "show_indirect_diffuse_only",
)


def supports_fused(scene: dict, mode: str, ao_only: bool) -> bool:
    """Whether the megakernel takes this scene and mode
    (``fused_sample_pallas.supports_fused``): progressive or realtime, no
    AO, a brute-force scene of at most MAX_TRIS triangles (a BVH tagged
    ``tex_autoroute`` exists only for routing and does not count) without
    albedo textures, the 1 directional + 1 point rig and any env kind."""
    if mode not in ("progressive", "realtime") or ao_only:
        return False
    if "tlas" in scene or ("bvh" in scene and "tex_autoroute" not in scene["bvh"]):
        return False
    if int(scene["mt_pack"].shape[1]) > MAX_TRIS:
        return False
    if "textures" in scene or light_counts(scene["lights"]) != (1, 1, 0):
        return False
    return int(scene["env"]["kind"]) in (0, 1, 2, 3)


def _check_supported(scene: dict, env_kind: int, mode: str) -> None:
    envmap.check_env_kind(env_kind)
    if not supports_fused(scene, mode, False):
        raise NotImplementedError(
            "scene outside the megakernel's scope (more than 256 triangles, "
            "albedo textures, a BVH, or a rig other than 1 directional + 1 point "
            "light): such scenes take the wavefront route (trace.integrator, kernel B3)"
        )


def knobs(cluster_rows: int | None = None, block_w: int | None = None) -> tuple[int, int]:
    """(cluster_rows, block_w): the keyword arguments where given, else
    ``FUSED_CLUSTERS`` and ``FUSED_BLOCK_W`` from the environment, read at
    each call (``fused_sample_pallas._env_knobs``); 0 = off."""
    if cluster_rows is None:
        cluster_rows = int(os.environ.get("FUSED_CLUSTERS", "0"))
    if block_w is None:
        block_w = int(os.environ.get("FUSED_BLOCK_W", "0"))
    return int(cluster_rows), int(block_w)


def cluster_aabbs(scene: dict, cluster_rows: int) -> torch.Tensor:
    """Per-cluster boxes [K, 8] (lo xyz, hi xyz, 2 zeros) of the padded
    triangle rows in windows of ``cluster_rows``, degenerate rows (the
    padding) excluded, grown by a 1e-4 margin for grazing rays
    (``fused_sample_pallas._cluster_aabbs``, line for line)."""
    v0, e1, e2 = scene["v0"], scene["e1"], scene["e2"]
    c = v0.shape[0]
    k_count = -(-c // cluster_rows)
    pad = k_count * cluster_rows - c
    deg = (torch.sum(torch.abs(e1), 1) + torch.sum(torch.abs(e2), 1)) == 0.0
    p1, p2 = v0 + e1, v0 + e2
    lo = torch.minimum(torch.minimum(v0, p1), p2)
    hi = torch.maximum(torch.maximum(v0, p1), p2)
    lo = torch.where(deg[:, None], BIG, lo)  # a scalar: no host-to-card copy per call
    hi = torch.where(deg[:, None], -BIG, hi)
    if pad:
        lo = torch.cat([lo, torch.full((pad, 3), BIG, dtype=torch.float32, device=v0.device)])
        hi = torch.cat([hi, torch.full((pad, 3), -BIG, dtype=torch.float32, device=v0.device)])
    lo = lo.reshape(k_count, cluster_rows, 3).amin(dim=1) - 1e-4
    hi = hi.reshape(k_count, cluster_rows, 3).amax(dim=1) + 1e-4
    return torch.cat([lo, hi, torch.zeros((k_count, 2), dtype=torch.float32, device=v0.device)],
                     dim=1)


def block_order(width: int, height: int, block_w: int) -> int:
    """The block width the kernel takes: ``block_w`` where it divides the
    block's THREADS pixels and the width, and the height divides by
    THREADS / block_w; else 0, the raster order (JAX's raster rule)."""
    if block_w <= 0 or THREADS % block_w or width % block_w:
        return 0
    return block_w if height % (THREADS // block_w) == 0 else 0


def pack_cameras(cameras: dict, realtime: bool = False, py0=None,
                 full_height: int = 0) -> torch.Tensor:
    """Camera pack [S, 16]: origin (0:3) with the jitter folded in at the
    mode's scale, U (3:6), V (6:9), W (9:12), the row offset py0 (12; 0
    when None), the full image's height (13; 0 = the launch's own), zeros.
    Both are exact in float32 for any image height."""
    eye = cameras["eye"]
    s_count = int(eye.shape[0])
    scale = REALTIME_JITTER_SCALE if realtime else JITTER_SCALE
    zeros = torch.zeros((s_count, 1), dtype=torch.float32, device=eye.device)
    origin = eye + torch.cat([cameras["jitter"] * scale, zeros], dim=1)
    tail = torch.zeros((s_count, 4), dtype=torch.float32, device=eye.device)
    if py0 or full_height:  # a row block; a whole launch packs no more work
        tail[:, 0] = float(py0 or 0)
        tail[:, 1] = float(full_height)
    return torch.cat([origin, cameras["u"], cameras["v"], cameras["w"], tail], dim=1)


def check_rows(height: int, py0, full_height: int) -> None:
    """A row block [py0, py0 + height) must lie inside a full_height-tall
    image (full_height 0: the launch's own height, py0 0)."""
    if py0 is None and not full_height:
        return
    py0 = int(py0 or 0)
    if py0 < 0 or (full_height and py0 + height > full_height) or (not full_height and py0):
        raise ValueError(f"row block [{py0}, {py0 + height}) outside an image of "
                         f"{full_height or height} rows")


def pack_consts(scene: dict, options: dict, env_kind: int) -> torch.Tensor:
    """Lights / env / flags pack [2, 16] for the 1 directional + 1 point rig."""
    lights = normalize_lights(scene["lights"])
    dl = {k: v[0] for k, v in lights["dir"].items()}
    pt = {k: v[0] for k, v in lights["point"].items()}
    fwd = dl["forward"]
    n2 = (fwd * fwd).sum()
    inv = torch.where(
        n2 > 1e-8, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-8)), torch.zeros_like(n2)
    )
    env = scene["env"]
    if env_kind == 0:
        env0, env1 = env["const_color"], torch.zeros_like(env["const_color"])
    elif env_kind == 1:
        env0, env1 = env["grad_horizon"], env["grad_zenith"]
    else:  # a texture env: the kernel reads its texture (env_args)
        env0 = env1 = torch.zeros_like(env["const_color"])
    row0 = torch.cat(
        [
            -fwd * inv,
            dl["color"] * dl["intensity"],
            pt["position"],
            pt["color"] * pt["intensity"],
            env0,
            env["strength"].reshape(1),
        ]
    )
    flags = [
        float(int(options["debug"]) == 2) if k is None else float(bool(options[k]))
        for k in _FLAG_OPTIONS
    ]
    row1 = torch.cat(
        [
            torch.tensor(flags, dtype=torch.float32, device=row0.device),
            env1,
            torch.zeros(5, dtype=torch.float32, device=row0.device),
        ]
    )
    return torch.stack([row0, row1]).to(torch.float32)


def fused_progressive_sum_reference(
    scene: dict, options: dict, cameras: dict, width: int, height: int, env_kind: int,
    py0=None, full_height: int = 0,
) -> torch.Tensor:
    """Plain version: sum of S samples of the wavefront integrator, summed in
    sample order as the kernel does. Returns [H, W, 3] float32."""
    return progressive_sample_sum(scene, options, cameras, width, height, env_kind,
                                  JITTER_SCALE, impl="torch", row0=py0,
                                  full_height=full_height)


AOV_KEYS = ("direct", "indirect_specular", "albedo", "roughness")


def fused_realtime_outputs_reference(
    scene: dict, options: dict, cameras: dict, width: int, height: int, env_kind: int,
    py0=None, full_height: int = 0,
) -> dict:
    """Plain version: S realtime frames of the wavefront integrator, one per
    camera. Returns the AOV dict with a leading [S] axis: ``direct``,
    ``indirect_specular``, ``albedo``, ``color`` [S, H, W, 3] and
    ``roughness`` [S, H, W], float32."""
    frames = []
    for s in range(int(cameras["eye"].shape[0])):
        cam = {k: v[s] for k, v in cameras.items()}
        frames.append(render_sample(
            scene, options, cam, width, height, mode="realtime",
            jitter_scale=REALTIME_JITTER_SCALE, impl="torch", env_kind=env_kind,
            row0=py0, full_height=full_height,
        ))
    return {k: torch.stack([f[k] for f in frames]) for k in (*AOV_KEYS, "color")}


def _frames_u32(frame_count: torch.Tensor) -> torch.Tensor:
    """uint32 frame counters as the bits of an int32 host tensor."""
    fc = torch.as_tensor(frame_count, dtype=torch.int64).reshape(-1).cpu() & 0xFFFFFFFF
    fc = torch.where(fc >= 2**31, fc - 2**32, fc)
    return fc.to(torch.int32)


def _checked(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t


def env_args(scene: dict, env_kind: int, device) -> tuple[int | None, int, int]:
    """The kernels' env texture arguments (pointer, width, height): the
    lat-long [H, W, 3] (W, H) or the cubemap [6, S, S, 3] (S, S), float32,
    contiguous and on ``device``, where the scene put it at build; (None,
    0, 0) for kinds 0 and 1. A texture elsewhere raises: nothing is copied
    per dispatch."""
    if env_kind not in (envmap.ENV_LATLONG, envmap.ENV_CUBEMAP):
        return None, 0, 0
    tex = envmap.texture(scene["env"], env_kind)
    shape = tuple(tex.shape)
    if env_kind == envmap.ENV_LATLONG and len(shape) == 3 and shape[2] == 3:
        w, h = shape[1], shape[0]
    elif env_kind == envmap.ENV_CUBEMAP and len(shape) == 4 and shape[0] == 6 \
            and shape[1] == shape[2] and shape[3] == 3:
        w = h = shape[1]
    else:
        raise ValueError(f"env texture: bad shape {shape} for env kind {env_kind}")
    return _checked("env texture", tex, shape, device).data_ptr(), w, h


def _upload(cam: torch.Tensor, cst: torch.Tensor, frames: torch.Tensor, device) -> torch.Tensor:
    """The per-dispatch parameters, [cam S*16 | consts 32 | frames S] as
    32-bit words, in ONE non-blocking copy from pinned host memory. A copy
    from pageable memory would wait for the stream, i.e. for the previous
    dispatch's kernel, and leave the card idle while the host builds the
    next frame."""
    host = torch.empty(cam.numel() + cst.numel() + frames.numel(), dtype=torch.int32,
                       pin_memory=True)
    host[: cam.numel()] = cam.reshape(-1).view(torch.int32)
    host[cam.numel() : cam.numel() + cst.numel()] = cst.reshape(-1).view(torch.int32)
    host[cam.numel() + cst.numel() :] = frames
    return host.to(device, non_blocking=True)


def opt_in_args(scene: dict, width: int, height: int, cluster_rows: int | None,
                block_w: int | None) -> tuple:
    """The kernels' opt-in arguments (cluster boxes or None, their count,
    rows per cluster, block width) for ``knobs(cluster_rows, block_w)``:
    clusters only where C > cluster_rows (as JAX), the block width of
    ``block_order``. Returns (args, boxes); the caller keeps the boxes alive
    until the launch is queued."""
    cluster_rows, block_w = knobs(cluster_rows, block_w)
    c = int(scene["mt_pack"].shape[1])
    boxes = None
    if cluster_rows > 0 and c > cluster_rows:
        boxes = cluster_aabbs(scene, cluster_rows).contiguous()
    else:
        cluster_rows = 0
    args = (None if boxes is None else boxes.data_ptr(), 0 if boxes is None else boxes.shape[0],
            cluster_rows, block_order(width, height, block_w))
    return args, boxes


def prepare_launch(scene, options, cameras, width, height, env_kind, realtime: bool,
                   cluster_rows: int | None = None, block_w: int | None = None, lib=None,
                   py0=None, full_height: int = 0):
    """Pack and upload the parameters and allocate the outputs of one
    dispatch of S samples (progressive) or S frames (realtime). Returns
    (launch, outs, None): ``launch()`` enqueues the kernel and returns the
    CUDA error code; B1 has no error flag. Timing ``launch`` alone measures
    the kernel without the wrapper's packing and checks. ``lib``: a build
    of the kernel's source with the same entry points (default the
    package's). py0/full_height: a row-block launch (``pack_cameras``)."""
    launch, outs, _ = _prepare(scene, options, cameras, width, height, env_kind, realtime,
                               cluster_rows, block_w, lib, py0, full_height)
    return launch, outs, None


def _prepare(scene, options, cameras, width, height, env_kind, realtime: bool,
             cluster_rows: int | None, block_w: int | None, lib, py0, full_height: int):
    """``prepare_launch``'s (launch, outs) and the launch's counter names."""
    with annotate("B1.pack"):
        check_rows(height, py0, full_height)
        mt = scene["mt_pack"]
        device = mt.device
        c = int(mt.shape[1])
        s_count = int(cameras["eye"].shape[0])
        if "tri_records" not in scene:
            raise ValueError("scene has no tri_records: build it with Scene.build or "
                             "scene_from_numpy")
        rec = _checked("tri_records", scene["tri_records"], (c, REC_WORDS), device)
        if rec.data_ptr() % 16:
            raise ValueError("tri_records: expected a 16-byte aligned tensor")
        # the rows the sweeps test: num_tris, and at least one (a scene without
        # triangles sweeps one padding row, which never hits)
        n_live = max(1, min(int(scene["num_tris"]), c))
        attr = _checked("attr_pack", scene["attr_pack"], (32, c), device)
        cpu = torch.device("cpu")
        cam = _checked("cameras", pack_cameras(cameras, realtime, py0, full_height).cpu()
                       .contiguous(), (s_count, 16), cpu)
        cst = _checked("consts", pack_consts(scene, options, env_kind).cpu().contiguous(),
                       (2, 16), cpu)
        frames = _frames_u32(cameras["frame_count"])
        if frames.shape[0] != s_count:
            raise ValueError(f"frame_count: expected {s_count} entries, got {frames.shape[0]}")
        tail = (s_count, c, n_live, width, height, int(env_kind),
                *env_args(scene, int(env_kind), device))
        opt_ins, boxes = opt_in_args(scene, width, height, cluster_rows, block_w)
        counts = ("B1 realtime" if realtime else "B1",
                  *(("B1 clustered",) if boxes is not None else ()),
                  *(("B1 blocked",) if opt_ins[3] > 0 else ()))
        lib = lib or B1.library()
    with annotate("B1.upload"):
        params = _upload(cam, cst, frames, device)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    with annotate("B1.alloc"):
        if realtime:  # direct, indirect specular, albedo, roughness
            outs = (empty(s_count, height, width, 3), empty(s_count, height, width, 3),
                    empty(s_count, height, width, 3), empty(s_count, height, width))
            fn = lib.dxr_fused_realtime_outputs
        else:
            outs = (empty(height, width, 3),)
            fn = lib.dxr_fused_progressive_sum

    def launch() -> int:
        # the closure holds params, rec and boxes: a queued launch's inputs
        # stay allocated for its stream
        cam_ptr = params.data_ptr()
        cst_ptr = cam_ptr + 4 * cam.numel()
        frames_ptr = cst_ptr + 4 * cst.numel()
        head = (cam_ptr, frames_ptr, cst_ptr, rec.data_ptr(), attr.data_ptr())
        box_ptr = None if boxes is None else boxes.data_ptr()
        return kernel.on_stream(fn, device, *head, *(o.data_ptr() for o in outs), *tail,
                                box_ptr, *opt_ins[1:])

    return launch, outs, counts


def _launch(scene, options, cameras, width, height, env_kind, realtime: bool,
            cluster_rows: int | None = None, block_w: int | None = None, py0=None,
            full_height: int = 0):
    """Pack, upload and launch one dispatch of S samples (progressive) or S
    frames (realtime); returns the output tensors."""
    launch, outs, counts = _prepare(scene, options, cameras, width, height, env_kind, realtime,
                                    cluster_rows, block_w, None, py0, full_height)
    B1.run(launch, *counts, n=int(cameras["eye"].shape[0]))
    return outs


def fused_progressive_sum(
    scene: dict,
    options: dict,
    cameras: dict,
    width: int,
    height: int,
    env_kind: int,
    light_mc: bool = False,
    cluster_rows: int | None = None,
    block_w: int | None = None,
    py0=None,
    full_height: int = 0,
) -> torch.Tensor:
    """Sum of S progressive samples, [H, W, 3] float32 (divide by S for the
    mean). ``cameras`` is CameraParams stacked on a leading [S] axis.
    py0/full_height: rows [py0, py0 + H) of a full_height-tall image.

    ``light_mc`` exists for the JAX signature and changes nothing: JAX
    compiles a static debug==2 variant, while this kernel already skips the
    unpicked light's shadow sweep per thread. It only checks that
    ``options["debug"] == 2`` and raises otherwise. ``cluster_rows`` and
    ``block_w`` override ``FUSED_CLUSTERS`` and ``FUSED_BLOCK_W`` (``knobs``).

    CUDA scene tensors -> one kernel launch; CPU scene tensors -> the plain
    version. Scenes outside the kernel's scope raise."""
    with annotate("B1.wrapper", int(cameras["eye"].shape[0])):
        _check_supported(scene, env_kind, "progressive")
        if light_mc and int(options["debug"]) != 2:
            raise ValueError(
                f"light_mc=True is the debug==2 light pick; options['debug'] is "
                f"{int(options['debug'])}"
            )
        if not kernel.on_card(scene["mt_pack"].device):
            check_rows(height, py0, full_height)
            return fused_progressive_sum_reference(scene, options, cameras, width, height,
                                                   env_kind, py0, full_height)
        return _launch(scene, options, cameras, width, height, env_kind, False, cluster_rows,
                       block_w, py0, full_height)[0]


def realtime_aovs(
    scene: dict,
    options: dict,
    cameras: dict,
    width: int,
    height: int,
    env_kind: int,
    cluster_rows: int | None = None,
    block_w: int | None = None,
    py0=None,
    full_height: int = 0,
) -> dict:
    """The AOVs of S realtime frames, one per camera of ``cameras``
    (CameraParams stacked on a leading [S] axis): ``direct``,
    ``indirect_specular``, ``albedo`` [S, H, W, 3] and ``roughness``
    [S, H, W]. CUDA scene tensors -> one kernel launch and no ``color``, so
    a caller that needs only the AOVs queues no sum; CPU scene tensors ->
    the plain version, whose dict holds ``color`` too. ``cluster_rows`` and
    ``block_w``, ``py0`` and ``full_height`` as in ``fused_progressive_sum``.
    Scenes outside the kernel's scope raise."""
    with annotate("B1.wrapper", int(cameras["eye"].shape[0])):
        _check_supported(scene, env_kind, "realtime")
        if not kernel.on_card(scene["mt_pack"].device):
            check_rows(height, py0, full_height)
            return fused_realtime_outputs_reference(scene, options, cameras, width, height,
                                                    env_kind, py0, full_height)
        return dict(zip(AOV_KEYS, _launch(scene, options, cameras, width, height, env_kind,
                                          True, cluster_rows, block_w, py0, full_height)))


def fused_realtime_outputs_batch(
    scene: dict,
    options: dict,
    cameras: dict,
    width: int,
    height: int,
    env_kind: int,
    cluster_rows: int | None = None,
    block_w: int | None = None,
    py0=None,
    full_height: int = 0,
) -> dict:
    """S realtime frames (primary + 2 shadow sweeps + the Phong bounce with
    its 3 sweeps; no indirect diffuse): ``realtime_aovs`` plus ``color``
    [S, H, W, 3], ``direct + indirect_specular`` summed outside the kernel
    as the JAX package does."""
    out = realtime_aovs(scene, options, cameras, width, height, env_kind, cluster_rows, block_w,
                        py0, full_height)
    if kernel.on_card(scene["mt_pack"].device):
        out["color"] = out["direct"] + out["indirect_specular"]
    return out


def fused_realtime_outputs(
    scene: dict,
    options: dict,
    camera: dict,
    width: int,
    height: int,
    env_kind: int,
    cluster_rows: int | None = None,
    block_w: int | None = None,
    py0=None,
    full_height: int = 0,
) -> dict:
    """One realtime frame: ``fused_realtime_outputs_batch`` for a single
    CameraParams, without the leading [S] axis."""
    cameras = {k: v[None] for k, v in camera.items()}
    out = fused_realtime_outputs_batch(scene, options, cameras, width, height, env_kind,
                                       cluster_rows, block_w, py0, full_height)
    return {k: v[0] for k, v in out.items()}
