"""The progressive-sample megakernel: wrapper, plain version and launch count.

Port of ``dxrexperiments_tpu.ops.fused_sample_pallas`` (progressive mode).
On a CUDA tensor, ``fused_progressive_sum`` launches the hand-written kernel
in ``csrc/fused_sample.cu`` (one launch renders S samples and returns their
sum) or raises; on a CPU tensor it takes the plain version,
``fused_progressive_sum_reference``, a loop over the wavefront integrator.
There is no fallback from the kernel to the plain version.

Packs: ``pack_cameras`` gives [S, 16] (origin with the progressive jitter
folded in at scale 30, then U, V, W, and lane 12 the row offset, 0 here);
``pack_consts`` gives [2, 16] (lights, env colours and strength in row 0;
the runtime option flags and env colour 1 in row 1), the same layout as the
TPU kernel's.
"""

from __future__ import annotations

import ctypes

import torch

from ..scene.lights import light_counts, normalize_lights
from ..trace.integrator import render_sample

MAX_TRIS = 256  # the kernel stages at most 256 triangles in shared memory
JITTER_SCALE = 30.0  # progressive pipeline jitter scale

# Kernel launches so far (one per dispatch of S samples). Callers reset it
# to 0 and read it back to show that a run went through the kernel.
LAUNCHES = 0

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
    """Whether the megakernel takes this scene and mode: progressive, no AO,
    a brute-force scene of at most MAX_TRIS triangles without textures, the
    1 directional + 1 point rig and an analytic env (kinds 0 and 1)."""
    if mode != "progressive" or ao_only:
        return False
    if any(k in scene for k in ("bvh", "tlas", "textures")):
        return False
    if int(scene["mt_pack"].shape[1]) > MAX_TRIS:
        return False
    if light_counts(scene["lights"]) != (1, 1, 0):
        return False
    return int(scene["env"]["kind"]) in (0, 1)


def _check_supported(scene: dict, env_kind: int, realtime: bool, light_mc: bool) -> None:
    if realtime:
        raise NotImplementedError(
            "realtime mode of the megakernel is not ported yet (ROADMAP Queue A item 8)"
        )
    if light_mc:
        raise NotImplementedError(
            "the static light_mc variant is not ported yet (ROADMAP Queue A item 8)"
        )
    if int(env_kind) not in (0, 1):
        raise NotImplementedError(
            f"env kind {env_kind} (texture env) is not ported yet (ROADMAP Queue A item 9)"
        )
    if not supports_fused(scene, "progressive", False):
        raise NotImplementedError(
            "scene outside the megakernel's scope (more than 256 triangles, "
            "textures, a BVH, or a rig other than 1 directional + 1 point "
            "light): the wavefront route waits for ROADMAP Queue A item 10"
        )


def pack_cameras(cameras: dict) -> torch.Tensor:
    """Camera pack [S, 16]: origin (0:3) with the jitter folded in, U (3:6),
    V (6:9), W (9:12), row offset (12, always 0 here), zeros."""
    eye = cameras["eye"]
    s_count = int(eye.shape[0])
    zeros = torch.zeros((s_count, 1), dtype=torch.float32, device=eye.device)
    origin = eye + torch.cat([cameras["jitter"] * JITTER_SCALE, zeros], dim=1)
    tail = torch.zeros((s_count, 4), dtype=torch.float32, device=eye.device)
    return torch.cat([origin, cameras["u"], cameras["v"], cameras["w"], tail], dim=1)


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
    else:
        env0, env1 = env["grad_horizon"], env["grad_zenith"]
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
    scene: dict, options: dict, cameras: dict, width: int, height: int, env_kind: int
) -> torch.Tensor:
    """Plain version: sum of S samples of the wavefront integrator, summed in
    sample order as the kernel does. Returns [H, W, 3] float32."""
    total = None
    for s in range(int(cameras["eye"].shape[0])):
        cam = {k: v[s] for k, v in cameras.items()}
        color = render_sample(
            scene, options, cam, width, height, mode="progressive",
            jitter_scale=JITTER_SCALE, impl="torch", env_kind=env_kind,
        )["color"]
        total = color if total is None else total + color
    return total


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from ..utils.cuda_build import load_library

        lib = load_library("fused_sample", ["fused_sample.cu"])
        fn = lib.dxr_fused_progressive_sum
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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


def _launch(scene, options, cameras, width, height, env_kind) -> torch.Tensor:
    global LAUNCHES
    mt = scene["mt_pack"]
    device = mt.device
    c = int(mt.shape[1])
    s_count = int(cameras["eye"].shape[0])
    mt = _checked("mt_pack", mt, (4, c, 16), device)
    attr = _checked("attr_pack", scene["attr_pack"], (32, c), device)
    cpu = torch.device("cpu")
    cam = _checked("cameras", pack_cameras(cameras).cpu().contiguous(), (s_count, 16), cpu)
    cst = _checked("consts", pack_consts(scene, options, env_kind).cpu().contiguous(), (2, 16), cpu)
    frames = _frames_u32(cameras["frame_count"])
    if frames.shape[0] != s_count:
        raise ValueError(f"frame_count: expected {s_count} entries, got {frames.shape[0]}")
    params = _upload(cam, cst, frames, device)
    cam_ptr = params.data_ptr()
    cst_ptr = cam_ptr + 4 * cam.numel()
    frames_ptr = cst_ptr + 4 * cst.numel()
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    fn = _library().dxr_fused_progressive_sum
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            cam_ptr, frames_ptr, cst_ptr, mt.data_ptr(), attr.data_ptr(), out.data_ptr(),
            s_count, c, width, height, int(env_kind), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_sample kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def fused_progressive_sum(
    scene: dict,
    options: dict,
    cameras: dict,
    width: int,
    height: int,
    env_kind: int,
    realtime: bool = False,
    light_mc: bool = False,
) -> torch.Tensor:
    """Sum of S progressive samples, [H, W, 3] float32 (divide by S for the
    mean). ``cameras`` is CameraParams stacked on a leading [S] axis.

    CUDA scene tensors -> one kernel launch; CPU scene tensors -> the plain
    version. Modes and scenes outside the kernel's scope raise."""
    _check_supported(scene, env_kind, realtime, light_mc)
    device = scene["mt_pack"].device
    if device.type == "cpu":
        return fused_progressive_sum_reference(scene, options, cameras, width, height, env_kind)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return _launch(scene, options, cameras, width, height, env_kind)
