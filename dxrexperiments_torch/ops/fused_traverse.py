"""The fused-traversal megakernel (B5): wrappers and plain versions.

Port of ``dxrexperiments_tpu.ops.fused_traverse_pallas`` (``_make_ft_kernel``
in all its modes): the whole progressive sample, or a realtime frame, with
every trace a fat-node BVH walk inside the kernel. On CUDA scene tensors
``fused_traverse_progressive_sum`` and ``realtime_aovs`` launch the
hand-written kernels in ``csrc/fused_traverse.cu`` or raise; on CPU scene
tensors they take the plain versions, loops over the wavefront integrator
(whose BVH traces are then the brute-force sweep). There is no fallback from
a kernel to its plain version.

Scope (``supports_fused_traverse``, the JAX gate): progressive or realtime,
no AO, a single-level BVH scene with the fat nodes and attribute lanes, at
most one light per group (one area light included: the JAX kernel's area
mode) and at most 128 materials. Env kinds 0-3: a texture env (the JAX
kernel's env-deferred mode) is looked up inside the kernel
(``fused_sample.env_args``). Albedo textures (the JAX kernel's
tex-deferred mode): progressive only, with the corner-UV lanes of mt_rows
(``mt_attr_lanes`` 2); the kernel reads the scene's texel table at each
hit, so nothing is resolved outside it. A scene outside the gate raises;
it is never rerouted here.

The packs are B1's (``fused_sample.pack_cameras``/``pack_consts``) and the
area pack (``pack_area_consts``), all in one pinned upload per dispatch;
the material table is the scene's ``material_pack`` and the leaf arrays
are the BVH's ``ft_test`` and ``ft_attr`` (``ops/traverse.leaf_records``:
each leaf slot's 19 coefficients as one 80-byte record, and its attribute
lanes), all built once by ``Scene.build``; the kernel does not read
``mt_rows``. Seeds come from the raster pixel index and the output is
raster order, so nothing is permuted back. A row-block launch (``py0``,
``full_height``, as in ``fused_sample``) renders rows [py0, py0 + H) of a
full_height-tall image with the full image's NDC and seeds.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import vecmath as vm
from ..scene import envmap
from ..scene.lights import light_counts, normalize_lights
from ..scene.materials import MP_MAX_MATERIALS
from ..utils.profiling import annotate
from . import fused_sample as fs
from . import kernel
from .traverse import REC_WORDS, check_rows

_ENV = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # texture, width, height
_TEX = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2  # texels, meta, their rows
# "B5" counts progressive dispatches (S samples each), "B5 realtime" realtime
# dispatches (S frames each)
B5 = kernel.Kernel("B5", "fused_traverse", {
    "dxr_fused_traverse_progressive_sum": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + _ENV
    + _TEX + [ctypes.c_void_p] * 2,
    "dxr_fused_traverse_realtime_outputs": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + _ENV
    + [ctypes.c_void_p] * 2,
}, ("B5", "B5 realtime"))


def supports_fused_traverse(scene: dict, mode: str, ao_only: bool) -> bool:
    """Whether the fused-traversal kernel's gate takes this scene and mode
    (``fused_traverse_pallas.supports_fused_traverse``): a textured scene
    needs the corner-UV lanes (``mt_attr_lanes`` >= 2) and runs progressive
    only; an untextured one takes any env kind."""
    if mode not in ("progressive", "realtime") or ao_only:
        return False
    if "tlas" in scene or "bvh" not in scene:
        return False
    b = scene["bvh"]
    if "bvhf_nodes" not in b or "mt_attr_lanes" not in b:
        return False
    d_n, p_n, a_n = light_counts(scene["lights"])
    if d_n > 1 or p_n > 1 or a_n > 1 or d_n + p_n + a_n == 0:
        return False
    if int(scene["materials"]["albedo"].shape[0]) > MP_MAX_MATERIALS:
        return False
    if "textures" in scene:
        return int(b["mt_attr_lanes"]) >= 2 and mode == "progressive"
    return int(scene["env"]["kind"]) in (0, 1, 2, 3)


def _check_supported(scene: dict, env_kind: int, mode: str) -> None:
    envmap.check_env_kind(env_kind)
    if not supports_fused_traverse(scene, mode, False):
        raise NotImplementedError(
            "scene outside the fused-traversal kernel's scope (no fat-node BVH, more than one "
            "light per group, more than 128 materials, or albedo textures in realtime or "
            "without the corner-UV lanes): take the wavefront route"
        )


def pack_area_consts(scene: dict) -> torch.Tensor:
    """The area pack [1, 16] of a rig's one area light
    (``fused_sample_pallas.pack_area_consts``): corner (0:3), edge u (3:6),
    edge v (6:9), colour * intensity (9:12), unit normal (12:15), quad area
    (15); the geometry terms of the integrator's area estimate."""
    al = normalize_lights(scene["lights"])["area"]
    corner = al["corner"].reshape(-1)[:3]
    eu = al["eu"].reshape(-1)[:3]
    ev = al["ev"].reshape(-1)[:3]
    ci = (al["color"] * al["intensity"][:, None]).reshape(-1)[:3]
    cross = vm.cross(eu, ev)
    area = torch.sqrt(torch.clamp((cross * cross).sum(), min=1e-24))
    n_l = cross / torch.clamp(area, min=1e-12)
    return torch.cat([corner, eu, ev, ci, n_l, area[None]])[None].to(torch.float32)


def _rig_consts(scene: dict, options: dict, env_kind: int) -> tuple[torch.Tensor, int]:
    """The const pack [3, 16]: B1's two rows for a rig of at most one
    directional and one point light, then the area pack (zeros without an
    area light); and the rig's bits (1 directional, 2 point, 4 area). A
    missing directional or point light's lanes hold a dark stand-in that
    the kernel skips."""
    lights = normalize_lights(scene["lights"])
    dl, pt = lights["dir"], lights["point"]
    has_area = bool(lights["area"]["corner"].shape[0])
    rig = ((1 if dl["forward"].shape[0] else 0) | (2 if pt["position"].shape[0] else 0)
           | (4 if has_area else 0))
    dark = {"color": torch.zeros(1, 3), "intensity": torch.zeros(1)}
    full = {
        "dir": dl if rig & 1 else dict(dark, forward=torch.tensor([[0.0, -1.0, 0.0]])),
        "point": pt if rig & 2 else dict(dark, position=torch.zeros(1, 3)),
    }
    area = pack_area_consts(scene) if has_area else torch.zeros(1, 16)
    return torch.cat([fs.pack_consts(dict(scene, lights=full), options, env_kind), area]), rig


# The plain versions are B1's: loops over the wavefront integrator, whose
# BVH traces are the brute-force sweep on any device.
fused_traverse_progressive_sum_reference = fs.fused_progressive_sum_reference
fused_traverse_realtime_outputs_reference = fs.fused_realtime_outputs_reference

def prepare_launch(scene, options, cameras, width, height, env_kind, realtime: bool, lib=None,
                   py0=None, full_height: int = 0):
    """Pack and upload the parameters and allocate the outputs of one
    dispatch of S samples (progressive) or S frames (realtime). Returns
    (launch, outs, err): ``launch()`` enqueues the kernel and returns the
    CUDA error code. Timing ``launch`` alone measures the kernel without the
    wrapper's packing and checks. ``lib``: a build of the kernel's source
    with the same entry points (default the package's). py0/full_height: a
    row-block launch (``fused_sample.pack_cameras``)."""
    with annotate("B5.pack"):
        fs.check_rows(height, py0, full_height)
        bvh = scene["bvh"]
        device = bvh["mt_rows"].device
        nodes, test, attr = check_rows(bvh, {"bvhf_rows": 16, "ft_test": REC_WORDS,
                                             "ft_attr": 16}, device)
        if test.shape[0] != attr.shape[0]:
            raise ValueError(f"ft_test and ft_attr: {test.shape[0]} against {attr.shape[0]} "
                             "slots")
        mats = scene["material_pack"]
        if (mats.device != device or mats.shape != (16, MP_MAX_MATERIALS)
                or not mats.is_contiguous()):
            raise ValueError(f"material_pack: expected a contiguous [16, {MP_MAX_MATERIALS}] "
                             f"tensor on {device}")
        s_count = int(cameras["eye"].shape[0])
        cpu = torch.device("cpu")
        cam = fs._checked("cameras", fs.pack_cameras(cameras, realtime, py0, full_height).cpu()
                          .contiguous(), (s_count, 16), cpu)
        cst, rig = _rig_consts(scene, options, env_kind)
        cst = fs._checked("consts", cst.cpu().contiguous(), (3, 16), cpu)
        frames = fs._frames_u32(cameras["frame_count"])
        if frames.shape[0] != s_count:
            raise ValueError(f"frame_count: expected {s_count} entries, got {frames.shape[0]}")
        tail = (s_count, nodes.shape[0], test.shape[0], width, height, int(env_kind), rig,
                *fs.env_args(scene, int(env_kind), device))
        if not realtime:
            tail += texture_args(scene, device)
        lib = lib or B5.library()
    with annotate("B5.upload"):
        params = fs._upload(cam, cst, frames, device)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    with annotate("B5.alloc"):
        err = torch.zeros(1, dtype=torch.int32, device=device)
        if realtime:  # direct, indirect specular, albedo, roughness
            outs = (empty(s_count, height, width, 3), empty(s_count, height, width, 3),
                    empty(s_count, height, width, 3), empty(s_count, height, width))
            fn = lib.dxr_fused_traverse_realtime_outputs
        else:
            outs = (empty(height, width, 3),)
            fn = lib.dxr_fused_traverse_progressive_sum

    def launch() -> int:
        cam_ptr = params.data_ptr()
        cst_ptr = cam_ptr + 4 * cam.numel()
        area_ptr = cst_ptr + 4 * 32  # the const pack's third row
        frames_ptr = cst_ptr + 4 * cst.numel()
        head = (cam_ptr, frames_ptr, cst_ptr, area_ptr, nodes.data_ptr(), test.data_ptr(),
                attr.data_ptr(), mats.data_ptr())
        return kernel.on_stream(fn, device, *head, *(o.data_ptr() for o in outs), *tail,
                                err.data_ptr())

    return launch, outs, err


def texture_args(scene: dict, device) -> tuple:
    """The kernel's albedo-texture arguments (texels, meta, their row
    counts): the scene's texel table [R, 3] float32 and meta [M, 3] int32,
    contiguous and on ``device``, where ``Scene.build`` put them; (None,
    None, 0, 0) for an untextured scene. A table elsewhere raises: nothing
    is copied per dispatch."""
    if "textures" not in scene:
        return None, None, 0, 0
    texels, meta = scene["textures"]["texels"], scene["textures"]["meta"]
    for name, t, dtype in (("texels", texels, torch.float32), ("meta", meta, torch.int32)):
        if (t.dtype != dtype or t.dim() != 2 or t.shape[1] != 3 or t.shape[0] < 1
                or not t.is_contiguous()):
            raise ValueError(f"albedo textures: {name} must be a contiguous [N, 3] {dtype} "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
        if t.device != device:
            raise ValueError(f"albedo textures: {name} lies on {t.device}, the scene on {device}: "
                             "build the scene on its device (Scene.build moves it once)")
    return texels.data_ptr(), meta.data_ptr(), int(texels.shape[0]), int(meta.shape[0])


def _launch(scene, options, cameras, width, height, env_kind, realtime: bool, py0=None,
            full_height: int = 0):
    """Launch one dispatch; returns the output tensors."""
    launch, outs, err = prepare_launch(scene, options, cameras, width, height, env_kind, realtime,
                                       py0=py0, full_height=full_height)
    B5.run(launch, "B5 realtime" if realtime else "B5", n=int(cameras["eye"].shape[0]), err=err)
    return outs


def fused_traverse_progressive_sum(
    scene: dict, options: dict, cameras: dict, width: int, height: int, env_kind: int,
    py0=None, full_height: int = 0,
) -> torch.Tensor:
    """Sum of S progressive samples, [H, W, 3] float32 (divide by S for the
    mean); ``cameras`` is CameraParams stacked on a leading [S] axis. CUDA
    scene tensors -> one kernel launch; CPU scene tensors -> the plain
    version. Scenes outside the kernel's scope raise. py0/full_height: rows
    [py0, py0 + H) of a full_height-tall image."""
    with annotate("B5.wrapper", int(cameras["eye"].shape[0])):
        _check_supported(scene, env_kind, "progressive")
        if not kernel.on_card(scene["bvh"]["mt_rows"].device):
            fs.check_rows(height, py0, full_height)
            return fused_traverse_progressive_sum_reference(scene, options, cameras, width,
                                                            height, env_kind, py0, full_height)
        return _launch(scene, options, cameras, width, height, env_kind, False, py0,
                       full_height)[0]


def realtime_aovs(scene: dict, options: dict, cameras: dict, width: int, height: int,
                  env_kind: int, py0=None, full_height: int = 0) -> dict:
    """The AOVs of S realtime frames, one per camera of ``cameras``:
    ``direct``, ``indirect_specular``, ``albedo`` [S, H, W, 3] and
    ``roughness`` [S, H, W]. CUDA scene tensors -> one kernel launch and no
    ``color``; CPU scene tensors -> the plain version, whose dict holds
    ``color`` too. Scenes outside the kernel's scope raise. py0/full_height
    as in ``fused_traverse_progressive_sum``."""
    with annotate("B5.wrapper", int(cameras["eye"].shape[0])):
        _check_supported(scene, env_kind, "realtime")
        if not kernel.on_card(scene["bvh"]["mt_rows"].device):
            fs.check_rows(height, py0, full_height)
            return fused_traverse_realtime_outputs_reference(scene, options, cameras, width,
                                                             height, env_kind, py0, full_height)
        return dict(zip(fs.AOV_KEYS, _launch(scene, options, cameras, width, height, env_kind,
                                             True, py0, full_height)))


def fused_traverse_realtime_outputs(scene: dict, options: dict, camera: dict, width: int,
                                    height: int, env_kind: int, py0=None,
                                    full_height: int = 0) -> dict:
    """One realtime frame (the JAX function's contract): the AOVs of
    ``realtime_aovs`` for a single CameraParams, without the leading [S]
    axis, plus ``color`` = direct + indirect_specular."""
    out = realtime_aovs(scene, options, {k: v[None] for k, v in camera.items()}, width, height,
                        env_kind, py0, full_height)
    out = {k: v[0] for k, v in out.items()}
    if "color" not in out:
        out["color"] = out["direct"] + out["indirect_specular"]
    return out
