"""Brute-force trace kernels (B3): the wrappers, the plain versions, the counts.

Port of ``dxrexperiments_tpu.ops.intersect_pallas`` (``_closest_kernel``,
``_any_kernel``; ``trace_closest``, ``trace_any``). ``trace_closest``
returns the hit with its attributes fused, as the JAX function does: hit,
t, tri, u, v, the unit shading normal, the position o + t d, mat_id and the
eight material fields. ``trace_any`` returns the occlusion flags.

On CUDA tensors both launch the hand-written kernels in
``csrc/intersect_brute.cu`` or raise; on CPU tensors they take the plain
versions, ``trace_closest_reference`` and ``trace_any_reference``: the
brute-force sweep of ``ops/intersect.py`` plus the integrator's attribute
gather (vertex normals by triangle, material rows by material id). There is
no fallback from a kernel to its plain version.

A miss gives what the kernel writes: t = -1, tri = -1, the position o - d
and zeros elsewhere. The kernel's t, u and v are the sweep's own (ts / |det|),
where the plain version recomputes them on the winner by classic
Möller–Trumbore, so the two agree to the hit gate, not bit for bit.

Scalar windows travel as launch arguments: a trace with a scalar t_min or
t_max copies nothing to the card (a per-frame host-to-card copy makes the
host wait for the card).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import vecmath as vm
from . import intersect

MATERIAL_KEYS = ("albedo", "specular", "emissive", "emissive_strength", "reflectivity",
                 "roughness", "ior", "type")
# the closest kernel's outputs, each field one contiguous block: scalars
# [7, R], 3-vectors [5, R, 3] and ids [3, R] int64
SCALARS = ("t", "u", "v", "emissive_strength", "reflectivity", "roughness", "ior")
VECTORS = ("normal", "position", "albedo", "specular", "emissive")
IDS = ("tri", "mat_id", "type")

# Kernel launches so far, one per traced batch. Callers reset them to 0 and
# read them back to show that a run went through the kernel.
CLOSEST_LAUNCHES = 0
ANY_LAUNCHES = 0


def trace_closest_reference(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                            t_min=intersect.RAY_EPSILON, t_max=intersect.RAY_MAX_T,
                            cull_backface: bool = False) -> dict:
    """Plain version of ``trace_closest``: ``intersect.intersect_closest``
    and the attribute gather of the hit triangle and its material."""
    hits = intersect.intersect_closest(scene, origins, directions, t_min, t_max,
                                       cull_backface=cull_backface)
    hit = hits["hit"]
    tri = hits["tri"].clamp(min=0)
    u, v = hits["u"], hits["v"]
    w = 1.0 - u - v
    n = (w[:, None] * scene["n0"][tri] + u[:, None] * scene["n1"][tri]
         + v[:, None] * scene["n2"][tri])
    mid = torch.where(hit, scene["mat_id"][tri], 0)
    out = dict(hits, normal=torch.where(hit[:, None], vm.normalize(n), 0.0),
               position=origins + hits["t"][:, None] * directions, mat_id=mid)
    for k in MATERIAL_KEYS:
        val = scene["materials"][k][mid]
        out[k] = torch.where(hit.reshape(-1, *[1] * (val.dim() - 1)), val, torch.zeros_like(val))
    return out


def trace_any_reference(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                        t_min=intersect.RAY_EPSILON, t_max=intersect.RAY_MAX_T) -> torch.Tensor:
    """Plain version of ``trace_any``: ``intersect.intersect_any``."""
    return intersect.intersect_any(scene, origins, directions, t_min, t_max)


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from ..utils.cuda_build import load_library

        lib = load_library("intersect_brute", ["intersect_brute.cu"])
        window = [ctypes.c_void_p] * 4 + [ctypes.c_float] * 2
        lib.dxr_intersect_closest.argtypes = (
            window + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4)
        lib.dxr_intersect_closest.restype = ctypes.c_int
        lib.dxr_intersect_any.argtypes = (
            window + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        lib.dxr_intersect_any.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _window(x, r: int, device) -> tuple[torch.Tensor | None, float]:
    """A ray window for the kernel: (per-ray float32 [r] tensor, 0.0) or
    (None, the scalar). A scalar never becomes a device tensor, and a 0-d
    device tensor is broadcast on the card, not read back."""
    if not isinstance(x, torch.Tensor) or (x.dim() == 0 and x.device.type == "cpu"):
        return None, float(x)
    if x.dim() == 0:
        x = x.expand(r)
    if tuple(x.shape) != (r,) or x.device != device:
        raise ValueError(f"a per-ray window must be [{r}] on {device}, got "
                         f"{tuple(x.shape)} on {x.device}")
    return x.to(torch.float32).contiguous(), 0.0


def _rays(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"{name}: expected [R, 3], got {tuple(x.shape)}")
    return x.to(torch.float32).contiguous()


def _packs(scene: dict, device, attr: bool) -> tuple[torch.Tensor, ...]:
    """The scene's mt_pack [4, T, 16] (and attr_pack [32, T]), checked."""
    mt = scene["mt_pack"]
    t_pad = int(mt.shape[1])
    packs = [("mt_pack", mt, (4, t_pad, 16))]
    if attr:
        packs.append(("attr_pack", scene["attr_pack"], (32, t_pad)))
    for name, t, shape in packs:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if tuple(t.shape) != shape or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 {shape} tensor on {device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    return tuple(p[1] for p in packs)


def prepare_launch(scene, origins, directions, t_min, t_max, cull: bool, occlusion: bool):
    """Check the inputs and allocate the outputs of one B3 launch. Returns
    (launch, outs): ``launch()`` enqueues the kernel and returns the CUDA
    error code; outs is (occ,) or (scalars [7, R], vectors [5, R, 3], ids
    [3, R]). Timing
    ``launch`` alone measures the kernel without the wrapper's checks and
    allocations."""
    device = origins.device
    o, d = _rays(origins, "origins"), _rays(directions, "directions")
    r = o.shape[0]
    if d.shape[0] != r or d.device != device:
        raise ValueError("origins and directions must be [R, 3] on one device")
    (tmin_t, tmin_s), (tmax_t, tmax_s) = _window(t_min, r, device), _window(t_max, r, device)
    packs = _packs(scene, device, not occlusion)
    t_pad = int(packs[0].shape[1])
    t_count = min(int(scene.get("num_tris", t_pad)), t_pad)  # padding never hits
    lib = _library()
    rays = (o, d, tmin_t, tmax_t)  # held by launch(): a timed relaunch reads them again
    if occlusion:
        outs = (torch.empty(r, dtype=torch.bool, device=device),)
        fn, tail = lib.dxr_intersect_any, (r, t_pad, t_count)
    else:
        outs = (torch.empty((len(SCALARS), r), dtype=torch.float32, device=device),
                torch.empty((len(VECTORS), r, 3), dtype=torch.float32, device=device),
                torch.empty((len(IDS), r), dtype=torch.int64, device=device))
        fn, tail = lib.dxr_intersect_closest, (r, t_pad, t_count, int(cull))

    def launch() -> int:
        with torch.cuda.device(device):
            return fn(*(x.data_ptr() if x is not None else None for x in rays), tmin_s, tmax_s,
                      *(p.data_ptr() for p in packs), *tail, *(x.data_ptr() for x in outs),
                      torch.cuda.current_stream(device).cuda_stream)

    return launch, outs


def _launch(scene, origins, directions, t_min, t_max, cull: bool, occlusion: bool):
    global CLOSEST_LAUNCHES, ANY_LAUNCHES
    launch, outs = prepare_launch(scene, origins, directions, t_min, t_max, cull, occlusion)
    if origins.shape[0]:  # no rays, no launch
        rc = launch()
        if rc != 0:
            raise RuntimeError(f"intersect_brute kernel launch failed: cudaError {rc}")
        if occlusion:
            ANY_LAUNCHES += 1
        else:
            CLOSEST_LAUNCHES += 1
    if occlusion:
        return outs[0]
    res = {k: x for names, block in zip((SCALARS, VECTORS, IDS), outs)
           for k, x in zip(names, block)}
    res["hit"] = res["tri"] >= 0
    return res


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def trace_closest(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
                  t_min=intersect.RAY_EPSILON, t_max=intersect.RAY_MAX_T,
                  cull_backface: bool = False) -> dict:
    """Closest hit of rays [R, 3] against every triangle of a brute-force
    scene, attributes fused: {"hit" [R] bool, "t" (-1 on a miss), "tri"
    int64 (-1), "u", "v", "normal" [R, 3], "position" [R, 3], "mat_id"
    int64, and the material fields (albedo, specular, emissive [R, 3];
    emissive_strength, reflectivity, roughness, ior [R]; type int64)}.
    t_min/t_max: Python scalars or [R] tensors. CUDA rays -> one launch of
    B3a; CPU rays -> the plain version."""
    if _on_cuda(origins):
        return _launch(scene, origins, directions, t_min, t_max, cull_backface, False)
    return trace_closest_reference(scene, origins, directions, t_min, t_max, cull_backface)


def trace_any(scene: dict, origins: torch.Tensor, directions: torch.Tensor,
              t_min=intersect.RAY_EPSILON, t_max=intersect.RAY_MAX_T) -> torch.Tensor:
    """Occlusion of rays [R, 3]: [R] bool, True where a triangle blocks
    (t_min, t_max); no culling. A zero direction is never occluded. CUDA
    rays -> one launch of B3b; CPU rays -> the plain version."""
    if _on_cuda(origins):
        return _launch(scene, origins, directions, t_min, t_max, False, True)
    return trace_any_reference(scene, origins, directions, t_min, t_max)
