"""Wavefront integrator, the plain PyTorch twin of
``dxrexperiments_tpu.trace.integrator`` (brute-force progressive route).

The reference's ray recursion is bounded, so each progressive sample is a
fixed tree, traced over dense [N]-ray batches:

    primary closest-hit (backfaces culled)
      +- directional and point shadow rays      (any-hit)
      +- indirect-diffuse bounce ray            (closest)
      |    +- 2 shadow rays at depth 1
      +- Phong-lobe specular bounce ray         (closest)
           +- 2 shadow rays at depth 1

RNG parity: each shade invocation re-seeds from the pixel hash, so depth-1
draws alias depth-0 draws, and seeds advance only where the reference
consumes draws inside branches (debug==2 light pick, noIndirectDiffuse).

This module is the plain version of the CUDA megakernel
(``ops/fused_sample.py``). Realtime mode, ambient occlusion, refraction and
the BVH routes wait for later ROADMAP Queue A items and raise.
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..core import vecmath as vm
from ..core.camera import primary_ray_grid
from ..ops import intersect
from ..scene.envmap import sample_environment
from ..scene.lights import normalize_lights
from ..scene.scene import to_device
from . import sampling

RAY_EPSILON = intersect.RAY_EPSILON
RAY_MAX_T = intersect.RAY_MAX_T
M_PI = math.pi


def default_options(**overrides) -> dict:
    """Per-frame debug options (the reference's DebugOptions and pipeline
    defaults), as Python scalars."""
    opts = {
        "max_iterations": 1024,
        "cosine_hemisphere_sampling": True,
        "show_indirect_diffuse_only": False,
        "show_indirect_specular_only": False,
        "show_gbuffer_albedo_only": False,
        "show_direct_lighting_only": False,
        "show_fresnel_term": False,
        "no_indirect_diffuse": False,
        "debug": 0,
    }
    for k, v in overrides.items():
        opts[k] = type(opts[k])(v) if k in opts else v
    return opts


def resolve_impl(impl: str, device) -> str:
    """'auto' -> 'cuda' (the kernels) for a CUDA device, 'torch' (the plain
    path) for a CPU device. Never switches devices."""
    if impl == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown impl {impl!r} (auto, cuda or torch)")
    return impl


def _check_brute(scene: dict, impl: str) -> None:
    if "bvh" in scene or "tlas" in scene:
        raise NotImplementedError("BVH scenes are not ported yet (ROADMAP Queue A item 11)")
    if impl == "cuda":
        raise NotImplementedError(
            "the wavefront route has no CUDA kernel yet (kernel B3, ROADMAP "
            "Queue A item 10); use impl='torch' or a scene the fused kernel takes"
        )


def _trace_closest(scene, origins, directions, t_min, t_max, cull, impl: str):
    """Closest hit + hit attributes. Returns (hit, position, normal, mat)."""
    _check_brute(scene, impl)
    hits = intersect.intersect_closest(
        scene, origins, directions, t_min, t_max, cull_backface=cull
    )
    position, normal, mat = _interpolate_hit(scene, hits, origins, directions)
    return hits["hit"], position, normal, mat


def _trace_any(scene, origins, directions, t_min, t_max, impl: str):
    _check_brute(scene, impl)
    return intersect.intersect_any(scene, origins, directions, t_min, t_max)


def _interpolate_hit(scene: dict, hits: dict, origins, directions):
    """Barycentric normal, hit position and the material rows, gathered by
    triangle and material index."""
    tri = torch.clamp(hits["tri"], min=0)
    u, v = hits["u"], hits["v"]
    w = 1.0 - u - v
    n = (
        w[..., None] * scene["n0"][tri]
        + u[..., None] * scene["n1"][tri]
        + v[..., None] * scene["n2"][tri]
    )
    normal = vm.normalize(n)
    position = origins + hits["t"][..., None] * directions
    mid = scene["mat_id"][tri]
    mat = {k: val[mid] for k, val in scene["materials"].items()}
    return position, normal, mat


def _direct_lighting(scene, options, position, normal, seed, active, impl):
    """Direct term over D directional + P point lights (stacked rig), with
    the debug==2 one-of-L MC estimator. All shadow rays go through one
    any-hit call. Returns (seed, direct [N,3])."""
    lights = normalize_lights(scene["lights"])
    dl, pl_ = lights["dir"], lights["point"]
    d_count = int(dl["forward"].shape[0])
    p_count = int(pl_["position"].shape[0])
    l_count = d_count + p_count
    n = position.shape[0]
    if l_count == 0:
        return seed, torch.zeros_like(position)

    seed_mc, pick = rng.next_rand(seed)
    is_mc = int(options["debug"]) == 2
    # The reference consumes the picking draw only when debug==2.
    seed_out = seed_mc if is_mc else seed

    dirs, t_maxs = [], []
    dev = position.device
    if d_count:
        l_dir = vm.normalize(-dl["forward"])[:, None, :].expand(d_count, n, 3)
        dirs.append(l_dir)
        t_maxs.append(torch.full((d_count, n), RAY_MAX_T, dtype=torch.float32, device=dev))
    if p_count:
        path = pl_["position"][:, None, :] - position[None]  # [P, N, 3]
        dist = vm.length(path)
        dirs.append(vm.normalize(path))
        t_maxs.append(torch.clamp(dist - RAY_EPSILON, min=RAY_EPSILON))

    r_count = d_count + p_count
    all_dirs = torch.cat(dirs).reshape(r_count * n, 3)
    all_tmax = torch.cat(t_maxs).reshape(r_count * n)
    act = active[None].expand(r_count, n).reshape(-1, 1)
    all_dirs = torch.where(act, all_dirs, torch.zeros_like(all_dirs))
    occ = _trace_any(
        scene,
        position[None].expand(r_count, n, 3).reshape(-1, 3),
        all_dirs,
        RAY_EPSILON,
        all_tmax,
        impl,
    ).reshape(r_count, n)
    vis = (active[None] & ~occ).to(torch.float32)

    contribs = []
    if d_count:
        nol = vm.saturate(vm.dot(normal[None], dirs[0]))
        contribs.append(
            (dl["color"] * dl["intensity"][:, None])[:, None, :]
            * (nol * vis[:d_count])[..., None]
        )
    if p_count:
        l_pnt = dirs[1 if d_count else 0]
        nol = vm.saturate(vm.dot(normal[None], l_pnt))
        falloff = 1.0 / (2.0 * M_PI * torch.clamp(dist * dist, min=1e-12))
        contribs.append(
            (pl_["color"] * pl_["intensity"][:, None])[:, None, :]
            * (nol * vis[d_count:] * falloff)[..., None]
        )
    per_light = torch.cat(contribs)  # [L, N, 3]
    if not is_mc:
        return seed_out, per_light.sum(dim=0)
    idx = torch.clamp((pick * l_count).to(torch.int64), max=l_count - 1)
    mc = per_light.gather(0, idx[None, :, None].expand(1, n, 3))[0] * float(l_count)
    return seed_out, mc


def _secondary_radiance(scene, options, origins, directions, seeds, active, impl, env_kind):
    """Depth-1 radiance: closest hit, direct lighting and emissive (the
    specular and indirect terms are cut by the recursion depth). Inactive
    lanes get an empty ray interval and contribute 0."""
    t_max_eff = torch.where(
        active,
        torch.full_like(active, RAY_MAX_T, dtype=torch.float32),
        torch.zeros_like(active, dtype=torch.float32),
    )
    is_hit, position, normal, mat = _trace_closest(
        scene, origins, directions, RAY_EPSILON, t_max_eff, cull=False, impl=impl
    )
    hit = is_hit & active
    env_col = sample_environment(scene["env"], directions, env_kind)
    env_term = torch.where(active[..., None], env_col, torch.zeros_like(env_col))
    _, direct = _direct_lighting(scene, options, position, normal, seeds, hit, impl)
    shade_col = (
        mat["emissive"] * mat["emissive_strength"][..., None]
        + mat["albedo"] * direct / M_PI
    )
    return torch.where(hit[..., None], shade_col, env_term)


def trace_rays(
    scene: dict,
    options: dict,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seeds: torch.Tensor,
    mode: str = "progressive",
    ao_only: bool = False,
    impl: str = "torch",
    env_kind: int | None = None,
    refraction: bool = False,
) -> dict:
    """Trace one progressive sample for a dense batch of primary rays.

    origins/directions: [N, 3]; seeds: [N] int64 pixel hashes. Returns
    {"color": [N, 3]}."""
    if mode != "progressive":
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet (realtime: ROADMAP Queue A item 8)"
        )
    if ao_only or refraction:
        raise NotImplementedError(
            "ao_only and refraction are not ported yet (ROADMAP Queue A item 10)"
        )
    if env_kind is None:
        env_kind = scene["env"]["kind"]
    # lights and env arrive as host tensors (per-frame parameters)
    dev = origins.device
    scene = dict(scene, lights=to_device(scene["lights"], dev), env=to_device(scene["env"], dev))

    hit, position, normal, mat = _trace_closest(
        scene, origins, directions, 0.0, RAY_MAX_T, cull=True, impl=impl
    )
    env_col = sample_environment(scene["env"], directions, env_kind)

    seed = seeds  # initRand restart per shade invocation
    seed, direct = _direct_lighting(scene, options, position, normal, seed, hit, impl)

    # ---- indirect diffuse direction (depth 0 only) ----------------------
    seed_drawn, r0, r1 = rng.next_rand2(seed)
    cosine = bool(options["cosine_hemisphere_sampling"])
    tangent, bitangent = vm.orthonormal_basis(normal)
    phi = 2.0 * M_PI * r1
    if cosine:
        rr = torch.sqrt(r0)
        sample_dir = (
            (rr * torch.cos(phi))[..., None] * tangent
            + torch.sqrt(torch.clamp(1.0 - r0, min=0.0))[..., None] * normal
            + (rr * torch.sin(phi))[..., None] * bitangent
        )
    else:
        sin_t = torch.sqrt(torch.clamp(1.0 - r0 * r0, min=0.0))
        sample_dir = (
            (sin_t * torch.cos(phi))[..., None] * tangent
            + r0[..., None] * normal
            + (sin_t * torch.sin(phi))[..., None] * bitangent
        )
    no_ind = bool(options["no_indirect_diffuse"])
    # The reference consumes the 2 draws only when indirect diffuse runs.
    seed = seed if no_ind else seed_drawn

    # ---- indirect specular direction (Phong lobe) -----------------------
    mtype = mat["type"]
    spec_active = hit & ((mtype == 1) | (mtype == 2)) & (mat["reflectivity"] > 0.001)
    exponent = torch.exp((1.0 - mat["roughness"]) * 12.0)
    mirror = vm.normalize(vm.reflect(directions, normal))
    seed, phong_dir, pdf, brdf = sampling.phong_lobe_sample(seed, mirror, exponent)

    # ---- one batched secondary trace for both bounce rays ---------------
    n = position.shape[0]
    sec_both = _secondary_radiance(
        scene,
        options,
        torch.cat([position, position]),
        torch.cat([sample_dir, phong_dir]),
        torch.cat([seeds, seeds]),
        torch.cat([hit, spec_active]),
        impl,
        env_kind,
    )
    sec = sec_both[:n]
    spec_rad = sec_both[n:]
    nol = vm.saturate(vm.dot(normal, sample_dir))
    # cosine: the pdf cancels -> L * pi; uniform: L * NoL * 2pi
    contrib = sec * M_PI if cosine else sec * (nol * 2.0 * M_PI)[..., None]
    indirect = torch.zeros_like(contrib) if no_ind else contrib

    # brdf/pdf = (e+2)/(e+1) analytically; guard the 0/0 underflow.
    ratio = torch.where(
        pdf > 1e-30, brdf / torch.clamp(pdf, min=1e-30), (exponent + 2.0) / (exponent + 1.0)
    )
    zero3 = torch.zeros_like(spec_rad)
    specular = torch.where(spec_active[..., None], spec_rad * ratio[..., None], zero3)
    fresnel = sampling.fresnel_schlick(directions, normal, mat["specular"])
    fresnel = torch.where(spec_active[..., None], fresnel, zero3)

    diffuse_comp = (direct + indirect) / M_PI
    refl = mat["reflectivity"][..., None]
    emissive = mat["emissive"] * mat["emissive_strength"][..., None]
    color = emissive + mat["albedo"] * diffuse_comp + refl * specular * fresnel

    # ---- debug AOV selection at depth 0 ---------------------------------
    if options["show_direct_lighting_only"]:
        color = mat["albedo"] * direct / M_PI
    if options["show_gbuffer_albedo_only"]:
        color = mat["albedo"]
    if options["show_fresnel_term"]:
        color = fresnel
    if options["show_indirect_specular_only"]:
        color = refl * specular * fresnel
    if options["show_indirect_diffuse_only"]:
        color = mat["albedo"] * indirect / M_PI
    color = torch.where(hit[..., None], color, env_col)
    return {"color": _sanitize(color)}


def _sanitize(color: torch.Tensor) -> torch.Tensor:
    """max(c, 0) with HLSL NaN semantics (NaN -> 0)."""
    return torch.where(torch.isnan(color), torch.zeros_like(color), torch.clamp(color, min=0.0))


def render_sample(
    scene: dict,
    options: dict,
    camera: dict,
    width: int,
    height: int,
    mode: str = "progressive",
    ao_only: bool = False,
    jitter_scale: float = 30.0,
    impl: str = "torch",
    env_kind: int | None = None,
) -> dict:
    """Render one sample for the full [H, W] grid on the scene's device.
    Returns {"color": [H, W, 3]}."""
    camera = to_device(camera, scene["mt_pack"].device)
    origins, directions = primary_ray_grid(camera, width, height, jitter_scale)
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    seeds = rng.pixel_seeds(width, height, camera["frame_count"], device=o.device).reshape(-1)
    out = trace_rays(
        scene, options, o, d, seeds, mode=mode, ao_only=ao_only, impl=impl, env_kind=env_kind
    )
    return {k: v.reshape(height, width, v.shape[-1]) for k, v in out.items()}
