"""Wavefront integrator, the PyTorch twin of
``dxrexperiments_tpu.trace.integrator`` (progressive and realtime modes, the
AO view and the opt-in refraction bounce).

The reference's ray recursion is bounded, so each sample is a fixed tree,
traced over dense [N]-ray batches:

    primary closest-hit (backfaces culled)
      +- directional and point shadow rays      (any-hit)
      +- indirect-diffuse bounce ray            (closest; progressive only)
      |    +- 2 shadow rays at depth 1
      +- Phong-lobe specular bounce ray         (closest)
           +- 2 shadow rays at depth 1

RNG parity: each shade invocation re-seeds from the pixel hash, so depth-1
draws alias depth-0 draws, and seeds advance only where the reference
consumes draws inside branches (debug==2 light pick, noIndirectDiffuse).

This module is the plain version of the CUDA megakernels
(``ops/fused_sample.py``, ``ops/fused_traverse.py``), and the route of every
scene and option they do not take. Each trace stage is one launch of a
trace kernel with impl='cuda', or its plain version with impl='torch': on a
brute-force scene ``ops/intersect_kernel.py`` (kernel B3, the hit
attributes fused in the kernel); on a BVH scene ``ops/traverse.py`` (kernel
B4a, or B4b for a BVH without fat nodes; their plain version is the
brute-force sweep over the same triangles); on a two-level (TLAS/BLAS)
scene ``ops/traverse2.py`` (kernel B6a, or B6b for a TLAS without fat
nodes; their plain version tests every instance's triangles in object
space, and the hit attributes come from the object-space normals, the
instance's normal matrix and its material override). ``walk_functions``
makes the choice, keyed as the JAX integrator keys it.

Lights: any number of directional, point and area lights; every shadow ray
of a shading point, the area lights' AREA_LIGHT_SAMPLES each, goes through
one any-hit launch.

Albedo textures (a scene with ``textures``): each closest hit's albedo is
multiplied by ``scene.textures.sample_albedo`` at the hit's UV, the
barycentric mix of its triangle's corner UVs, on all three routes. As in
the JAX package, this is glue after the trace kernels, not a kernel.

Two opt-ins, both off by default as in the JAX package, change only the
work of a walk, never its result:

  * PRIME seeding (``DXR_PRIME=1`` in the environment, read at each call):
    the bounce closest trace of a scene with a PRIME table gets a per-ray
    t_max clamped to a conservative hit on the scene's few dominating
    triangles (``_prime_seed_tmax``);
  * ray sorting (``sort_rays`` of ``_trace_closest`` / ``_trace_any``,
    ``sort_shadows`` of ``_direct_lighting``): a BVH scene's kernel walk
    (B4a, B4b) takes its rays in (direction octant, origin Morton cell)
    order and scatters the results back (``_sorted_trace``).

Spans (``utils/profiling.annotate``; ``n`` the work covered, none of them
synchronises or reads a device tensor): ``wavefront.sample`` around
``render_sample`` (n: the sample's primary rays) holds
``wavefront.upload`` around each copy of per-call host parameters to the
rays' device (the camera, the frame count in ``core/rng.pixel_seeds``, the
lights and the env; n: the bytes copied), ``wavefront.trace`` around each
``_trace_closest`` / ``_trace_any`` call (n: the rays passed; it holds the
trace kernel's launch span, ``B6a.launch`` on a two-level scene) and
``wavefront.shade`` around each bounce's shading after its closest trace
(n: the rays of the bounce's batch, live or not: which of them hit lies on
the device), which holds that bounce's shadow traces and the next bounce.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..accel import tlas as tlas_mod
from ..core import rng
from ..core import vecmath as vm
from ..core.camera import primary_ray_grid
from ..ops import intersect, intersect_kernel, traverse, traverse2
from ..scene.envmap import on_device, sample_environment
from ..scene.lights import AREA_LIGHT_SAMPLES, area_light_draws, normalize_lights
from ..scene.textures import sample_albedo
from ..scene.scene import scene_device, to_device
from ..utils.profiling import annotate
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


def walk_functions(scene: dict, impl: str) -> tuple:
    """(closest, any) trace functions of a two-level or BVH scene's route:
    with impl='cuda' the fat walks B6a / B4a where the scene's TLAS or BVH
    carries fat nodes (``"tlasf_nodes" in scene["tlas"]``, ``"bvhf_nodes" in
    scene["bvh"]``: the entries the JAX integrator keys on), else the binary
    walks B6b / B4b; with impl='torch' the plain versions."""
    if "tlas" in scene:
        if impl != "cuda":
            return tlas_mod.two_level_closest_reference, tlas_mod.two_level_any_reference
        if "tlasf_nodes" in scene["tlas"]:
            return traverse2.traverse2_fat_closest, traverse2.traverse2_fat_any
        return traverse2.traverse2_closest, traverse2.traverse2_any
    if impl != "cuda":
        return traverse.traverse_fat_closest_reference, traverse.traverse_fat_any_reference
    if "bvhf_nodes" in scene["bvh"]:
        return traverse.traverse_fat_closest, traverse.traverse_fat_any
    return traverse.traverse_closest, traverse.traverse_any


def _ray_sort_order(scene: dict, origins: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """The ray order of a sorted BVH walk: a stable argsort of the key
    ``octant << 12 | morton``, the direction's sign octant (3 bits) major and
    the 12-bit Morton code of the origin's cell in a 16^3 grid over the root
    box (``bvh_nodes`` rows 0:3 and 3:6 of column 0) minor. The stable sort
    keeps the launch order within a cell, so the permutation equals the JAX
    package's. The root box is read on the host, so no device value waits."""
    bvhn = scene["bvh"]["bvh_nodes"]
    lo = np.asarray(bvhn[0:3, 0].tolist(), np.float32)
    ext = np.maximum(np.asarray(bvhn[3:6, 0].tolist(), np.float32) - lo, np.float32(1e-6))
    cell = torch.stack([
        torch.clamp((torch.clamp((origins[:, k] - float(lo[k])) / float(ext[k]), 0.0, 1.0)
                     * 16.0).to(torch.int64), max=15)
        for k in range(3)], dim=1)

    def part(x):
        x = (x | (x << 4)) & 0x0F0F
        x = (x | (x << 2)) & 0x3333
        x = (x | (x << 1)) & 0x5555
        return x

    morton = (part(cell[:, 0]) << 2) | (part(cell[:, 1]) << 1) | part(cell[:, 2])
    neg = (directions < 0).to(torch.int64)
    octant = neg[:, 0] * 4 + neg[:, 1] * 2 + neg[:, 2]
    return torch.argsort((octant << 12) | morton, stable=True)


def _bytes_off(tree, device) -> int:
    """Bytes of the tensors of a nested dict/list that lie off ``device``:
    what ``to_device`` copies there (shapes only, no device read)."""
    if isinstance(tree, torch.Tensor):
        return 0 if tree.device == device else tree.nbytes
    if isinstance(tree, dict):
        return sum(_bytes_off(v, device) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes_off(v, device) for v in tree)
    return 0


def _sorted_trace(scene: dict, walk, origins, directions, t_min, t_max, **kw):
    """``walk(scene, o, d, t_min, t_max, **kw)`` over the rays in
    ``_ray_sort_order``: origins, directions and per-ray windows gathered,
    the walk's outputs (a hit dict's every field, or the occlusion flags)
    scattered back to the launch order. The scatter of the gathered origins
    and directions is the caller's tensors themselves."""
    order = _ray_sort_order(scene, origins, directions)

    def gather(x):
        return x[order] if isinstance(x, torch.Tensor) and x.dim() else x

    out = walk(scene, origins[order], directions[order], gather(t_min), gather(t_max), **kw)

    def scatter(v):
        back = torch.empty_like(v)
        back[order] = v
        return back

    return {k: scatter(v) for k, v in out.items()} if isinstance(out, dict) else scatter(out)


def _trace_closest(scene, origins, directions, t_min, t_max, cull, impl: str,
                   sort_rays: bool = False):
    """Closest hit + hit attributes. Returns (hit, position, normal, mat).

    sort_rays: a BVH scene's kernel walk (impl='cuda') takes the rays in
    ``_ray_sort_order`` and its hits are scattered back; the other routes
    ignore it, as the JAX package's jnp path does."""
    with annotate("wavefront.trace", int(origins.shape[0])):
        if "tlas" in scene:
            fn = walk_functions(scene, impl)[0]
            hits = fn(scene, origins, directions, t_min, t_max, cull_backface=cull)
            position, normal, mat = _interpolate_hit_two_level(scene, hits, origins, directions)
            return hits["hit"], position, normal, mat
        if "bvh" not in scene:  # brute force: the attributes come with the hit
            fn = (intersect_kernel.trace_closest if impl == "cuda"
                  else intersect_kernel.trace_closest_reference)
            h = fn(scene, origins, directions, t_min, t_max, cull_backface=cull)
            mat = {k: h[k] for k in intersect_kernel.MATERIAL_KEYS}
            if "textures" in scene:
                tri = torch.clamp(h["tri"], min=0)
                _modulate_albedo(scene, mat, scene["mat_id"][tri], tri, h["u"], h["v"], "")
            return h["hit"], h["position"], h["normal"], mat
        fn = walk_functions(scene, impl)[0]
        if sort_rays and impl == "cuda":
            hits = _sorted_trace(scene, fn, origins, directions, t_min, t_max,
                                 cull_backface=cull)
        else:
            hits = fn(scene, origins, directions, t_min, t_max, cull_backface=cull)
        position, normal, mat = _interpolate_hit(scene, hits, origins, directions)
        return hits["hit"], position, normal, mat


def _trace_any(scene, origins, directions, t_min, t_max, impl: str, sort_rays: bool = False):
    """Occlusion [N] bool. sort_rays: as in ``_trace_closest``."""
    with annotate("wavefront.trace", int(origins.shape[0])):
        if "tlas" in scene or "bvh" in scene:
            fn = walk_functions(scene, impl)[1]
            if sort_rays and impl == "cuda" and "tlas" not in scene:
                return _sorted_trace(scene, fn, origins, directions, t_min, t_max)
        else:
            fn = (intersect_kernel.trace_any if impl == "cuda"
                  else intersect_kernel.trace_any_reference)
        return fn(scene, origins, directions, t_min, t_max)


def _modulate_albedo(scene: dict, mat: dict, mid, tri, u, v, suffix: str) -> None:
    """mat["albedo"] times the albedo texture at the hit's UV: the
    barycentric mix of triangle ``tri``'s corner UVs (``uv0{suffix}`` ...)."""
    w = 1.0 - u - v
    uv = (w[..., None] * scene[f"uv0{suffix}"][tri] + u[..., None] * scene[f"uv1{suffix}"][tri]
          + v[..., None] * scene[f"uv2{suffix}"][tri])
    mat["albedo"] = mat["albedo"] * sample_albedo(scene["textures"], mid, uv)


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
    if "textures" in scene:
        _modulate_albedo(scene, mat, mid, tri, u, v, "")
    return position, normal, mat


def _interpolate_hit_two_level(scene: dict, hits: dict, origins, directions):
    """Two-level hits: the barycentric normal of the object-space vertex
    normals, taken to world space by the instance's normal matrix
    (inv(R)^T) and normalised; the material id of the mesh unless the
    instance overrides it."""
    tri = torch.clamp(hits["tri"], min=0)
    inst = torch.clamp(hits["inst"], min=0)
    u, v = hits["u"], hits["v"]
    w = 1.0 - u - v
    n_obj = (
        w[..., None] * scene["n0_obj"][tri]
        + u[..., None] * scene["n1_obj"][tri]
        + v[..., None] * scene["n2_obj"][tri]
    )
    nm = scene["tlas"]["inst_nm"][inst]  # [N, 3, 3]
    normal = vm.normalize((nm * n_obj[:, None, :]).sum(-1))
    position = origins + hits["t"][..., None] * directions
    override = scene["tlas"]["inst_mat_override"][inst].to(torch.int64)
    mid = torch.where(override >= 0, override, scene["mat_id_obj"][tri])
    mat = {k: val[mid] for k, val in scene["materials"].items()}
    if "textures" in scene:
        _modulate_albedo(scene, mat, mid, tri, u, v, "_obj")
    return position, normal, mat


def _direct_lighting(scene, options, position, normal, seed, active, impl,
                     sort_shadows: bool = False):
    """Direct term over D directional + P point + A area lights (stacked
    rig), with the debug==2 one-of-L MC estimator. Each area light draws
    AREA_LIGHT_SAMPLES points from a seed chain of its own and estimates
    L * area * mean_j(NoL * |cos at the light| / dist_j^2 * vis_j). All
    shadow rays go through one any-hit call (sorted with sort_shadows, see
    ``_trace_any``). Returns (seed, direct [N,3])."""
    lights = normalize_lights(scene["lights"])
    dl, pl_, al = lights["dir"], lights["point"], lights["area"]
    d_count = int(dl["forward"].shape[0])
    p_count = int(pl_["position"].shape[0])
    a_count = int(al["corner"].shape[0])
    l_count = d_count + p_count + a_count
    n = position.shape[0]
    if l_count == 0:
        return seed, torch.zeros_like(position)

    seed_mc, pick = rng.next_rand(seed)
    is_mc = int(options["debug"]) == 2
    # The reference consumes the picking draw only when debug==2.
    seed_out = seed_mc if is_mc else seed

    dirs, t_maxs, a_dist2 = [], [], []
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
    if a_count:
        for r0, r1 in area_light_draws(seed):
            p_l = (al["corner"][:, None, :] + r0[None, :, None] * al["eu"][:, None, :]
                   + r1[None, :, None] * al["ev"][:, None, :])  # [A, N, 3]
            apath = p_l - position[None]
            adist = vm.length(apath)
            dirs.append(vm.normalize(apath))
            t_maxs.append(torch.clamp(adist - RAY_EPSILON, min=RAY_EPSILON))
            a_dist2.append(torch.clamp(adist * adist, min=1e-12))

    r_count = d_count + p_count + a_count * AREA_LIGHT_SAMPLES
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
        sort_rays=sort_shadows,
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
            * (nol * vis[d_count:d_count + p_count] * falloff)[..., None]
        )
    if a_count:
        cross = vm.cross(al["eu"], al["ev"])  # [A, 3]
        quad_area = vm.length(cross)
        n_l = cross / torch.clamp(quad_area, min=1e-12)[:, None]
        base = d_count + p_count
        first = (1 if d_count else 0) + (1 if p_count else 0)
        geo = torch.zeros((a_count, n), dtype=torch.float32, device=dev)
        for j in range(AREA_LIGHT_SAMPLES):
            wi = dirs[first + j]
            nol = vm.saturate(vm.dot(normal[None], wi))
            cos_l = torch.abs(vm.dot(n_l[:, None, :], wi))  # both faces emit
            geo = geo + (nol * cos_l / a_dist2[j]
                         * vis[base + j * a_count:base + (j + 1) * a_count])
        geo = geo * (quad_area / AREA_LIGHT_SAMPLES)[:, None]
        contribs.append((al["color"] * al["intensity"][:, None])[:, None, :] * geo[..., None])
    per_light = torch.cat(contribs)  # [L, N, 3]
    if not is_mc:
        return seed_out, per_light.sum(dim=0)
    idx = torch.clamp((pick * l_count).to(torch.int64), max=l_count - 1)
    mc = per_light.gather(0, idx[None, :, None].expand(1, n, 3))[0] * float(l_count)
    return seed_out, mc


def _ambient_occlusion(scene, options, position, normal, seed, active, impl):
    """4-ray ambient occlusion (the reference's evaluateAO): cosine or
    uniform hemisphere rays of length 10, each visible ray weighted by
    NoL / pdf. Returns [N]."""
    visibility = torch.zeros(position.shape[:-1], dtype=torch.float32, device=position.device)
    cosine = bool(options["cosine_hemisphere_sampling"])
    opts = dict(options, no_indirect_diffuse=False)  # AO always consumes its two draws
    for _ in range(4):
        seed, sample_dir = _diffuse_direction(seed, normal, opts)
        nol = vm.saturate(vm.dot(normal, sample_dir))
        pdf = nol / M_PI if cosine else torch.full_like(nol, 1.0 / (2.0 * M_PI))
        traced_dir = torch.where(active[..., None], sample_dir, torch.zeros_like(sample_dir))
        occluded = _trace_any(scene, position, traced_dir, RAY_EPSILON, 10.0, impl)
        vis = (active & ~occluded).to(torch.float32)
        visibility = visibility + vis * nol / torch.clamp(pdf, min=1e-8)
    return visibility / 4.0


def _prime_seed_tmax(scene: dict, origins: torch.Tensor, directions: torch.Tensor, t_max):
    """Per-ray t_max clamped by a conservative pre-test against the scene's
    PRIME triangles (``scene.select_prime_triangles``: the few dominating
    floors and walls): a bounce ray's nearest large occluder is most often
    the floor, and a far clamp at its distance lets the walk prune what lies
    beyond from its first visit on.

    The clamp only tightens t_max to the distance of a hit that the walk
    will also find, with margins against float32 evaluation-order
    differences: a hit counts only with barycentrics at least 1e-3 inside
    the triangle and t at least twice the bounce trace's t_min, and the
    clamp is inflated by 0.1% + 1e-4. Borderline rays get no seed. Plain
    torch, as the JAX function is plain jnp."""
    pv0 = scene["prime_v0"][None, :, :]  # [1, m, 3]
    pe1 = scene["prime_e1"][None, :, :]
    pe2 = scene["prime_e2"][None, :, :]
    o = origins[:, None, :]  # [n, 1, 3]
    d = directions[:, None, :]
    pvec = vm.cross(d, pe2)
    det = vm.dot(pe1, pvec)  # [n, m]
    safe = det.abs() > 1e-12
    inv_det = 1.0 / torch.where(safe, det, torch.ones_like(det))
    tvec = o - pv0
    u = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, pe1)
    v = vm.dot(d, qvec) * inv_det
    t = vm.dot(pe2, qvec) * inv_det
    delta = 1e-3  # interior margin: accept only hits robustly inside
    valid = (safe & (u >= delta) & (v >= delta) & (u + v <= 1.0 - delta)
             & (t >= 2.0 * RAY_EPSILON) & torch.isfinite(t))
    t_seed = torch.where(valid, t, torch.full_like(t, math.inf)).amin(dim=-1)  # [n]
    clamp = t_seed * 1.001 + 1e-4  # conservative inflation
    if not isinstance(t_max, torch.Tensor):
        t_max = torch.full_like(t_seed, float(t_max))
    return torch.where(torch.isfinite(t_seed), torch.minimum(t_max, clamp), t_max)


def _secondary_radiance(scene, options, origins, directions, seeds, active, impl, env_kind,
                        realtime: bool = False):
    """Depth-1 radiance: closest hit, direct lighting and, in progressive
    mode, emissive (the specular and indirect terms are cut by the recursion
    depth; the realtime shader adds no emissive term). Inactive lanes get an
    empty ray interval and contribute 0. With ``DXR_PRIME=1`` (read at each
    call) a scene with a PRIME table seeds the active lanes' t_max
    (``_prime_seed_tmax``); the hits are the same."""
    t_max_eff = torch.where(
        active,
        torch.full_like(active, RAY_MAX_T, dtype=torch.float32),
        torch.zeros_like(active, dtype=torch.float32),
    )
    if "prime_v0" in scene and os.environ.get("DXR_PRIME", "0") == "1":
        t_max_eff = _prime_seed_tmax(scene, origins, directions, t_max_eff)
    # sort_rays and sort_shadows stay off here: the JAX package measured both
    # negative on bounce rays
    is_hit, position, normal, mat = _trace_closest(
        scene, origins, directions, RAY_EPSILON, t_max_eff, cull=False, impl=impl
    )
    with annotate("wavefront.shade", int(origins.shape[0])):
        hit = is_hit & active
        env_col = sample_environment(scene["env"], directions, env_kind)
        env_term = torch.where(active[..., None], env_col, torch.zeros_like(env_col))
        _, direct = _direct_lighting(scene, options, position, normal, seeds, hit, impl,
                                     sort_shadows=False)
        shade_col = mat["albedo"] * direct / M_PI
        if not realtime:
            shade_col = mat["emissive"] * mat["emissive_strength"][..., None] + shade_col
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
    """Trace one sample for a dense batch of primary rays.

    origins/directions: [N, 3]; seeds: [N] int64 pixel hashes. mode:
    'progressive' returns {"color": [N, 3]}; 'realtime' (1 spp, no indirect
    diffuse, no debug views) returns "color", "direct", "indirect_specular",
    "albedo" [N, 3] and "roughness" [N]. ao_only: the AO view, {"color"}
    only, in either mode. refraction (progressive): glass (type 2) also
    traces a transmission bounce through vecmath.refract, weighted
    reflectivity * (1 - fresnel); lanes of total internal reflection add
    nothing."""
    if mode not in ("progressive", "realtime"):
        raise NotImplementedError(f"mode={mode!r} is unknown (progressive or realtime)")
    realtime = mode == "realtime"
    if env_kind is None:
        env_kind = scene["env"]["kind"]
    # lights and the env's scalars arrive as host tensors (per-frame
    # parameters); a texture env's textures already lie on the scene's device
    dev = origins.device
    with annotate("wavefront.upload", _bytes_off(scene["lights"], dev)
                  + _bytes_off(scene["env"], dev)):
        scene = dict(scene, lights=to_device(scene["lights"], dev),
                     env=on_device(scene["env"], dev))

    hit, position, normal, mat = _trace_closest(
        scene, origins, directions, 0.0, RAY_MAX_T, cull=True, impl=impl
    )
    with annotate("wavefront.shade", int(origins.shape[0])):
        return _shade_primary(scene, options, directions, seeds, hit, position, normal, mat,
                              realtime, ao_only, impl, env_kind, refraction)


def _shade_primary(scene, options, directions, seeds, hit, position, normal, mat,
                   realtime: bool, ao_only: bool, impl: str, env_kind: int,
                   refraction: bool) -> dict:
    """``trace_rays``' depth-0 shading of its primary hits: direct light,
    the bounce directions and their depth-1 radiance (or AO), the debug
    views; its output dict."""
    env_col = sample_environment(scene["env"], directions, env_kind)

    if ao_only:
        ao = _ambient_occlusion(scene, options, position, normal, seeds, hit, impl)
        return {"color": _sanitize(torch.where(hit[..., None], ao[..., None], env_col))}

    seed = seeds  # initRand restart per shade invocation
    seed, direct = _direct_lighting(scene, options, position, normal, seed, hit, impl)

    if not realtime:
        seed, sample_dir = _diffuse_direction(seed, normal, options)

    # ---- indirect specular direction (Phong lobe) -----------------------
    # Realtime mode draws no diffuse direction, so its Phong draws take the
    # no-diffuse slots whatever no_indirect_diffuse says.
    mtype = mat["type"]
    spec_active = hit & ((mtype == 1) | (mtype == 2)) & (mat["reflectivity"] > 0.001)
    exponent = torch.exp((1.0 - mat["roughness"]) * 12.0)
    mirror = vm.normalize(vm.reflect(directions, normal))
    seed, phong_dir, pdf, brdf = sampling.phong_lobe_sample(seed, mirror, exponent)

    if realtime:
        spec_rad = _secondary_radiance(
            scene, options, position, phong_dir, seeds, spec_active, impl, env_kind,
            realtime=True,
        )
    else:
        # ---- one batched secondary trace for the bounce rays ------------
        n = position.shape[0]
        dirs_list, act_list = [sample_dir, phong_dir], [hit, spec_active]
        if refraction:
            trans_dir, trans_ok = vm.refract(directions, normal, mat["ior"])
            trans_active = hit & (mtype == 2) & (mat["reflectivity"] > 0.001) & trans_ok
            dirs_list.append(trans_dir)
            act_list.append(trans_active)
        reps = len(dirs_list)
        sec_both = _secondary_radiance(
            scene,
            options,
            torch.cat([position] * reps),
            torch.cat(dirs_list),
            torch.cat([seeds] * reps),
            torch.cat(act_list),
            impl,
            env_kind,
        )
        sec = sec_both[:n]
        spec_rad = sec_both[n:2 * n]
        nol = vm.saturate(vm.dot(normal, sample_dir))
        # cosine: the pdf cancels -> L * pi; uniform: L * NoL * 2pi
        cosine = bool(options["cosine_hemisphere_sampling"])
        contrib = sec * M_PI if cosine else sec * (nol * 2.0 * M_PI)[..., None]
        indirect = torch.zeros_like(contrib) if options["no_indirect_diffuse"] else contrib

    # brdf/pdf = (e+2)/(e+1) analytically; guard the 0/0 underflow.
    ratio = torch.where(
        pdf > 1e-30, brdf / torch.clamp(pdf, min=1e-30), (exponent + 2.0) / (exponent + 1.0)
    )
    zero3 = torch.zeros_like(spec_rad)
    specular = torch.where(spec_active[..., None], spec_rad * ratio[..., None], zero3)
    fresnel = sampling.fresnel_schlick(directions, normal, mat["specular"])
    fresnel = torch.where(spec_active[..., None], fresnel, zero3)
    refl = mat["reflectivity"][..., None]

    if realtime:
        # The two AOVs of the realtime shader; a miss routes env into direct.
        direct_aov = mat["albedo"] * direct / M_PI
        spec_aov = refl * specular * fresnel
        hit3 = hit[..., None]
        return {
            "color": _sanitize(torch.where(hit3, direct_aov + spec_aov, env_col)),
            "direct": _sanitize(torch.where(hit3, direct_aov, env_col)),
            "indirect_specular": _sanitize(torch.where(hit3, spec_aov, zero3)),
            "albedo": torch.where(hit3, mat["albedo"], zero3),
            "roughness": torch.where(hit, mat["roughness"], torch.zeros_like(mat["roughness"])),
        }

    diffuse_comp = (direct + indirect) / M_PI
    emissive = mat["emissive"] * mat["emissive_strength"][..., None]
    color = emissive + mat["albedo"] * diffuse_comp + refl * specular * fresnel
    if refraction:
        # the transmission ray: pdf = brdf = 1, split against the reflection
        # by the same Schlick term
        transmitted = torch.where(trans_active[..., None], sec_both[2 * n:], zero3)
        color = color + refl * (1.0 - fresnel) * transmitted

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


def _diffuse_direction(seed, normal, options):
    """Indirect-diffuse bounce direction (progressive, depth 0 only):
    cosine or uniform hemisphere from two draws. The reference consumes the
    two draws only when indirect diffuse runs. Returns (seed, direction)."""
    seed_drawn, r0, r1 = rng.next_rand2(seed)
    tangent, bitangent = vm.orthonormal_basis(normal)
    phi = 2.0 * M_PI * r1
    if options["cosine_hemisphere_sampling"]:
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
    return (seed if options["no_indirect_diffuse"] else seed_drawn), sample_dir


def _sanitize(color: torch.Tensor) -> torch.Tensor:
    """max(c, 0) with HLSL NaN semantics (NaN -> 0)."""
    return torch.where(torch.isnan(color), torch.zeros_like(color), torch.clamp(color, min=0.0))


def progressive_sample_sum(
    scene: dict,
    options: dict,
    cameras: dict,
    width: int,
    height: int,
    env_kind: int,
    jitter_scale: float = 30.0,
    impl: str = "torch",
    ao_only: bool = False,
    refraction: bool = False,
    row0=None,
    full_height: int = 0,
) -> torch.Tensor:
    """Sum of S progressive samples, one per camera of CameraParams stacked
    on a leading [S] axis, summed in sample order as the megakernels do.
    Returns [H, W, 3] float32; row0/full_height as in ``render_sample``."""
    total = None
    for s in range(int(cameras["eye"].shape[0])):
        cam = {k: v[s] for k, v in cameras.items()}
        color = render_sample(
            scene, options, cam, width, height, mode="progressive", ao_only=ao_only,
            jitter_scale=jitter_scale, impl=impl, env_kind=env_kind, refraction=refraction,
            row0=row0, full_height=full_height,
        )["color"]
        total = color if total is None else total + color
    return total


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
    refraction: bool = False,
    row0=None,
    full_height: int = 0,
) -> dict:
    """Render one sample for the full [H, W] grid on the scene's device.
    Returns {"color": [H, W, 3]} (progressive) or the realtime AOVs, each
    [H, W, 3] except "roughness" [H, W].

    row0/full_height: render rows [row0, row0 + height) of a
    full_height-tall image (a row block of a sharded render): raygen's NDC
    and the TEA pixel seeds, and so every draw seeded from them (the area
    lights' chains included), use the global row."""
    with annotate("wavefront.sample", width * height):
        dev = scene_device(scene)
        with annotate("wavefront.upload", _bytes_off(camera, dev)):
            camera = to_device(camera, dev)
        origins, directions = primary_ray_grid(camera, width, height, jitter_scale, row0=row0,
                                               full_height=full_height)
        o = origins.reshape(-1, 3)
        d = directions.reshape(-1, 3)
        seeds = rng.pixel_seeds(width, height, camera["frame_count"], device=o.device,
                                row0=row0).reshape(-1)
        out = trace_rays(
            scene, options, o, d, seeds, mode=mode, ao_only=ao_only, impl=impl,
            env_kind=env_kind, refraction=refraction,
        )
        return {k: v.reshape(height, width, *v.shape[1:]) for k, v in out.items()}
