"""Animated instances (``dxrexperiments_tpu.scene.dynamic``).

Two ways to move instances from frame to frame:

  * two-level scenes (``Scene.build_two_level``): ``refit_scene_instances``,
    the per-frame TLAS refit, which also keeps the PRIME table's world-space
    triangles current;
  * flattened scenes: a re-bake on the scene's device, with no host round
    trip per frame,

        base = prepare_base(scene_of_the_base_mesh, num_instances)
        scene_t = bake_instances(base, transforms_t, mat_override)

    whose result renders through the pipelines' brute-force routes (B1 up
    to 256 rows, else B3), or through a BVH rebuilt every frame with
    ``accel.bvh.build_bvh_device``.

Every product here is written out as float32 multiply-adds, so the card
computes what the CPU computes whatever the matmul precision settings are.
"""

from __future__ import annotations

import torch

from ..accel import tlas as tlas_mod
from ..core import vecmath as vm
from ..utils.profiling import annotate
from . import envmap as envmap_mod
from .scene import add_tri_records


def _rotate(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x @ m.T for each matrix: m [..., 3, 3], x [..., N, 3] -> [..., N, 3],
    as three float32 multiply-adds per component (no matmul, so no TF32)."""
    m = m[..., None, :, :]
    x = x[..., None, :]
    return x[..., 0] * m[..., 0] + x[..., 1] * m[..., 1] + x[..., 2] * m[..., 2]


def refit_scene_instances(scene: dict, transforms) -> dict:
    """Per-frame animation of a two-level scene (``Scene.build_two_level``):
    the TLAS boxes and the instances' inverse and normal matrices for new
    [I, 4, 4] transforms, as O(instances) work on the scene's device, with no
    triangle re-bake and no BVH rebuild; the analogue of a D3D12 TLAS update
    build (PERFORM_UPDATE). Returns a new scene dict; the BLAS arrays are
    shared with ``scene``. Only the TLAS layouts the scene carries are
    replaced: a TLAS without fat nodes stays without them, so its route
    keeps the binary walk (kernel B6b) from frame to frame.

    A scene with a PRIME table gets its world-space triangles re-derived
    from their object-space sources (``tlas_meta["prime_src"]``) and the
    owning instances' new transforms; the selection stays the build's (a
    heuristic), only the coordinates follow the transforms. They are full
    float32: a TF32 product would put about 1.5e-3 relative error on them,
    more than ``_prime_seed_tmax``'s margins.

    Spans (``utils/profiling``): ``refit`` (n: the instances) holds
    ``refit.tlas`` around ``accel/tlas.refit_instances_arrays``."""
    device = scene["tlas"]["mt_rows"].device
    ctx = scene["tlas_meta"]["refit_ctx"]
    with annotate("refit", ctx.num_instances):
        with annotate("refit.tlas", ctx.num_instances):
            dyn = tlas_mod.refit_instances_arrays(ctx, transforms, device)
        new = dict(scene, tlas=dict(scene["tlas"],
                                    **{k: v for k, v in dyn.items() if k in scene["tlas"]}))
        src = scene["tlas_meta"].get("prime_src")
        if src is not None and "prime_v0" in scene:
            t = tlas_mod._upload(transforms, device)[src["inst"]]
            rot, trn = t[:, :3, :3], t[:, :3, 3]
            new["prime_v0"] = _rotate(rot, src["v0"][:, None, :])[:, 0] + trn
            new["prime_e1"] = _rotate(rot, src["e1"][:, None, :])[:, 0]
            new["prime_e2"] = _rotate(rot, src["e2"][:, None, :])[:, 0]
        return new


def prepare_base(base_scene: dict, num_instances: int) -> dict:
    """The bake's fixed inputs: the base mesh's object-space arrays (from
    ``Scene.build`` of the base mesh alone, padding rows included), its
    materials and the instance count."""
    keys = ("v0", "e1", "e2", "n0", "n1", "n2", "mat_id")
    return {
        "mesh": {k: base_scene[k] for k in keys},
        "materials": base_scene["materials"],
        "num_instances": num_instances,
        "num_base_tris": int(base_scene["num_tris"]),
    }


def _bake(mesh: dict, materials: dict, transforms: torch.Tensor,
          mat_override: torch.Tensor, num_instances: int) -> dict:
    """transforms: [I, 4, 4]; mat_override: [I] (-1 = keep the mesh's ids).
    The flattened scene's geometry arrays (T = I * T_base rows, instance by
    instance), the intersection precomputes and the kernel packs, on the
    mesh's device."""
    rot = transforms[:, :3, :3]  # [I, 3, 3]
    trans = transforms[:, :3, 3][:, None, :]  # [I, 1, 3]
    inv_rot_t = tlas_mod._inverse3(rot).transpose(1, 2)  # normal matrices

    v0 = _rotate(rot, mesh["v0"]) + trans
    p1 = _rotate(rot, mesh["v0"] + mesh["e1"]) + trans
    p2 = _rotate(rot, mesh["v0"] + mesh["e2"]) + trans

    def nrm(n):
        out = _rotate(inv_rot_t, n)
        l2 = vm.dot(out, out)[..., None]
        return out * torch.rsqrt(torch.clamp(l2, min=1e-24))

    over = mat_override.to(torch.int64)[:, None]
    mid = torch.where(over >= 0, over, mesh["mat_id"].to(torch.int64)[None])
    flat = {"v0": v0, "e1": p1 - v0, "e2": p2 - v0,
            "n0": nrm(mesh["n0"]), "n1": nrm(mesh["n1"]), "n2": nrm(mesh["n2"]), "mat_id": mid}
    flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in flat.items()}

    v0, e1, e2 = flat["v0"], flat["e1"], flat["e2"]
    pn = vm.cross(e1, e2)
    c1 = vm.cross(v0, e2)
    c2 = vm.cross(v0, e1)
    d0 = vm.dot(v0, pn)
    t_total = v0.shape[0]
    mid = flat["mat_id"]

    # the kernel packs, in Scene.build's layouts
    mt = torch.zeros((4, t_total, 16), dtype=torch.float32, device=v0.device)
    mt[0, :, 0:3] = -pn
    mt[1, :, 0:3] = c1
    mt[1, :, 3:6] = e2
    mt[2, :, 0:3] = -c2
    mt[2, :, 3:6] = -e1
    mt[3, :, 6:9] = pn
    mt[3, :, 9] = -d0

    attr = torch.zeros((32, t_total), dtype=torch.float32, device=v0.device)
    attr[0:3] = flat["n0"].T
    attr[3:6] = flat["n1"].T
    attr[6:9] = flat["n2"].T
    attr[9] = mid.to(torch.float32)
    attr[10:13] = materials["albedo"][mid].T
    attr[13:16] = materials["specular"][mid].T
    attr[16:19] = materials["emissive"][mid].T
    attr[19] = materials["emissive_strength"][mid]
    attr[20] = materials["reflectivity"][mid]
    attr[21] = materials["roughness"][mid]
    attr[22] = materials["ior"][mid]
    attr[23] = materials["type"][mid].to(torch.float32)

    return dict(
        flat,
        pn=pn, c1=c1, c2=c2, d0=d0,
        mt_pack=mt, attr_pack=attr,
        num_tris=t_total,
        inst_id=torch.arange(num_instances, dtype=torch.int32, device=v0.device)
        .repeat_interleave(t_total // num_instances),
    )


def bake_instances(
    base: dict,
    transforms,
    mat_override=None,
    lights: dict | None = None,
    env: dict | None = None,
) -> dict:
    """Re-bake the instanced scene on the base mesh's device: ``transforms``
    [I, 4, 4] (a tensor or a numpy array; a host array reaches a card in
    one non-blocking copy from pinned memory), ``mat_override`` [I] (default
    all -1). The result is a flattened scene dict (``num_tris`` a Python
    int, the padding rows of the base mesh included: degenerate rows, which
    never hit) that renders through the pipelines' brute-force routes, with
    the ``tri_records`` of B1 and B3 built from its new ``mt_pack``
    (``scene.add_tri_records``, up to 4,096 rows); ``lights`` as given and
    ``env`` on the scene's device (``envmap.place``) when given. As in the
    JAX package, the padded row count must be one the kernels take: at most
    256 rows for B1, any count for B3."""
    i = base["num_instances"]
    device = base["mesh"]["v0"].device
    tf = tlas_mod._upload(transforms, device)
    if mat_override is None:
        mat_override = torch.full((i,), -1, dtype=torch.int64, device=device)
    else:
        mat_override = torch.as_tensor(mat_override).to(device)
    scene = _bake(base["mesh"], base["materials"], tf, mat_override, i)
    add_tri_records(scene)
    scene["materials"] = base["materials"]
    if lights is not None:
        scene["lights"] = lights
    if env is not None:
        scene["env"] = envmap_mod.place(env, device)
    return scene
