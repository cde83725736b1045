"""Carry the JAX package's lowered data across to the port.

The JAX ``Scene.build()`` and ``Scene.build_two_level()`` pytrees, its
options dict, its CameraParams and its denoise parameters, each with every
leaf turned into a numpy array (``np.asarray``), become the port's scene
dict, options dict, CameraParams and denoise parameters. The tests feed both
packages the same inputs through these functions. A two-level pytree's
static ``tlas_meta`` is read by duck typing (its ``.value``), so nothing of
the JAX package is imported here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.tlas import TlasRefitContext
from ..core.device import setup_device
from ..ops.traverse import coef_records
from .envmap import TEXTURE_KEY
from .scene import add_tri_records, bvh_to_device

_SCENE_ARRAYS = (
    "mt_pack", "attr_pack", "v0", "e1", "e2", "n0", "n1", "n2",
    "pn", "c1", "c2", "d0",
)
# the JAX pack's node layouts and their row-major device copies; a pytree
# may lack the fat or 8-wide layout (its route then takes another walk)
_BVH_LAYOUTS = {"bvh_nodes": "bvh_rows", "bvhf_nodes": "bvhf_rows", "bvh8_nodes": "bvh8_rows"}
_OBJ_ARRAYS = ("v0", "e1", "e2", "pn", "c1", "c2", "d0", "n0", "n1", "n2")


def _t(x, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.array(x))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def _lights_from_numpy(lights: dict) -> dict:
    out = {}
    for group, g in lights.items():
        if isinstance(g, (list, tuple)):
            out[group] = [
                {k: _t(v, "cpu", torch.float32) for k, v in e.items()} for e in g
            ]
        else:
            out[group] = {k: _t(v, "cpu", torch.float32) for k, v in g.items()}
    return out


def _two_level_from_numpy(d: dict, device) -> dict:
    """The two-level entries of a JAX ``Scene.build_two_level()`` pytree:
    ``tlas`` with the kernels' row-major copies of the layouts it carries (a
    pytree without ``tlasf_nodes`` takes the binary walk, B6b) and B6a's
    leaf records ``blas_test`` (``ops/traverse.coef_records`` of mt_rows),
    ``tlas_meta`` (the JAX HostStatic's value, its refit context copied into
    the port's, and the PRIME table's sources ``prime_src`` on ``device``
    where the pytree has them) and the object-space arrays."""
    tl = d["tlas"]
    host = ("blas_nodes", "blasf_nodes")
    out_tl = {k: _t(tl[k], "cpu" if k in host else device) for k in tl}
    rows = {"tlas_nodes": "tlas_rows", "tlasf_nodes": "tlasf_rows", "blas_nodes": "blas_rows",
            "blasf_nodes": "blasf_rows"}
    for k, row_key in rows.items():
        if k in tl:
            out_tl[row_key] = _t(np.ascontiguousarray(np.asarray(tl[k]).T), device)
    out_tl["inst_rows_t"] = _t(np.ascontiguousarray(np.asarray(tl["inst_rows"])[:16].T), device)
    out_tl["blas_test"] = coef_records(out_tl["mt_rows"])  # B6a's leaf records
    meta = d["tlas_meta"].value
    ctx = meta["refit_ctx"]
    fields = [f.name for f in dataclasses.fields(TlasRefitContext) if not f.name.startswith("_")]
    out = {
        "tlas": out_tl,
        "tlas_meta": {
            "num_instances": int(meta["num_instances"]),
            "slot_mesh": np.asarray(meta["slot_mesh"]),
            "mesh_tri_ranges": [tuple(int(x) for x in r) for r in meta["mesh_tri_ranges"]],
            "refit_ctx": TlasRefitContext(**{f: getattr(ctx, f) for f in fields}),
        },
    }
    if "prime_src" in meta:
        src = meta["prime_src"]
        out["tlas_meta"]["prime_src"] = {
            **{k: _t(src[k], device, torch.float32) for k in ("v0", "e1", "e2")},
            "inst": _t(src["inst"], device, torch.int64),
        }
    for k in _OBJ_ARRAYS:
        out[f"{k}_obj"] = _t(d[f"{k}_obj"], device, torch.float32)
    out["mat_id_obj"] = _t(d["mat_id_obj"], device, torch.int64)
    return out


def _textures_from_numpy(d: dict, device) -> dict:
    """A textured JAX scene's albedo textures and corner UVs: the port's
    texel table is column block 0:3 of the JAX quad-packed rows (c00, each
    row's own texel; scene/textures.py), the meta as it is; ``uv0``..``uv2``
    (flattened) or ``uv0_obj``..``uv2_obj`` (two-level)."""
    rows = np.asarray(d["textures"]["rows"], np.float32)
    out = {"textures": {
        "texels": _t(np.ascontiguousarray(rows[:, 0:3]), device, torch.float32),
        "meta": _t(d["textures"]["meta"], device, torch.int32),
    }}
    suffix = "_obj" if "tlas" in d else ""
    for k in range(3):
        out[f"uv{k}{suffix}"] = _t(d[f"uv{k}{suffix}"], device, torch.float32)
    return out


def scene_from_numpy(d: dict, device="cuda") -> dict:
    """JAX scene pytree (numpy leaves; a flattened ``Scene.build()`` or a
    ``Scene.build_two_level()``) -> the port's scene dict, geometry, albedo
    textures and a texture env's texture on ``device`` (default the card;
    without one it raises), the lights and the env's scalars on the host.
    The JAX quad-packed copies of env and albedo textures and its dummy env
    textures of other kinds are dropped (scene/envmap.py,
    scene/textures.py). A flat scene gets the ``tri_records`` of B1 and B3,
    as from ``Scene.build``. The PRIME table (``prime_v0``, ``prime_e1``,
    ``prime_e2``) goes to ``device``. A re-baked scene
    (``scene/dynamic.bake_instances``: no BVH, ``inst_id``, lights and env
    only where the bake was given them) keeps that layout."""
    device = setup_device(device)
    if "tlas" in d:
        out = _two_level_from_numpy(d, device)
    else:
        out = {k: _t(d[k], device, torch.float32) for k in _SCENE_ARRAYS}
        out["mat_id"] = _t(d["mat_id"], device, torch.int64)
        if "inst_id" in d:  # each triangle's instance (JAX's builds and bakes)
            out["inst_id"] = _t(d["inst_id"], device, torch.int32)
        add_tri_records(out)
    for k in ("prime_v0", "prime_e1", "prime_e2"):
        if k in d:
            out[k] = _t(d[k], device, torch.float32)
    if "textures" in d:
        out.update(_textures_from_numpy(d, device))
    out["num_tris"] = int(np.asarray(d["num_tris"]))
    mats = d["materials"]
    out["materials"] = {
        k: _t(v, device, torch.int64 if k == "type" else torch.float32)
        for k, v in mats.items()
    }
    if "bvh" in d:
        b = d["bvh"]
        bvh = {"mt_rows": np.array(b["mt_rows"], np.float32)}
        for k, row_key in _BVH_LAYOUTS.items():
            if k in b:
                bvh[k] = np.array(b[k], np.float32)
                # bvh8_nodes is row-major already: its row copy is itself
                bvh[row_key] = bvh[k] if k == "bvh8_nodes" else np.ascontiguousarray(bvh[k].T)
        bvh["slot_tri"] = np.array(b["slot_tri"], np.int32)
        bvh["mt_attr_lanes"] = int(np.asarray(b["mt_attr_lanes"]))
        if "tex_autoroute" in b:
            bvh["tex_autoroute"] = 1
        out.update(bvh_to_device(bvh, out["materials"], device))
    # lights and env are per-frame parameters and stay on the host (Scene.build)
    if "lights" in d:
        out["lights"] = _lights_from_numpy(d["lights"])
    if "env" in d:
        env = d["env"]
        out["env"] = {"kind": int(np.asarray(env["kind"]))}
        for k in ("strength", "const_color", "grad_horizon", "grad_zenith"):
            out["env"][k] = _t(env[k], "cpu", torch.float32)
        tex = TEXTURE_KEY.get(out["env"]["kind"])
        if tex is not None:
            out["env"][tex] = _t(env[tex], device, torch.float32)
    return out


def options_from_numpy(opts: dict) -> dict:
    """JAX options dict (numpy leaves) -> the port's options of Python
    scalars: bools, ints and floats (a float32 leaf keeps its float32 value
    exactly)."""
    out = {}
    for k, v in opts.items():
        a = np.asarray(v)
        if a.dtype == np.bool_:
            out[k] = bool(a)
        elif np.issubdtype(a.dtype, np.integer):
            out[k] = int(a)
        else:
            out[k] = float(a)
    return out


# A JAX ``default_denoise_params(...)`` dict converts the same way.
denoise_params_from_numpy = options_from_numpy


def camera_from_numpy(cam: dict) -> dict:
    """JAX CameraParams (numpy leaves, optionally stacked on [S]) -> the
    port's CameraParams (host tensors, see core.camera.camera_params)."""
    out = {k: _t(cam[k], "cpu", torch.float32) for k in ("eye", "u", "v", "w", "jitter")}
    out["frame_count"] = torch.as_tensor(
        np.array(cam["frame_count"]).astype(np.int64) & 0xFFFFFFFF
    )
    out["accum_count"] = torch.as_tensor(np.array(cam["accum_count"], np.float32))
    return out
