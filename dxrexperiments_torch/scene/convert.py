"""Carry the JAX package's lowered data across to the port.

The JAX ``Scene.build()`` pytree, its options dict, its CameraParams and its
denoise parameters, each with every leaf turned into a numpy array
(``np.asarray``), become the port's scene dict, options dict, CameraParams
and denoise parameters. The tests feed both packages the same inputs through
these functions.
"""

from __future__ import annotations

import numpy as np
import torch

from .scene import bvh_to_device

_SCENE_ARRAYS = (
    "mt_pack", "attr_pack", "v0", "e1", "e2", "n0", "n1", "n2",
    "pn", "c1", "c2", "d0",
)
_BVH_ARRAYS = ("bvh_nodes", "bvhf_nodes", "mt_rows")
_UNPORTED = {
    "tlas": "two-level scenes (ROADMAP Queue A item 13)",
    "textures": "albedo textures (ROADMAP Queue A item 12)",
}


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


def scene_from_numpy(d: dict, device="cpu") -> dict:
    """JAX scene pytree (numpy leaves) -> the port's scene dict, geometry on
    ``device``."""
    for key, what in _UNPORTED.items():
        if key in d:
            raise NotImplementedError(f"scene carries {key!r}: {what} is not ported yet")
    out = {k: _t(d[k], device, torch.float32) for k in _SCENE_ARRAYS}
    out["mat_id"] = _t(d["mat_id"], device, torch.int64)
    out["num_tris"] = int(np.asarray(d["num_tris"]))
    mats = d["materials"]
    out["materials"] = {
        k: _t(v, device, torch.int64 if k == "type" else torch.float32)
        for k, v in mats.items()
    }
    if "bvh" in d:
        b = d["bvh"]
        bvh = {k: np.array(b[k], np.float32) for k in _BVH_ARRAYS}
        bvh["bvhf_rows"] = np.ascontiguousarray(bvh["bvhf_nodes"].T)
        bvh["slot_tri"] = np.array(b["slot_tri"], np.int32)
        bvh["mt_attr_lanes"] = int(np.asarray(b["mt_attr_lanes"]))
        out.update(bvh_to_device(bvh, out["materials"], device))
    # lights and env are per-frame parameters and stay on the host (Scene.build)
    out["lights"] = _lights_from_numpy(d["lights"])
    env = d["env"]
    out["env"] = {"kind": int(np.asarray(env["kind"]))}
    for k in ("strength", "const_color", "grad_horizon", "grad_zenith"):
        out["env"][k] = _t(env[k], "cpu", torch.float32)
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
