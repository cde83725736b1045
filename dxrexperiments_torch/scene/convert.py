"""Carry the JAX package's lowered data across to the port.

The JAX ``Scene.build()`` pytree, its options dict and its CameraParams, each
with every leaf turned into a numpy array (``np.asarray``), become the port's
scene dict, options dict and CameraParams. The tests feed both packages the
same scene through these functions.
"""

from __future__ import annotations

import numpy as np
import torch

_SCENE_ARRAYS = (
    "mt_pack", "attr_pack", "v0", "e1", "e2", "n0", "n1", "n2",
    "pn", "c1", "c2", "d0",
)
_UNPORTED = {
    "bvh": "BVH traversal (ROADMAP Queue A item 11)",
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
    # lights and env are per-frame parameters and stay on the host (Scene.build)
    out["lights"] = _lights_from_numpy(d["lights"])
    env = d["env"]
    out["env"] = {"kind": int(np.asarray(env["kind"]))}
    for k in ("strength", "const_color", "grad_horizon", "grad_zenith"):
        out["env"][k] = _t(env[k], "cpu", torch.float32)
    return out


def options_from_numpy(opts: dict) -> dict:
    """JAX options dict (numpy leaves) -> the port's options of Python
    scalars (bools and ints)."""
    out = {}
    for k, v in opts.items():
        a = np.asarray(v)
        out[k] = bool(a) if a.dtype == np.bool_ else int(a)
    return out


def camera_from_numpy(cam: dict) -> dict:
    """JAX CameraParams (numpy leaves, optionally stacked on [S]) -> the
    port's CameraParams (host tensors, see core.camera.camera_params)."""
    out = {k: _t(cam[k], "cpu", torch.float32) for k in ("eye", "u", "v", "w", "jitter")}
    out["frame_count"] = torch.as_tensor(
        np.array(cam["frame_count"]).astype(np.int64) & 0xFFFFFFFF
    )
    out["accum_count"] = torch.as_tensor(np.array(cam["accum_count"], np.float32))
    return out
