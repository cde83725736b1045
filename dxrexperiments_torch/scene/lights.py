"""Light definitions and the animated sun (``dxrexperiments_tpu.scene.lights``).

A rig is a dict of groups ("dir", "point"), each a single light dict, a list
of them, or already-stacked tensors. Area lights wait for ROADMAP Queue A
item 12.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DEFAULT_POINT_COLOR = (0.2, 0.8, 0.6, 2.0)
DEFAULT_DIR_COLOR = (0.9, 0.9, 0.9, 1.0)

_GROUPS = (
    ("dir", ("forward", "color", "intensity")),
    ("point", ("position", "color", "intensity")),
)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def directional_light(forward_dir, color=DEFAULT_DIR_COLOR) -> dict:
    return {
        "forward": _f32(np.asarray(forward_dir, np.float32)[:3]),
        "color": _f32(np.asarray(color, np.float32)[:3]),
        "intensity": _f32(color[3]),
    }


def point_light(position, color=DEFAULT_POINT_COLOR) -> dict:
    return {
        "position": _f32(np.asarray(position, np.float32)[:3]),
        "color": _f32(np.asarray(color, np.float32)[:3]),
        "intensity": _f32(color[3]),
    }


def _stack_group(entries, keys, device=None) -> dict:
    if not entries:
        return {
            k: torch.zeros((0, 3) if k != "intensity" else (0,), dtype=torch.float32,
                           device=device)
            for k in keys
        }
    return {k: torch.stack([torch.as_tensor(e[k], dtype=torch.float32) for e in entries])
            for k in keys}


def normalize_lights(lights: dict) -> dict:
    """Canonicalize a rig to stacked tensors {"dir": [D,...], "point": [P,...]}.
    An area group raises: area lights are not ported yet."""
    if lights.get("area"):
        raise NotImplementedError(
            "area lights are not ported yet (ROADMAP Queue A item 12)"
        )
    out = {}
    for group, keys in _GROUPS:
        g = lights.get(group)
        if g is None:
            out[group] = _stack_group([], keys)
        elif isinstance(g, (list, tuple)):
            out[group] = _stack_group(list(g), keys)
        elif torch.as_tensor(g[keys[0]]).dim() == 1:  # single light
            out[group] = {k: torch.as_tensor(g[k], dtype=torch.float32)[None] for k in keys}
        else:  # already stacked
            out[group] = {k: torch.as_tensor(g[k], dtype=torch.float32) for k in keys}
    return out


def light_counts(lights: dict) -> tuple[int, int, int]:
    """(num directional, num point, num area) for a rig in any form."""
    n = normalize_lights(lights)
    return (int(n["dir"]["forward"].shape[0]), int(n["point"]["position"].shape[0]), 0)


def animated_dir_light_forward(elapsed_time: float) -> np.ndarray:
    """The reference's animated sun: base (0.3, -0.2, -1.0) rotated about Y
    by sin(t*0.2)*pi/2."""
    base = np.array([0.3, -0.2, -1.0], np.float64)
    angle = math.sin(elapsed_time * 0.2) * math.pi * 0.5
    c, s = math.cos(angle), math.sin(angle)
    rot = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
    return (base @ rot).astype(np.float32)


def default_lights(elapsed_time: float = 142.0) -> dict:
    """Default rig: the animated sun and a point light at the origin."""
    return {
        "dir": directional_light(animated_dir_light_forward(elapsed_time)),
        "point": point_light((0.0, 0.0, 0.0)),
    }
