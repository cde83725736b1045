"""Light definitions and the animated sun (``dxrexperiments_tpu.scene.lights``).

A rig is a dict of groups ("dir", "point", "area"), each a single light
dict, a list of them, or already-stacked tensors. An area light is a
parallelogram that emits from both faces; shading draws AREA_LIGHT_SAMPLES
stratified points on it (``area_light_draws``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng

DEFAULT_POINT_COLOR = (0.2, 0.8, 0.6, 2.0)
DEFAULT_DIR_COLOR = (0.9, 0.9, 0.9, 1.0)

# Stratified samples drawn on each area light per shading point (a 2 x 2
# stratum grid), as in the JAX package.
AREA_LIGHT_SAMPLES = 4

_GROUPS = (
    ("dir", ("forward", "color", "intensity")),
    ("point", ("position", "color", "intensity")),
    ("area", ("corner", "eu", "ev", "color", "intensity")),
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


def area_light(corner, edge_u, edge_v, color=(1.0, 1.0, 1.0, 10.0)) -> dict:
    """Quad area light: emits color * intensity from both faces of the
    parallelogram corner + s * edge_u + t * edge_v, s, t in [0, 1]."""
    return {
        "corner": _f32(np.asarray(corner, np.float32)[:3]),
        "eu": _f32(np.asarray(edge_u, np.float32)[:3]),
        "ev": _f32(np.asarray(edge_v, np.float32)[:3]),
        "color": _f32(np.asarray(color, np.float32)[:3]),
        "intensity": _f32(color[3]),
    }


def dir_lights(entries: list) -> dict:
    """Stacked directional rig: a list of directional_light() dicts -> tensors."""
    return _stack_group(entries, _GROUPS[0][1])


def point_lights(entries: list) -> dict:
    """Stacked point rig: a list of point_light() dicts -> tensors."""
    return _stack_group(entries, _GROUPS[1][1])


def area_lights(entries: list) -> dict:
    """Stacked area rig: a list of area_light() dicts -> [A, ...] tensors."""
    return _stack_group(entries, _GROUPS[2][1])


def area_light_draws(seed: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The [0, 1)^2 draws of the AREA_LIGHT_SAMPLES samples of each area
    light: a TEA/LCG chain of its own (aseed = initRand(seed, 0x9E3779B9)),
    so the main shading chain draws what it draws without area lights,
    stratified on a su x sv grid (the remainder unstratified). Returns a
    list of (r0, r1) shaped like ``seed``; bit-equal to the JAX package's."""
    su = max(int(math.isqrt(AREA_LIGHT_SAMPLES)), 1)
    sv = AREA_LIGHT_SAMPLES // su
    aseed = rng.init_rand(seed, torch.full_like(seed, 0x9E3779B9))  # on seed's device
    out = []
    for j in range(AREA_LIGHT_SAMPLES):
        aseed, r0, r1 = rng.next_rand2(aseed)
        if j < su * sv:
            r0 = (float(j % su) + r0) / su
            r1 = (float(j // su % sv) + r1) / sv
        out.append((r0, r1))
    return out


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
    """Canonicalize a rig to stacked tensors {"dir": [D,...], "point": [P,...],
    "area": [A,...]}; a missing group has 0 lights."""
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
    """(num directional, num point, num area) for a rig in any form, read
    from each group's first field."""
    counts = []
    for group, keys in _GROUPS:
        g = lights.get(group)
        if g is None:
            counts.append(0)
        elif isinstance(g, (list, tuple)):
            counts.append(len(g))
        else:
            first = torch.as_tensor(g[keys[0]])
            counts.append(1 if first.dim() == 1 else int(first.shape[0]))
    return tuple(counts)


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
