"""Environment lighting (``dxrexperiments_tpu.scene.envmap``): constant and
gradient. Lat-long and cubemap textures wait for ROADMAP Queue A item 9.

An env is a dict: ``kind`` (a Python int), ``strength`` and the colour
tensors of its kind.
"""

from __future__ import annotations

import numpy as np
import torch

ENV_CONSTANT = 0
ENV_GRADIENT = 1
ENV_LATLONG = 2
ENV_CUBEMAP = 3


def _base(kind: int, strength: float) -> dict:
    return {
        "kind": kind,
        "strength": torch.tensor(strength, dtype=torch.float32),
        "const_color": torch.zeros(3, dtype=torch.float32),
        "grad_horizon": torch.zeros(3, dtype=torch.float32),
        "grad_zenith": torch.zeros(3, dtype=torch.float32),
    }


def constant_env(color=(0.0, 0.0, 0.0), strength: float = 1.0) -> dict:
    env = _base(ENV_CONSTANT, strength)
    env["const_color"] = torch.as_tensor(np.asarray(color, np.float32))
    return env


def gradient_env(horizon=(0.8, 0.85, 1.0), zenith=(0.2, 0.35, 0.7), strength=1.0) -> dict:
    env = _base(ENV_GRADIENT, strength)
    env["grad_horizon"] = torch.as_tensor(np.asarray(horizon, np.float32))
    env["grad_zenith"] = torch.as_tensor(np.asarray(zenith, np.float32))
    return env


def check_env_kind(kind: int) -> int:
    kind = int(kind)
    if kind in (ENV_LATLONG, ENV_CUBEMAP):
        raise NotImplementedError(
            f"env kind {kind} (texture env) is not ported yet (ROADMAP Queue A item 9)"
        )
    if kind not in (ENV_CONSTANT, ENV_GRADIENT):
        raise ValueError(f"unknown env kind {kind}")
    return kind


def sample_environment(env: dict, directions: torch.Tensor, static_kind: int | None = None):
    """Radiance for unit directions [..., 3], times the env strength."""
    kind = check_env_kind(env["kind"] if static_kind is None else static_kind)
    if kind == ENV_CONSTANT:
        col = env["const_color"].expand(directions.shape)
    else:
        t = torch.clamp(directions[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
        col = env["grad_horizon"] * (1 - t) + env["grad_zenith"] * t
    return col * env["strength"]
