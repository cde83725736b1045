"""Environment lighting (``dxrexperiments_tpu.scene.envmap``): constant,
gradient, lat-long and cubemap.

An env is a dict: ``kind`` (a Python int), ``strength`` and the colour
tensors, which stay host (CPU) tensors since they are per-frame parameters,
and for a texture env its texture: ``latlong`` [H, W, 3] (kind 2) or
``cube`` [6, S, S, 3] (kind 3), float32. ``Scene.build`` moves the texture
to the scene's device once; nothing copies it per frame (``on_device``).
Constant and gradient envs carry no texture (the JAX package's 1x1 dummies
exist only to fix its pytree's structure).

Every lookup reads the four texels of its bilinear footprint from the
texture itself: ``sample_environment`` here, and the CUDA megakernels
(``csrc/common.cuh``). The JAX package's quad-packed copies (each texel with
its 2x2 footprint, 4x the texture's bytes) exist because its TPU kernels
cannot gather; the four taps read the same texels, so they are not carried.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ENV_CONSTANT = 0
ENV_GRADIENT = 1
ENV_LATLONG = 2
ENV_CUBEMAP = 3
TEXTURE_KEY = {ENV_LATLONG: "latlong", ENV_CUBEMAP: "cube"}
_INV_PI = 1.0 / math.pi


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


def latlong_env(image: np.ndarray, strength: float = 1.0) -> dict:
    """Equirectangular [H, W, 3] float image."""
    env = _base(ENV_LATLONG, strength)
    img = np.ascontiguousarray(image, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"lat-long env: expected [H, W, 3], got {img.shape}")
    env["latlong"] = torch.from_numpy(img)
    return env


def cubemap_env(faces: np.ndarray, strength: float = 1.0) -> dict:
    """[6, S, S, 3] float faces in D3D order +X -X +Y -Y +Z -Z."""
    env = _base(ENV_CUBEMAP, strength)
    f = np.ascontiguousarray(faces, np.float32)
    if f.ndim != 4 or f.shape[0] != 6 or f.shape[1] != f.shape[2] or f.shape[3] != 3:
        raise ValueError(f"cubemap env: expected [6, S, S, 3], got {f.shape}")
    env["cube"] = torch.from_numpy(f)
    return env


def check_env_kind(kind: int) -> int:
    kind = int(kind)
    if kind not in (ENV_CONSTANT, ENV_GRADIENT, ENV_LATLONG, ENV_CUBEMAP):
        raise ValueError(f"unknown env kind {kind}")
    return kind


def texture(env: dict, kind: int) -> torch.Tensor:
    """The texture a texture env of ``kind`` samples: ``latlong`` or ``cube``."""
    key = TEXTURE_KEY[kind]
    if key not in env:
        raise ValueError(f"env kind {kind} needs the texture leaf {key!r}; this env has none")
    return env[key]


def place(env: dict, device) -> dict:
    """The env as a scene holds it: the texture on ``device`` (moved once,
    at build), the scalars and colours on the host."""
    tex = TEXTURE_KEY.get(int(env["kind"]))
    return {k: v.to(device if k == tex else "cpu") if isinstance(v, torch.Tensor) else v
            for k, v in env.items()}


def on_device(env: dict, device) -> dict:
    """The env for one trace on ``device``: the scalars and colours moved
    there, the texture used as it is. A texture on another device raises: a
    frame never copies a texture."""
    device = torch.device(device)
    out = {}
    for k, v in env.items():
        if k == TEXTURE_KEY.get(int(env["kind"])):
            if v.device != device:
                raise ValueError(f"env texture {k!r} lies on {v.device}, the trace on {device}: "
                                 "build the scene on its device (Scene.build moves it once)")
            out[k] = v
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        else:
            out[k] = v
    return out


# --------------------------------------------------------------------------- #
# Sampling
# --------------------------------------------------------------------------- #
def _bilinear_mix(q: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    c00, c10, c01, c11 = q[..., 0:3], q[..., 3:6], q[..., 6:9], q[..., 9:12]
    return c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy) + c01 * (1 - fx) * fy + c11 * fx * fy


def _footprint_latlong(img: torch.Tensor, x0i: torch.Tensor, y0i: torch.Tensor) -> torch.Tensor:
    """The 2x2 footprint (c00, c10, c01, c11) [..., 12] of texel (x0i, y0i):
    x wraps, y clamps (the texels of the JAX package's quad pack)."""
    h, w = img.shape[0], img.shape[1]
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    return torch.cat([img[y0i, x0i], img[y0i, x1i], img[y1i, x0i], img[y1i, x1i]], dim=-1)


def _bilinear_wrap_u(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of [H, W, 3] at uv in [0, 1]; wrap u (a floor mod, so
    texel -1 is W-1), clamp v."""
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    return _bilinear_mix(_footprint_latlong(img, x0i, y0i), fx, fy)


def dir_to_latlong_uv(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Parity with wsVectorToLatLong: u from atan2(x, -z), v from acos(y)."""
    u = (1.0 + torch.atan2(d[..., 0], -d[..., 2]) * _INV_PI) * 0.5
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) * _INV_PI
    return u, v


def dir_to_cube_face_uv(d: torch.Tensor):
    """D3D cubemap addressing: (face [...] int64, u [...], v [...]) in [0, 1].
    Ties go to x over y over z (x wins with >=, y needs > x)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x >= 0, 0, 1),
        torch.where(is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)),
    ).to(torch.int64)
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)), min=1e-12)
    sc = torch.where(is_x, torch.where(x >= 0, -z, z),
                     torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    tc = torch.where(is_x, -y, torch.where(is_y, torch.where(y >= 0, z, -z), -y))
    u = (sc / ma + 1.0) * 0.5
    v = (tc / ma + 1.0) * 0.5
    return face, u, v


def _footprint_cube(cube: torch.Tensor, face, x0i, y0i) -> torch.Tensor:
    """The 2x2 footprint [..., 12] of texel (x0i, y0i) of ``face``, x and y
    clamped inside the face (no cross-face filtering)."""
    s = cube.shape[1]
    x1i = torch.clamp(x0i + 1, 0, s - 1)
    y1i = torch.clamp(y0i + 1, 0, s - 1)
    return torch.cat([cube[face, y0i, x0i], cube[face, y0i, x1i], cube[face, y1i, x0i],
                      cube[face, y1i, x1i]], dim=-1)


def _bilinear_cube(cube: torch.Tensor, face, u, v) -> torch.Tensor:
    """Bilinear sample inside one face, x and y clamped to it, the weights
    from the unclamped position."""
    s = cube.shape[1]
    x = u * s - 0.5
    y = v * s - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int64), 0, s - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, s - 1)
    return _bilinear_mix(_footprint_cube(cube, face, x0i, y0i), fx, fy)


def sample_environment(env: dict, directions: torch.Tensor, static_kind: int | None = None):
    """Radiance for unit directions [..., 3], times the env strength (the
    miss shader). ``static_kind`` names the kind the caller compiled for;
    it must be the env's own when it is a texture kind."""
    kind = check_env_kind(env["kind"] if static_kind is None else static_kind)
    if kind == ENV_CONSTANT:
        col = env["const_color"].expand(directions.shape)
    elif kind == ENV_GRADIENT:
        t = torch.clamp(directions[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
        col = env["grad_horizon"] * (1 - t) + env["grad_zenith"] * t
    elif kind == ENV_LATLONG:
        u, v = dir_to_latlong_uv(directions)
        col = _bilinear_wrap_u(texture(env, kind), u, v)
    else:
        face, u, v = dir_to_cube_face_uv(directions)
        col = _bilinear_cube(texture(env, kind), face, u, v)
    return col * env["strength"]
