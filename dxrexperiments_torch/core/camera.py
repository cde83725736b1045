"""Pinhole camera with U/V/W ray-generation basis (``dxrexperiments_tpu.core.camera``).

The ``Camera`` class is host state in numpy, copied from the JAX package
(importing that module loads jax). ``camera_params`` lowers it to the
per-frame CameraParams dict of torch tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 1e-12 else v


@dataclasses.dataclass
class Camera:
    """Mutable host-side camera (the interactive object)."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    # Orthonormal basis rows: right, up, forward (forward = look direction).
    right: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1, 0, 0], np.float32)
    )
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 1, 0], np.float32)
    )
    forward: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 0, -1], np.float32)
    )
    fov_y: float = math.pi / 4.0
    aspect: float = 16.0 / 9.0  # width / height
    near: float = 1.0
    far: float = 1000.0

    def set_look_direction(self, forward, up) -> None:
        forward = np.asarray(forward, np.float32)
        up = np.asarray(up, np.float32)
        if np.dot(forward, forward) < 1e-6:
            forward = np.array([0, 0, -1], np.float32)
        forward = _normalize(forward)
        right = np.cross(forward, up)
        if np.dot(right, right) < 1e-6:
            # up parallel to forward: rotate forward -90deg about Y.
            right = np.array([-forward[2], 0.0, forward[0]], np.float32)
        right = _normalize(right)
        self.forward = forward
        self.right = right
        self.up = np.cross(right, forward).astype(np.float32)

    def set_eye_at_up(self, eye, at, up) -> None:
        eye = np.asarray(eye, np.float32)
        at = np.asarray(at, np.float32)
        self.set_look_direction(at - eye, up)
        self.position = eye

    def set_aspect(self, width: int, height: int) -> None:
        self.aspect = float(width) / float(height)

    def uvw(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Ray-generation basis: W = forward, U = normalize(W x up) * ulen,
        V = normalize(U x W) * vlen, vlen = |W| tan(fov/2), ulen = vlen*aspect."""
        w = self.forward.astype(np.float32)
        wlen = float(np.linalg.norm(w))
        u = _normalize(np.cross(w, self.up))
        v = _normalize(np.cross(u, w))
        vlen = wlen * math.tan(0.5 * self.fov_y)
        ulen = vlen * self.aspect
        return (u * ulen).astype(np.float32), (v * vlen).astype(np.float32), w

    def view_matrix(self) -> np.ndarray:
        """World->view (view: +X right, +Y up, -Z forward)."""
        r, u, f = self.right, self.up, self.forward
        rot = np.stack([r, u, -f], axis=0).astype(np.float32)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot
        m[:3, 3] = -rot @ self.position
        return m

    def proj_matrix(self) -> np.ndarray:
        """Reverse-Z perspective."""
        y = 1.0 / math.tan(0.5 * self.fov_y)
        x = y / self.aspect
        q1 = self.near / (self.far - self.near)
        q2 = q1 * self.far
        m = np.zeros((4, 4), np.float32)
        m[0, 0] = x
        m[1, 1] = y
        m[2, 2] = q1
        m[2, 3] = q2
        m[3, 2] = -1.0
        return m

    def view_proj_matrix(self) -> np.ndarray:
        return (self.proj_matrix() @ self.view_matrix()).astype(np.float32)


def camera_params(
    camera: Camera,
    jitter: tuple[float, float] = (0.0, 0.0),
    frame_count: int = 0,
    accum_count: int = 0,
) -> dict:
    """Lower a Camera to the CameraParams dict of host (CPU) tensors:
    float32 eye/u/v/w/jitter, int64 ``frame_count``, float32 ``accum_count``.

    CameraParams are per-frame parameters and stay on the host: the kernel
    wrapper packs them into its one upload per dispatch, the plain path
    moves them to its device, and reading the counters never waits for the
    device."""
    u, v, w = camera.uvw()

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32))

    return {
        "eye": f32(camera.position),
        "u": f32(u),
        "v": f32(v),
        "w": f32(w),
        "jitter": f32(jitter),
        "frame_count": torch.tensor(int(frame_count) & 0xFFFFFFFF, dtype=torch.int64),
        "accum_count": torch.tensor(float(accum_count), dtype=torch.float32),
    }


def stack_cameras(cams: list[dict]) -> dict:
    """Stack CameraParams dicts on a leading [S] axis."""
    return {k: torch.stack([c[k] for c in cams]) for k in cams[0]}


def primary_ray_grid(params: dict, width: int, height: int, jitter_scale: float = 30.0,
                     row0=None, full_height: int = 0):
    """[H, W] grid of primary rays: NDC from pixel centers, direction
    ``normalize(d.x*U - d.y*V + W)``, origin = eye + jitter*scale in XY.
    Returns (origins [H,W,3], directions [H,W,3]) on the camera's device.

    row0/full_height: the rays of rows [row0, row0 + height) of a
    full_height-tall image (a row block of a sharded render)."""
    dev = params["u"].device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width * 2.0 - 1.0
    ys_pix = torch.arange(height, dtype=torch.float32, device=dev)
    if row0 is not None:
        ys_pix = ys_pix + float(row0)
    ys = (ys_pix + 0.5) / (full_height or height) * 2.0 - 1.0
    dy, dx = torch.meshgrid(ys, xs, indexing="ij")  # [H, W] each (rows = y)
    u, v, w = params["u"], params["v"], params["w"]
    d = dx[..., None] * u + (-dy)[..., None] * v + w
    norm = torch.sqrt((d * d).sum(dim=-1, keepdim=True))
    directions = d / norm
    jit = params["jitter"] * jitter_scale
    origin = params["eye"] + torch.cat([jit, torch.zeros(1, dtype=torch.float32, device=dev)])
    origins = origin.expand(directions.shape)
    return origins, directions
