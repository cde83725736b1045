"""Vector math over ``[..., 3]`` tensors (``dxrexperiments_tpu.core.vecmath``)."""

from __future__ import annotations

import torch

EPS = 1e-8


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product of [..., 3] tensors -> [...]."""
    return (a * b).sum(dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product written out by components."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Normalize [..., 3]; zero vectors map to zero (no NaN)."""
    n2 = dot(a, a)
    inv = torch.where(
        n2 > eps, 1.0 / torch.sqrt(torch.clamp(n2, min=eps)), torch.zeros_like(n2)
    )
    return a * inv[..., None]


def saturate(x: torch.Tensor) -> torch.Tensor:
    """HLSL saturate(): clamp to [0, 1]."""
    return torch.clamp(x, 0.0, 1.0)


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """HLSL reflect(): i - 2*dot(i,n)*n (i points toward the surface)."""
    return i - 2.0 * dot(i, n)[..., None] * n


def refract(i: torch.Tensor, n: torch.Tensor, ior: torch.Tensor):
    """Refraction of i through the surface with normal n and index of
    refraction ior, entering or leaving by the sign of dot(i, n). Returns
    (r, ok); total internal reflection gives ok False and r 0."""
    neg_ndotv = dot(i, n)
    entering = neg_ndotv <= 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    nn = torch.where(entering[..., None], n, -n)
    ndotv = torch.where(entering, neg_ndotv, -neg_ndotv)
    k = 1.0 - eta * eta * (1.0 - ndotv * ndotv)
    ok = k >= 0.0
    k_safe = torch.clamp(k, min=0.0)
    r = normalize(i * eta[..., None] - (eta * ndotv + torch.sqrt(k_safe))[..., None] * nn)
    return torch.where(ok[..., None], r, torch.zeros_like(r)), ok


def get_perpendicular(u: torch.Tensor) -> torch.Tensor:
    """Branchless perpendicular: cross with the smallest-magnitude axis."""
    a = torch.abs(u)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    xm = ((ax - ay) < 0) & ((ax - az) < 0)
    ym = ((ay - az) < 0) & ~xm
    zm = ~(xm | ym)
    axis = torch.stack([xm.to(u.dtype), ym.to(u.dtype), zm.to(u.dtype)], dim=-1)
    return cross(u, axis)


def orthonormal_basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(tangent, bitangent): bitangent = perpendicular(n),
    tangent = cross(bitangent, n)."""
    bitangent = get_perpendicular(n)
    tangent = cross(bitangent, n)
    return tangent, bitangent


def transform_points(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a [3, 4] or [4, 4] affine matrix to points [..., 3]."""
    return p @ m[:3, :3].T + m[:3, 3]


def transform_vectors(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply the linear part of a [3, 4] / [4, 4] matrix to direction vectors."""
    return v @ m[:3, :3].T


def transform_normals(m: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Transform normals by the inverse-transpose of the linear part."""
    return n @ torch.linalg.inv(m[:3, :3])  # (inv.T).T = inv
