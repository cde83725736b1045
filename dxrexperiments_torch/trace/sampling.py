"""Monte-Carlo direction sampling (``dxrexperiments_tpu.trace.sampling``).

Every sampler threads the LCG seed as the reference shaders do, so the
sample sequences match the JAX package draw for draw.
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..core import vecmath as vm

TWO_PI = 2.0 * math.pi


def cos_hemisphere_sample(seed, normal):
    """Cosine-weighted hemisphere around `normal`. Returns (seed, dir [N,3])."""
    seed, r0, r1 = rng.next_rand2(seed)
    tangent, bitangent = vm.orthonormal_basis(normal)
    r = torch.sqrt(r0)
    phi = TWO_PI * r1
    x = r * torch.cos(phi)
    z = r * torch.sin(phi)
    y = torch.sqrt(torch.clamp(1.0 - r0, min=0.0))
    d = x[..., None] * tangent + y[..., None] * normal + z[..., None] * bitangent
    return seed, d


def uniform_hemisphere_sample(seed, normal):
    """Uniform hemisphere. Returns (seed, dir)."""
    seed, r0, r1 = rng.next_rand2(seed)
    tangent, bitangent = vm.orthonormal_basis(normal)
    cos_t = r0
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * r1
    x = sin_t * torch.cos(phi)
    z = sin_t * torch.sin(phi)
    y = cos_t
    d = x[..., None] * tangent + y[..., None] * normal + z[..., None] * bitangent
    return seed, d


def phong_lobe_sample(seed, mirror_dir, exponent):
    """Phong-lobe importance sample around the mirror direction.
    Returns (seed, dir, pdf, brdf)."""
    seed, r0, r1 = rng.next_rand2(seed)
    tangent, bitangent = vm.orthonormal_basis(mirror_dir)
    cos_t = torch.pow(r0, 1.0 / (exponent + 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * r1
    powered_cos = torch.pow(cos_t, exponent)
    pdf = (exponent + 1.0) / TWO_PI * powered_cos
    brdf = (exponent + 2.0) / TWO_PI * powered_cos
    x = sin_t * torch.cos(phi)
    z = sin_t * torch.sin(phi)
    y = cos_t
    d = x[..., None] * tangent + y[..., None] * mirror_dir + z[..., None] * bitangent
    return seed, d, pdf, brdf


def fresnel_schlick(i, n, f0):
    """Schlick Fresnel; i is the incident (toward-surface) direction."""
    cosi = vm.saturate(vm.dot(-i, n))
    return f0 + (1.0 - f0) * torch.pow(1.0 - cosi, 5.0)[..., None]
