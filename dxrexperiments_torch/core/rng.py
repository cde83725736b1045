"""Counter-based per-pixel RNG, bit-exact with ``dxrexperiments_tpu.core.rng``.

TEA-hash seeding per pixel and frame, then one LCG step per draw
(initRand/nextRand of the reference shaders). The JAX package carries the
state as uint32; torch on the CPU has no uint32 add, so seeds ride int64
tensors holding values in [0, 2^32). Every add, multiply and left shift is
masked back to 32 bits, and right shifts act on masked (non-negative) values,
which makes them logical shifts.
"""

from __future__ import annotations

import torch

from ..utils.profiling import annotate

MASK = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & MASK


def init_rand(val0, val1, backoff: int = 16) -> torch.Tensor:
    """TEA-hash seed from two values (inputs broadcast). Returns int64 seeds
    in [0, 2^32)."""
    v0, v1 = torch.broadcast_tensors(_u32(val0), _u32(val1))
    s0 = torch.zeros_like(v0)
    for _ in range(backoff):
        s0 = (s0 + 0x9E3779B9) & MASK
        v0 = (
            v0
            + (
                ((((v1 << 4) & MASK) + 0xA341316C) & MASK)
                ^ ((v1 + s0) & MASK)
                ^ (((v1 >> 5) + 0xC8013EA4) & MASK)
            )
        ) & MASK
        v1 = (
            v1
            + (
                ((((v0 << 4) & MASK) + 0xAD90777D) & MASK)
                ^ ((v0 + s0) & MASK)
                ^ (((v0 >> 5) + 0x7E95761E) & MASK)
            )
        ) & MASK
    return v0


def next_rand(seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """LCG step. Returns (new_seed, uniform float32 in [0, 1))."""
    seed = (seed * 1664525 + 1013904223) & MASK
    u = (seed & 0x00FFFFFF).to(torch.float32) / float(0x01000000)
    return seed, u


def next_rand2(seed: torch.Tensor):
    """Two consecutive draws (the samplers always consume pairs)."""
    seed, r0 = next_rand(seed)
    seed, r1 = next_rand(seed)
    return seed, r0, r1


def pixel_seeds(width: int, height: int, frame_count, device=None, row0=None) -> torch.Tensor:
    """Per-pixel seeds [H, W]: ``initRand(px + py * width, frameCount)``.

    row0: seeds for rows [row0, row0 + height) of a taller image; pixel ids
    stay global, so a row block's seeds are those rows of the full image's.
    A frame count off the seeds' device is copied there under the
    integrator's ``wavefront.upload`` span (n: bytes copied)."""
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.int64, device=device),
        torch.arange(width, dtype=torch.int64, device=device),
        indexing="ij",
    )
    if row0 is not None:
        py = py + int(row0)
    linear = (px + py * width) & MASK
    fc = torch.as_tensor(frame_count, dtype=torch.int64)
    with annotate("wavefront.upload", 0 if fc.device == linear.device else fc.nbytes):
        fc = fc.to(linear.device)
    return init_rand(linear, fc)
