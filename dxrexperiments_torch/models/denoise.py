"""Tonemapping helpers of ``dxrexperiments_tpu.models.denoise``.

The joint-bilateral denoiser and its compositor (kernel B2) arrive with the
realtime pipeline (ROADMAP Queue A item 8).
"""

from __future__ import annotations

import torch

_LUMA = (0.299, 0.587, 0.114)  # Rec.601


def luminance(color: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(_LUMA, dtype=color.dtype, device=color.device)
    return (color * w).sum(dim=-1)


def reinhard_tonemap(color: torch.Tensor) -> torch.Tensor:
    """Luma-based Reinhard."""
    lum = luminance(color)
    reinhard = lum / (lum + 1.0)
    scale = torch.where(
        lum > 1e-12, reinhard / torch.clamp(lum, min=1e-12), torch.zeros_like(lum)
    )
    return color * scale[..., None]


def linear_to_srgb(color: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    return torch.pow(torch.clamp(color, min=0.0), 1.0 / gamma)
