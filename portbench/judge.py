"""The numbers that decide ``correct``: what the timed path produced
against the reference, each held to its limit from ``limits/<cell>.json``.

For a pixel of an image or an AOV, the gap is the largest channel's
|program - reference| over (the reference's largest channel + 0.01); a
pixel is off where the gap passes 1e-3. Per cell:

  image_off_share   progressive: the share of sampled pixels off, the worse
                    of the compared images
  image_mean_gap    progressive: the mean gap over them, the worse image
  aov_off_share     realtime: as image_off_share over direct and indirect
                    specular of the compared frames, at the sampled pixels
                    and at every input of the unit's anchor tile of display
                    pixels
  aov_mean_gap      realtime: as image_mean_gap over them
  display_max_gap   realtime: the largest |display - reference denoiser| over
                    every pixel of the compared frames, the reference
                    denoiser run on the program's own AOVs (B2 and the
                    composite exactly; at the anchor tiles those AOVs are
                    themselves judged above)
"""

from __future__ import annotations

import math

import torch

OFF = 1e-3
FLOOR = 0.01


def gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per-pixel gap of [P, 3] images, computed in float64; NaN or inf is
    an infinite gap."""
    got, want = got.double(), want.double()
    g = (got - want).abs().amax(-1) / (want.abs().amax(-1) + FLOOR)
    return torch.where(torch.isfinite(g), g, torch.full_like(g, math.inf))


def image_numbers(pairs: list[tuple[torch.Tensor, torch.Tensor]], prefix: str) -> dict:
    off, mean = 0.0, 0.0
    for got, want in pairs:
        g = gaps(got, want)
        off = max(off, float((g > OFF).double().mean()))
        mean = max(mean, float(g.mean()) if bool(torch.isfinite(g).all()) else math.inf)
    return {f"{prefix}_off_share": off, f"{prefix}_mean_gap": mean}


def display_number(pairs: list[tuple[torch.Tensor, torch.Tensor]]) -> dict:
    worst = 0.0
    for got, want in pairs:
        d = (got.double() - want.double()).abs()
        worst = max(worst, float(d.max()) if bool(torch.isfinite(d).all()) else math.inf)
    return {"display_max_gap": worst}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): every number at or under its limit; a number
    without a limit, or a limit without a number, is not correct."""
    checks = {k: {"value": numbers.get(k), "limit": v["limit"]} for k, v in limits.items()}
    ok = set(numbers) == set(limits) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
