"""The benchmark's frozen yardstick: the H100's peaks, ``bound`` and the
operation and byte counts of kernels B1 and B2, copied from
``chip_smoke.py`` (FP32_PEAK, HBM_RATE, OPS_PAIR, OPS_TAP, ``bound``, and
the B1 and B2 bounds of its phases 4-6). Each counts what the function
needs on the cell's inputs, whatever kernel computes it.
"""

from __future__ import annotations

FP32_PEAK = 67e12  # H100 SXM float32 FLOP/s without tensor cores (FMA = 2), at 1,980 MHz
HBM_RATE = 3.35e12  # H100 SXM bytes/s
OPS_PAIR = 50  # float32 operations of one Moller-Trumbore pair test
OPS_TAP = 24  # of one bilateral tap (guide distance, weight, 3-channel sum)
TRI_WORDS = 20 + 24  # a triangle's record (20 words) and its attributes (24), read once


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of operations over the float32 peak
    and bytes over the memory rate."""
    t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def b1_bound(rays: float, num_tris: int, pixels: int, realtime: bool) -> tuple[float, str]:
    """B1's bound for one launch: every live ray (a non-empty window, and
    for a shadow ray a direction) tests all ``num_tris`` triangles; each
    triangle's record and attributes are read once; each pixel's output is
    written once (progressive: the 12-byte sum of its samples; realtime:
    direct, indirect specular, albedo and roughness, 40 bytes a frame's
    pixel, ``pixels`` counting every frame of the launch)."""
    return bound(rays * num_tris * OPS_PAIR,
                 num_tris * TRI_WORDS * 4 + pixels * (40 if realtime else 12))


def b2_bound(width: int, height: int, radius: float) -> tuple[float, str]:
    """B2's bound for one pass: 2r + 1 taps a pixel; the input, the guide
    and the output, 12 bytes a pixel each."""
    return bound(width * height * (2 * radius + 1) * OPS_TAP, width * height * 12 * 3)
