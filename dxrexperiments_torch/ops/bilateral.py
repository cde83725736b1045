"""The joint-bilateral pass (B2): wrapper and plain version.

Port of ``dxrexperiments_tpu.ops.bilateral_pallas.bilateral_pass`` and its
XLA reference ``models.denoise._bilateral_pass``. On CUDA tensors,
``bilateral_pass`` launches the hand-written kernel in ``csrc/bilateral.cu``
or raises; on CPU tensors it takes the plain version, ``_bilateral_pass``, a
chain of 51 zero-padded shifts. There is no fallback from the kernel to the
plain version. ``models/denoise.py`` re-exports the plain helpers under
their JAX names.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.profiling import annotate
from . import kernel

MAX_EXTENT = 25  # UI slider max (the reference's DenoiseCompositor)
KERNEL_TAPS = 6
_TAP_TABLE = (1.0, 1.0, 0.9, 0.75, 0.6, 0.5, 0.0)

B2 = kernel.Kernel("B2", "bilateral", {"dxr_bilateral_pass": [ctypes.c_void_p] * 3 + [
    ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]}, ("B2",))


def _tap_weight(i: int, radius: float) -> float:
    """Disk-like spatial weight of tap i (the reference's precalculated
    table): idx = clamp(int(|i| * 5 / (0.001 + |radius * 0.8|)), 0, 6), in
    float32 as the JAX package computes it, into {1, 1, .9, .75, .6, .5, 0}."""
    f32 = np.float32
    x = f32(abs(i)) * f32(KERNEL_TAPS - 1) / (f32(0.001) + abs(f32(radius) * f32(0.8)))
    return _TAP_TABLE[min(max(int(x), 0), KERNEL_TAPS)]


def _shift2d(img: torch.Tensor, offset: int, axis: int) -> torch.Tensor:
    """img shifted so out[p] = img[p + offset * e_axis], zero-filled outside
    the image (out-of-bounds texture reads return 0)."""
    if offset == 0:
        return img
    n = img.shape[axis]
    out = torch.zeros_like(img)
    k = min(abs(offset), n)
    if offset > 0:
        out.narrow(axis, 0, n - k).copy_(img.narrow(axis, k, n - k))
    else:
        out.narrow(axis, k, n - k).copy_(img.narrow(axis, 0, n - k))
    return out


def _color_weight(joint_center: torch.Tensor, joint_sample: torch.Tensor) -> torch.Tensor:
    """1 - clamp(10 * L1(center - sample), 0, 1) over the channel axis."""
    dist = (joint_center - joint_sample).abs().sum(dim=-1) * 10.0
    return 1.0 - torch.clamp(dist, 0.0, 1.0)


def _bilateral_pass(inp: torch.Tensor, joint: torch.Tensor, radius: float, axis: int):
    """Plain version: one separable pass along ``axis`` (0 vertical, 1
    horizontal) on [H, W, 3], taps summed in order i = -25..25."""
    color = torch.zeros_like(inp)
    weight = torch.zeros(inp.shape[:-1], dtype=inp.dtype, device=inp.device)
    for i in range(-MAX_EXTENT, MAX_EXTENT + 1):
        s_in = _shift2d(inp, i, axis)
        s_joint = _shift2d(joint, i, axis)
        w = _tap_weight(i, radius) * _color_weight(joint, s_joint)
        color = color + s_in * w[..., None]
        weight = weight + w
    return color / torch.clamp(weight, min=1e-8)[..., None]


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != 3 or t.shape[-1] != 3 or t.shape != like.shape:
        raise ValueError(f"{name}: expected [H, W, 3] like the input, got {tuple(t.shape)}")
    if t.device != like.device:
        raise ValueError(f"{name}: expected device {like.device}, got {t.device}")


def bilateral_pass(inp: torch.Tensor, joint: torch.Tensor, radius: float, axis: int):
    """One joint-bilateral pass along ``axis`` (0 vertical, 1 horizontal) of
    ``inp`` [H, W, 3] guided by ``joint`` [H, W, 3], float32.

    CUDA tensors -> one kernel launch; CPU tensors -> the plain version."""
    with annotate("B2.wrapper", 1):
        if axis not in (0, 1):
            raise ValueError(f"axis must be 0 or 1, got {axis}")
        _check("inp", inp, inp)
        _check("joint", joint, inp)
        if not kernel.on_card(inp.device):
            return _bilateral_pass(inp, joint, radius, axis)
        if not (inp.is_contiguous() and joint.is_contiguous()):
            raise ValueError("inp and joint must be contiguous")
        h, w, _ = inp.shape
        out = torch.empty_like(inp)
        fn = B2.library().dxr_bilateral_pass
        B2.run(lambda: kernel.on_stream(fn, inp.device, inp.data_ptr(), joint.data_ptr(),
                                        out.data_ptr(), h, w, axis, float(radius)), "B2", n=1)
        return out
