"""DenoiseCompositor: separable joint-bilateral filter + composite + tonemap
(``dxrexperiments_tpu.models.denoise``).

Pass 0 filters the indirect-specular AOV horizontally with direct lighting
as the joint guide; pass 1 filters vertically, then the tail composites
(adds direct lighting), applies exposure, Reinhard tonemap and gamma. Each
pass is kernel B2 (``ops/bilateral.py``) on CUDA tensors and its plain
version, ``_bilateral_pass``, on the CPU.

The parameters are a dict of Python scalars (the UI surface), with the JAX
package's defaults; ``scene.convert.denoise_params_from_numpy`` carries a
JAX parameter dict across.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import setup_device
from ..ops import bilateral
from ..ops.bilateral import (  # noqa: F401  (the plain helpers, under their JAX names)
    KERNEL_TAPS,
    MAX_EXTENT,
    _bilateral_pass,
    _color_weight,
    _shift2d,
    _tap_weight,
)
from ..utils.profiling import annotate

_LUMA = (0.299, 0.587, 0.114)  # Rec.601


def default_denoise_params(**overrides) -> dict:
    """The reference compositor's defaults: exposure 1, gamma 2.2, tonemap
    on, gamma correction off, radius 12, debug view 0."""
    p = {
        "exposure": 1.0,
        "gamma": 2.2,
        "tonemap": True,
        "gamma_correct": False,
        "max_kernel_size": 12,
        "debug_visualize": 0,
    }
    for k, v in overrides.items():
        p[k] = type(p[k])(v)
    return p


def luminance(color: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma, summed over the channels in order. The weights stay
    Python scalars: a weight tensor built on the card is a blocking
    host-to-device copy, which waits for the stream every frame."""
    return color[..., 0] * _LUMA[0] + color[..., 1] * _LUMA[1] + color[..., 2] * _LUMA[2]


def reinhard_tonemap(color: torch.Tensor) -> torch.Tensor:
    """Luma-based Reinhard."""
    lum = luminance(color)
    reinhard = lum / (lum + 1.0)
    scale = torch.where(
        lum > 1e-12, reinhard / torch.clamp(lum, min=1e-12), torch.zeros_like(lum)
    )
    return color * scale[..., None]


def linear_to_srgb(color: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    # 1 / gamma rounded in float32, as the JAX package computes it
    inv_gamma = float(np.float32(1.0) / np.float32(gamma))
    return torch.pow(torch.clamp(color, min=0.0), inv_gamma)


def denoise_composite(
    direct_lighting: torch.Tensor,
    indirect_specular: torch.Tensor,
    params: dict,
    impl: str = "auto",
) -> torch.Tensor:
    """The compositor's dispatch: horizontal pass over the indirect-specular
    AOV -> vertical pass -> composite + exposure + tonemap + gamma. Inputs
    are [H, W, 3] linear HDR; returns [H, W, 3].

    impl: 'auto' is ``ops.bilateral.bilateral_pass``, kernel B2 on CUDA
    tensors and the plain version on CPU tensors; 'torch' is the plain
    version on any device. debug_visualize == 2 shows the raw input, so
    both passes are skipped (the JAX package computes and discards them)."""
    return composite_tail(direct_lighting,
                          _filtered(direct_lighting, indirect_specular, params, impl), params)


def _filtered(direct_lighting, indirect_specular, params: dict, impl: str) -> torch.Tensor:
    """The two bilateral passes of one frame (B2 launches on CUDA tensors
    with impl 'auto'), or the raw input under debug_visualize 2."""
    if impl not in ("auto", "torch"):
        raise ValueError(f"unknown impl {impl!r} (auto or torch)")
    if int(params["debug_visualize"]) == 2:
        return indirect_specular
    run_pass = bilateral.bilateral_pass if impl == "auto" else _bilateral_pass
    radius = float(params["max_kernel_size"])
    pass0 = run_pass(indirect_specular, direct_lighting, radius, 1)
    return run_pass(pass0, direct_lighting, radius, 0)


def denoise_composite_frames(
    direct_lighting: torch.Tensor,
    indirect_specular: torch.Tensor,
    params: dict,
    impl: str = "auto",
) -> torch.Tensor:
    """K frames' denoise + composite (the frames-in-flight batch,
    models/realtime.py): inputs [K, H, W, 3]; the K filter chains (2K
    launches of B2 on CUDA tensors) are queued back to back with no host
    sync between them, then the composite tail runs once on the K frames
    (elementwise: each frame equals ``denoise_composite``'s bit for bit).
    Returns [K, H, W, 3]."""
    filtered = [_filtered(d, s, params, impl) for d, s in zip(direct_lighting, indirect_specular)]
    with annotate("denoise.stack", len(filtered)):
        pass1 = stack_frames(filtered)
        del filtered  # the frames' memory back before the composite, as a temporary's
    return composite_tail(direct_lighting, pass1, params)


def stack_frames(frames: list) -> torch.Tensor:
    """Frames stacked on a new leading [K] axis; one frame is a view of
    itself, not a copy, so a batch of one costs what the frame costs."""
    return frames[0][None] if len(frames) == 1 else torch.stack(frames)


def denoise_composite_frames_temporal(
    direct_lighting: torch.Tensor,
    indirect_specular: torch.Tensor,
    params: dict,
    history: torch.Tensor | None,
    history_valid: bool,
    alpha: float,
    impl: str = "auto",
):
    """The temporal frames batch: the K composites (``denoise_composite_
    frames``), then the history carried through them in order, each frame
    blended into it as ``DenoiseCompositor.dispatch`` blends one;
    history_valid False seeds it with the first frame's composite. Returns
    (final history, the blended frames [K, H, W, 3])."""
    outs = []
    for out in denoise_composite_frames(direct_lighting, indirect_specular, params, impl):
        history = temporal_blend(history, out, alpha) if history_valid else out
        history_valid = True
        outs.append(history)
    return history, stack_frames(outs)


def composite_tail(
    direct_lighting: torch.Tensor, pass1: torch.Tensor, params: dict
) -> torch.Tensor:
    """Composite + exposure + tonemap + gamma after the two passes.

    debug modes: 0 filtered + direct; 1 filtered only; 2 raw input;
    3 direct only."""
    with annotate("denoise.composite"):
        dbg = int(params["debug_visualize"])
        if dbg == 0:
            color = pass1 + direct_lighting
        else:
            color = direct_lighting if dbg == 3 else pass1
        color = color * float(np.float32(params["exposure"]))
        if params["tonemap"]:
            color = torch.clamp(reinhard_tonemap(color), min=0.0)
        if params["gamma_correct"]:
            color = torch.clamp(linear_to_srgb(color, params["gamma"]), 0.0, 1.0)
        return color


def temporal_blend(history: torch.Tensor, current: torch.Tensor, alpha: float) -> torch.Tensor:
    """Exponential temporal accumulation: lerp(history, current, alpha)."""
    return history + (current - history) * float(np.float32(alpha))


class DenoiseCompositor:
    """Host-side wrapper of the reference class shape (create / load
    resources / dispatch): the parameter dict (the UI surface), optional
    mock inputs on ``device``, and an optional temporal history (reset on
    camera move, like the progressive pipeline's accumulation)."""

    def __init__(
        self,
        params: dict | None = None,
        temporal_alpha: float | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = setup_device(device)
        self.params = params or default_denoise_params()
        self.active = True
        self.mock_inputs: tuple | None = None
        self.temporal_alpha = temporal_alpha  # None = spatial only (reference parity)
        self._history: torch.Tensor | None = None

    def load_mock_resources(self, direct_img, indirect_img) -> None:
        """The reference's fixture-image mode: fixed inputs for dispatch()."""
        self.mock_inputs = tuple(
            torch.as_tensor(np.asarray(img, np.float32)).to(self.device)
            for img in (direct_img, indirect_img)
        )

    def reset_history(self) -> None:
        """Call on camera move / scene change (ghosting guard)."""
        self._history = None

    def dispatch(self, direct_lighting=None, indirect_specular=None) -> torch.Tensor:
        if direct_lighting is None:
            if self.mock_inputs is None:
                raise ValueError("no inputs and no mock resources loaded")
            direct_lighting, indirect_specular = self.mock_inputs
        with annotate("denoise.dispatch", 1):
            out = denoise_composite(direct_lighting, indirect_specular, self.params)
            if self.temporal_alpha is not None:
                if self._history is None or self._history.shape != out.shape:
                    self._history = out
                else:
                    self._history = temporal_blend(self._history, out, self.temporal_alpha)
                return self._history
            return out

    def dispatch_frames(self, direct_lighting, indirect_specular) -> torch.Tensor:
        """Dispatch over a leading [K] frame axis (the frames-in-flight batch,
        models/realtime.py): the K filter chains queued back to back, the
        temporal history carried through them when temporal_alpha is set.
        Returns [K, H, W, 3]; the history advances exactly as K sequential
        dispatch() calls would."""
        with annotate("denoise.dispatch_frames", int(direct_lighting.shape[0])):
            if self.temporal_alpha is None:
                return denoise_composite_frames(direct_lighting, indirect_specular, self.params)
            valid = (self._history is not None
                     and self._history.shape == direct_lighting.shape[1:])
            self._history, outs = denoise_composite_frames_temporal(
                direct_lighting, indirect_specular, self.params,
                self._history if valid else None, valid, self.temporal_alpha)
            return outs
