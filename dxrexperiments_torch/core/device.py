"""Device selection for the port.

A name that asks for CUDA on a machine without a card raises: the port never
falls back to the CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def setup_device(name: str | torch.device = "cuda") -> torch.device:
    """Resolve ``name`` to a torch.device and pin float32 math to full
    precision.

    TF32 is switched off for matmuls and cuDNN: the plain path's intersection
    terms are float32 contractions, and TF32 keeps about three decimal
    digits, which flips hit/miss decisions against the float32 kernel and
    the JAX reference (parity)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
