"""Material model (``dxrexperiments_tpu.scene.materials``).

Fields: albedo, specular, emissive (rgb + strength in .a), reflectivity,
roughness, index of refraction and an integer type (0 diffuse, 1 glossy,
2 glass). Textured albedo waits for ROADMAP Queue A item 12.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MATERIAL_DIFFUSE = 0
MATERIAL_GLOSSY = 1
MATERIAL_GLASS = 2


@dataclasses.dataclass
class Material:
    """One material with the reference-default values."""

    albedo: tuple = (1.0, 1.0, 1.0, 1.0)
    specular: tuple = (0.0, 0.0, 0.0, 1.0)
    emissive: tuple = (0.0, 0.0, 0.0, 0.0)  # rgb + strength
    reflectivity: float = 0.0
    roughness: float = 1.0
    ior: float = 1.5
    type: int = MATERIAL_DIFFUSE


def stack_materials_np(materials: list[Material]) -> dict:
    """Stack host materials into numpy SoA arrays [M, ...]."""
    if not materials:
        materials = [Material()]
    return {
        "albedo": np.array([m.albedo[:3] for m in materials], np.float32),
        "specular": np.array([m.specular[:3] for m in materials], np.float32),
        "emissive": np.array([m.emissive[:3] for m in materials], np.float32),
        "emissive_strength": np.array([m.emissive[3] for m in materials], np.float32),
        "reflectivity": np.array([m.reflectivity for m in materials], np.float32),
        "roughness": np.array([m.roughness for m in materials], np.float32),
        "ior": np.array([m.ior for m in materials], np.float32),
        "type": np.array([m.type for m in materials], np.int64),
    }


def stack_materials(materials: list[Material], device="cpu") -> dict:
    """Stack host materials into the device SoA dict of tensors [M, ...]."""
    return {
        k: torch.as_tensor(v).to(device)
        for k, v in stack_materials_np(materials).items()
    }
