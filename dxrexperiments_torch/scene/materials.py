"""Material model (``dxrexperiments_tpu.scene.materials``).

Fields: albedo, specular, emissive (rgb + strength in .a), reflectivity,
roughness, index of refraction and an integer type (0 diffuse, 1 glossy,
2 glass), and an optional albedo texture (``scene/textures.py``) that
multiplies the constant albedo at hit UVs. ``material_pack`` is the
fused-traversal kernel's [16, 128] material table; the texture is not part
of it (``Scene.build`` packs the textures into their own table).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import setup_device

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
    # optional [H, W, 3] (or [H, W]) float albedo image, multiplied into
    # `albedo` at hit UVs (scene/textures.py)
    albedo_texture: "np.ndarray | None" = None

    @staticmethod
    def reference_default() -> "Material":
        """The single material the reference app creates: a red glossy."""
        return Material(
            albedo=(0.95, 0.05, 0.0, 1.0),
            specular=(0.58, 0.58, 0.58, 1.0),
            roughness=0.5,
            reflectivity=0.7,
            type=MATERIAL_GLOSSY,
        )


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


def stack_materials(materials: list[Material], device="cuda") -> dict:
    """Stack host materials into the device SoA dict of tensors [M, ...] on
    ``device`` (default the card; without one it raises)."""
    device = setup_device(device)
    return {
        k: torch.as_tensor(v).to(device)
        for k, v in stack_materials_np(materials).items()
    }


# Row indices of the fused-traversal material table (material_pack).
MP_ALBEDO, MP_SPECULAR, MP_EMISSIVE = 0, 3, 6
MP_ESTR, MP_REFL, MP_ROUGH, MP_TYPE, MP_IOR = 9, 10, 11, 12, 13
MP_MAX_MATERIALS = 128


def material_pack(mats: dict) -> torch.Tensor:
    """Pack a stacked material dict (stack_materials) into the [16, 128]
    float32 table the fused-traversal kernel stages in shared memory, on the
    materials' device. Supports up to MP_MAX_MATERIALS materials."""
    m = int(mats["albedo"].shape[0])
    if m > MP_MAX_MATERIALS:
        raise ValueError(f"material_pack supports <= {MP_MAX_MATERIALS} materials, got {m}")
    pack = torch.zeros((16, MP_MAX_MATERIALS), dtype=torch.float32, device=mats["albedo"].device)
    pack[MP_ALBEDO : MP_ALBEDO + 3, :m] = mats["albedo"].T
    pack[MP_SPECULAR : MP_SPECULAR + 3, :m] = mats["specular"].T
    pack[MP_EMISSIVE : MP_EMISSIVE + 3, :m] = mats["emissive"].T
    pack[MP_ESTR, :m] = mats["emissive_strength"]
    pack[MP_REFL, :m] = mats["reflectivity"]
    pack[MP_ROUGH, :m] = mats["roughness"]
    pack[MP_TYPE, :m] = mats["type"].to(torch.float32)
    pack[MP_IOR, :m] = mats["ior"]
    return pack
