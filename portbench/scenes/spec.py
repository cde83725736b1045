"""The scene spec: the plain data a generator under ``scenes/`` returns and
both sides of the benchmark read.

    meshes     [{"positions" [V, 3] f32, "normals" [V, 3] f32 (unit),
                 "indices" [F, 3] i32, "material_ids" [F] i32}]
    instances  [{"mesh": index, "transform": [4, 4] f32,
                 "material": override index or None}]
    materials  [material(...)], the port's Material fields
    lights     {"dir": {forward, color, intensity},
                "point": {position, color, intensity}}
    env        {"kind": "constant", color, strength} or
               {"kind": "gradient", horizon, zenith, strength}
    camera     {eye, at, up, fov_y}: the framing the traffic moves from

``harness.port_scene`` lowers it to the port's ``Scene``;
``reference.RefScene`` to the reference renderer's world-space triangles.
"""

from __future__ import annotations


def material(albedo=(1.0, 1.0, 1.0), specular=(0.0, 0.0, 0.0), emissive=(0.0, 0.0, 0.0, 0.0),
             reflectivity=0.0, roughness=1.0, ior=1.5, type=0) -> dict:
    """One material with the reference application's defaults (type 0
    diffuse, 1 glossy, 2 glass; emissive is rgb + strength)."""
    return {"albedo": tuple(albedo), "specular": tuple(specular), "emissive": tuple(emissive),
            "reflectivity": float(reflectivity), "roughness": float(roughness),
            "ior": float(ior), "type": int(type)}
