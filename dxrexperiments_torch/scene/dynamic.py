"""Animated instances of two-level scenes (``dxrexperiments_tpu.scene.dynamic``).

``refit_scene_instances`` is the per-frame TLAS refit. The JAX module's
brute-force re-bake (``prepare_base``/``bake_instances``, flattened
world-space triangles per frame) and its PRIME table update are not on this
path and wait in ROADMAP Queue A item 13.
"""

from __future__ import annotations

from ..accel import tlas as tlas_mod


def refit_scene_instances(scene: dict, transforms) -> dict:
    """Per-frame animation of a two-level scene (``Scene.build_two_level``):
    the TLAS boxes and the instances' inverse and normal matrices for new
    [I, 4, 4] transforms, as O(instances) work on the scene's device, with no
    triangle re-bake and no BVH rebuild; the analogue of a D3D12 TLAS update
    build (PERFORM_UPDATE). Returns a new scene dict; the BLAS arrays are
    shared with ``scene``. Only the TLAS layouts the scene carries are
    replaced: a TLAS without fat nodes stays without them, so its route
    keeps the binary walk (kernel B6b) from frame to frame."""
    ctx = scene["tlas_meta"]["refit_ctx"]
    dyn = tlas_mod.refit_instances_arrays(ctx, transforms, scene["tlas"]["mt_rows"].device)
    return dict(scene, tlas=dict(scene["tlas"],
                                 **{k: v for k, v in dyn.items() if k in scene["tlas"]}))
