"""Realtime 1-spp pipeline producing the denoiser's AOVs
(``dxrexperiments_tpu.models.realtime``).

Same topology as the progressive pipeline but two outputs, direct lighting
and indirect specular; no accumulation (accumCount pinned to 0), a 10x
jitter scale and no indirect diffuse. Feeds models/denoise.py.

On a CUDA device each render is one launch of a realtime megakernel, B1's
``ops.fused_sample.realtime_aovs`` or B5's ``ops.fused_traverse.realtime_aovs``,
or the wavefront integrator whose traces run kernel B3 (brute-force scenes
B1 does not take), B4a or B4b (BVH scenes) or B6a or B6b (two-level scenes, attached with
``set_scene_data``), as ``select_route`` picks; on the CPU it is the plain
wavefront integrator in realtime mode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fused_sample, fused_traverse, traverse
from ..scene.lights import default_lights
from ..scene.scene import scene_device
from ..trace.integrator import default_options, render_sample, resolve_impl
from .base import RaytracingPipeline, select_route, wall_seed


def realtime_step(scene: dict, options: dict, camera: dict, width: int, height: int):
    """One realtime frame; returns (direct, indirect_specular), [H, W, 3]
    each. CUDA scenes launch the route's kernel, or take the wavefront
    integrator whose traces launch B3 (brute force), B4a or B4b (BVH) or B6a or B6b
    (two-level); CPU scenes take the wavefront integrator."""
    impl = resolve_impl("auto", scene_device(scene))
    route = select_route(scene, "realtime")
    if impl == "cuda" and route != "wavefront":
        # the AOVs without the color sum, which nothing downstream reads
        kernel = fused_sample if route == "fused" else fused_traverse
        out = kernel.realtime_aovs(
            scene, options, {k: v[None] for k, v in camera.items()}, width, height,
            int(scene["env"]["kind"]),
        )
        return out["direct"][0], out["indirect_specular"][0]
    out = render_sample(
        scene, options, camera, width, height, mode="realtime",
        jitter_scale=fused_sample.REALTIME_JITTER_SCALE, impl=impl,
    )
    return out["direct"], out["indirect_specular"]


class RealtimeRaytracingPipeline(RaytracingPipeline):
    name = "Realtime Raytracing"

    def __init__(
        self,
        width: int = 1920,
        height: int = 1080,
        seed: int | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(device)
        self.options = default_options()
        self.rng = np.random.default_rng(wall_seed() if seed is None else seed)
        self.animation_paused = True
        self.create_output_resource(width, height)
        self._camera_params = None

    def create_output_resource(self, width: int, height: int) -> None:
        super().create_output_resource(width, height)
        self.direct = torch.zeros((height, width, 3), dtype=torch.float32, device=self.device)
        self.indirect_specular = torch.zeros_like(self.direct)

    @property
    def num_outputs(self) -> int:
        return 2

    def update(self, elapsed_time: float, elapsed_frames: int) -> None:
        if self.animation_paused:
            elapsed_time = 142.0  # the reference's freeze point
        # accumCount pinned to 0: every frame is a fresh sample
        self._camera_params = self._frame_camera_params(elapsed_frames, 0, self.rng)
        if self.scene_data is not None and self.owns_lights:
            self.scene_data = dict(self.scene_data, lights=default_lights(elapsed_time))

    def render(self):
        self.direct, self.indirect_specular = realtime_step(
            self.scene_data, self.options, self._camera_params, self.width, self.height
        )
        return self.direct, self.indirect_specular

    def get_output(self, index: int = 0) -> torch.Tensor:
        traverse.check_errors()  # raises for a BVH walk that overflowed its stack
        return self.direct if index == 0 else self.indirect_specular
