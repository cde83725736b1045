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

The frames-in-flight batch (``render_frames``,
``make_realtime_denoise_frames_step``): K frames' cameras in one dispatch,
one launch of B1 or B5 for all K (their camera axis), K integrator frames
on the wavefront route, and the K denoiser chains queued after them with no
host sync between frames. It trades K frames of input latency for the host
cost of K - 1 dispatches, as the reference's ring of frames in flight does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import stack_cameras
from ..ops import fused_sample, fused_traverse
from ..ops.kernel import check_errors
from ..scene.lights import default_lights
from ..scene.scene import scene_device
from ..trace.integrator import default_options, render_sample, resolve_impl
from ..utils.profiling import annotate
from .base import RaytracingPipeline, select_route, wall_seed
from .denoise import denoise_composite_frames, stack_frames


def realtime_step(scene: dict, options: dict, camera: dict, width: int, height: int):
    """One realtime frame; returns (direct, indirect_specular), [H, W, 3]
    each: ``realtime_frames`` for one camera."""
    out = realtime_frames(scene, options, {k: v[None] for k, v in camera.items()}, width,
                          height)
    return out["direct"][0], out["indirect_specular"][0]


def realtime_frames(scene: dict, options: dict, cameras: dict, width: int, height: int) -> dict:
    """K realtime frames, one per camera of ``cameras`` (CameraParams
    stacked on a leading [K] axis): the AOV dict with a leading [K] axis,
    ``direct``, ``indirect_specular``, ``albedo`` [K, H, W, 3] and
    ``roughness`` [K, H, W] (and ``color`` where the plain path gives it).
    On a CUDA scene the B1 and B5 routes take ONE launch for the K frames;
    the wavefront route, and a CPU scene, K integrator frames. A frame does
    not depend on K: each equals the one-camera call's bit for bit."""
    impl = resolve_impl("auto", scene_device(scene))
    route = select_route(scene, "realtime")
    env_kind = int(scene["env"]["kind"])
    if impl == "cuda" and route != "wavefront":
        kernel = fused_sample if route == "fused" else fused_traverse
        return kernel.realtime_aovs(scene, options, cameras, width, height, env_kind)
    frames = [
        render_sample(scene, options, {k: v[f] for k, v in cameras.items()}, width, height,
                      mode="realtime", jitter_scale=fused_sample.REALTIME_JITTER_SCALE,
                      impl=impl, env_kind=env_kind)
        for f in range(int(cameras["eye"].shape[0]))
    ]
    return {k: stack_frames([f[k] for f in frames]) for k in frames[0]}


def make_realtime_denoise_frames_step(
    scene: dict,
    width: int,
    height: int,
    frames_per_step: int,
):
    """K realtime frames and their denoised composites in one dispatch.
    Returns ``step(options, cameras_K, lights, env, denoise_params) ->
    (aovs_K, display [K, H, W, 3])``: ``realtime_frames`` (one B1 or B5
    launch on a CUDA scene of those routes), then ``denoise_composite_frames``
    (2K B2 launches on CUDA tensors)."""
    k_frames = int(frames_per_step)
    if k_frames < 1:
        raise ValueError(f"frames_per_step must be >= 1, got {frames_per_step}")

    def step(options, cameras, lights, env, denoise_params):
        if int(cameras["eye"].shape[0]) != k_frames:
            raise ValueError(f"expected {k_frames} cameras, got {int(cameras['eye'].shape[0])}")
        out = realtime_frames(dict(scene, lights=lights, env=env), options, cameras, width,
                              height)
        img = denoise_composite_frames(out["direct"], out["indirect_specular"], denoise_params)
        return out, img

    return step


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
        with annotate("realtime.update"):
            # accumCount pinned to 0: every frame is a fresh sample
            with annotate("realtime.cameras", 1):
                self._camera_params = self._frame_camera_params(elapsed_frames, 0, self.rng)
            if self.scene_data is not None and self.owns_lights:
                self.scene_data = dict(self.scene_data, lights=default_lights(elapsed_time))

    def render(self):
        with annotate("realtime.render", 1):
            self.direct, self.indirect_specular = realtime_step(
                self.scene_data, self.options, self._camera_params, self.width, self.height
            )
        return self.direct, self.indirect_specular

    def frame_cameras(self, elapsed_frames: int, k: int) -> dict:
        """CameraParams of frames [elapsed_frames, elapsed_frames + k),
        stacked on a leading [k] axis, the jitter drawn in order from
        ``self.rng`` as k sequential update() calls draw it."""
        with annotate("realtime.cameras", k):
            return stack_cameras([self._frame_camera_params(elapsed_frames + f, 0, self.rng)
                                  for f in range(k)])

    def render_frames(self, elapsed_frames: int, k: int):
        """Render frames [elapsed_frames, elapsed_frames + k) in one dispatch
        (``realtime_frames``). Returns (direct [k, H, W, 3],
        indirect_specular [k, H, W, 3]); the last frame's AOVs become the
        pipeline's current outputs.

        Lights and env are frozen for the k frames: a sequential update() +
        render() loop with owns_lights and animation unpaused re-derives
        default_lights(elapsed_time) each frame, which this batch does not.
        With animation paused (the default) or a scene's own rig, the batch
        equals k sequential render() calls bit for bit."""
        with annotate("realtime.render_frames", k):
            out = realtime_frames(self.scene_data, self.options,
                                  self.frame_cameras(elapsed_frames, k), self.width, self.height)
        self.direct, self.indirect_specular = out["direct"][-1], out["indirect_specular"][-1]
        return out["direct"], out["indirect_specular"]

    def get_output(self, index: int = 0) -> torch.Tensor:
        check_errors()  # raises for a BVH walk that overflowed its stack
        return self.direct if index == 0 else self.indirect_specular
