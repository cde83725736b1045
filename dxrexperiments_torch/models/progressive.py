"""Progressive (accumulation) path tracing (``dxrexperiments_tpu.models.progressive``).

Each step renders S samples and folds their mean into the running average

    accum = (base * accum + S * mean) / (base + S)

and skips the work once the accumulated count reaches max_iterations. The
state (image, count, last camera view-projection, host RNG) is explicit and
checkpointable.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from ..core.camera import stack_cameras
from ..ops import fused_sample, fused_traverse
from ..ops.kernel import check_errors
from ..scene.dynamic import refit_scene_instances
from ..scene.lights import default_lights
from ..scene.scene import scene_device
from ..trace.integrator import (
    default_options,
    progressive_sample_sum,
    render_sample,
    resolve_impl,
)
from ..utils.profiling import annotate
from .base import RaytracingPipeline, has_camera_moved, select_route, wall_seed


def progressive_step(
    scene: dict,
    options: dict,
    camera: dict,
    accum: torch.Tensor,
    max_iterations,
    width: int,
    height: int,
    ao_only: bool = False,
) -> torch.Tensor:
    """One accumulation step with the scene as an argument
    (``dxrexperiments_tpu.models.progressive.progressive_step``): one sample
    of ``camera`` through the integrator's ``render_sample``, folded into
    ``accum`` as ``(count * accum + color) / (count + 1)`` with count the
    camera's ``accum_count``; ``accum`` unchanged once count reaches
    ``max_iterations``. On a CUDA scene the integrator's traces launch the
    scene's trace kernels (B3 for a brute-force scene such as the Cornell
    box, B4a or B4b with a BVH, B6a or B6b two-level); on the CPU they are
    the plain versions. ``make_progressive_step`` is the pipelines' step
    (the megakernel routes, S samples a dispatch)."""
    count = float(camera["accum_count"])
    if count >= float(max_iterations):
        return accum
    cur = render_sample(scene, options, camera, width, height, mode="progressive",
                        ao_only=ao_only, jitter_scale=30.0,
                        impl=resolve_impl("auto", scene_device(scene)),
                        env_kind=int(scene["env"]["kind"]))["color"]
    return (count * accum + cur) / (count + 1.0)


def make_progressive_step(
    scene: dict,
    width: int,
    height: int,
    samples_per_step: int = 1,
    light_mc: bool = False,
    ao_only: bool = False,
    refraction: bool = False,
):
    """Return ``step(accum, options, cameras, lights, env, max_iterations,
    geometry=None)``. ``cameras`` is CameraParams stacked on a leading [S]
    axis (S = samples_per_step). ``geometry`` is the scene dict to render,
    by default ``scene``; it must take the route ``scene`` took (the same
    kind of structure and rig): a refit two-level scene passes its current
    arrays here, so the step never renders stale transforms.

    The route is ``select_route``'s. On a CUDA device each step is one
    launch of ``fused_sample.fused_progressive_sum`` (B1) or of
    ``fused_traverse.fused_traverse_progressive_sum`` (B5), or, on the
    wavefront route, S samples of the integrator with two closest and two
    any-hit launches each (AO: one closest and four any) of kernel B3
    (brute-force scenes), B4a or B4b (BVH) or B6a or B6b (two-level). On the CPU each step
    is the plain version, the wavefront integrator summed over the S
    samples. The env kind is fixed with the route; the env itself, a texture
    env's texture on the scene's device included, comes with every call, so
    a new texture of the same kind needs no new step.

    light_mc: passed on to ``fused_sample.fused_progressive_sum`` (see
    there); the other routes ignore it, as in JAX. ao_only: the AO view.
    refraction: the transmission bounce through glass (the wavefront route
    only, as in JAX)."""
    s_count = int(samples_per_step)
    env_kind = int(scene["env"]["kind"])
    route = select_route(scene, "progressive", ao_only, refraction)
    if route == "fused":
        sample_sum = functools.partial(fused_sample.fused_progressive_sum, light_mc=light_mc)
    elif route == "fused_traverse":
        sample_sum = fused_traverse.fused_traverse_progressive_sum
    else:
        sample_sum = functools.partial(
            progressive_sample_sum, jitter_scale=fused_sample.JITTER_SCALE,
            impl=resolve_impl("auto", scene_device(scene)), ao_only=ao_only,
            refraction=refraction)

    def step(accum, options, cameras, lights, env, max_iterations, geometry=None):
        base_count = float(cameras["accum_count"][0])
        if base_count >= float(max_iterations):
            return accum
        full = dict(scene if geometry is None else geometry, lights=lights, env=env)
        mean = sample_sum(full, options, cameras, width, height, env_kind)
        with annotate("progressive.fold"):
            mean = mean / s_count  # the sum freed here, as a temporary would be
            return (base_count * accum + s_count * mean) / (base_count + s_count)

    return step


class ProgressiveRaytracingPipeline(RaytracingPipeline):
    name = "Progressive Raytracing"

    def __init__(
        self,
        width: int = 512,
        height: int = 512,
        seed: int | None = None,
        samples_per_frame: int = 1,
        device: str | torch.device = "cuda",
    ):
        super().__init__(device)
        self.options = default_options()
        self.samples_per_frame = max(int(samples_per_frame), 1)
        self.max_iterations = 1024
        self.frame_accumulation_enabled = True
        self.animation_paused = True  # reference default
        self.ao_only = False  # the AO view
        self.refraction = False  # the opt-in transmission bounce through glass
        self.rng = np.random.default_rng(wall_seed() if seed is None else seed)
        self.accum_count = 0
        self.last_vp: np.ndarray | None = None
        self._frame_dirty = False
        self._camera_params = None
        self._step = None
        self._step_key = None
        self.create_output_resource(width, height)

    def create_output_resource(self, width: int, height: int) -> None:
        super().create_output_resource(width, height)
        self.accum = torch.zeros((height, width, 3), dtype=torch.float32, device=self.device)
        self.accum_count = 0
        self.last_vp = None

    def mark_dirty(self) -> None:
        """UI parameter change -> restart accumulation."""
        self._frame_dirty = True

    def update(self, elapsed_time: float, elapsed_frames: int) -> None:
        if self.animation_paused:
            elapsed_time = 142.0  # the reference's freeze point
        with annotate("progressive.update"):
            if (
                has_camera_moved(self.camera, self.last_vp)
                or not self.frame_accumulation_enabled
                or self._frame_dirty
            ):
                self.accum_count = 0
                self.last_vp = self.camera.view_proj_matrix()
                self._frame_dirty = False

            s_count = self.samples_per_frame
            with annotate("progressive.cameras", s_count):
                self._camera_params = stack_cameras([
                    self._frame_camera_params(
                        elapsed_frames * s_count + k,
                        self.accum_count,
                        self.rng,
                    )
                    for k in range(s_count)
                ])
            self.accum_count += s_count

            # Animated sun + default point light, only when the pipeline owns the rig.
            if self.scene_data is not None and self.owns_lights:
                self.scene_data = dict(self.scene_data, lights=default_lights(elapsed_time))

    def set_instance_transforms(self, transforms) -> None:
        """Animate the instances of a two-level scene by a TLAS refit
        (``scene/dynamic.refit_scene_instances``): O(instances) work on the
        card, no re-bake and no new step. Restarts accumulation (the scene
        changed). transforms: [I, 4, 4], a numpy array or a tensor."""
        if "tlas" not in self.scene_data:
            raise ValueError("set_instance_transforms needs a two-level scene "
                             "(Scene.build_two_level)")
        self.scene_data = refit_scene_instances(self.scene_data, transforms)
        self.mark_dirty()

    def _step_fn(self):
        # The step takes the current geometry as an argument, so it is rebuilt
        # only when the static config or what the route depends on changes;
        # lights, env and a refit's new arrays rebuild nothing.
        scene = self.scene_data
        key = (self.width, self.height, self.samples_per_frame, self.ao_only, self.refraction,
               select_route(scene, "progressive", self.ao_only, self.refraction),
               int(scene["env"]["kind"]), scene_device(scene), tuple(sorted(scene)))
        if self._step_key != key:
            self._step = make_progressive_step(
                scene, self.width, self.height, samples_per_step=self.samples_per_frame,
                ao_only=self.ao_only, refraction=self.refraction,
            )
            self._step_key = key
        return self._step

    def render(self) -> torch.Tensor:
        with annotate("progressive.render"):
            self.accum = self._step_fn()(
                self.accum,
                self.options,
                self._camera_params,
                self.scene_data["lights"],
                self.scene_data["env"],
                self.max_iterations,
                self.scene_data,
            )
        return self.accum

    def get_output(self, index: int = 0) -> torch.Tensor:
        check_errors()  # raises for a BVH walk that overflowed its stack
        return self.accum

    # -- checkpoint/resume ---------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "accum": self.accum.detach().cpu().numpy(),
            "accum_count": self.accum_count,
            "last_vp": self.last_vp,
        }

    def load_state_dict(self, state: dict) -> None:
        self.accum = torch.as_tensor(np.asarray(state["accum"], np.float32)).to(self.device)
        self.accum_count = int(state["accum_count"])
        self.last_vp = state["last_vp"]

    def save_checkpoint(self, path: str, frames_done: int | None = None) -> None:
        """Persist the accumulation state plus the host RNG state and frame
        index, so a resumed render draws the same jitter sequence and
        continues bit-identically. Same file layout as the JAX pipeline."""
        s = self.state_dict()
        rng_state = json.dumps(self.rng.bit_generator.state).encode()
        np.savez(
            path,
            accum=s["accum"],
            accum_count=np.asarray(s["accum_count"]),
            last_vp=s["last_vp"] if s["last_vp"] is not None else np.zeros((0,)),
            rng_state=np.frombuffer(rng_state, dtype=np.uint8),
            frames_done=np.asarray(-1 if frames_done is None else frames_done),
        )

    def load_checkpoint(self, path: str) -> int | None:
        """Restore a save_checkpoint file; returns the recorded frame index
        (None when the checkpoint has none)."""
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        self.load_state_dict(
            {
                "accum": z["accum"],
                "accum_count": int(z["accum_count"]),
                "last_vp": z["last_vp"] if z["last_vp"].size else None,
            }
        )
        if "rng_state" in z.files:
            self.rng.bit_generator.state = json.loads(z["rng_state"].tobytes().decode())
        if "frames_done" in z.files and int(z["frames_done"]) >= 0:
            return int(z["frames_done"])
        return None
