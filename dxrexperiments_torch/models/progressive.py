"""Progressive (accumulation) path tracing (``dxrexperiments_tpu.models.progressive``).

Each step renders S samples and folds their mean into the running average

    accum = (base * accum + S * mean) / (base + S)

and skips the work once the accumulated count reaches max_iterations. The
state (image, count, last camera view-projection, host RNG) is explicit and
checkpointable.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.camera import stack_cameras
from ..ops import fused_sample
from ..scene.lights import default_lights
from ..trace.integrator import default_options, resolve_impl
from .base import RaytracingPipeline, has_camera_moved, wall_seed


def make_progressive_step(
    scene: dict,
    width: int,
    height: int,
    samples_per_step: int = 1,
):
    """Return ``step(accum, options, cameras, lights, env, max_iterations)``,
    a closure over the scene tensors. ``cameras`` is CameraParams stacked on
    a leading [S] axis (S = samples_per_step).

    On a CUDA device, each step is one ``fused_sample.fused_progressive_sum``
    launch; scenes outside the kernel's scope have no CUDA route yet and
    raise (ROADMAP Queue A item 10). On the CPU each step is the kernel's
    plain version, the wavefront integrator summed over the S samples."""
    s_count = int(samples_per_step)
    env_kind = int(scene["env"]["kind"])
    use_kernel = resolve_impl("auto", scene["mt_pack"].device) == "cuda"
    if use_kernel and not fused_sample.supports_fused(scene, "progressive", False):
        raise NotImplementedError(
            "this scene needs the wavefront route, which has no CUDA kernel yet "
            "(kernel B3, ROADMAP Queue A item 10)"
        )
    sample_sum = (
        fused_sample.fused_progressive_sum
        if use_kernel
        else fused_sample.fused_progressive_sum_reference
    )

    def step(accum, options, cameras, lights, env, max_iterations):
        base_count = float(cameras["accum_count"][0])
        if base_count >= float(max_iterations):
            return accum
        full = dict(scene, lights=lights, env=env)
        mean = sample_sum(full, options, cameras, width, height, env_kind) / s_count
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
        if (
            has_camera_moved(self.camera, self.last_vp)
            or not self.frame_accumulation_enabled
            or self._frame_dirty
        ):
            self.accum_count = 0
            self.last_vp = self.camera.view_proj_matrix()
            self._frame_dirty = False

        s_count = self.samples_per_frame
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

    def _step_fn(self):
        # Rebuild the step only when the geometry or the static config changes;
        # lights and env stay arguments, so animating them rebuilds nothing.
        key = (self.width, self.height, self.samples_per_frame, id(self.scene_data["mt_pack"]))
        if self._step_key != key:
            self._step = make_progressive_step(
                self.scene_data, self.width, self.height, samples_per_step=self.samples_per_frame
            )
            self._step_key = key
        return self._step

    def render(self) -> torch.Tensor:
        self.accum = self._step_fn()(
            self.accum,
            self.options,
            self._camera_params,
            self.scene_data["lights"],
            self.scene_data["env"],
            self.max_iterations,
        )
        return self.accum

    def get_output(self, index: int = 0) -> torch.Tensor:
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
