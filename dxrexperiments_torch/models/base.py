"""Render pipeline interface (``dxrexperiments_tpu.models.base``)."""

from __future__ import annotations

import abc
import time

import numpy as np
import torch

from ..core.camera import Camera, camera_params
from ..core.device import setup_device
from ..scene.scene import Scene


class RaytracingPipeline(abc.ABC):
    """update / render / set_scene / set_camera / get_output.

    The pipeline holds its scene and output tensors on ``device``; a CUDA
    device without a card raises (no fallback to the CPU)."""

    name: str = "pipeline"

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = setup_device(device)
        self.camera: Camera | None = None
        self.scene_data: dict | None = None
        self.owns_lights = False

    def set_scene(self, scene: Scene) -> None:
        # Scenes with their own rig keep it; otherwise the pipeline owns
        # (and animates) the default rig.
        self.owns_lights = scene.lights is None
        self.scene_data = scene.build(self.device)

    def set_camera(self, camera: Camera) -> None:
        self.camera = camera

    def create_output_resource(self, width: int, height: int) -> None:
        self.width = width
        self.height = height

    @abc.abstractmethod
    def update(self, elapsed_time: float, elapsed_frames: int) -> None:
        ...

    @abc.abstractmethod
    def render(self):
        ...

    @abc.abstractmethod
    def get_output(self, index: int = 0):
        ...

    def _frame_camera_params(self, frame_count: int, accum_count: int, rng) -> dict:
        """CameraParams with the per-frame sub-pixel jitter draw from the
        host numpy Generator (the same draws as the JAX pipeline)."""
        x_jitter = (rng.random() - 0.5) / float(self.width)
        y_jitter = (rng.random() - 0.5) / float(self.height)
        return camera_params(
            self.camera,
            jitter=(x_jitter, y_jitter),
            frame_count=frame_count,
            accum_count=accum_count,
        )


def wall_seed() -> int:
    return int(time.time() * 1000) & 0xFFFFFFFF


def has_camera_moved(camera: Camera, last_vp: np.ndarray | None) -> bool:
    if last_vp is None:
        return True
    return not np.array_equal(camera.view_proj_matrix(), last_vp)
