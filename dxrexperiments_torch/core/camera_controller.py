"""Fly-camera controller: WASD/QE movement and heading/pitch look with
momentum (``dxrexperiments_tpu.core.camera_controller``, copied). Input is
a plain :class:`InputState` snapshot a frame, so the controller is pure
host logic; the viewer maps keys, mouse drags and a gamepad onto it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .camera import Camera


@dataclasses.dataclass
class InputState:
    """One frame of input. Keys are held-state booleans; mouse is a delta."""

    forward: bool = False  # W
    backward: bool = False  # S
    strafe_left: bool = False  # A
    strafe_right: bool = False  # D
    ascend: bool = False  # E
    descend: bool = False  # Q
    mouse_dx: float = 0.0
    mouse_dy: float = 0.0
    analog_yaw: float = 0.0
    analog_pitch: float = 0.0
    # Analog movement axes in [-1, 1] (gamepad sticks/triggers). They ADD to
    # the digital booleans, as the reference's analog stick axes feed the
    # same controller paths as key edges.
    analog_forward: float = 0.0
    analog_strafe: float = 0.0
    analog_ascent: float = 0.0
    fine_movement: bool = False
    fine_rotation: bool = False


class CameraController:
    """Heading/pitch fly camera with exponential momentum smoothing."""

    def __init__(self, camera: Camera, world_up=(0.0, 1.0, 0.0)):
        self.camera = camera
        up = np.asarray(world_up, np.float64)
        self.world_up = up / np.linalg.norm(up)
        # As the reference controller's constructor:
        # north = normalize(cross(up, +X)), east = cross(north, up).
        north = np.cross(self.world_up, np.array([1.0, 0.0, 0.0]))
        self.world_north = north / np.linalg.norm(north)
        self.world_east = np.cross(self.world_north, self.world_up)

        self.horizontal_look_sensitivity = 2.0
        self.vertical_look_sensitivity = 2.0
        self.move_speed = 10.0
        self.strafe_speed = 10.0
        self.mouse_sensitivity_x = 0.6
        self.mouse_sensitivity_y = 0.6
        self.momentum = True
        self.first_person_mouse = False

        # The reference computes Sin(dot) here, a small-angle approximation;
        # this uses the exact asin, as the JAX package does.
        fwd = camera.forward.astype(np.float64)
        self.current_pitch = math.asin(
            float(np.clip(np.dot(fwd, self.world_up), -1.0, 1.0))
        )
        flat = np.cross(self.world_up, camera.right.astype(np.float64))
        flat /= np.linalg.norm(flat)
        self.current_heading = math.atan2(
            -float(np.dot(flat, self.world_east)), float(np.dot(flat, self.world_north))
        )

        self._last = {"yaw": 0.0, "pitch": 0.0, "forward": 0.0, "strafe": 0.0, "ascent": 0.0}

    @staticmethod
    def _apply_momentum(old: float, new: float, dt: float) -> float:
        """The reference controller's ApplyMomentum."""
        if abs(new) > abs(old):
            blend = 0.6 ** (dt * 60.0)
        else:
            blend = 0.8 ** (dt * 60.0)
        return old * blend + new * (1.0 - blend)

    def update(self, dt: float, inp: InputState) -> None:
        speed_scale = 0.2 if inp.fine_movement else 1.0
        pan_scale = 0.5 if inp.fine_rotation else 1.0

        yaw = inp.analog_yaw * self.horizontal_look_sensitivity * pan_scale
        pitch = inp.analog_pitch * self.vertical_look_sensitivity * pan_scale
        forward = self.move_speed * speed_scale * dt * (
            (1.0 if inp.forward else 0.0) - (1.0 if inp.backward else 0.0)
            + inp.analog_forward
        )
        strafe = self.strafe_speed * speed_scale * dt * (
            (1.0 if inp.strafe_right else 0.0)
            - (1.0 if inp.strafe_left else 0.0)
            + inp.analog_strafe
        )
        ascent = self.strafe_speed * speed_scale * dt * (
            (1.0 if inp.ascend else 0.0) - (1.0 if inp.descend else 0.0)
            + inp.analog_ascent
        )

        if self.momentum:
            for key, val in (
                ("yaw", yaw),
                ("pitch", pitch),
                ("forward", forward),
                ("strafe", strafe),
                ("ascent", ascent),
            ):
                self._last[key] = self._apply_momentum(self._last[key], val, dt)
            yaw, pitch = self._last["yaw"], self._last["pitch"]
            forward, strafe, ascent = (
                self._last["forward"],
                self._last["strafe"],
                self._last["ascent"],
            )

        if self.first_person_mouse:
            # Mouse input bypasses momentum, as in the reference.
            yaw += inp.mouse_dx * self.mouse_sensitivity_x
            pitch += inp.mouse_dy * self.mouse_sensitivity_y

        self.current_pitch = min(math.pi / 2, max(-math.pi / 2, self.current_pitch + pitch))
        self.current_heading -= yaw
        if self.current_heading > math.pi:
            self.current_heading -= 2 * math.pi
        elif self.current_heading <= -math.pi:
            self.current_heading += 2 * math.pi

        # orientation = [east, up, -north] * rotY(heading) * rotX(pitch).
        base = np.stack([self.world_east, self.world_up, -self.world_north], axis=1)
        ch, sh = math.cos(self.current_heading), math.sin(self.current_heading)
        cp, sp = math.cos(self.current_pitch), math.sin(self.current_pitch)
        rot_y = np.array([[ch, 0, sh], [0, 1, 0], [-sh, 0, ch]])
        rot_x = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        orientation = base @ rot_y @ rot_x  # columns: right, up, back(-fwd)... see below

        # Columns of `orientation` are the camera's right/up/-forward axes.
        right = orientation[:, 0]
        up = orientation[:, 1]
        neg_fwd = orientation[:, 2]
        delta = orientation @ np.array([strafe, ascent, -forward])
        self.camera.position = (self.camera.position.astype(np.float64) + delta).astype(
            np.float32
        )
        self.camera.right = right.astype(np.float32)
        self.camera.up = up.astype(np.float32)
        self.camera.forward = (-neg_fwd).astype(np.float32)
