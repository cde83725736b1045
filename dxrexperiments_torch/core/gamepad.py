"""Analog gamepad input through the Linux joystick API
(``dxrexperiments_tpu.core.gamepad``, copied). The left stick feeds the
forward/strafe axes and the right stick yaw/pitch, after a radial dead zone,
into :class:`~.camera_controller.InputState`'s analog fields: the path the
keyboard's booleans take, so gamepad and keyboard compose. The source is
``/dev/input/js*`` (8-byte ``struct js_event`` records); the reader is pure
over any file-like object, so tests drive it with ``make_event`` streams.
"""

from __future__ import annotations

import os
import struct

from .camera_controller import InputState

# struct js_event { __u32 time; __s16 value; __u8 type; __u8 number; }
_EVENT = struct.Struct("<IhBB")
_JS_EVENT_BUTTON = 0x01
_JS_EVENT_AXIS = 0x02
_JS_EVENT_INIT = 0x80  # synthetic state-dump events sent on open

# Standard xpad/evdev axis numbering (Xbox-class pads, the devices XInput
# serves): 0/1 left stick X/Y, 3/4 right stick X/Y. Y axes point down.
AXIS_LX, AXIS_LY, AXIS_RX, AXIS_RY = 0, 1, 3, 4
# XInput's left-thumb deadzone is 7849/32767 ~ 0.24; GameInput filters with
# the same constant. Keep the radial form (per stick, not per axis).
DEADZONE = 7849.0 / 32767.0


def _filtered(x: float, y: float) -> tuple[float, float]:
    """Radial deadzone + rescale so output magnitude spans [0, 1]."""
    mag = (x * x + y * y) ** 0.5
    if mag <= DEADZONE:
        return 0.0, 0.0
    scale = min(1.0, (mag - DEADZONE) / (1.0 - DEADZONE)) / mag
    return x * scale, y * scale


class Gamepad:
    """Polls a joystick event stream into per-frame analog axes.

    ``fd`` is a non-blocking file descriptor (or any object with ``read``)
    yielding ``js_event`` records. Axis state persists between polls (the
    kernel only reports changes); buttons are exposed as a held-state set.
    """

    def __init__(self, fd, name: str = "js"):
        self._fd = fd
        self.name = name
        self._axes: dict[int, float] = {}
        self._buttons: set[int] = set()
        self._partial = b""

    @classmethod
    def open(cls, path: str | None = None) -> "Gamepad | None":
        """Open the first /dev/input/js* node (or ``path``); None if absent."""
        candidates = [path] if path else sorted(
            f"/dev/input/{n}"
            for n in (os.listdir("/dev/input") if os.path.isdir("/dev/input") else [])
            if n.startswith("js")
        )
        for cand in candidates:
            try:
                fd = os.open(cand, os.O_RDONLY | os.O_NONBLOCK)
            except OSError:
                continue
            return cls(fd, name=cand)
        return None

    def _read(self) -> bytes:
        if isinstance(self._fd, int):
            try:
                return os.read(self._fd, 4096)
            except BlockingIOError:
                return b""
            except OSError:
                return b""
        return self._fd.read(4096) or b""

    def poll(self) -> None:
        """Drain pending events into the axis/button state."""
        data = self._partial + self._read()
        n = len(data) - len(data) % _EVENT.size
        self._partial = data[n:]
        for off in range(0, n, _EVENT.size):
            _, value, etype, number = _EVENT.unpack_from(data, off)
            kind = etype & ~_JS_EVENT_INIT
            if kind == _JS_EVENT_AXIS:
                self._axes[number] = value / 32767.0
            elif kind == _JS_EVENT_BUTTON:
                (self._buttons.add if value else self._buttons.discard)(number)

    def buttons(self) -> frozenset:
        return frozenset(self._buttons)

    def apply(self, inp: InputState) -> InputState:
        """Merge current stick state into an InputState (in place).

        Left stick -> analog_forward/analog_strafe, right stick ->
        analog_yaw/analog_pitch, the reference's axis routing. Stick Y is
        negated: the kernel reports down-positive, the controller wants
        up-positive.
        """
        self.poll()
        lx, ly = _filtered(self._axes.get(AXIS_LX, 0.0), self._axes.get(AXIS_LY, 0.0))
        rx, ry = _filtered(self._axes.get(AXIS_RX, 0.0), self._axes.get(AXIS_RY, 0.0))
        inp.analog_strafe += lx
        inp.analog_forward += -ly
        inp.analog_yaw += rx
        inp.analog_pitch += -ry
        return inp

    def close(self) -> None:
        if isinstance(self._fd, int):
            try:
                os.close(self._fd)
            except OSError:
                pass


def make_event(number: int, value: float, *, axis: bool = True, init: bool = False) -> bytes:
    """Build one js_event record (test fixture helper)."""
    etype = (_JS_EVENT_AXIS if axis else _JS_EVENT_BUTTON) | (
        _JS_EVENT_INIT if init else 0
    )
    raw = int(round(value * 32767.0)) if axis else int(value)
    raw = max(-32767, min(32767, raw))
    return _EVENT.pack(0, raw, etype, number)
