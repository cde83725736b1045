"""The port's interactive viewer (app/viewer.py) and its input helpers
(core/timer.py, core/camera_controller.py, core/gamepad.py) against the JAX
package's, and utils/profiling.py, on the CPU at 16x12.

The helpers are copied host code: the same inputs give the same state,
exactly (camera matrices within 1e-6: float32 products of float64 angles).
The same key script through JAX's ViewerApp and the port's, with the camera
stepped at a fixed dt, ends in the same state: camera view-projection,
material 0 and the re-baked attr_pack, lights, options, AOV, env strength
and denoiser parameters. The other tests mirror tests/test_viewer_edit.py
and tests/test_input_display.py on the port.
"""

import base64
import dataclasses
import io
import os
import re
import types

import numpy as np
import pytest
import torch

from dxrexperiments_torch.app import viewer as tviewer
from dxrexperiments_torch.core import camera as tcam
from dxrexperiments_torch.core import camera_controller as tcc
from dxrexperiments_torch.core import gamepad as tpad
from dxrexperiments_torch.core import timer as ttimer
from dxrexperiments_torch.utils import profiling as tprof
from dxrexperiments_tpu.core import camera as jcam
from dxrexperiments_tpu.core import camera_controller as jcc
from dxrexperiments_tpu.core import gamepad as jpad
from dxrexperiments_tpu.core import timer as jtimer

W, H = 16, 12
SCRIPT = (list("wwaddijklqecgz-+mMnNtoOrRfFbBuUyYhH2317") + [("mouse", 3, -1), "ALT_ENTER"]
          + list("5]NO[ssq"))


def make_app(**kw):
    return tviewer.ViewerApp("cornell-glossy", width=W, height=H, device="cpu", **kw)


# --------------------------------------------------------------------------- #
# the key script against JAX's ViewerApp
# --------------------------------------------------------------------------- #
def run_script(app, keys, dt=1.0 / 30.0):
    for k in keys:
        inp, quit_requested = app.handle_keys([k])
        assert not quit_requested
        app.controller.update(dt, inp)
    return app


def test_key_script_ends_in_jax_state():
    from dxrexperiments_tpu.app.viewer import ViewerApp as JViewerApp

    got = run_script(make_app(), SCRIPT)
    want = run_script(JViewerApp("cornell-glossy", width=W, height=H), SCRIPT)
    np.testing.assert_allclose(got.camera.view_proj_matrix(), want.camera.view_proj_matrix(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.camera.position, want.camera.position, rtol=0, atol=1e-6)
    assert (got.active, got.aov, got.ao_only, got.fit_terminal) == (
        want.active, want.aov, want.ao_only, want.fit_terminal)
    assert got.env_strength == want.env_strength
    gm, wm = dataclasses.asdict(got.mat0), dataclasses.asdict(want.mat0)
    assert gm.pop("albedo_texture") is None and wm.pop("albedo_texture") is None
    assert gm == wm
    for key in ("max_kernel_size", "tonemap", "exposure"):
        assert got.denoiser.params[key] == type(got.denoiser.params[key])(
            np.asarray(want.denoiser.params[key])), key
    for gp, wp in zip(got.pipelines, want.pipelines):
        for key, value in gp.options.items():
            assert value == type(value)(np.asarray(wp.options[key])), key
        assert getattr(gp, "max_iterations", None) == getattr(wp, "max_iterations", None)
        assert getattr(gp, "refraction", None) == getattr(wp, "refraction", None)
        assert getattr(gp, "ao_only", None) == getattr(wp, "ao_only", None)
        for name, lt in wp.scene_data["lights"].items():
            for field, value in lt.items():
                np.testing.assert_array_equal(gp.scene_data["lights"][name][field].numpy(),
                                              np.asarray(value), err_msg=f"{name}.{field}")
        assert float(gp.scene_data["env"]["strength"]) == float(wp.scene_data["env"]["strength"])
        np.testing.assert_array_equal(gp.scene_data["attr_pack"].numpy(),
                                      np.asarray(wp.scene_data["attr_pack"]))
    assert got.ui_state() == want.ui_state()


# --------------------------------------------------------------------------- #
# StepTimer, CameraController, Gamepad against JAX's
# --------------------------------------------------------------------------- #
class FakeClock:
    def __init__(self, deltas_ns):
        self.t = 0
        self.deltas = list(deltas_ns)

    def perf_counter_ns(self):
        t = self.t
        if self.deltas:
            self.t += self.deltas.pop(0)
        return t


@pytest.mark.parametrize("fixed", [False, True])
def test_step_timer_matches_jax(monkeypatch, fixed):
    deltas = [16_000_000, 17_000_000, 250_000_000, 5_000_000, 900_000_000, 33_000_000] * 4
    states = []
    for mod in (ttimer, jtimer):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter_ns=FakeClock(deltas).perf_counter_ns))
        timer = mod.StepTimer()
        timer.is_fixed_timestep = fixed
        calls = []
        seq = []
        for _ in range(len(deltas) - 1):
            timer.tick(lambda: calls.append(1))
            seq.append((timer.elapsed_seconds, timer.total_seconds, timer.frame_count,
                        timer.frames_per_second, len(calls)))
        timer.reset_elapsed_time()
        states.append(seq)
    assert states[0] == states[1]
    assert states[0][-1][2] > 0


def controller_run(cam_mod, cc_mod, inputs):
    cam = cam_mod.Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    ctl = cc_mod.CameraController(cam)
    ctl.first_person_mouse = True
    out = []
    for dt, kw, momentum in inputs:
        ctl.momentum = momentum
        ctl.update(dt, cc_mod.InputState(**kw))
        out.append(np.concatenate([cam.position, cam.right, cam.up, cam.forward,
                                   [ctl.current_heading, ctl.current_pitch]]))
    return np.stack(out)


def test_camera_controller_matches_jax():
    rng = np.random.default_rng(2)
    fields = ("forward", "backward", "strafe_left", "strafe_right", "ascend", "descend",
              "fine_movement", "fine_rotation")
    inputs = []
    for k in range(60):
        kw = {f: bool(rng.random() < 0.3) for f in fields}
        kw.update(mouse_dx=float(rng.normal(0, 0.05)), mouse_dy=float(rng.normal(0, 0.05)),
                  analog_yaw=float(rng.uniform(-1, 1)), analog_pitch=float(rng.uniform(-1, 1)),
                  analog_forward=float(rng.uniform(-1, 1)),
                  analog_strafe=float(rng.uniform(-1, 1)),
                  analog_ascent=float(rng.uniform(-1, 1)))
        inputs.append((float(rng.uniform(1e-3, 0.1)), kw, k % 7 != 3))
    got = controller_run(tcam, tcc, inputs)
    want = controller_run(jcam, jcc, inputs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got[-1, :3] - got[0, :3]).max() > 0.1  # the camera moved


def test_gamepad_matches_jax():
    rng = np.random.default_rng(4)
    events = []
    for _ in range(40):
        if rng.random() < 0.3:
            events.append(((int(rng.integers(0, 4)), int(rng.integers(0, 2))),
                           {"axis": False}))
        else:
            events.append(((int(rng.choice([0, 1, 3, 4])), float(rng.uniform(-1.2, 1.2))),
                           {"init": bool(rng.random() < 0.2)}))
    stream = b"".join(tpad.make_event(*a, **kw) for a, kw in events)
    assert stream == b"".join(jpad.make_event(*a, **kw) for a, kw in events)
    results = []
    for pad_mod, cc_mod in ((tpad, tcc), (jpad, jcc)):
        src = io.BytesIO(stream)
        pad = pad_mod.Gamepad(types.SimpleNamespace(read=lambda n, s=src: s.read(13)))
        seq = []
        for _ in range(len(stream) // 13 + 2):  # reads split records
            inp = pad.apply(cc_mod.InputState(analog_yaw=0.25))
            seq.append((inp.analog_forward, inp.analog_strafe, inp.analog_yaw,
                        inp.analog_pitch, sorted(pad.buttons())))
        results.append(seq)
    assert results[0] == results[1]


# --------------------------------------------------------------------------- #
# tests/test_input_display.py on the port
# --------------------------------------------------------------------------- #
class _Stream:
    def __init__(self):
        self.buf = b""

    def feed(self, data: bytes) -> None:
        self.buf += data

    def read(self, n: int) -> bytes:
        out, self.buf = self.buf[:n], self.buf[n:]
        return out


def test_gamepad_axes_and_deadzone():
    st = _Stream()
    pad = tpad.Gamepad(st)
    st.feed(tpad.make_event(tpad.AXIS_LX, tpad.DEADZONE * 0.5))
    inp = pad.apply(tcc.InputState())
    assert inp.analog_strafe == 0.0 and inp.analog_forward == 0.0
    st.feed(tpad.make_event(tpad.AXIS_LX, 1.0) + tpad.make_event(tpad.AXIS_LY, -1.0))
    inp = pad.apply(tcc.InputState())
    assert inp.analog_strafe > 0.5 and inp.analog_forward > 0.5
    inp = pad.apply(tcc.InputState())
    assert inp.analog_strafe > 0.5
    st.feed(tpad.make_event(tpad.AXIS_RX, 0.8, init=True) + tpad.make_event(tpad.AXIS_RY, 0.0))
    inp = pad.apply(tcc.InputState())
    assert inp.analog_yaw > 0.5 and inp.analog_pitch == 0.0


def test_gamepad_partial_reads_and_buttons():
    st = _Stream()
    pad = tpad.Gamepad(st)
    ev = tpad.make_event(0, 1, axis=False)
    st.feed(ev[:3])
    pad.poll()
    assert pad.buttons() == frozenset()
    st.feed(ev[3:] + tpad.make_event(1, 1, axis=False))
    pad.poll()
    assert pad.buttons() == {0, 1}
    st.feed(tpad.make_event(0, 0, axis=False))
    pad.poll()
    assert pad.buttons() == {1}


def test_gamepad_drives_camera_like_keys():
    def fly(inp):
        cam = tcam.Camera()
        cam.position = np.zeros(3, np.float32)
        ctl = tcc.CameraController(cam)
        ctl.momentum = False
        for _ in range(10):
            ctl.update(1.0 / 60.0, inp)
        return cam.position.copy()

    key_pos = fly(tcc.InputState(forward=True))
    np.testing.assert_allclose(fly(tcc.InputState(analog_forward=1.0)), key_pos, rtol=1e-6)
    np.testing.assert_allclose(fly(tcc.InputState(analog_forward=0.5)), key_pos * 0.5,
                               rtol=1e-5)


_KITTY_RE = re.compile(r"\x1b_G([^;]*);([^\x1b]*)\x1b\\")


def test_kitty_present_is_pixel_accurate():
    img = np.random.default_rng(7).random((48, 64, 3)).astype(np.float32)
    out = io.StringIO()
    tviewer.KittyDisplay(out=out).present(img, hud="hud-line")
    text = out.getvalue()
    chunks = _KITTY_RE.findall(text)
    head = chunks[0][0]
    assert "a=T" in head and "f=24" in head and "s=64" in head and "v=48" in head
    got = np.frombuffer(base64.standard_b64decode("".join(c[1] for c in chunks)),
                        np.uint8).reshape(48, 64, 3)
    np.testing.assert_array_equal(got, np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8))
    assert "hud-line" in text
    assert all(len(c[1]) <= 4096 for c in chunks)
    assert "m=1" in text and chunks[-1][0].endswith("m=0")


def test_presenters_match_jax_and_fall_back_without_tty():
    from dxrexperiments_tpu.app.viewer import KittyDisplay as JKitty
    from dxrexperiments_tpu.app.viewer import TerminalDisplay as JTerminal

    img = np.random.default_rng(8).random((6, 10, 3)).astype(np.float32)
    for port_cls, jax_cls in ((tviewer.TerminalDisplay, JTerminal),
                              (tviewer.KittyDisplay, JKitty)):
        a, b = io.StringIO(), io.StringIO()
        port_cls(out=a).present(img, "hud")
        jax_cls(out=b).present(img, "hud")
        assert a.getvalue() == b.getvalue()
    w, h = tviewer.KittyDisplay(out=io.StringIO()).size()
    assert w >= 16 and h >= 16 and h % 2 == 0


# --------------------------------------------------------------------------- #
# tests/test_viewer_edit.py on the port
# --------------------------------------------------------------------------- #
def test_material_keys_rebake_and_restart():
    app = make_app()
    app.step(app.handle_keys([])[0])
    pipe = app.pipelines[0]
    assert pipe.accum_count > 0
    before = pipe.scene_data["attr_pack"].clone()
    r0 = app.mat0.roughness
    app.handle_keys(["r"])
    assert not torch.equal(before, pipe.scene_data["attr_pack"])
    assert abs(app.mat0.roughness - max(0.0, r0 - 0.1)) < 1e-6
    assert not torch.equal(before, app.pipelines[1].scene_data["attr_pack"])
    app.step(app.handle_keys([])[0])
    assert pipe.accum_count == 1


def test_light_keys_update_args_and_restart():
    app = make_app()
    app.step(app.handle_keys([])[0])
    pipe = app.pipelines[0]
    i0 = float(pipe.scene_data["lights"]["dir"]["intensity"])
    app.handle_keys(["U"])
    i1 = float(pipe.scene_data["lights"]["dir"]["intensity"])
    assert abs(i1 - i0 * 1.25) < 1e-5
    app.handle_keys(["H"])
    assert tuple(pipe.scene_data["lights"]["point"]["color"].tolist()) != (1.0, 1.0, 1.0)
    app.step(app.handle_keys([])[0])
    assert pipe.accum_count == 1


def test_resize_recreates_outputs():
    app = make_app()
    app.step(app.handle_keys([])[0])
    app.resize(24, 20)
    assert (app.width, app.height) == (24, 20)
    for p in app.pipelines:
        assert (p.width, p.height) == (24, 20)
    pipe = app.pipelines[0]
    assert pipe.accum_count == 0
    img = app.step(app.handle_keys([])[0])
    assert img.shape[:2] == (20, 24)
    count = pipe.accum_count
    app.resize(24, 20)
    assert pipe.accum_count == count


def test_both_pipelines_present_finite_frames():
    app = make_app()
    for keys in ([], ["]"], ["2"], ["1"], ["["]):
        img = app.step(app.handle_keys(keys)[0])
        assert img.shape == (H, W, 3) and np.isfinite(img).all() and img.max() > 0.0
    assert app.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in app.pipelines)


def test_viewer_two_level_animate_steps():
    app = tviewer.ViewerApp("instanced:2", width=W, height=H, accel="two-level",
                            animate_instances=True, device="cpu")
    assert "tlas" in app.pipelines[0].scene_data
    assert app.step(tcc.InputState()).shape == (H, W, 3)
    tf_a = app.pipelines[0].scene_data["tlas"]["tlas_nodes"].clone()
    app.step(tcc.InputState())
    tf_b = app.pipelines[0].scene_data["tlas"]["tlas_nodes"]
    assert not torch.allclose(tf_a, tf_b)
    app.handle_keys(["]"])
    assert app.step(tcc.InputState()).shape == (H, W, 3)
    with pytest.raises(KeyError):  # a two-level scene has no material rows to re-bake
        app.handle_keys(["r"])


def test_input_parser_mouse_and_escapes():
    kb = tviewer.RawKeyboard.__new__(tviewer.RawKeyboard)
    kb._drag_from = None
    ev = kb.parse("\x1b[<0;10;5M" "\x1b[<32;13;4M" "\x1b[<0;13;4m")
    assert ("mouse", 3, -1) in ev
    assert kb._drag_from is None
    assert kb.parse("\x1b[<35;4;4M") == []
    assert kb.parse("\x1b[A\x1b[D") == ["i", "j"]
    assert kb.parse("\x1b\rw") == ["ALT_ENTER", "w"]


def test_raw_keyboard_is_inert_without_a_tty(monkeypatch):
    monkeypatch.setattr(tviewer.sys, "stdin", io.StringIO("wasd"))
    with tviewer.RawKeyboard() as kb:
        assert not kb.enabled and kb.poll() == []


def test_mouse_drag_and_alt_enter():
    app = make_app()
    fwd = np.array(app.camera.forward)
    inp, _ = app.handle_keys([("mouse", 8, 0)])
    assert inp.mouse_dx != 0.0
    app.step(inp)
    assert not np.allclose(fwd, np.array(app.camera.forward))
    before = app.fit_terminal
    app.handle_keys(["ALT_ENTER"])
    assert app.fit_terminal is (not before)
    app.handle_keys(["ALT_ENTER"])
    assert app.fit_terminal is before


def test_ui_state_roundtrip(tmp_path):
    app = make_app()
    app.handle_keys(["4", "N", "N", "O", "+", "R", "U", "g"])
    app.handle_keys(["]"])
    path = str(tmp_path / "ui.json")
    app.save_ui_state(path)
    app2 = make_app()
    assert app2.load_ui_state(path)
    assert app2.ui_state() == app.ui_state()
    assert torch.equal(app2.pipelines[0].scene_data["attr_pack"],
                       app.pipelines[0].scene_data["attr_pack"])
    assert not app2.load_ui_state(str(tmp_path / "nope.json"))


def viewer_args(*extra):
    return ["--scene", "cornell", "--size", f"{W}x{H}", "--device", "cpu", *extra]


def test_main_scripted_run_reports_frames(capsys):
    report = {}
    rc = tviewer.main(viewer_args("--display", "ansi", "--no-ui-state", "--max-frames", "6",
                                  "--script", "w]2\x1b\r\x1b\r["), report=report)
    assert rc == 0
    assert report["frames"] == 6 and report["recoveries"] == 0
    assert all(report["finite"]) and min(report["max"]) > 0.0
    assert len(report["frame_ms"]) == 6
    # Alt-Enter (an escape sequence in the script) fits the terminal from the
    # next frame on, the second one goes back
    fit = report["size"][4]
    assert report["size"] == [(W, H)] * 4 + [fit, (W, H)] and fit != (W, H)
    assert "\u2580" in capsys.readouterr().out


def test_viewer_auto_checkpoint_and_recovery(tmp_path, monkeypatch):
    calls = {"n": 0}
    orig = tviewer.ViewerApp.step

    def flaky(self, inp):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("synthetic device loss")
        return orig(self, inp)

    monkeypatch.setattr(tviewer.ViewerApp, "step", flaky)
    ckpt, ui = tmp_path / "auto.npz", tmp_path / "ui.json"
    report = {}
    rc = tviewer.main(viewer_args("--max-frames", "5", "--script", "wwwwwwwwx",
                                  "--auto-checkpoint", str(ckpt), "--checkpoint-every-sec", "0",
                                  "--ui-state", str(ui)), report=report)
    assert rc == 0
    assert calls["n"] >= 4
    assert ckpt.exists() and ui.exists()
    assert report["recoveries"] == 1 and report["frames"] == 5


def test_viewer_recovery_rebuilds_on_the_same_device(tmp_path, monkeypatch):
    devices = []
    real_init = tviewer.ViewerApp.__init__

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        devices.append(self.device)

    calls = {"n": 0}
    orig = tviewer.ViewerApp.step

    def flaky(self, inp):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("synthetic device loss")
        return orig(self, inp)

    monkeypatch.setattr(tviewer.ViewerApp, "__init__", init)
    monkeypatch.setattr(tviewer.ViewerApp, "step", flaky)
    report = {}
    tviewer.main(viewer_args("--max-frames", "3", "--script", "www", "--no-ui-state",
                             "--auto-checkpoint", str(tmp_path / "ck")), report=report)
    assert [d.type for d in devices] == ["cpu", "cpu"]
    assert report["recoveries"] == 1


def test_viewer_recovery_disabled_reraises(monkeypatch):
    def broken(self, inp):
        raise RuntimeError("synthetic device loss")

    monkeypatch.setattr(tviewer.ViewerApp, "step", broken)
    with pytest.raises(RuntimeError, match="synthetic device loss"):
        tviewer.main(viewer_args("--max-frames", "2", "--script", "wx", "--no-ui-state"))


def test_viewer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="cuda"):
        tviewer.ViewerApp("cornell", width=W, height=H)


def test_ui_state_default_path(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    tviewer.main(viewer_args("--max-frames", "1", "--script", "x"))
    assert os.path.exists(tmp_path / ".dxrexperiments_torch" / "viewer_ui.json")


# --------------------------------------------------------------------------- #
# utils/profiling.py
# --------------------------------------------------------------------------- #
def test_device_trace_and_frame_timer(tmp_path):
    app = make_app()
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        with tprof.annotate("viewer frame"):
            app.step(app.handle_keys([])[0])
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert "viewer frame" in {e.key for e in prof.key_averages()}
    timer = tprof.FrameTimer()
    with timer.phase("render", fence=lambda: app.pipelines[0].accum):
        app.step(app.handle_keys([])[0])
    with timer.phase("render"):
        pass
    assert set(timer.phases) == {"render"} and timer.phases["render"] > 0.0
    assert timer.report().startswith("total ")
