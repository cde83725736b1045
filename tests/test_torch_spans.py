"""The program's spans (``dxrexperiments_torch.utils.profiling``): the
recorder on its own, the spans each layer records on the CPU at 16x12, the
kernel wrappers' steps through a stand-in library, and outputs bit-equal
with the recorder on and off. On the card (marked ``cuda``):
``device_trace``'s CUDA-only default and the wrappers' spans around real
launches."""

import contextlib
import threading
import time
import types

import numpy as np
import pytest
import torch

from dxrexperiments_torch.app.headless import build_scene
from dxrexperiments_torch.core.camera import camera_params, stack_cameras
from dxrexperiments_torch.models.denoise import DenoiseCompositor
from dxrexperiments_torch.models.progressive import ProgressiveRaytracingPipeline
from dxrexperiments_torch.models.realtime import RealtimeRaytracingPipeline
from dxrexperiments_torch.ops import fused_sample as fs
from dxrexperiments_torch.ops import fused_traverse as ft
from dxrexperiments_torch.ops import kernel
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.trace.integrator import default_options
from dxrexperiments_torch.utils import native
from dxrexperiments_torch.utils import profiling as prof

W, H = 16, 12


@pytest.fixture
def recorder():
    """The recorder on, from an empty list; off again after the test."""
    prof.enable()
    yield prof
    prof.disable()


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.t0) if s.parent == parent.id]


# --------------------------------------------------------------------------- #
# the recorder
# --------------------------------------------------------------------------- #
def test_off_records_nothing_and_returns_the_shared_no_op(monkeypatch):
    prof.enable()
    prof.disable()
    assert prof.annotate("a.b") is prof.annotate("c.d", 3)

    def forbidden(*args, **kwargs):
        raise AssertionError("a span read the clock or entered a record_function while off")

    monkeypatch.setattr(time, "perf_counter", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    with prof.annotate("a.b", 1):
        with prof.annotate("a.c"):
            pass
    monkeypatch.undo()
    assert prof.spans() == [] and prof.dropped() == 0


def test_nesting_parents_work_counts_and_clock(recorder):
    before = time.perf_counter()
    with prof.annotate("layer.outer", 2):
        with prof.annotate("layer.inner", 5):
            pass
        with prof.annotate("layer.inner"):
            pass
    after = time.perf_counter()
    spans = prof.spans()
    assert [s.name for s in spans] == ["layer.inner", "layer.inner", "layer.outer"]
    outer = spans[-1]
    assert outer.parent == -1 and outer.n == 2
    assert [s.parent for s in spans[:2]] == [outer.id, outer.id]
    assert [s.n for s in spans[:2]] == [5, None]
    assert len({s.id for s in spans}) == 3
    for s in spans:
        assert before <= s.t0 <= s.t1 <= after
        assert outer.t0 <= s.t0 and s.t1 <= outer.t1


def test_each_thread_keeps_its_own_stack(recorder):
    gate = threading.Barrier(2)

    def work(tag):
        with prof.annotate(f"{tag}.outer"):
            gate.wait()  # both outer spans are open before either inner one
            with prof.annotate(f"{tag}.inner"):
                gate.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = {s.name: s for s in prof.spans()}
    assert set(spans) == {"a.outer", "a.inner", "b.outer", "b.inner"}
    for tag in "ab":
        assert spans[f"{tag}.outer"].parent == -1
        assert spans[f"{tag}.inner"].parent == spans[f"{tag}.outer"].id


def test_cap_counts_dropped_records_and_enable_starts_afresh(recorder, monkeypatch):
    monkeypatch.setattr(prof, "MAX_SPANS", 3)
    for i in range(5):
        with prof.annotate("x.step", i):
            pass
    assert [s.n for s in prof.spans()] == [0, 1, 2] and prof.dropped() == 2
    prof.enable()
    assert prof.spans() == [] and prof.dropped() == 0


def test_cpu_trace_names_spans_while_the_recorder_is_off(tmp_path):
    with prof.device_trace(str(tmp_path / "trace")) as p:
        with prof.annotate("probe.step"):
            torch.ones(4).add_(1)
    assert "probe.step" in {e.key for e in p.key_averages()}
    assert prof.spans() == []
    assert prof.annotate("probe.step") is prof.annotate("other.step")  # off again after


# --------------------------------------------------------------------------- #
# the layers on the CPU
# --------------------------------------------------------------------------- #
def progressive(seed=3, s=2):
    sc, cam = build_scene("cornell-glossy")
    pipe = ProgressiveRaytracingPipeline(W, H, seed=seed, samples_per_frame=s, device="cpu")
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    return pipe


def realtime(seed=3):
    sc, cam = build_scene("cornell-glossy")
    pipe = RealtimeRaytracingPipeline(W, H, seed=seed, device="cpu")
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    return pipe, DenoiseCompositor(device="cpu")


def test_progressive_spans(recorder):
    pipe = progressive(s=2)
    prof.enable()  # from an empty list
    for d in range(2):
        pipe.update(d / 60.0, d)
        pipe.render()
    spans = prof.spans()
    updates, renders = by_name(spans, "progressive.update"), by_name(spans, "progressive.render")
    assert len(updates) == len(renders) == 2
    for u, r in zip(updates, renders):
        assert children(spans, u) == ["progressive.cameras"]
        assert by_name(spans, "progressive.cameras")[0].n == 2
        assert children(spans, r) == ["B1.wrapper", "progressive.fold"]
    assert {s.n for s in by_name(spans, "B1.wrapper")} == {2}


def test_realtime_and_denoiser_spans(recorder):
    pipe, den = realtime()
    prof.enable()  # from an empty list
    pipe.update(0.0, 0)
    direct, spec = pipe.render()
    den.dispatch(direct, spec)
    direct, spec = pipe.render_frames(1, 3)
    den.dispatch_frames(direct, spec)
    spans = prof.spans()
    (upd,) = by_name(spans, "realtime.update")
    assert children(spans, upd) == ["realtime.cameras"]
    (frames,) = by_name(spans, "realtime.render_frames")
    assert frames.n == 3 and "realtime.cameras" in children(spans, frames)
    assert [s.n for s in sorted(by_name(spans, "realtime.cameras"), key=lambda s: s.t0)] == [1, 3]
    assert by_name(spans, "realtime.render")[0].n == 1
    (one,) = by_name(spans, "denoise.dispatch")
    assert one.n == 1
    assert children(spans, one) == ["B2.wrapper", "B2.wrapper", "denoise.composite"]
    (batch,) = by_name(spans, "denoise.dispatch_frames")
    assert batch.n == 3
    assert children(spans, batch) == ["B2.wrapper"] * 6 + ["denoise.stack", "denoise.composite"]


def test_realtime_wrapper_span_on_the_plain_path(recorder):
    pipe, _ = realtime()
    cams = pipe.frame_cameras(0, 2)
    prof.enable()  # from an empty list
    fs.realtime_aovs(pipe.scene_data, pipe.options, cams, W, H, int(pipe.scene_data["env"]["kind"]))
    spans = prof.spans()
    (wrapper,) = [s for s in spans if s.parent == -1]
    assert wrapper.name == "B1.wrapper" and wrapper.n == 2
    # the plain version is the wavefront integrator, whose spans nest inside
    samples = by_name(spans, "wavefront.sample")
    assert len(samples) == 2 and all(s.parent == wrapper.id for s in samples)
    assert {s.name.split(".")[0] for s in spans if s is not wrapper} == {"wavefront"}


def test_outputs_bit_equal_with_the_recorder_on_and_off():
    def run():
        pipe = progressive(seed=11)
        rt, den = realtime(seed=11)
        outs = []
        for d in range(2):
            pipe.update(d / 60.0, d)
            outs.append(pipe.render().clone())
            rt.update(d / 60.0, d)
            outs += list(rt.render())
            outs.append(den.dispatch(*outs[-2:]))
        direct, spec = rt.render_frames(2, 2)
        return outs + [direct, spec, den.dispatch_frames(direct, spec)]

    off = run()
    prof.enable()
    try:
        on = run()
        assert len(prof.spans()) > 0
    finally:
        prof.disable()
    for a, b in zip(off, on, strict=True):
        assert torch.equal(a, b)


def test_scene_build_spans(recorder):
    sc, _ = build_scene("instanced:1")
    data = sc.build("cpu", accel="bvh")
    spans = prof.spans()
    (build,) = by_name(spans, "scene.build")
    assert children(spans, build) == ["scene.bvh", "scene.upload", "scene.records",
                                      "scene.bvh_to_device"]
    assert by_name(spans, "scene.bvh")[0].n == data["num_tris"]
    prof.enable()  # from an empty list
    sc.build_two_level("cpu")
    spans = prof.spans()
    (build,) = by_name(spans, "scene.build")
    # a BLAS a unique mesh (the sphere and the floor), then the upload
    assert children(spans, build) == ["scene.bvh", "scene.bvh", "scene.upload"]


def test_kernel_load_span(recorder, monkeypatch):
    monkeypatch.setattr(native, "_libs", {})  # loaded afresh in this process
    native.get_lib()
    (load,) = prof.spans()
    assert load.name == "kernel_load" and load.n in (0, 1)


# --------------------------------------------------------------------------- #
# the kernel wrappers' steps, through a stand-in library on CPU tensors
# --------------------------------------------------------------------------- #
@pytest.fixture
def stand_in_launch(monkeypatch):
    """The wrappers' CUDA path on CPU tensors: the device checks see a card,
    the pinned upload is a host copy, the library's entry points return 0."""
    def upload(cam, cst, frames, device):
        return torch.cat([cam.reshape(-1).view(torch.int32), cst.reshape(-1).view(torch.int32),
                          frames])

    lib = types.SimpleNamespace(**{
        name: (lambda *args: 0) for name in (
            "dxr_fused_progressive_sum", "dxr_fused_realtime_outputs",
            "dxr_fused_traverse_progressive_sum", "dxr_fused_traverse_realtime_outputs")})
    monkeypatch.setattr(kernel, "on_card", lambda device: True)
    monkeypatch.setattr(fs, "_upload", upload)
    monkeypatch.setattr(fs.B1, "lib", lib)
    monkeypatch.setattr(ft.B5, "lib", lib)
    monkeypatch.setattr(kernel, "queue_error_check", lambda err, what: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    kernel.reset_launch_counts()


def cameras(cam, s):
    rng = np.random.default_rng(0)
    return stack_cameras([camera_params(cam, jitter=tuple(rng.random(2) - 0.5), frame_count=k)
                          for k in range(s)])


STEPS = ["pack", "upload", "alloc", "launch"]


@pytest.mark.parametrize("realtime_mode", [False, True])
def test_b1_wrapper_steps(recorder, stand_in_launch, realtime_mode):
    sc, cam = build_scene("cornell-glossy")
    scene = sc.build("cpu")
    entry = fs.realtime_aovs if realtime_mode else fs.fused_progressive_sum
    prof.enable()  # from an empty list
    entry(scene, default_options(), cameras(cam, 3), W, H, int(scene["env"]["kind"]))
    spans = prof.spans()
    (wrapper,) = by_name(spans, "B1.wrapper")
    assert wrapper.n == 3 and children(spans, wrapper) == [f"B1.{s}" for s in STEPS]
    n = launch_counts()
    assert (n["B1 realtime"], n["B1"]) == ((1, 0) if realtime_mode else (0, 1))


@pytest.mark.parametrize("realtime_mode", [False, True])
def test_b5_wrapper_steps(recorder, stand_in_launch, realtime_mode):
    sc, cam = build_scene("instanced:1")
    scene = sc.build("cpu", accel="bvh")
    entry = ft.realtime_aovs if realtime_mode else ft.fused_traverse_progressive_sum
    prof.enable()  # from an empty list
    entry(scene, default_options(), cameras(cam, 2), W, H, int(scene["env"]["kind"]))
    spans = prof.spans()
    (wrapper,) = by_name(spans, "B5.wrapper")
    assert wrapper.n == 2 and children(spans, wrapper) == [f"B5.{s}" for s in STEPS]
    n = launch_counts()
    assert (n["B5 realtime"], n["B5"]) == ((1, 0) if realtime_mode else (0, 1))


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_trace_records_cuda_alone_by_default(card, tmp_path):
    sc, cam = build_scene("cornell-glossy")
    pipe = RealtimeRaytracingPipeline(64, 48, seed=1, device=card)
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    pipe.update(0.0, 0)
    pipe.render()
    pipe.update(0.0, 1)
    with prof.device_trace(str(tmp_path / "cuda")) as p:
        with prof.annotate("probe.frame"):
            pipe.render()
    events = list(p.events())
    kernels = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("fused_realtime_kernel" in k for k in kernels), kernels
    assert "probe.frame" not in {e.name for e in events}  # no CPU operators, no ranges
    with prof.device_trace(str(tmp_path / "cpu"), cpu_ops=True) as p:
        with prof.annotate("probe.frame"):
            pipe.render()
    assert "probe.frame" in {e.key for e in p.key_averages()}


@pytest.mark.cuda
def test_pipeline_spans_on_the_card(card, recorder):
    sc, cam = build_scene("cornell-glossy")
    pipe = ProgressiveRaytracingPipeline(64, 48, seed=1, samples_per_frame=4, device=card)
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    rt = RealtimeRaytracingPipeline(64, 48, seed=1, device=card)
    rt.set_camera(cam)
    rt.set_scene(sc)
    den = DenoiseCompositor(device=card)
    pipe.update(0.0, 0)
    pipe.render()
    direct, spec = rt.render_frames(0, 3)
    den.dispatch_frames(direct, spec)
    torch.cuda.synchronize(card)
    spans = prof.spans()
    wrappers = sorted(by_name(spans, "B1.wrapper"), key=lambda s: s.t0)
    assert [w.n for w in wrappers] == [4, 3]
    for w in wrappers:
        assert children(spans, w) == [f"B1.{s}" for s in STEPS]
    (render,) = by_name(spans, "progressive.render")
    assert children(spans, render) == ["B1.wrapper", "progressive.fold"]
    (frames,) = by_name(spans, "realtime.render_frames")
    assert children(spans, frames) == ["realtime.cameras", "B1.wrapper"]
    assert len(by_name(spans, "B2.wrapper")) == 6
    assert {s.n for s in by_name(spans, "kernel_load")} <= {0, 1}
