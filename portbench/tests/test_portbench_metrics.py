"""The metric arithmetic: rates over the whole window, the tail over all
frames, the idle share of a synthetic profile, and the frozen bounds of B1
and B2 against the port's own figures."""

import types

import numpy as np
import pytest
import torch
from conftest import SMALL

from portbench import drive, harness, roofline, trace


def units(latencies_ms, frames=1, samples=100):
    out, t = [], 0.0
    for i, ms in enumerate(latencies_ms):
        out.append({"index": i, "t0": t, "t1": t + ms / 1e3, "frames": frames,
                    "samples": samples, "dispatches": 1})
        t += ms / 1e3
    return out


def test_rate_counts_all_work_over_all_time():
    ctx = {"units": [{"index": -1, "samples": 10 ** 9}] + units([5.0] * 40, samples=2_000_000),
           "window_s": 0.25}
    assert harness.reader("mrays_per_s").read(ctx) == pytest.approx(40 * 2.0 / 0.25)
    assert harness.reader("frame_ms").read(ctx) == pytest.approx(250.0 / 40)


def test_p95_is_over_every_frame():
    lat = list(np.arange(1.0, 101.0))
    ctx = {"units": units(lat), "window_s": sum(lat) / 1e3}
    assert harness.reader("frame_ms_p95").read(ctx) == pytest.approx(np.percentile(lat, 95))
    assert harness.reader("frame_ms_p95").read({"units": units(lat, frames=3)}) is None


def ev(name, start, end, device=False, eid=0):
    return types.SimpleNamespace(
        name=name, id=eid, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU)


def test_idle_share_and_attribution_of_a_synthetic_profile():
    # host (the benchmark's clock, seconds from 5.0): render 0-100 us, present
    # 100-400 us; profiler (us): markers launched at -100 and 500, B1 50-250,
    # a copy 300-350
    h = lambda us: 5.0 + us * 1e-6  # noqa: E731
    events = [ev("cudaLaunchKernel", -100, -98, eid=1), ev("spin_kernel(long)", -95, -90, True, 1),
              ev("cudaLaunchKernel", 10, 12, eid=7), ev("cudaMemcpyAsync", 110, 112, eid=8),
              ev("fused_progressive_kernel(float const*)", 50, 250, True, 7),
              ev("Memcpy HtoD (Pinned -> Device)", 300, 350, True, 8),
              ev("cudaLaunchKernel", 500, 502, eid=2), ev("spin_kernel(long)", 505, 510, True, 2)]
    table = trace.kernel_table()
    red = trace.reduce(types.SimpleNamespace(events=lambda: events), table, [h(-100), h(500)],
                       [{"t0": h(0), "t1": h(400)}],
                       [("render", h(0), h(100), 0), ("present", h(100), h(400), 0)])
    assert red["window_s"] == pytest.approx(400e-6)
    assert red["busy_s"] == pytest.approx(250e-6)
    assert red["launched_share"] == 1.0
    assert [o["span"] for o in red["ops"]] == ["render", "present"]
    assert [o["id"] for o in red["ops"]] == ["B1", None]
    ctx = {"trace": red}
    assert harness.reader("device_idle_pct.progressive").read(ctx) == pytest.approx(37.5)
    bd = trace.breakdown(red)
    assert bd["device_ops"][0] == ["B1", pytest.approx(200e-6)]
    assert dict((k, v) for k, v in bd["idle_gaps"]) == {
        "render": pytest.approx(50e-6), "present": pytest.approx(100e-6)}
    assert trace.required(table, {"route": "fused", "denoise": True}) == ["B1", "B2"]


def test_slice_pace_compares_a_unit_inside_with_one_outside():
    us = units([4.0, 4.0, 6.0, 6.0, 4.0])
    pace = trace.pace(us[2:4], us[:2] + us[4:])
    assert pace == {"slice_ms": pytest.approx(6.0), "window_ms": pytest.approx(4.0)}
    assert trace.off_pace(pace, 0.10) and not trace.off_pace(pace, 0.6)


def test_an_off_pace_slice_is_profiled_again(monkeypatch):
    # units of 10 ms, but 20 ms under the first slice: it is dropped and the
    # next units are profiled in its place
    starts = []

    class Prof:
        def start(self):
            starts.append(len(window))

        def stop(self):
            pass

    monkeypatch.setattr(trace, "profiler", Prof)
    monkeypatch.setattr(trace, "mark", lambda: 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    window = []
    sl = trace.Slice(drive.Spans(), window, start_s=0.05, span_s=0.015, min_units=2,
                     limit=0.10, tries=3)
    t = 0.0
    for i in range(40):
        sl(i, t)
        ms = 20.0 if 5 <= i < 7 else 10.0
        window.append({"index": i, "t0": t, "t1": t + ms / 1e3})
        t += ms / 1e3
    sl(40, None)
    assert starts == [5, 7]
    assert (sl.first, sl.last, sl.done, sl.tries) == (7, 8, True, 1)
    assert sl.profiled == {5, 6, 7, 8}


def test_b2_bound_is_the_ports_figure():
    # PERF.md's B2 bound: 0.0223 ms a 1080p pass at radius 12, bound by bytes
    ms, by = roofline.b2_bound(1920, 1080, 12.0)
    assert by == "bytes" and ms == pytest.approx(0.0223, abs=5e-5)


def test_b1_bound_arithmetic():
    # chip_smoke.py's B1 bound: live rays x num_tris pair tests of 50 operations,
    # 44 words a triangle read once, 12 output bytes a pixel (40 realtime)
    ms, by = roofline.b1_bound(23.45e6, 36, 512 * 512, False)
    assert by == "operations" and ms == pytest.approx(0.630, rel=2e-3)
    ms_b, by_b = roofline.b1_bound(0, 36, 1920 * 1080, True)
    assert by_b == "bytes" and ms_b == pytest.approx((36 * 44 * 4 + 1920 * 1080 * 40) / 3.35e9)


@pytest.mark.parametrize("cell", ["cornell512_progressive", "cornell1080_realtime_fif3"])
def test_b1_census_counts_the_rays_the_ports_plain_path_tests(cell, monkeypatch):
    """The census that B1's bound reads equals the live rays of the port's
    plain path (chip_smoke.py's PairCount) on the same launch."""
    from dxrexperiments_torch.ops import fused_sample, intersect

    small = SMALL[cell]
    parts = harness.cell_parts(harness.manifest(), cell)  # both cells are in BENCHMARK.json
    tr = dict(parts["traffic"], **small["traffic"])
    tr["compare"] = dict(tr["compare"], pixels=tr["width"] * tr["height"])
    spec = harness.scene_spec(parts["config"])
    drv = drive.Driver(spec, tr, 77, "cpu", drive.Spans())
    drv.build()
    drv.run_unit(-1)
    drv.window(0.0)
    unit = drv.units[-1]
    counted = {"rays": 0}
    closest, any_ = intersect.intersect_closest, intersect.intersect_any

    def live(d, t_min, t_max, occlusion):
        tmax = torch.as_tensor(t_max).expand(d.shape[0])
        ok = tmax > t_min
        if occlusion:
            ok = ok & (d.abs().sum(1) > 0)
        counted["rays"] += int(ok.sum())

    def c(scene, o, d, t_min=1e-4, t_max=1e38, **kw):
        live(d, t_min, t_max, False)
        return closest(scene, o, d, t_min, t_max, **kw)

    def a(scene, o, d, t_min=1e-4, t_max=1e38, **kw):
        live(d, t_min, t_max, True)
        return any_(scene, o, d, t_min, t_max, **kw)

    monkeypatch.setattr(intersect, "intersect_closest", c)
    monkeypatch.setattr(intersect, "intersect_any", a)
    pipe = drv.pipe
    if drv.realtime:
        # the unit's cameras again: its jitter draws from a fresh stream, its poses
        pipe.rng = np.random.default_rng(drv.seed)
        pipe.rng.random(2 * unit["frame0"])
        cams = []
        for f, p in enumerate(unit["poses"]):
            drv.cam.set_eye_at_up(p["eye"], p["at"], p["up"])
            cams.append({k: v[0] for k, v in pipe.frame_cameras(unit["frame0"] + f, 1).items()})
        cams = {k: torch.stack([c[k] for c in cams]) for k in cams[0]}
        fused_sample.realtime_aovs(pipe.scene_data, pipe.options, cams, drv.w, drv.h, 0)
    else:
        fused_sample.fused_progressive_sum(pipe.scene_data, pipe.options, pipe._camera_params,
                                           drv.w, drv.h, 0)
        unit = dict(unit, dispatch0=drv.dispatch - 1, dispatches=1)
    assert harness.b1_rays(spec, drv, "cpu", [unit]) == counted["rays"]
