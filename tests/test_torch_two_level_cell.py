"""The animated two-level deployment as a benchmark cell,
``instanced32_two_level_animated`` (BENCHMARK.json): 1,024 sphere instances
of one BLAS and a floor, turned by a TLAS refit every dispatch, rendered
progressively on the wavefront route, whose traces launch B6a on a card.

On the CPU: a whole run of the benchmark's harness is correct, and a refit
that keeps the old transforms is not; a recorded run holds the refit's and
the wavefront route's spans, nested and counted as the integrator's
docstring says; B6a's launch span nests in its trace span (a stand-in
library on CPU tensors); B1's and B5's card paths open none of these
spans; B6a's bound (``portbench/roofline_b6a.py``) counts as by hand.

The harness runs at the cell's small size of ``portbench/tests/conftest.py``
(32 x 24, a 2 x 2 grid) with one sample a dispatch in place of four: the
plain two-level walk takes about a second a sample on the CPU, and a run
makes at least three dispatches (the warm-up and two compared units)."""

import contextlib
import ctypes
import io
import json
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from test_torch_spans import cameras, stand_in_launch  # noqa: F401 (a fixture)

from dxrexperiments_torch.app.headless import build_scene
from dxrexperiments_torch.models import progressive as prog_mod
from dxrexperiments_torch.ops import fused_sample as fs
from dxrexperiments_torch.ops import fused_traverse as ft
from dxrexperiments_torch.ops import traverse2
from dxrexperiments_torch.ops import kernel
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.trace import integrator
from dxrexperiments_torch.trace.integrator import default_options, render_sample
from dxrexperiments_torch.utils import profiling as prof
from portbench import harness, roofline, roofline_b6a

CELL = "instanced32_two_level_animated"
W, H, GRID = 32, 24, 2
SMALL = {"traffic": {"width": W, "height": H, "samples_per_dispatch": 1,
                     "compare": {"pixels": 256, "early_span": 1}},
         "scene": {"grid": GRID}}
INSTANCES = GRID * GRID + 1  # the spheres and the floor
SEED = 2147483659  # over 32 signed bits, as the benchmark's seeds are


@pytest.fixture(autouse=True)
def jax_of_the_test_process(monkeypatch):
    """``tests/conftest.py`` loads JAX into this process before any test, so
    the harness's check that a run loads none sees only what the run loads
    on top of what was there (``portbench/tests`` checks a run in a process
    of its own)."""
    before = set(harness.forbidden_modules())
    real = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules", lambda: sorted(set(real()) - before))


def run_cell(seed=SEED):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.run(["--workload", CELL, "--seed", str(seed), "--seconds", "0.2"],
                         device="cpu", overrides=SMALL)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_the_cell_is_in_the_benchmark():
    man = harness.manifest()
    parts = harness.cell_parts(man, CELL)
    assert parts["cell"]["chips"] == 1 and parts["traffic"]["accel"] == "two_level"
    assert "animate" in parts["traffic"]
    # Its own configuration: the flattened cell's scene, built two-level.
    flat = harness.cell_parts(man, "instanced32_1080_realtime")["config"]
    assert parts["config_entry"]["name"] == parts["config"]["name"] == "instanced32_two_level"
    assert parts["config"]["accel"] == "two_level"
    assert (parts["config"]["generator"], parts["config"]["params"]) == (
        flat["generator"], flat["params"])
    names = {m["name"] for m in harness.metrics_of(man, CELL, "per_layer")}
    assert {"B6a_ms.progressive", "glue_ms.progressive", "refit_ms",
            "B6a_roofline.progressive", "host_ms.progressive",
            "device_idle_pct.progressive", "scene_build_s"} <= names
    assert {m["name"] for m in harness.metrics_of(man, CELL, "end_to_end")} == {
        "mrays_per_s", "setup_s"}
    for m in harness.metrics_of(man, CELL, "per_layer"):
        assert hasattr(harness.reader(m["name"]), "read"), m["name"]


def test_sound_run_is_correct():
    out = run_cell()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2
    assert set(out["metrics"]) == {"mrays_per_s", "setup_s"}


def test_a_refit_that_keeps_the_old_transforms_is_not_correct(monkeypatch):
    monkeypatch.setattr(prog_mod, "refit_scene_instances", lambda scene, transforms: scene)
    out = run_cell()
    assert not out["correct"], out["checks"]


def tree(spans):
    kids = {}
    for s in sorted(spans, key=lambda s: s.t0):
        kids.setdefault(s.parent, []).append(s)
    return kids


def names(kids, span):
    return [(c.name, c.n) for c in kids.get(span.id, [])]


def test_a_recorded_run_holds_the_refit_and_wavefront_spans():
    prof.enable()
    try:
        out = run_cell()
    finally:
        prof.disable()
    assert out["correct"], out["checks"]
    spans = prof.spans()
    kids = tree(spans)
    dispatches = out["attempted"] + 1  # the warm-up too; one dispatch a unit
    refits = [s for s in spans if s.name == "refit"]
    assert len(refits) == dispatches
    for r in refits:
        assert r.n == INSTANCES and names(kids, r) == [("refit.tlas", INSTANCES)]
    samples = [s for s in spans if s.name == "wavefront.sample"]
    assert len(samples) == dispatches and {s.n for s in samples} == {W * H}
    n = W * H  # a sample's primary rays; 2 lights a shading point; 2 bounces a hit
    for s in samples:
        (_, _, _, primary, shade0) = kids[s.id]
        assert [c.name for c in kids[s.id][:3]] == ["wavefront.upload"] * 3
        assert {c.n for c in kids[s.id][:3]} == {0}  # on the CPU nothing is copied
        assert (primary.name, primary.n) == ("wavefront.trace", n)
        assert (shade0.name, shade0.n) == ("wavefront.shade", n)
        assert names(kids, shade0) == [("wavefront.trace", 2 * n), ("wavefront.trace", 2 * n),
                                       ("wavefront.shade", 2 * n)]
        shade1 = kids[shade0.id][2]
        assert names(kids, shade1) == [("wavefront.trace", 4 * n)]
    # every span of the route lies under a sample or a refit
    for sp in spans:
        if sp.name.startswith("wavefront.") and sp.name != "wavefront.sample":
            parent = {x.id: x for x in spans}[sp.parent]
            assert parent.name.startswith("wavefront."), sp
    assert prof.dropped() == 0


def test_upload_spans_count_the_bytes_that_cross():
    cam = {"eye": torch.zeros(3), "u": torch.zeros(3), "v": torch.zeros(3), "w": torch.zeros(3),
           "jitter": torch.zeros(2), "frame_count": torch.tensor(7, dtype=torch.int64),
           "accum_count": torch.tensor(0.0), "kind": 1}
    assert integrator._bytes_off(cam, torch.device("meta")) == 4 * 3 * 4 + 2 * 4 + 8 + 4
    assert integrator._bytes_off(cam, torch.device("cpu")) == 0
    lights = {"dir": [torch.zeros(2, 3)], "point": ({"position": torch.zeros(1, 3)},)}
    assert integrator._bytes_off(lights, torch.device("meta")) == 6 * 4 + 3 * 4


@pytest.fixture
def stand_in_b6a(monkeypatch):
    """B6a's CUDA path on CPU tensors: the device checks see a card, the
    library's entry point writes misses (slot and instance -1, no
    occlusion) and returns 0."""
    def walk(*args):
        rays, occlusion = args[5], args[10]
        if occlusion:
            ctypes.memset(args[17], 0, rays)
        else:
            for ptr in args[12:17]:  # t, slot, u, v, inst
                ctypes.memset(ptr, 0xFF, 4 * rays)
        return 0

    monkeypatch.setattr(kernel, "on_card", lambda device: True)
    monkeypatch.setattr(traverse2.WALKS["fat"][0], "lib",
                        types.SimpleNamespace(dxr_traverse2_fat=walk))
    monkeypatch.setattr(kernel, "queue_error_check", lambda err, what: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    kernel.reset_launch_counts()


def test_each_b6a_launch_span_nests_in_its_trace_span(stand_in_b6a):
    sc, cam = build_scene("instanced:1")
    scene = sc.build_two_level("cpu")
    assert "tlasf_nodes" in scene["tlas"]
    cams = cameras(cam, 1)
    prof.enable()
    try:
        render_sample(scene, default_options(), {k: v[0] for k, v in cams.items()}, 16, 16,
                      impl="cuda", env_kind=int(scene["env"]["kind"]))
    finally:
        prof.disable()
    spans = prof.spans()
    kids = tree(spans)
    traces = [s for s in spans if s.name == "wavefront.trace"]
    n = launch_counts()
    assert len(traces) == 4 == n["B6a closest"] + n["B6a any"]
    for t in traces:
        assert names(kids, t) == [("B6a.launch", t.n)]
    assert sorted(t.n for t in traces) == [256, 512, 512, 1024]


@pytest.mark.parametrize("entry", ["B1.progressive", "B1.realtime", "B5.progressive",
                                   "B5.realtime"])
def test_the_fused_routes_open_no_wavefront_or_refit_span(stand_in_launch, entry):  # noqa: F811
    kernel, mode = entry.split(".")
    sc, cam = build_scene("cornell-glossy" if kernel == "B1" else "instanced:1")
    scene = sc.build("cpu") if kernel == "B1" else sc.build("cpu", accel="bvh")
    mod = fs if kernel == "B1" else ft
    fn = mod.realtime_aovs if mode == "realtime" else (
        fs.fused_progressive_sum if kernel == "B1" else ft.fused_traverse_progressive_sum)
    prof.enable()
    try:
        fn(scene, default_options(), cameras(cam, 2), 16, 12, int(scene["env"]["kind"]))
    finally:
        prof.disable()
    got = {s.name for s in prof.spans()}
    assert f"{kernel}.launch" in got
    assert not {g for g in got if g.startswith(("wavefront.", "refit", "B6"))}, got


def test_b6a_bound_counts_as_by_hand():
    # 1,000 rays, 2 instances, 3 BLAS triangles, 4 launches
    ops = 1000 * (36 + 50)
    nbytes = 1000 * (32 + 1) + 4 * (2 * 16 + 3 * 20) * 4
    assert nbytes == 34472
    bound_ms, by = roofline_b6a.b6a_bound(1000, 2, 3, 4)
    assert by == "bytes"
    assert bound_ms == pytest.approx(nbytes / roofline.HBM_RATE * 1e3, rel=1e-12)
    assert nbytes / roofline.HBM_RATE > ops / roofline.FP32_PEAK
    # operations bound it once rays outweigh the fixed reads 86 / 67e12 : 33 / 3.35e12
    bound_ms, by = roofline_b6a.b6a_bound(1e9, 0, 0, 0)
    assert by == "bytes" and bound_ms == pytest.approx(33e9 / 3.35e12 * 1e3)
    spec = harness.scene_spec(harness.cell_parts(harness.manifest(), CELL)["config"])
    assert len(spec["instances"]) == 1025 and roofline_b6a.blas_tris(spec) == 960 + 2


def test_the_roofline_reader_reads_the_slice():
    reader = harness.reader("B6a_roofline.progressive")
    spec = {"meshes": [{"indices": np.zeros((3, 3))}], "instances": [{"mesh": 0}] * 2}
    units = [{"index": i, "dispatches": 1} for i in range(4)]
    ops = [{"id": "B6a", "seconds": 2e-6, "span": "render"} for _ in range(8)]
    ctx = {"trace": {"ops": ops}, "slice": types.SimpleNamespace(first=1, last=2),
           "units": units, "spec": spec, "traffic": {"samples_per_dispatch": 1},
           "b1_rays": lambda us: 1000.0, "roofline": roofline}
    # 16 us of B6a over the slice's 2 dispatches: 8 us a dispatch
    expect = roofline_b6a.b6a_bound(1000.0, 2, 3, 4)[0] / 8e-3 * 100.0
    assert reader.read(ctx) == pytest.approx(expect)
    assert reader.read(dict(ctx, trace=None)) is None


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
def test_a_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    small = {"traffic": dict(SMALL["traffic"], samples_per_dispatch=4), "scene": SMALL["scene"]}
    buf = io.StringIO()
    prof.enable()
    try:
        with redirect_stdout(buf):
            rc = harness.run(["--workload", CELL, "--seed", str(SEED), "--seconds", "1",
                              "--trace", "1"], overrides=small)
    finally:
        prof.disable()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and out["correct"], out["checks"]
    ops = {name for name, _ in out["breakdown"]["device_ops"]}
    assert "B6a" in ops and not ops & {"B1", "B5"}, ops
    assert 0.0 < out["metrics"]["B6a_roofline.progressive"]["value"] <= 100.0
    spans = prof.spans()
    by_id = {s.id: s for s in spans}
    launches = [s for s in spans if s.name == "B6a.launch"]
    assert launches and all(by_id[s.parent].name == "wavefront.trace" for s in launches)
    assert all(by_id[s.parent].n == s.n for s in launches)
    assert {s.n for s in spans if s.name == "refit"} == {INSTANCES}
