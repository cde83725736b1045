"""The program's span recorder (``dxrexperiments_torch.utils.profiling``)
under the benchmark's traffic: a run with the recorder on exits 0 and
records the layers' spans for every dispatch; on the card (marked
``cuda``), a traced run of ``cornell512_progressive`` records ``B1.wrapper``
and its four steps around each launch."""

import io
import json
from contextlib import redirect_stdout

import pytest
from conftest import SMALL

from dxrexperiments_torch.utils import profiling
from portbench import harness

CELL = "cornell512_progressive"
STEPS = ("B1.pack", "B1.upload", "B1.alloc", "B1.launch")


def recorded_run(root, device, trace):
    buf = io.StringIO()
    profiling.enable()
    try:
        with redirect_stdout(buf):
            rc = harness.run(["--workload", CELL, "--seed", "2147483659", "--seconds", "0.5",
                              "--trace", str(trace)], device=device, overrides=SMALL[CELL],
                             root=root)
    finally:
        profiling.disable()
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1]), profiling.spans()


def test_run_with_the_recorder_on(root):
    rc, out, spans = recorded_run(root, "cpu", 0)
    assert rc == 0 and out["correct"], out["checks"]
    names = [s.name for s in spans]
    units = out["attempted"] + 1  # the warm-up unit too
    dispatches = units * SMALL[CELL]["traffic"]["dispatches_per_image"]
    for name in ("progressive.update", "progressive.cameras", "progressive.render"):
        assert names.count(name) == dispatches, name
    # a dispatch renders unless its image has converged: the first unit
    # repeats the warm-up's pose, so its dispatches return the image as it is
    rendered = dispatches - SMALL[CELL]["traffic"]["dispatches_per_image"]
    assert names.count("B1.wrapper") == names.count("progressive.fold") == rendered
    assert names.count("scene.build") == 1 and profiling.dropped() == 0


@pytest.mark.cuda
def test_traced_run_records_the_b1_wrapper_steps(root, cuda_device):
    rc, out, spans = recorded_run(root, cuda_device, 1)
    assert rc == 0 and out["correct"], out["checks"]
    wrappers = [s for s in spans if s.name == "B1.wrapper"]
    assert wrappers and {s.n for s in wrappers} == {SMALL[CELL]["traffic"]["samples_per_dispatch"]}
    for w in wrappers:
        steps = sorted((s for s in spans if s.parent == w.id), key=lambda s: s.t0)
        assert tuple(s.name for s in steps) == STEPS
