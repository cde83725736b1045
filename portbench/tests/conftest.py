"""Shared by the benchmark's own tests (run them from the repository root:
``python -m pytest portbench/tests -q``). CPU tests drive the harness on the
port's plain CPU path at small sizes; tests marked ``cuda`` need the card
and skip without one."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Each cell at a size the CPU runs in seconds: the traffic's image, samples
# and compared pixels cut, the instanced grid at 2 x 2.
SMALL = {
    "cornell512_progressive": {
        "traffic": {"width": 32, "height": 24, "samples_per_dispatch": 4,
                    "dispatches_per_image": 4,
                    "compare": {"pixels": 256, "early_span": 1}}},
    "instanced32_1080_realtime": {
        "traffic": {"width": 32, "height": 24,
                    "compare": {"pixels": 256, "early_span": 1}},
        "scene": {"grid": 2}},
    "cornell1080_realtime_fif3": {
        "traffic": {"width": 32, "height": 24,
                    "compare": {"pixels": 256, "early_span": 1}}},
    "instanced32_two_level_animated": {
        "traffic": {"width": 32, "height": 24,
                    "compare": {"pixels": 256, "early_span": 1}},
        "scene": {"grid": 2}},
}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


# The two-level animated cell, measured but left out of BENCHMARK.json (its
# traced run showed the card idle most of the window, PERF.md): its traffic,
# limits and readers stay under portbench/, and these entries alone add it
# back.
CELL4 = "instanced32_two_level_animated"
CELL4_ENTRIES = {
    "workload": {"name": CELL4, "config": "instanced32", "traffic": "progressive_512_s4_animated",
                 "chips": 1, "why": "512^2, 4 samples a dispatch, instances turned by a refit"},
    "per_layer": [
        {"name": "B6a_ms.progressive", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "Kernels", "moves": "mrays_per_s", "workloads": [CELL4]},
        {"name": "glue_ms.progressive", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "Wavefront integrator", "moves": "mrays_per_s",
         "workloads": [CELL4]},
        {"name": "refit_ms", "unit": "ms", "better": "lower", "source": "host_clock",
         "layer": "Refit", "moves": "mrays_per_s", "workloads": [CELL4]}],
}


@pytest.fixture(scope="session")
def root(tmp_path_factory):
    """A checkout root whose BENCHMARK.json is the repository's with the
    two-level animated cell added back; portbench/ is the repository's."""
    tree = tmp_path_factory.mktemp("root")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["workloads"].append(CELL4_ENTRIES["workload"])
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("mrays_per_s", "host_ms.progressive", "device_idle_pct.progressive"):
            m["workloads"].append(CELL4)
    man["per_layer"] += CELL4_ENTRIES["per_layer"]
    (tree / "BENCHMARK.json").write_text(json.dumps(man))
    os.symlink(os.path.join(ROOT, "portbench"), tree / "portbench")
    return str(tree)
