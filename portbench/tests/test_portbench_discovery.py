"""A later change adds a configuration, a traffic mix, a cell and a metric
as new files and BENCHMARK.json entries alone: a copy of the benchmark
with such files added runs the new cell and reports the new metric."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, SMALL

NEW_METRIC = '''"""Units presented a second (a metric a later change adds)."""


def read(ctx):
    return sum(1 for u in ctx["units"] if u["index"] >= 0) / ctx["window_s"]
'''


def test_new_files_alone_add_a_cell(tmp_path):
    tree = tmp_path / "tree"
    tree.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tree)
    shutil.copytree(os.path.join(ROOT, "portbench"), tree / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tree / "portbench"
    with open(bench / "configs" / "cornell_glossy.json") as f:
        cfg = json.load(f)
    cfg["name"] = "cornell_copy"
    (bench / "configs" / "cornell_copy.json").write_text(json.dumps(cfg))
    with open(bench / "traffic" / "progressive_512_s16.json") as f:
        traffic = json.load(f)
    traffic.update(samples_per_dispatch=2, dispatches_per_image=2)
    (bench / "traffic" / "progressive_tiny_s2.json").write_text(json.dumps(traffic))
    (bench / "limits" / "cornell_copy.tiny.json").write_text(
        (bench / "limits" / "cornell512_progressive.json").read_text())
    (bench / "metrics" / "units_per_s.py").write_text(NEW_METRIC)
    man = json.loads((tree / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "cornell_copy", "source": "https://example.org/cornell",
                           "file": "portbench/configs/cornell_copy.json", "reduced": [],
                           "why": "a copy"})
    man["workloads"].append({"name": "cornell_copy.tiny", "config": "cornell_copy",
                             "traffic": "progressive_tiny_s2", "chips": 1, "why": "a test"})
    man["end_to_end"].append({"name": "units_per_s", "unit": "1/s", "better": "higher",
                              "bound": 0.05, "source": "host_clock",
                              "workloads": ["cornell_copy.tiny"]})
    for m in man["end_to_end"]:
        if m["name"] == "mrays_per_s":
            m["workloads"].append("cornell_copy.tiny")
    (tree / "BENCHMARK.json").write_text(json.dumps(man))
    small = dict(SMALL["cornell512_progressive"])
    small["traffic"] = dict(small["traffic"], samples_per_dispatch=2, dispatches_per_image=2)
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "from portbench import harness\n"
            "sys.exit(harness.run(['--workload', 'cornell_copy.tiny', '--seed', '9', "
            "'--seconds', '0.2'], device='cpu', overrides=%r))" % (small,))
    proc = subprocess.run([sys.executable, "-c", code, str(tree), ROOT], capture_output=True,
                          text=True, timeout=600, cwd=tree)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert set(out["metrics"]) == {"units_per_s", "mrays_per_s", "setup_s"}
