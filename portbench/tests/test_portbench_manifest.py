"""BENCHMARK.json against the benchmark's contract, and every name it uses
against the files that carry it."""

import json
import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
BENCH = os.path.join(ROOT, "portbench")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_limits():
    man = manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["paths"] == ["portbench"]
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert len(man["command"]) <= 32 and all(TEXT.match(w) for w in man["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    cells = 24
    checked = 2 + 14 * cells
    assert checked * (man["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    man = manifest()
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    names += [c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in man[group]]
        assert len(ns) == len(set(ns))
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_its_metrics_move():
    man = manifest()
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for w in man["workloads"]:
        cell = w["name"]
        assert reports(e2e["setup_s"], cell)
        assert sum(reports(m, cell) for m in e2e.values()) >= 2
        assert any(reports(m, cell) for m in man["per_layer"])
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in man["workloads"]]):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {m["layer"] for m in man["per_layer"]}
    assert all(len(x.split()) <= 4 for x in layers)


def test_every_name_has_its_file():
    man = manifest()
    configs = {c["name"] for c in man["configs"]}
    for w in man["workloads"]:
        assert w["config"] in configs
        assert os.path.exists(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(BENCH, "limits", f"{w['name']}.json"))
    for m in man["end_to_end"] + man["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py")), m["name"]
    for c in man["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert os.path.exists(os.path.join(BENCH, "scenes", f"{cfg['generator']}.py"))


def test_roofline_and_mfu_names():
    man = manifest()
    for m in man["per_layer"]:
        if "roofline" in m["name"]:
            assert re.match(r"^B\w+_roofline(\.\w+)?$", m["name"]) and m["unit"] == "%"
