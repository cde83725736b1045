"""The benchmark of ``dxrexperiments_torch`` on one H100: one run of one
cell, as ``BENCHMARK.json`` describes it.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file that entry names (with
the generator ``scenes/<generator>.py``), its traffic mix in
``traffic/<name>.json``, its correctness limits in ``limits/<cell>.json``,
each metric's reader in ``metrics/<name>.py`` and the kernels' names in
``kernels/*.json``. A run builds the scene, warms the cell's route up with
one unit (set-up), runs the traffic for the window, reads the device's
memory peak, checks that no JAX module was loaded, frees the pipeline,
judges the compared units against the reference renderer, and prints one
JSON line: the end-to-end metrics (``--trace 0``) or the per-layer ones and
the ``breakdown`` of a profiled slice (``--trace 1``).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from . import drive, judge, reference, roofline, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dxrexperiments_tpu")
# The traced slice; "pace": the most its host ms a unit may differ from the
# window's, "tries": slices profiled before a run gives up on that
SLICE = {"start": 0.4, "span_s": 2.0, "min_units": 2, "pace": 0.25, "tries": 3}
CENSUS_UNITS = 4  # slice units whose rays the B1 census counts


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_parts(man: dict, name: str, root: str = ROOT) -> dict:
    """The cell ``name`` with its configuration (entry and file), traffic
    mix and limits, each found by name."""
    cells = {c["name"]: c for c in man["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r} (known: {', '.join(cells)})")
    cell = cells[name]
    cfg = {c["name"]: c for c in man["configs"]}[cell["config"]]
    return {
        "cell": cell,
        "config_entry": cfg,
        "config": load_json(os.path.join(root, cfg["file"])),
        "traffic": load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")),
        "limits": load_json(os.path.join(HERE, "limits", f"{name}.json")),
    }


def metrics_of(man: dict, name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in man[kind] if "workloads" not in m or name in m["workloads"]]


def reader(metric: str, root: str = HERE):
    """The reader module ``metrics/<metric>.py`` (its ``read(ctx)``)."""
    path = os.path.join(root, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scene_spec(config: dict, overrides: dict | None = None) -> dict:
    gen = importlib.import_module(f"portbench.scenes.{config['generator']}")
    return gen.build(dict(config.get("params", {}), **(overrides or {})))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ------------------------------------------------------------- the judge ---
def ref_renderer(spec, drv, device, dtype, unit: dict) -> reference.Renderer:
    tf = None
    if "animate" in drv.tr:
        (angle,) = unit["angles"]  # one dispatch an image where instances move
        tf = np.einsum("ij,njk->nik", reference.yaw(angle), drv.base_tf.astype(np.float64))
    return reference.Renderer(reference.RefScene(spec, device, dtype, tf), spec)


def progressive_cams(drv, unit: dict) -> list:
    """(camera basis, jitter, frame_count) of every sample of a unit."""
    basis = reference.camera_basis(unit["pose"], drv.w / drv.h)
    out = []
    for j in range(unit["dispatches"]):
        d = unit["dispatch0"] + j
        jit = reference.jitters(drv.seed, d * drv.s, drv.s, drv.w, drv.h)
        out += [(basis, jit[k], d * drv.s + k) for k in range(drv.s)]
    return out


def realtime_cams(drv, unit: dict) -> list:
    out = []
    for f, p in enumerate(unit["poses"]):
        frame = unit["frame0"] + f
        jit = reference.jitters(drv.seed, frame, 1, drv.w, drv.h)[0]
        out.append((reference.camera_basis(p, drv.w / drv.h), jit, frame))
    return out


def aov_pixels(drv, slot: int) -> np.ndarray:
    """The pixels whose AOVs a compared realtime unit (``slot`` 0 the early
    one, 1 the last) is judged on: the sample ``drv.pix`` and every input of
    its anchor tile's display pixels, the tile grown by the denoiser's
    extent."""
    y0, x0 = drv.anchors[slot]
    e = reference.extent(float(drv.tr["denoise"]["max_kernel_size"]))
    ys = np.arange(max(y0 - e, 0), min(y0 + drive.ANCHOR + e, drv.h))
    xs = np.arange(max(x0 - e, 0), min(x0 + drive.ANCHOR + e, drv.w))
    return np.union1d(drv.pix, (ys[:, None] * drv.w + xs[None, :]).ravel())


def reference_outputs(spec, drv, device, dtype) -> list[dict]:
    """The reference's outputs of each compared unit at the judged pixels
    (and, realtime, the reference denoiser on the program's own AOVs over
    whole frames), in ``dtype``."""
    out = []
    for slot, u in enumerate(drv.compared()):
        unit = drv.kept[u]
        rend = ref_renderer(spec, drv, device, dtype, unit)
        if not drv.realtime:
            pix = torch.as_tensor(drv.pix, device=device)
            out.append({"image": reference.render_progressive(
                rend, progressive_cams(drv, unit), pix, drv.w, drv.h)})
            continue
        pix = torch.as_tensor(aov_pixels(drv, slot), device=device)
        frames = []
        radius = float(drv.tr["denoise"]["max_kernel_size"])
        for f, (cam, jit, frame) in enumerate(realtime_cams(drv, unit)):
            direct, spec_aov = reference.render_realtime(rend, cam, jit, frame, pix, drv.w, drv.h)
            disp = reference.denoise(unit["direct"][f].to(device, dtype),
                                     unit["indirect_specular"][f].to(device, dtype), radius)
            frames.append({"direct": direct, "indirect_specular": spec_aov, "display": disp})
        out.append({"frames": frames})
    return out


def program_outputs(drv, device) -> list[dict]:
    """The program's outputs of each compared unit, as ``reference_outputs``
    lays them out."""
    out = []
    for slot, u in enumerate(drv.compared()):
        unit = drv.kept[u]
        if not drv.realtime:
            pix = torch.as_tensor(drv.pix, device=device)
            out.append({"image": unit["image"].to(device).reshape(-1, 3)[pix]})
            continue
        pix = torch.as_tensor(aov_pixels(drv, slot), device=device)
        out.append({"frames": [
            {"direct": unit["direct"][f].to(device).reshape(-1, 3)[pix],
             "indirect_specular": unit["indirect_specular"][f].to(device).reshape(-1, 3)[pix],
             "display": unit["display"][f].to(device)}
            for f in range(len(unit["poses"]))]})
    return out


def numbers(got: list[dict], want: list[dict], realtime: bool) -> dict:
    if not realtime:
        return judge.image_numbers([(g["image"], w["image"]) for g, w in zip(got, want)],
                                   "image")
    aov, disp = [], []
    for g, w in zip(got, want):
        for gf, wf in zip(g["frames"], w["frames"]):
            aov += [(gf[k], wf[k]) for k in ("direct", "indirect_specular")]
            disp.append((gf["display"], wf["display"]))
    return dict(judge.image_numbers(aov, "aov"), **judge.display_number(disp))


# --------------------------------------------------------------- census ----
def b1_rays(spec, drv, device, units: list[dict]) -> float:
    """Live rays (a non-empty window; a shadow ray with a direction) that
    one B1 launch traces, as the reference counts them on a sample of
    ``drv.pix`` at the cameras of one launch of each unit, scaled to the
    image and averaged over the units."""
    pix = torch.as_tensor(drv.pix, device=device)
    scale = drv.w * drv.h / len(drv.pix)
    per_launch = []
    for unit in units[:CENSUS_UNITS]:
        rend = ref_renderer(spec, drv, device, torch.float32, unit)
        if drv.realtime:
            for cam, jit, frame in realtime_cams(drv, unit):
                reference.render_realtime(rend, cam, jit, frame, pix, drv.w, drv.h)
        else:
            reference.render_progressive(rend, progressive_cams(drv, unit)[:drv.s], pix,
                                         drv.w, drv.h)
        per_launch.append((rend.rays["closest"] + rend.rays["any"]) * scale)
    return float(np.mean(per_launch))


# ------------------------------------------------------------------ a run --
def run(argv=None, t_start: float | None = None, device=None, overrides=None,
        fault=None, root: str = ROOT) -> int:
    """One run; returns the exit code. ``device`` (default the card),
    ``overrides`` (the scene's and traffic's sizes) and ``fault`` (called
    with the driver once set up, to break the timed path underneath) exist
    for the CPU tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    man = manifest(root)
    parts = cell_parts(man, args.workload, root)
    cell, traffic = parts["cell"], dict(parts["traffic"], **(overrides or {}).get("traffic", {}))
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"portbench: needs {cell['chips']} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if args.trace and not on_card:
        raise RuntimeError("--trace 1 profiles the card")
    spec = scene_spec(parts["config"], (overrides or {}).get("scene"))
    spans = drive.Spans()
    spans.sync_refit = bool(args.trace)
    drv = drive.Driver(spec, traffic, args.seed, device, spans)
    scene_build_s = drv.build()
    route = drv.route()
    if fault is not None:
        fault(drv)
    drv.run_unit(-1)  # warm-up: builds and launches every kernel of the route
    if args.trace:
        trace.warm_profiler()
    drive.sync(device)
    setup_s = time.perf_counter() - t_start

    table = trace.kernel_table()
    sl = None
    if args.trace:
        sl = trace.Slice(spans, drv.units, SLICE["start"] * args.seconds,
                         min(SLICE["span_s"], 0.2 * args.seconds), SLICE["min_units"],
                         SLICE["pace"], SLICE["tries"])
    w0, w1 = drv.window(args.seconds, sl)
    drive.sync(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    red = None
    if sl is not None:
        inside = [u for u in drv.units if sl.first <= u["index"] <= sl.last]
        red = trace.reduce(sl.prof, table, sl.marks, inside,
                           [s for s in spans.items if sl.first <= s[3] <= sl.last])
        pace = trace.pace(inside, [u for u in drv.units if u["index"] not in sl.profiled])
        pace["tries"] = SLICE["tries"] - sl.tries
        print(f"portbench: slice {pace['slice_ms']:.4f} ms a unit, window "
              f"{pace['window_ms']:.4f} ms a unit outside the profiled units (try "
              f"{pace['tries']}); launches found for {red['launched_share']:.4f} of the "
              f"slice's device operations", file=sys.stderr)
        for a in sl.attempts:
            print(f"portbench: slice of units {a['units']}: {a['slice_ms']:.4f} ms a unit, "
                  f"{a['window_ms']:.4f} before it", file=sys.stderr)
        if trace.off_pace(pace, SLICE["pace"]):
            print(f"portbench: the profiled slice ran off the window's pace by more than "
                  f"{SLICE['pace']:.0%}", file=sys.stderr)
            return 1
        facts = {"route": route, "pipeline": traffic["pipeline"], "accel": traffic["accel"],
                 "denoise": "denoise" in traffic}
        seen = {o["id"] for o in red["ops"]}
        missing = [b for b in trace.required(table, facts) if b not in seen]
        if missing:
            print(f"portbench: the profile lacks the route's kernels {missing} "
                  f"(route {route}, {len(red['ops'])} device operations)", file=sys.stderr)
            return 1
    drv.release()

    t_ref = time.perf_counter()
    got = program_outputs(drv, device)
    want = reference_outputs(spec, drv, device, torch.float32)
    nums = numbers(got, want, drv.realtime)
    print(f"reference {time.perf_counter() - t_ref:.3f} s for {len(drv.compared())} units",
          file=sys.stderr)
    correct, checks = judge.verdict(nums, parts["limits"]["numbers"])

    ctx = {  # what the readers under metrics/ read
        "traffic": traffic, "spec": spec, "setup_s": setup_s, "scene_build_s": scene_build_s,
        "window_s": w1 - w0, "units": drv.units, "spans": spans.items, "trace": red,
        "slice": sl, "b1_rays": lambda units: b1_rays(spec, drv, device, units),
        "roofline": roofline,
    }
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in metrics_of(man, cell["name"], kind):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak),
        "power_limit": power_limit() if on_card else "none",
    }
    if red is not None:
        device_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 1
    result = {"correct": bool(correct), "attempted": len(drv.units), "failed": 0,
              "metrics": metrics, "device": device_info}
    if red is not None:
        result["breakdown"] = trace.breakdown(red)
        result["slice"] = pace
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=False)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
