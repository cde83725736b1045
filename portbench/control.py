"""Readings that set a cell's correctness limits: for each seed, a short
window of the cell at its own size and load, then the numbers of the
program against the reference (the lower readings) and of the control, the
reference computed a precision below the configuration's (bfloat16 for
float32) in the program's place, against the same reference (the upper
readings). The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 3

prints one JSON line a seed: {"seed", "program": {...}, "control": {...}}.
The seeds share one process and one scene build.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import drive, harness  # noqa: E402

# The precision a step below each that a configuration's "precision" states.
CONTROL_DTYPE = {"float64": torch.float32, "float32": torch.bfloat16}


def readings(workload: str, seeds: list[int], seconds: float, device=None, overrides=None,
             root: str = harness.ROOT) -> list[dict]:
    """The program's and the control's numbers, one dict a seed."""
    man = harness.manifest(root)
    parts = harness.cell_parts(man, workload, root)
    traffic = dict(parts["traffic"], **(overrides or {}).get("traffic", {}))
    device = torch.device(device) if device is not None else torch.device("cuda", 0)
    spec = harness.scene_spec(parts["config"], (overrides or {}).get("scene"))
    scene_data = None
    out = []
    for seed in seeds:
        drv = drive.Driver(spec, traffic, seed, device, drive.Spans())
        drv.build(scene_data)
        scene_data = drv.pipe.scene_data
        drv.run_unit(-1)
        drv.window(seconds)
        drive.sync(device)
        want = harness.reference_outputs(spec, drv, device, torch.float32)
        got = harness.program_outputs(drv, device)
        ctrl = harness.reference_outputs(spec, drv, device,
                                         CONTROL_DTYPE[parts["config"]["precision"]])
        out.append({"seed": seed, "units": len(drv.units),
                    "program": harness.numbers(got, want, drv.realtime),
                    "control": harness.numbers(ctrl, want, drv.realtime)})
        drv.release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    for r in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds):
        print(json.dumps(dict(r, elapsed_s=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
