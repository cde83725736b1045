"""The megakernels B1 (csrc/fused_sample.cu) and B5 (csrc/fused_traverse.cu)
against another commit's sources on one NVIDIA GPU.

    python3 kernel_ab.py --base DIR [--json PATH]

DIR is a checkout of the commit to compare with (its
``dxrexperiments_torch/csrc`` is built with this package's nvcc flags; its
entry points are called with the arguments they took before the triangle
records: mt_pack for B1, mt_rows for B5; ``base_launch``). For each case,
on the same inputs:

- the count of pixels whose output differs in any bit from the base
  build's (every AOV for a realtime frame);
- ms per launch, CUDA events around the launch alone, base and this tree in
  turns (base, this, this, base).

Cases (the main paths' first dispatch or frame, ``chip_smoke.py``'s
scenes): config 1 (Cornell-glossy, 512^2, S = 16), config 3 (Cornell-glossy
with the seeded 8192x4096 lat-long sky of chip_smoke.sky_image, 1080p,
S = 8), config 4 (Cornell-glossy realtime 1080p frame 0; B1); config 5
flattened (instanced:32, 512^2, S = 4), its realtime 1080p frame 0, and
the config-2 stand-in (chip_smoke.config2_stand_in with the seeded
cubemap, 512^2, S = 8; B5).

Also printed: ptxas' registers and spills of every kernel of B1, B5, B4a
(traverse_fat.cu), B4c (traverse_fat_grouped.cu) and B6a
(traverse2_fat.cu) in both trees, and whether B4a's, B4c's and B6a's
instructions equal the base's; for the sweep loops of B1 and B5 (the
innermost loops of ``cuobjdump -sass`` that load and do float work, each
pair test counted by its FSETP against 1e-12) the instructions, loads and
float instructions per pair test; the bytes of B1's records and B5's leaf
arrays. The last line is one JSON object with all of it but the loops'
counts, which --json writes too.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

SOURCES = {"B1": "fused_sample", "B5": "fused_traverse", "B4a": "traverse_fat",
           "B4c": "traverse_fat_grouped", "B6a": "traverse2_fat"}


def find_cuobjdump() -> str | None:
    path = shutil.which("cuobjdump")
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return path or (cand if os.path.exists(cand) else None)


def sass_functions(text: str) -> dict[str, list[tuple[int, str]]]:
    """``cuobjdump -sass`` output -> {function: [(address, instruction)]}."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def loop_counts(code: list[tuple[int, str]]) -> list[dict]:
    """The innermost loops (a backward BRA and its target) that load and do
    float work: per loop its span and instruction counts."""
    loops = []
    for addr, ins in code:
        if opcode(ins).startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", ins)
            if m and int(m.group(1), 16) <= addr:
                loops.append((int(m.group(1), 16), addr))
    inner = [a for a in loops if not any(b != a and a[0] <= b[0] and b[1] <= a[1] for b in loops)]
    out = []
    for lo, hi in sorted(set(inner)):
        body = [ins for addr, ins in code if lo <= addr <= hi]
        ops = [opcode(i) for i in body]
        counts: dict[str, int] = {}
        for op in ops:
            base = op.split(".")[0]
            if base in ("LDS", "LDG", "LD", "LDL"):
                width = next((w for w in ("128", "64") if f".{w}" in op), "32")
                key = f"{base}.{width}"
            else:
                key = base
            counts[key] = counts.get(key, 0) + 1
        loads = sum(v for k, v in counts.items() if k.split(".")[0] in ("LDS", "LDG", "LD"))
        if loads == 0 or counts.get("FFMA", 0) < 8:
            continue
        pairs = sum(1 for op, i in zip(ops, body) if op.startswith("FSETP") and "e-13" in i)
        out.append({"span": [lo, hi], "instructions": len(body), "pair_tests": pairs,
                    "counts": dict(sorted(counts.items()))})
    return out


def sass_text(so_path: str) -> str | None:
    """The instructions of every function in a build, without the file
    headers (None without cuobjdump)."""
    tool = find_cuobjdump()
    if tool is None:
        return None
    proc = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True, check=False)
    text = "\n".join(f"{name}\n" + "\n".join(i for _, i in code)
                     for name, code in sorted(sass_functions(proc.stdout).items()))
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)  # the file's own hash


FLOAT_OPS = ("FFMA", "FMUL", "FADD", "FSETP", "FMNMX", "FSEL")


def loop_summary(sass: dict) -> list[str]:
    """The sweep loops of a build grouped by their pair tests and loads: how
    many, and per pair test the instructions, loads and float instructions
    (the rest is address arithmetic and control), as min-max over the
    group's loops."""
    groups: dict[tuple, list[dict]] = {}
    for loops in sass.values():
        for lp in loops:
            loads = tuple(sorted((k, v) for k, v in lp["counts"].items()
                                 if k.split(".")[0] in ("LDS", "LDG", "LD")))
            groups.setdefault((lp["pair_tests"], loads), []).append(lp)
    out = []
    for (pairs, loads), lps in sorted(groups.items(), key=lambda kv: -len(kv[1])):
        if not pairs:
            continue
        per = [(lp["instructions"] / pairs,
                sum(lp["counts"].get(k, 0) for k in FLOAT_OPS) / pairs) for lp in lps]
        span = (lambda xs: f"{min(xs):g}" if min(xs) == max(xs) else f"{min(xs):g}-{max(xs):g}")
        out.append(f"{len(lps)} loops of {pairs} pair test{'s' if pairs > 1 else ''}; per pair "
                   f"test {span([p[0] for p in per])} instructions: "
                   + ", ".join(f"{k} {v / pairs:g}" for k, v in loads)
                   + f", {span([p[1] for p in per])} float, the rest address arithmetic and "
                   "control")
    return out


def sass_report(so_path: str) -> dict:
    tool = find_cuobjdump()
    if tool is None:
        return {"error": "cuobjdump not found"}
    proc = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[-400:]}
    return {name: loop_counts(code) for name, code in sass_functions(proc.stdout).items()}


def base_launch(kernel, lib, scene, options, cameras, width, height, env_kind, realtime):
    """The base commit's entry points: B1 reads mt_pack [4, C, 16] with no
    live-row count; B5 reads mt_rows [S, 128]. Returns (launch, outs, err):
    B5's error flag, or None."""
    import ctypes

    import torch

    from dxrexperiments_torch.ops import fused_sample as fs
    from dxrexperiments_torch.ops import fused_traverse as ft

    device = scene["mt_pack"].device
    s_count = int(cameras["eye"].shape[0])
    cam = fs.pack_cameras(cameras, realtime).cpu().contiguous()
    env = tuple(fs.env_args(scene, int(env_kind), device))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if kernel == "B1":
        cst = fs.pack_consts(scene, options, env_kind).cpu().contiguous()
    else:
        cst, rig = ft._rig_consts(scene, options, env_kind)
        cst = cst.cpu().contiguous()
    params = fs._upload(cam, cst, fs._frames_u32(cameras["frame_count"]), device)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    outs = ((empty(s_count, height, width, 3), empty(s_count, height, width, 3),
             empty(s_count, height, width, 3), empty(s_count, height, width)) if realtime
            else (empty(height, width, 3),))
    env_t = [vp, ci, ci]
    err = None
    if kernel == "B1":
        tensors = (scene["mt_pack"], scene["attr_pack"])
        ints = (s_count, int(tensors[0].shape[1]), width, height, int(env_kind))
        tail = env + (None, 0, 0, 0)
        fn = lib.dxr_fused_realtime_outputs if realtime else lib.dxr_fused_progressive_sum
        fn.argtypes = [vp] * (5 + len(outs)) + [ci] * 5 + env_t + [vp, ci, ci, ci, vp]
    else:
        bvh = scene["bvh"]
        err = torch.zeros(1, dtype=torch.int32, device=device)
        tensors = (bvh["bvhf_rows"], bvh["mt_rows"], scene["material_pack"])
        ints = (s_count, tensors[0].shape[0], tensors[1].shape[0], width, height, int(env_kind),
                rig)
        tail = env + (() if realtime else ft.texture_args(scene, device)) + (err.data_ptr(),)
        fn = (lib.dxr_fused_traverse_realtime_outputs if realtime
              else lib.dxr_fused_traverse_progressive_sum)
        fn.argtypes = ([vp] * (4 + 3 + len(outs)) + [ci] * 7 + env_t
                       + ([] if realtime else [vp, vp, ci, ci]) + [vp, vp])
    fn.restype = ci

    def launch() -> int:
        cam_ptr = params.data_ptr()
        cst_ptr = cam_ptr + 4 * cam.numel()
        frames_ptr = cst_ptr + 4 * cst.numel()
        head = (cam_ptr, frames_ptr, cst_ptr) + ((cst_ptr + 4 * 32,) if kernel == "B5" else ())
        return fn(*head, *(t.data_ptr() for t in tensors), *(o.data_ptr() for o in outs), *ints,
                  *tail, torch.cuda.current_stream(device).cuda_stream)

    return launch, outs, err


def this_launch(kernel, lib, scene, options, cameras, width, height, env_kind, realtime):
    """This tree's wrapper (prepare_launch) with ``lib``: (launch, outs, err)."""
    from dxrexperiments_torch.ops import fused_sample as fs
    from dxrexperiments_torch.ops import fused_traverse as ft

    if kernel == "B1":
        launch, outs, _ = fs.prepare_launch(scene, options, cameras, width, height, env_kind,
                                            realtime, 0, 0, lib=fs.bind(lib))
        return launch, outs, None
    return ft.prepare_launch(scene, options, cameras, width, height, env_kind, realtime,
                             lib=ft.bind(lib))


def differing_pixels(a, b, height: int, width: int) -> int:
    """Pixels where any channel of any output (and of any frame) differs in
    any bit."""
    import torch

    off = torch.zeros(height * width, dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        ne = x.contiguous().view(torch.int32) != y.contiguous().view(torch.int32)
        if tuple(ne.shape[-2:]) == (height, width):  # a one-channel output
            ne = ne[..., None]
        off |= ne.reshape(-1, height * width, ne.shape[-1]).any(2).any(0)
    return int(off.sum())


def time_ms(fn, reps: int) -> float:
    import torch

    if fn() != 0:
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cases(dev):
    """(name, kernel, scene, options, cameras, width, height, env_kind,
    realtime, reps) of the main paths' first dispatch or frame."""
    import chip_smoke as cs

    from dxrexperiments_torch.app.headless import build_scene
    from dxrexperiments_torch.models.progressive import ProgressiveRaytracingPipeline
    from dxrexperiments_torch.models.realtime import RealtimeRaytracingPipeline
    from dxrexperiments_torch.scene import envmap

    def progressive(sc, cam, size, s_count):
        cam.set_aspect(*size)
        pipe = ProgressiveRaytracingPipeline(*size, seed=0, samples_per_frame=s_count, device=dev)
        pipe.set_camera(cam)
        pipe.set_scene(sc)
        pipe.update(elapsed_time=0.0, elapsed_frames=0)
        return pipe.scene_data, pipe.options, pipe._camera_params

    def realtime(sc, cam, size, scene_data=None):
        cam.set_aspect(*size)
        rt = RealtimeRaytracingPipeline(*size, seed=0, device=dev)
        rt.set_camera(cam)
        if scene_data is None:
            rt.set_scene(sc)
        else:
            rt.set_scene_data(scene_data)
        rt.update(elapsed_time=0.0, elapsed_frames=0)
        return rt.scene_data, rt.options, {k: v[None] for k, v in rt._camera_params.items()}

    out = []
    sc, cam = build_scene("cornell-glossy")
    out.append(("config 1: Cornell 512^2, S = 16", "B1",
                *progressive(sc, cam, (512, 512), 16), 512, 512, False, 20))
    sc, cam = build_scene("cornell-glossy")
    sc.environment = envmap.latlong_env(cs.sky_image(cs.HDR_W, cs.HDR_H, 18))
    out.append(("config 3: Cornell + 8K lat-long 1080p, S = 8", "B1",
                *progressive(sc, cam, (1920, 1080), 8), 1920, 1080, False, 10))
    sc, cam = build_scene("cornell-glossy")
    out.append(("config 4: Cornell realtime 1080p frame 0", "B1",
                *realtime(sc, cam, (1920, 1080)), 1920, 1080, True, 20))
    sc, cam = build_scene("instanced:32")
    c5 = progressive(sc, cam, (512, 512), 4)
    out.append(("config 5 flattened: instanced:32 512^2, S = 4", "B5", *c5, 512, 512, False, 5))
    sc, cam = build_scene("instanced:32")
    out.append(("config 5 flattened: instanced:32 realtime 1080p frame 0", "B5",
                *realtime(sc, cam, (1920, 1080), c5[0]), 1920, 1080, True, 5))
    sc, cam = cs.config2_stand_in(envmap.cubemap_env(cs.cube_faces(cs.CUBE_S, 19)))
    out.append(("config-2 stand-in 512^2, S = 8", "B5",
                *progressive(sc, cam, (512, 512), 8), 512, 512, False, 10))
    return [(n, k, s, o, c, w, h, int(s["env"]["kind"]), r, reps)
            for n, k, s, o, c, w, h, r, reps in out]


def compare(base_csrc: str, card: str, dev) -> dict:
    """Build, check and time both trees (main's work)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from dxrexperiments_torch.ops.traverse import raise_on_error
    from dxrexperiments_torch.utils import cuda_build

    trees = {"base": base_csrc, "this": cuda_build.CSRC_DIR}
    # every build at once: one nvcc per (tree, source)
    jobs = [(tree, key) for tree in trees for key in SOURCES]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: cuda_build.load_library(
            SOURCES[j[1]], [SOURCES[j[1]] + ".cu"], trees[j[0]]), jobs)))

    def info(tree, key):
        d = trees[tree]
        return cuda_build.BUILD_INFO[SOURCES[key] if d == cuda_build.CSRC_DIR
                                     else f"{SOURCES[key]}@{d}"]

    report = {"card": card, "ptxas": {}, "sass_loops": {}, "cases": []}
    for tree in trees:
        for key in SOURCES:
            counts = cuda_build.ptxas_counts(info(tree, key)["log"])
            report["ptxas"][f"{key} {tree}"] = counts
            for k in counts:
                print(f"ptxas {key} {tree}: {k}", flush=True)
    report["sass_identical"] = {}
    for key in ("B4a", "B4c", "B6a"):  # kernels the redesign of B1 and B5 leaves as they were
        texts = [sass_text(info(tree, key)["path"]) for tree in trees]
        same = None if texts[0] is None else texts[0] == texts[1]
        report["sass_identical"][key] = same
        print(f"sass {key}: this build's instructions equal the base build's: {same}", flush=True)
    for tree in trees:
        for key in ("B1", "B5"):
            sass = sass_report(info(tree, key)["path"])
            report["sass_loops"][f"{key} {tree}"] = sass
            if "error" in sass:
                print(f"sass {key} {tree}: {sass['error']}", flush=True)
                continue
            for line in loop_summary(sass):
                print(f"sass {key} {tree}: {line}", flush=True)

    for name, kernel, scene, options, cams, width, height, ek, realtime, reps in cases(dev):
        mine = this_launch(kernel, libs["this", kernel], scene, options, cams, width, height,
                           ek, realtime)
        base = base_launch(kernel, libs["base", kernel], scene, options, cams, width, height, ek,
                           realtime)
        for launch, *_ in (base, mine):
            if launch() != 0:
                raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        diff = differing_pixels(base[1], mine[1], height, width)
        turns = [time_ms(f, reps) for f in (base[0], mine[0], mine[0], base[0])]
        row = {"case": name, "kernel": kernel, "differing_pixels": diff,
               "pixels": width * height, "base_ms": (turns[0] + turns[3]) / 2,
               "this_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns}
        if kernel == "B1":
            row.update(records_bytes=scene["tri_records"].numel() * 4,
                       live_rows=int(scene["num_tris"]),
                       padded_rows=int(scene["mt_pack"].shape[1]))
        else:
            bvh = scene["bvh"]
            row.update(ft_test_bytes=bvh["ft_test"].numel() * 4,
                       ft_attr_bytes=bvh["ft_attr"].numel() * 4,
                       mt_rows_bytes=bvh["mt_rows"].numel() * 4)
        report["cases"].append(row)
        print(f"case {name}: {diff} of {width * height} pixels differ from the base build; "
              f"ms base {row['base_ms']:.4f}, this {row['this_ms']:.4f} (turns "
              f"{', '.join(f'{t:.4f}' for t in turns)}) [{card}]", flush=True)
        for err in (base[2], mine[2]):
            if err is not None:
                raise_on_error(err, name)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--base", required=True, help="a checkout of the commit to compare with")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(f"card: {card}", flush=True)
    base_csrc = os.path.join(os.path.abspath(args.base), "dxrexperiments_torch", "csrc")
    report = compare(base_csrc, card, dev)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "sass_loops"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
