"""The port's kernels against another commit's sources on one NVIDIA GPU:
the trace kernels B4a (csrc/traverse_fat.cu), B4b
(csrc/traverse_binary.cu), B6b (csrc/traverse2_binary.cu), B3
(csrc/intersect_brute.cu), B6a (csrc/traverse2_fat.cu), B4d
(csrc/traverse8.cu) and B4c (csrc/traverse_fat_grouped.cu), the
bilateral pass B2 (csrc/bilateral.cu) and the roofline probes B7
(csrc/roofline.cu) case by case, every other kernel by its instructions.

    python3 kernel_ab.py --base DIR [--json PATH] [--reps N] [--kernels B7]
                         [--same-entries] [--this DIR2] [--no-fmad]

DIR is a checkout of the commit to compare with (its
``dxrexperiments_torch/csrc`` is built with this package's nvcc flags,
beside this tree's; one nvcc per source, all at once). Printed:

- ptxas' registers, spills and stack of every kernel of both trees;
- for every kernel but this tree's redesigns (``REDESIGNED``: B7, B5),
  whether its instructions (``cuobjdump -sass``) equal the base build's;
  for each redesign, its kernels' tensor-core instructions in both builds
  (``HGMMA``: warpgroup MMA, ``HMMA``: mma.sync);
- for the sweep and leaf loops of B1, B3, B5 and the walks (the innermost
  loops that load and do float work, each pair test counted by its FSETP
  against 1e-12) the instructions, loads and float instructions per pair
  test; for the walks (B4a, B4b, B4c, B4d, B6a, B6b) each loop that holds a
  pair-test loop, with its instructions outside its inner loops (a turn's
  work without its pair tests);
- per trace case (``trace_cases``: the four launches of the first sample of
  the first 512^2 S = 4 dispatch, on config 5 flattened for B4a, config 5
  flattened without fat nodes for B4b, config 5 two-level without fat
  nodes for B6b, ``instanced:2`` brute force for B3, config 5 two-level
  for B6a, and B4a's inputs on config 5 flattened for B4d (its 8-wide
  nodes) and for B4c at each of chip_smoke.GROUPINGS' packet layouts), on
  the same inputs: the rays whose output differs in any bit from the base
  build's, per output (t, u, v, slot, inst, occlusion and every fused
  attribute), and for B4d and B4c from this tree's B4a; the host figures
  (``trace_figures``: for B4a, B4b, B4d, B4c and B6b the leaf-weighted
  warp figures of every walk of the launch, ``walk_figures``); ms per
  launch,
  CUDA events around the launch alone, base and this tree in turns (base,
  this, this, base; ``--reps`` launches a turn, 0 for none); and the
  route's host ms per dispatch with either build (``BaseRoute``), in turns;
- with ``--kernels B1,B5``, the megakernels' cases (``megakernel_cases``:
  configs 1, 3, 4, config 5 flattened and its 1080p frame, the config-2
  stand-in): the pixels that differ in any bit, this build launched as
  usual and as the whole image's one row block (py0 0, full_height the
  height), ms in turns; for B5's cases the engagement counter of its leaf
  postponement (``leaf_phase_counts``: the opt-in counting build's walks
  and leaf phases by lanes a warp, and the pixels where its outputs differ
  from this build's), and for the 1080p frame the host figures of each of
  its walks (``b5_figures``: B5's warps with and without leaf
  postponement);
- with B2, the bilateral cases (``bilateral_cases``: config 4's 1080p
  frame 0 AOVs, both passes at each radius of ``B2_RADII``): the pixels
  whose channels differ in any bit, per channel, ms in turns;
- with B7, the roofline probes at roofline.py's size on seeded inputs
  (``roofline_cases``: the FMA peak, the pair mix, the seven overlap
  settings with the product kept): the elements that differ in any bit per
  output (out; o, t and grid block 0's last product), ms in turns.

The base's B4d and B4c are called with the entry points they had before
their leaf records (``base_trace_launch``, reading mt_rows), its other
trace kernels through this tree's wrappers; ``--same-entries`` (a base that is a variant
of this tree) launches all of them through this tree's wrappers. ``--this DIR2`` builds
DIR2's sources in place of this tree's (a variant with this tree's entry
points, run through this tree's wrappers), so two variants compare in one
call. ``--no-fmad`` builds both trees with ``nvcc -fmad=false``: where a
change moves which products nvcc fuses into a multiply-add, the outputs
differ by rounding alone, and without contraction they agree bit for bit
where the arithmetic is the same (the times are then not the shipped
builds'). The megakernels' entry points are the base's own. The last line
is one JSON object with all of it but the loops' counts, which --json
writes too.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

SOURCES = {"B1": "fused_sample", "B2": "bilateral", "B3": "intersect_brute",
           "B4a": "traverse_fat", "B4b": "traverse_binary", "B4c": "traverse_fat_grouped",
           "B4d": "traverse8", "B5": "fused_traverse", "B6a": "traverse2_fat",
           "B6b": "traverse2_binary", "B7": "roofline"}
# this tree's redesigns, compared case by case; every other kernel's
# instructions must equal the base's
REDESIGNED = ("B7", "B5")
TRACED = ("B4a", "B4b", "B6b", "B3", "B6a", "B4d", "B4c")  # the trace kernels with cases
COMPARED = TRACED + ("B2", "B1", "B5", "B7")  # the kernels with cases
B2_RADII = (1, 7, 12, 25)  # chip_smoke.BILATERAL_RADII; 12 is the denoiser's default
WALK_KERNELS = ("B4a", "B4b", "B4c", "B4d", "B6a", "B6b")  # whose walk loops are counted
# B4a's SASS per turn outside its pair tests and per pair test, closest and
# occlusion (walk_loops and the sass loops of its build with leaf records
# and postponement): the constants of the packet walks' predicted ms
# (packet_figures)
B4A_COSTS = {False: (138.0, 39.0), True: (124.0, 53.0)}
KINDS = {"B4a": "fat", "B4b": "binary", "B4c": "grouped", "B4d": "wide"}  # ops.traverse's walks
BATCHES = ("primary closest", "depth-0 shadow any", "bounce closest", "depth-1 shadow any")


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


def loop_spans(code: list[tuple[int, str]]) -> list[tuple[int, int]]:
    """Every loop of a function: (target, address) of each backward BRA."""
    loops = []
    for addr, ins in code:
        if opcode(ins).startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", ins)
            if m and int(m.group(1), 16) <= addr:
                loops.append((int(m.group(1), 16), addr))
    return loops


def inside(a: tuple[int, int], b: tuple[int, int]) -> bool:
    """Whether span a lies in span b and is not b."""
    return a != b and b[0] <= a[0] and a[1] <= b[1]


def loop_counts(code: list[tuple[int, str]]) -> list[dict]:
    """The innermost loops (a backward BRA and its target) that load and do
    float work: per loop its span and instruction counts."""
    loops = loop_spans(code)
    inner = [a for a in loops if not any(inside(b, a) for b in loops)]
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


def walk_loops(code: list[tuple[int, str]]) -> list[dict]:
    """The loops that hold a pair-test loop (a walk's loop over nodes): per
    loop its span, its instructions, those outside every loop it holds (a
    turn's own work, its leaf's pair tests aside) and its pair-test loops."""
    loops = sorted(set(loop_spans(code)))
    tests = [tuple(lp["span"]) for lp in loop_counts(code) if lp["pair_tests"]]
    out = []
    for span in loops:
        held = [t for t in tests if inside(t, span)]
        if not held:
            continue
        subs = [b for b in loops if inside(b, span)]
        body = [addr for addr, _ in code if span[0] <= addr <= span[1]]
        own = [a for a in body if not any(b[0] <= a <= b[1] for b in subs)]
        out.append({"span": list(span), "instructions": len(body), "own": len(own),
                    "pair_loops": len(held)})
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


def walk_report(so_path: str) -> dict:
    """``walk_loops`` of every function of a build."""
    tool = find_cuobjdump()
    if tool is None:
        return {"error": "cuobjdump not found"}
    proc = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[-400:]}
    return {name: walk_loops(code) for name, code in sass_functions(proc.stdout).items()}


def base_trace_launch(kernel, lib, scene, o, d, t_min, t_max, cull, occlusion, packet=()):
    """The base commit's entry points of the trace kernels: B4d
    (``dxr_traverse8``) and B4c (``dxr_traverse_fat_grouped``, ``packet`` =
    (tile, group, common_origin)) as they were before their leaf records,
    reading mt_rows where they now read ft_test; the others as this tree's
    (``this_trace_launch``). Returns (launch, outs, err)."""
    import torch

    from dxrexperiments_torch.ops import kernel as seam
    from dxrexperiments_torch.ops import traverse as tv

    if kernel not in ("B4d", "B4c"):
        return this_trace_launch(kernel, lib, scene, o, d, t_min, t_max, cull, occlusion)
    device = o.device
    r = o.shape[0]
    rays = tv.pack_rays(o, d, t_min, t_max)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    bvh = scene["bvh"]
    arrays = (bvh[tv.WALKS[KINDS[kernel]][1]], bvh["mt_rows"])
    fn = getattr(lib, f"dxr_{SOURCES[kernel]}")
    if occlusion:
        outs = (torch.empty(r, dtype=torch.bool, device=device),)
        ptrs = (None,) * 4 + (outs[0].data_ptr(),)
    else:
        outs = tuple(torch.empty(r, dtype=k, device=device)
                     for k in (torch.float32, torch.int32, torch.float32, torch.float32))
        ptrs = (*(x.data_ptr() for x in outs), None)

    def launch() -> int:
        return seam.on_stream(fn, device, rays.data_ptr(), *(a.data_ptr() for a in arrays), r,
                              *(a.shape[0] for a in arrays), int(occlusion), int(cull),
                              *(int(x) for x in packet), *ptrs, err.data_ptr())

    return launch, outs, err


def this_trace_launch(kernel, lib, scene, o, d, t_min, t_max, cull, occlusion, packet=()):
    """This tree's wrapper (prepare_launch) of a trace kernel with ``lib``,
    a build bound by the seam (``build_trees``): (launch, outs, err); B4c
    takes ``packet`` = (tile, group, common_origin)."""
    from dxrexperiments_torch.ops import intersect_kernel as ik
    from dxrexperiments_torch.ops import traverse as tv
    from dxrexperiments_torch.ops import traverse2 as tv2

    if kernel == "B3":
        return ik.prepare_launch(scene, o, d, t_min, t_max, cull, occlusion, lib=lib)
    if kernel in KINDS:
        return tv.prepare_launch(scene, o, d, t_min, t_max, cull, occlusion, KINDS[kernel], packet,
                                 lib=lib)
    kind = "fat" if kernel == "B6a" else "binary"
    return tv2.prepare_launch(scene["tlas"], o, d, t_min, t_max, cull, occlusion, kind, lib=lib)


def output_fields(kernel, occlusion, outs) -> dict:
    """A trace launch's outputs by field: {name: [R] or [R, 3] tensor}."""
    from dxrexperiments_torch.ops import intersect_kernel as ik

    if occlusion:
        return {"occluded": outs[0]}
    if kernel == "B3":
        return {k: x for names, block in zip((ik.SCALARS, ik.VECTORS, ik.IDS), outs)
                for k, x in zip(names, block)}
    return dict(zip(("t", "slot", "u", "v", "inst"), outs))


def differing_rays(a: dict, b: dict) -> dict:
    """Per output field, the rays whose value differs in any bit."""
    import torch

    out = {}
    for k, x in a.items():
        y = b[k]
        if x.dtype == torch.bool:
            x, y = x.to(torch.uint8), y.to(torch.uint8)
        elif x.dtype == torch.float32:
            x, y = x.contiguous().view(torch.int32), y.contiguous().view(torch.int32)
        ne = x != y
        out[k] = int(ne.reshape(ne.shape[0], -1).any(1).sum())
    return out


def this_launch(kernel, lib, scene, options, cameras, width, height, env_kind, realtime,
                py0=None, full_height=0):
    """This tree's wrapper (prepare_launch) with ``lib``, a build bound by
    the seam: (launch, outs, err). py0/full_height: the row-block form of
    the launch (camera lanes 12 and 13; a build before row blocks reads
    lane 12 and ignores lane 13)."""
    from dxrexperiments_torch.ops import fused_sample as fs
    from dxrexperiments_torch.ops import fused_traverse as ft

    if kernel == "B1":
        return fs.prepare_launch(scene, options, cameras, width, height, env_kind, realtime, 0,
                                 0, lib=lib, py0=py0, full_height=full_height)
    return ft.prepare_launch(scene, options, cameras, width, height, env_kind, realtime,
                             lib=lib, py0=py0, full_height=full_height)


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


def differing_channels(a, b) -> list[int]:
    """Per channel of two [H, W, C] float32 images, the pixels whose value
    differs in any bit."""
    import torch

    ne = a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)
    return [int(x) for x in ne.reshape(-1, ne.shape[-1]).sum(0)]


def bilateral_launch(lib, inp, guide, radius: float, axis: int):
    """One bilateral pass of a build ``lib``, bound by the seam (this tree's
    entry point, and the base's: it is unchanged): (launch, out)."""
    import torch

    from dxrexperiments_torch.ops import kernel as seam

    fn = lib.dxr_bilateral_pass
    out = torch.empty_like(inp)
    h, w, _ = inp.shape

    def launch() -> int:
        return seam.on_stream(fn, inp.device, inp.data_ptr(), guide.data_ptr(), out.data_ptr(),
                              h, w, axis, float(radius))

    return launch, out


def bilateral_cases(dev):
    """(name, input, guide, radius, axis) of the denoiser's two passes over
    config 4's frame 0 AOVs (Cornell-glossy realtime at 1920 x 1080, as
    chip_smoke.py's phase 5 renders it) at each radius of B2_RADII: the
    horizontal pass over the indirect-specular AOV guided by the direct
    lighting, the vertical pass over the plain version's horizontal result."""
    from dxrexperiments_torch.app.headless import build_scene
    from dxrexperiments_torch.models.realtime import RealtimeRaytracingPipeline
    from dxrexperiments_torch.ops import bilateral

    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(1920, 1080)
    rt = RealtimeRaytracingPipeline(1920, 1080, seed=0, device=dev)
    rt.set_camera(cam)
    rt.set_scene(sc)
    rt.update(elapsed_time=0.0, elapsed_frames=0)
    direct, spec = rt.render()
    for radius in B2_RADII:
        yield (f"config 4 frame 0 1920x1080, horizontal, radius {radius}", spec, direct,
               radius, 1)
        first = bilateral._bilateral_pass(spec, direct, float(radius), 1)
        yield (f"config 4 frame 0 1920x1080, vertical, radius {radius}", first, direct, radius, 0)


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


def mma_opcodes(so_path: str) -> dict:
    """{function: {"HGMMA": n, "HMMA": n}} of a build's kernels that use
    the tensor cores (``cuobjdump -sass``)."""
    tool = find_cuobjdump()
    if tool is None:
        return {"error": "cuobjdump not found"}
    proc = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True, check=False)
    out = {}
    for name, code in sass_functions(proc.stdout).items():
        ops = [opcode(i).split(".")[0] for _, i in code]
        counts = {k: ops.count(k) for k in ("HGMMA", "HMMA")}
        if any(counts.values()):
            out[name] = counts
    return out


def roofline_launch(lib, case, inputs):
    """One launch of a roofline build ``lib``, bound by the seam (this
    tree's C entry points, unchanged since the probes were ported): case
    "fma", "mix" or an overlap setting (do_vector, do_matrix, vector_scale)
    at roofline.py's size, the product kept. (launch, {name: output})."""
    import torch

    from dxrexperiments_torch.ops import kernel as seam
    from dxrexperiments_torch.ops import roofline as rf

    a, b, mt, rays = inputs
    if case in ("fma", "mix"):
        out = torch.empty((rf.SUB, rf.LANES * rf.GRID), device=a.device)
        code = 0 if case == "fma" else 1
        return (lambda: seam.on_stream(lib.dxr_roofline_vector, a.device, code, a.data_ptr(),
                                       b.data_ptr(), out.data_ptr(), rf.ITERS, rf.GRID)), {
            "out": out}
    outs = {k: torch.empty((rf.SUB, rf.LANES * rf.GRID), device=a.device) for k in ("o", "t")}
    outs["product"] = torch.zeros((4 * rf.C_TRIS, rf.LANES), device=a.device)
    return (lambda: seam.on_stream(lib.dxr_roofline_overlap, a.device, a.data_ptr(),
                                   b.data_ptr(), mt.data_ptr(), rays.data_ptr(),
                                   outs["o"].data_ptr(), outs["t"].data_ptr(),
                                   outs["product"].data_ptr(), rf.M_ITERS, rf.GRID, case[2],
                                   int(case[0]), int(case[1]))), outs


def roofline_cases(dev):
    """(name, case, inputs) of B7 at roofline.py's size on seeded inputs
    (the mix's a near its neutral growth, so that it stays finite)."""
    from dxrexperiments_torch.ops import roofline as rf

    inputs = rf.probe_inputs(dev, seed=37)
    yield "fma peak", "fma", inputs
    yield "pair mix", "mix", (*rf.mix_inputs(dev, seed=37), *inputs[2:])
    for case in [(False, True, 1)] + [(v, m, vs) for vs in (1, 2, 4)
                                      for v, m in ((True, False), (True, True))]:
        yield (f"overlap vector {case[0]} matrix {case[1]} scale {case[2]}", case, inputs)


def megakernel_cases(dev):
    """(name, kernel, scene, options, cameras, width, height, env_kind,
    realtime, reps) of B1's and B5's main paths' first dispatch or frame."""
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


def trace_cases(dev, kernels):
    """(name, kernel, scene, [(batch, o, d, t_min, t_max, cull, occlusion)],
    pipe, layout) of the trace kernels' main paths among ``kernels``: the
    four launches of the first sample of the first 512^2 dispatch (S = 4),
    as chip_smoke.py's phases record them: 8 (B4a, instanced:32 flattened;
    B4d and B4c take the same inputs, as phases 32 and 35 do: B4d through
    the 8-wide nodes, B4c at each packet layout of chip_smoke.GROUPINGS, one
    case each, ``layout`` = (tile, group)), 16 (B3, instanced:2 brute
    force), 12 (B6a, instanced:32 two-level), 32 (B4b, instanced:32
    flattened without fat nodes) and 34 (B6b, the two-level scene without
    them). ``scene`` is the whole scene (the B4b and B6b cases' fat nodes
    included, which the host models of B4a and B6a read); ``pipe``
    dispatches the case's route (B4a's: the wavefront route of the
    flattened scene, which the progressive pipeline takes once the BVH
    lacks ``mt_attr_lanes``, the fused-traversal kernel's gate; None for B4d
    and B4c, which no route takes). Each case's scenes are built when it is
    reached."""
    import chip_smoke as cs

    from dxrexperiments_torch.app.headless import build_scene
    from dxrexperiments_torch.models.progressive import ProgressiveRaytracingPipeline
    from dxrexperiments_torch.ops import intersect_kernel as ik
    from dxrexperiments_torch.ops import traverse as tv
    from dxrexperiments_torch.ops import traverse2 as tv2
    from dxrexperiments_torch.trace.integrator import render_sample

    def first_sample(scene, cam, tv, names):
        pipe = ProgressiveRaytracingPipeline(512, 512, seed=0, samples_per_frame=4, device=dev)
        pipe.set_camera(cam)
        pipe.set_scene_data(scene)
        pipe.update(elapsed_time=0.0, elapsed_frames=0)
        cam1 = {k: v[0] for k, v in pipe._camera_params.items()}
        traces = []

        def record(o, d, t_min, t_max, cull, occlusion):
            traces.append((o, d, t_min, t_max, cull, occlusion))

        with cs.TraceHook(tv, record, names):
            render_sample(pipe.scene_data, pipe.options, cam1, 512, 512, impl="cuda")
        return [(b, *t) for b, t in zip(BATCHES, traces)], pipe

    def built(name, form):
        sc, cam = build_scene(name)
        cam.set_aspect(512, 512)
        return (sc.build_two_level(dev) if form == "two-level" else sc.build(dev)), cam

    if {"B4a", "B4d", "B4c"} & set(kernels):
        scene, cam = built("instanced:32", "flat")
        wave = dict(scene, bvh={k: v for k, v in scene["bvh"].items() if k != "mt_attr_lanes"})
        traces, pipe = first_sample(wave, cam, tv, cs.TraceHook.B4A)
        name = "config 5 flattened: instanced:32 512^2, 1 sample"
        if "B4a" in kernels:
            yield name, "B4a", scene, traces, pipe, None
        if "B4d" in kernels:
            yield f"{name}, B4a's inputs", "B4d", scene, traces, None, None
        for tile, group in cs.GROUPINGS if "B4c" in kernels else ():
            yield (f"{name}, B4a's inputs, tile {tile} group {group}", "B4c", scene, traces, None,
                   (tile, group))
        del scene, wave, traces, pipe
    if "B3" in kernels:
        scene, cam = built(cs.BRUTE_MAIN_SCENE, "flat")
        yield ("instanced:2 brute force 512^2, 1 sample", "B3", scene,
               *first_sample(scene, cam, ik, cs.TraceHook.BRUTE), None)
    if "B4b" in kernels:
        scene, cam = built("instanced:32", "flat")
        fatless = dict(scene, bvh={k: v for k, v in scene["bvh"].items() if k not in cs.FAT_BVH})
        yield ("config 5 flattened without fat nodes: instanced:32 512^2, 1 sample", "B4b",
               scene, *first_sample(fatless, cam, tv, cs.TraceHook.BINARY), None)
        del scene, fatless
    if "B6a" in kernels or "B6b" in kernels:
        scene, cam = built("instanced:32", "two-level")
        if "B6a" in kernels:
            yield ("config 5 two-level: instanced:32 512^2, 1 sample", "B6a", scene,
                   *first_sample(scene, cam, tv2, cs.TraceHook.TWO_LEVEL), None)
        if "B6b" in kernels:
            fatless = dict(scene, tlas={k: v for k, v in scene["tlas"].items()
                                        if k not in cs.FAT_TLAS})
            yield ("config 5 two-level without fat nodes: instanced:32 512^2, 1 sample", "B6b",
                   scene, *first_sample(fatless, cam, tv2, cs.TraceHook.TWO_LEVEL_BINARY), None)


class BaseRoute:
    """While active, the wrappers of trace kernel ``kernel`` (ops.
    intersect_kernel for B3, ops.traverse's fat walk for B4a and binary walk for B4b,
    ops.traverse2's fat walk for B6a and binary walk for B6b) launch the
    build ``lib`` through ``launcher`` (``base_trace_launch``, or
    ``this_trace_launch`` for a build with this tree's entry points), so
    that a pipeline's dispatch runs that kernel with everything else this
    tree's."""

    def __init__(self, kernel, lib, launcher=None):
        from dxrexperiments_torch.ops import intersect_kernel as ik
        from dxrexperiments_torch.ops import traverse as tv
        from dxrexperiments_torch.ops import traverse2 as tv2

        self.kernel, self.lib = kernel, lib
        self.launcher = launcher or base_trace_launch
        self.mod = {"B3": ik, "B4a": tv, "B4b": tv, "B6a": tv2, "B6b": tv2}[kernel]
        self.kind = {"B3": None, "B4a": "fat", "B4b": "binary", "B6a": "fat",
                     "B6b": "binary"}[kernel]

    def launch(self, scene_or_tl, o, d, t_min, t_max, cull, occlusion, kind="fat", *rest):
        from dxrexperiments_torch.ops import intersect_kernel as ik
        from dxrexperiments_torch.ops.kernel import queue_error_check

        if self.kind is not None and kind != self.kind:  # another walk of the module
            return self.saved(scene_or_tl, o, d, t_min, t_max, cull, occlusion, kind, *rest)
        one_level = self.kernel in ("B3", "B4a", "B4b")
        scene = scene_or_tl if one_level else {"tlas": scene_or_tl}
        launch, outs, err = self.launcher(self.kernel, self.lib, scene, o, d, t_min, t_max, cull,
                                          occlusion)
        if o.shape[0] and launch() != 0:
            raise RuntimeError(f"base {self.kernel} launch failed")
        if err is not None:
            queue_error_check(err, f"base {self.kernel}")
        if occlusion:
            return outs[0]
        if self.kernel == "B3":
            res = {k: x for names, block in zip((ik.SCALARS, ik.VECTORS, ik.IDS), outs)
                   for k, x in zip(names, block)}
            res["hit"] = res["tri"] >= 0
            return res
        t, slot, u, v = outs[:4]
        hit = slot >= 0
        slot_tri = (scene["bvh"] if one_level else scene_or_tl)["slot_tri"]
        res = {"hit": hit, "t": t, "tri": slot_tri[slot.clamp(min=0).long()].where(hit, -1).long(),
               "slot": slot.long(), "u": u, "v": v}
        if len(outs) == 5:
            res["inst"] = outs[4].long()
        return res

    def __enter__(self):
        self.saved = self.mod._launch
        self.mod._launch = self.launch
        return self

    def __exit__(self, *exc):
        self.mod._launch = self.saved


# the walks on the same launch inputs beside B4a, B4b, B4d, B4c and B6b (this
# package's builds)
YARDSTICKS = {"B4a": (("B4b", "binary"), ("B4d", "wide")), "B4b": (("B4a", "fat"), ("B4d", "wide")),
              "B4d": (("B4a", "fat"), ("B4b", "binary")), "B4c": (("B4a", "fat"),),
              "B6b": (("B6a", "fat"),)}


def yardstick_ms(kernel, scene, o, d, t_min, t_max, cull, occlusion, reps: int) -> dict:
    """ms per launch, CUDA events around the launch alone, of the other
    walks of a B4a, B4b, B4d, B4c or B6b case's launch inputs
    (``YARDSTICKS``): B4a, B4b and B4d on the flattened scene's fat, binary
    and 8-wide nodes, B6a on the two-level scene's fat nodes."""
    from dxrexperiments_torch.ops import traverse as tv
    from dxrexperiments_torch.ops import traverse2 as tv2
    from dxrexperiments_torch.ops.kernel import raise_on_error

    out = {}
    for name, kind in YARDSTICKS[kernel]:
        if kernel in KINDS:
            launch, _, err = tv.prepare_launch(scene, o, d, t_min, t_max, cull, occlusion, kind)
        else:
            launch, _, err = tv2.prepare_launch(scene["tlas"], o, d, t_min, t_max, cull,
                                                occlusion, kind)
        out[name] = time_ms(launch, reps)
        raise_on_error(err, f"{name} yardstick")
    return out


def dispatch_ms(pipe, n: int) -> float:
    """Host ms per progressive dispatch (update + render), synchronised at
    the end of n dispatches, after one to warm up."""
    import time

    import torch

    pipe.max_iterations = 2**30  # every dispatch renders
    pipe.update(elapsed_time=0.0, elapsed_frames=99)
    pipe.render()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(n):
        pipe.update(elapsed_time=0.0, elapsed_frames=100 + f)
        pipe.render()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def trace_figures(kernel, scene, o, d, t_min, t_max, cull, occlusion, rng, packet=()) -> dict:
    """The host figures of one trace launch: B3's live share and lane slots
    from the plain sweep's verdicts on every ray
    (``intersect_kernel.sweep_figures``); B6a's warp costs on
    chip_smoke.COUNT_PIXELS rays of sampled whole warps
    (``chip_smoke.walk2_figures``); B4a's, B4b's, B4d's and B6b's
    leaf-weighted figures (``walk_figures``); B4c's packet figures at
    layout ``packet`` (``packet_figures``)."""
    import chip_smoke as cs

    from dxrexperiments_torch.ops import intersect_kernel as ik
    from dxrexperiments_torch.ops import traverse2 as tv2

    if kernel == "B3":
        t_count = min(int(scene["num_tris"]), int(scene["mt_pack"].shape[1]))
        work = ik.sweep_work(scene, o, d, t_min, t_max, occlusion, cull, cs.PLAIN_SLICE)
        return ik.sweep_figures(work, t_count)
    if kernel == "B4c":
        return packet_figures(scene, o, d, t_min, t_max, cull, occlusion, rng, packet)
    if kernel in ("B4a", "B4b", "B4d", "B6b"):
        return walk_figures(kernel, scene, o, d, t_min, t_max, cull, occlusion, rng)
    tl = scene["tlas"]
    tl_np = {k: tl[k].cpu().numpy() for k in ("tlasf_rows", "inst_rows_t", "blasf_rows",
                                               "mt_rows", "slot_tri")}
    sub = cs.sampled_warps(len(o), rng, o.device)
    _, counts = tv2.fat_walk2_numpy(tl_np, cs.host_array(o[sub]), cs.host_array(d[sub]),
                                    cs.host_array(t_min), cs.host_array(cs.rows_of(t_max, sub)),
                                    cull=cull, occlusion=occlusion)
    return cs.walk2_figures(tv2, counts, d[sub], t_min, cs.rows_of(t_max, sub), occlusion)


def walk_figures(kernel, scene, o, d, t_min, t_max, cull, occlusion, rng, live=None) -> dict:
    """Step-1 figures of a B4a, B4b, B4d, B5 or B6b launch, on
    chip_smoke.COUNT_PIXELS rays of sampled spans of whole warps
    (``chip_smoke.sampled_warps``; with rng None, every ray: whole warps
    already, as ``b5_figures`` passes them), for each walk's host model:
    B4a's launch inputs through its fat walk with and without leaf
    postponement (``fat_walk_numpy``) and B4b's walk; B4b's through B4a's fat walk, B4d's
    8-wide walk, the JAX kernel's binary walk (B4b before its redesign) and
    this tree's (``parent_walk_numpy`` with leaf postponement); B4d's
    through its 8-wide walk with and without leaf postponement
    (``wide_walk_numpy``) and B4a's; B5's (one of its walks, ``live`` [R]
    the lanes that make it) through its fat walk without leaf postponement
    (B5 before its redesign) and with it, in B5's warps
    (``fat_walk_numpy(..., live=)``: a lane without the walk neither visits
    nor votes); B6b's through B6a's walk and the JAX kernel's binary walk
    (B6b's). Per walk,
    summed over the warps (``ops/traverse2.turn_costs``): "turns" (a warp's
    loop turns), "slots" (Σ over turns of its largest pair tests), "pairs"
    (its lanes' pair tests), with leaf postponement (this tree's B4b)
    "p_turns", "p_slots", "visits" and "pairs" per ray, "deepest" (the
    deepest stack of any ray; two-level: TLAS + BLAS) and "mean_deepest"
    (each ray's deepest, mean); for B5 "warps" (the warps with a lane
    that walks), "lanes" (their walking lanes, mean), "cost" (turns and
    slots weighed by B4a's SASS constants, ``B4A_COSTS``) and, postponed,
    "p_cost" (the same of p_turns and p_slots), "phases" (the warps' leaf
    phases) and "phase_lanes" (the lanes testing leaves in one, mean: the
    engagement counter's figure); and for B4a, B4b, B4d and
    B5 "same_hits": whether the postponed model returns the unpostponed
    (B4a, B4d, B5) or the JAX kernel's (B4b) model's hits, bit for bit."""
    import functools

    import chip_smoke as cs
    import numpy as np

    from dxrexperiments_torch.ops import traverse as tv
    from dxrexperiments_torch.ops import traverse2 as tv2

    import torch

    sub = (torch.arange(len(o), device=o.device) if rng is None
           else cs.sampled_warps(len(o), rng, o.device))
    args = (cs.host_array(o[sub]), cs.host_array(d[sub]), cs.host_array(t_min),
            cs.host_array(cs.rows_of(t_max, sub)))
    lv = (np.ones(len(sub), bool) if live is None
          else np.asarray(live, bool)[cs.host_array(sub)])
    if kernel == "B5":
        tree = {k: scene["bvh"][k].cpu().numpy() for k in ("bvhf_rows", "mt_rows", "slot_tri")}
        models = {"B5 unpostponed": functools.partial(tv.fat_walk_numpy, live=lv),
                  "B5": functools.partial(tv.fat_walk_numpy, postpone=True, live=lv)}
    elif kernel in ("B4a", "B4b", "B4d"):
        tree = {k: scene["bvh"][k].cpu().numpy() for k in ("bvhf_rows", "bvh_rows", "bvh8_rows",
                                                          "mt_rows", "slot_tri")}
        b4a = functools.partial(tv.fat_walk_numpy, postpone=True)
        b4b = functools.partial(tv.parent_walk_numpy, postpone=True)
        if kernel == "B4a":
            models = {"B4a unpostponed": tv.fat_walk_numpy, "B4a": b4a, "B4b": b4b}
        elif kernel == "B4d":
            models = {"B4d unpostponed": tv.wide_walk_numpy,
                      "B4d": functools.partial(tv.wide_walk_numpy, postpone=True), "B4a": b4a}
        else:
            models = {"B4a": tv.fat_walk_numpy, "B4d": tv.wide_walk_numpy,
                      "B4b JAX order": tv.binary_walk_numpy, "B4b": b4b}
    else:
        tree = {k: scene["tlas"][k].cpu().numpy() for k in (
            "tlasf_rows", "tlas_rows", "inst_rows_t", "blasf_rows", "blas_rows", "mt_rows",
            "slot_tri")}
        models = {"B6a": tv2.fat_walk2_numpy, "B6b": tv2.binary_walk2_numpy}
    fig, results = {}, {}
    for name, model in models.items():
        res, c = model(tree, *args, cull=cull, occlusion=occlusion)
        results[name] = res
        w = tv2.turn_costs(c["turns"], len(sub))
        depth = c["ray_depth"]
        if isinstance(depth, dict):
            deepest = c["max_stack"]["tlas"] + c["max_stack"]["blas"]
            mean = float((depth["tlas"] + depth["blas"]).mean())
            visits = c["tlas_visits"] + c["blas_visits"]
        else:
            deepest, mean, visits = c["max_stack"], float(depth.mean()), c["visits"]
        row = {"turns": int(w["turns"].sum()), "slots": int(w["pair_slots"].sum()),
               "pairs": int(w["pairs"].sum())}
        if "postponed_turns" in w:
            row.update(p_turns=int(w["postponed_turns"].sum()),
                       p_slots=int(w["postponed_slots"].sum()))
        row.update(visits=visits / len(sub), pairs_per_ray=c["pair_tests"] / len(sub),
                   deepest=deepest, mean_deepest=mean)
        if kernel == "B5":
            walking = np.bincount(np.arange(len(sub))[lv] // tv.WARP,
                                  minlength=-(-len(sub) // tv.WARP))
            c_turn, c_pair = B4A_COSTS[bool(occlusion)]
            row.update(warps=int((walking > 0).sum()),
                       lanes=float(walking[walking > 0].mean()) if walking.any() else 0.0,
                       cost=c_turn * row["turns"] + c_pair * row["slots"])
            if name == "B5":  # no rounds logged: no lane made the walk
                row.setdefault("p_turns", 0)
                row.setdefault("p_slots", 0)
                row["p_cost"] = c_turn * row["p_turns"] + c_pair * row["p_slots"]
                rd = c["turns"].get("rounds")
                phases = [] if rd is None else rd["lanes"][~rd["traversal"]]
                row["phases"] = len(phases)
                row["phase_lanes"] = float(np.mean(phases)) if len(phases) else 0.0
        fig[name] = row
    if kernel in ("B4a", "B4b", "B4d", "B5"):
        base = results[{"B4a": "B4a unpostponed", "B4b": "B4b JAX order",
                        "B4d": "B4d unpostponed", "B5": "B5 unpostponed"}[kernel]]
        fig["same_hits"] = all(np.array_equal(results[kernel][k], base[k]) for k in base)
    return fig


B5_TILE = 16  # csrc/fused_traverse.cu kTileW = kTileH: a block's pixel tile


def b5_lanes(width: int, height: int):
    """B5's threads in launch order (blocks in blockIdx order, each block's
    B5_TILE x B5_TILE threads row-major), each as the raster index of its
    pixel, -1 for a thread outside the image (it returns before any walk):
    a warp, 32 consecutive threads, is 16 x 2 pixels of a tile."""
    import numpy as np

    gx, gy = -(-width // B5_TILE), -(-height // B5_TILE)
    by, bx, ty, tx = np.meshgrid(np.arange(gy), np.arange(gx), np.arange(B5_TILE),
                                 np.arange(B5_TILE), indexing="ij")
    px, py = bx * B5_TILE + tx, by * B5_TILE + ty
    return np.where((px < width) & (py < height), py * width + px, -1).reshape(-1)


def b5_walks(scene, options, camera, width, height, pixels, impl) -> list:
    """The walks of B5's realtime kernel for the pixels ``pixels`` [P]
    (raster indices) of a frame of ``camera`` (one CameraParams), as the
    wavefront route traces the same ray tree (``trace_rays`` in realtime
    mode on those pixels' primary rays and seeds, with ``impl``'s traces):
    [(walk, o, d, t_min, t_max [P], cull, occlusion, live [P] bool)] in the
    ray tree's order: the primary closest hit, a depth-0 shadow ray per
    light, the specular bounce and its shadow rays. ``live``: the pixels
    whose lane makes the walk (every primary; a hit's shadow rays; a
    specular hit's bounce). The wavefront route also traces dead rays, with
    a zero direction or an empty window; B5 does not walk them. A rig with
    an area light, or the debug==2 estimator (B5 then walks the picked
    light's ray alone), raises NotImplementedError."""
    import torch

    from dxrexperiments_torch.core import rng
    from dxrexperiments_torch.core.camera import primary_ray_grid
    from dxrexperiments_torch.ops.fused_sample import REALTIME_JITTER_SCALE
    from dxrexperiments_torch.scene.lights import light_counts
    from dxrexperiments_torch.scene.scene import to_device
    from dxrexperiments_torch.trace import integrator as ig

    d_n, p_n, a_n = light_counts(scene["lights"])
    if a_n or int(options["debug"]) == 2:
        raise NotImplementedError("b5_walks: an area light's samples or the debug==2 pick, "
                                  "which the wavefront route traces otherwise than B5")
    dev = scene["bvh"]["bvhf_rows"].device
    cam = to_device(camera, dev)
    o, d = primary_ray_grid(cam, width, height, REALTIME_JITTER_SCALE)
    seeds = rng.pixel_seeds(width, height, cam["frame_count"], device=dev).reshape(-1)
    idx = torch.as_tensor(pixels, dtype=torch.int64, device=dev)
    traces, saved = [], (ig._trace_closest, ig._trace_any)

    def closest(sc, o, d, t_min, t_max, cull, impl, sort_rays=False):
        traces.append((o, d, t_min, t_max, cull, False))
        return saved[0](sc, o, d, t_min, t_max, cull, impl, sort_rays)

    def occluded(sc, o, d, t_min, t_max, impl, sort_rays=False):
        traces.append((o, d, t_min, t_max, False, True))
        return saved[1](sc, o, d, t_min, t_max, impl, sort_rays)

    ig._trace_closest, ig._trace_any = closest, occluded
    try:
        ig.trace_rays(scene, options, o.reshape(-1, 3)[idx], d.reshape(-1, 3)[idx], seeds[idx],
                      mode="realtime", impl=impl, env_kind=int(scene["env"]["kind"]))
    finally:
        ig._trace_closest, ig._trace_any = saved

    def window(t, n):
        return t if torch.is_tensor(t) and t.dim() else torch.full((n,), float(t), device=dev)

    p, out = len(idx), []
    for depth, name in enumerate(("primary closest", "specular bounce closest")):
        o_, d_, t_min, t_max, cull, _ = traces[2 * depth]
        t_max = window(t_max, p)
        out.append((name, o_, d_, t_min, t_max, cull, False, t_max > 0))
        o_, d_, t_min, t_max, _, _ = traces[2 * depth + 1]
        t_max = window(t_max, len(o_))
        for k, light in enumerate(["directional"] * d_n + ["point"] * p_n):
            dk = d_[k * p:(k + 1) * p]
            out.append((f"depth-{depth} {light} shadow", o_[k * p:(k + 1) * p], dk, t_min,
                        t_max[k * p:(k + 1) * p], False, True, dk.abs().sum(1) >= 1e-30))
    return out


def b5_figures(scene, options, camera, width, height, impl, rng) -> dict:
    """Step-1 figures of B5's realtime frame: on the pixels of
    chip_smoke.COUNT_PIXELS threads in sampled spans of whole warps of
    ``b5_lanes``, each walk of ``b5_walks`` through ``walk_figures``' B5
    models in B5's warps (a lane outside the image or without the walk
    neither visits nor votes); "total": the unpostponed "cost" and the
    postponed "p_cost" summed over the walks, and their "ratio", the
    modelled ratio of B5's walk time with and without leaf postponement."""
    import chip_smoke as cs
    import numpy as np
    import torch

    lanes = b5_lanes(width, height)
    sub = cs.sampled_warps(len(lanes), rng, "cpu").numpy()
    pix = lanes[sub]
    inside = torch.as_tensor(pix >= 0)
    fig = {}
    for name, o, d, t_min, t_max, cull, occlusion, live in b5_walks(
            scene, options, camera, width, height, pix[pix >= 0], impl):
        def lane_order(x):
            out = torch.zeros((len(sub), *x.shape[1:]), dtype=x.dtype, device=x.device)
            out[inside.to(x.device)] = x
            return out

        fig[name] = walk_figures("B5", scene, lane_order(o), lane_order(d), t_min,
                                 lane_order(t_max), cull, occlusion, None,
                                 live=cs.host_array(lane_order(live)))
    cost = sum(f["B5 unpostponed"]["cost"] for f in fig.values())
    p_cost = sum(f["B5"]["p_cost"] for f in fig.values())
    fig["total"] = {"cost": cost, "p_cost": p_cost, "ratio": p_cost / max(cost, 1.0),
                    "lanes": int(np.count_nonzero(pix >= 0))}
    return fig


# the bins of lanes a warp (1..32) in which leaf_phase_counts reports shares
LANE_BINS = ((1, 1), (2, 4), (5, 8), (9, 16), (17, 31), (32, 32))


def lane_summary(hist) -> dict:
    """Of a histogram [33] of warps by lanes (index k: k lanes), the count
    of warps with a lane, the mean lanes of those, and the share of them in
    each bin of LANE_BINS ("lo-hi")."""
    import numpy as np

    h = np.asarray(hist, np.int64)
    k = np.arange(len(h))
    n = int(h[1:].sum())
    out = {"count": n, "mean": float((k * h)[1:].sum() / n) if n else 0.0}
    for lo, hi in LANE_BINS:
        out[f"{lo}-{hi}"] = float(h[lo:hi + 1].sum() / n) if n else 0.0
    return out


def leaf_phase_counts(scene, options, cams, width, height, env_kind, realtime,
                      flags: tuple = ()) -> tuple:
    """B5's engagement counter on one case: a launch of the opt-in counting
    build (csrc/fused_traverse.cu with DXR_LEAF_PHASE_COUNTS, its own
    library; ``flags`` as in ``compare``). Returns (counts, outs): counts
    per walk kind ("closest", "occlusion") of "walks" (lane_summary of the
    walks by the lanes of their mask) and "phases" (of the leaf phases by
    the lanes that test leaves in them), each histogram [33] beside it
    ("walks_hist", "phases_hist"); outs, the launch's outputs."""
    import ctypes

    import numpy as np

    from dxrexperiments_torch.ops import fused_traverse as ft
    from dxrexperiments_torch.ops.kernel import raise_on_error

    lib = ft.B5.build(library_name("B5", flags) + "_counts",
                      flags=(*flags, "-DDXR_LEAF_PHASE_COUNTS"))
    read = lib.dxr_fused_traverse_leaf_counts
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    buf = (ctypes.c_ulonglong * (2 * 2 * 33))()
    if read(buf, 1) != 0:
        raise RuntimeError("leaf_phase_counts: reading the tallies failed")
    launch, outs, err = this_launch("B5", lib, scene, options, cams, width, height, env_kind,
                                    realtime)
    if launch() != 0 or read(buf, 1) != 0:
        raise RuntimeError("leaf_phase_counts: the counting build's launch failed")
    raise_on_error(err, "leaf_phase_counts")
    h = np.array(buf, np.int64).reshape(2, 2, 33)
    counts = {kind: {"walks": lane_summary(h[k, 0]), "phases": lane_summary(h[k, 1]),
                     "walks_hist": h[k, 0].tolist(), "phases_hist": h[k, 1].tolist()}
              for k, kind in enumerate(("closest", "occlusion"))}
    return counts, outs


def packet_figures(scene, o, d, t_min, t_max, cull, occlusion, rng, packet) -> dict:
    """Step-1 figures of a B4c launch at layout ``packet`` = (tile, group,
    common_origin), on the rays of max(1, chip_smoke.COUNT_PIXELS / tile)
    sampled whole tiles, for the packet walk with the JAX kernel's packet
    of ``tile`` rays ("B4c tile", this tree's parent) and with the warp's
    32 (``fat_packet_walk_numpy(packet=32)``, "B4c"), and B4a's postponed
    walk of the same rays: per walk "lane_steps" (Σ over rays of their
    packet's steps), "warp_steps" (Σ over warps of 32 rays of the steps it
    walks), "slots" (Σ over warps of the pair slots it runs) and "pairs"
    (pair tests); B4a's "warp_steps" and "slots" are its traversal rounds
    and leaf-phase slots (``traverse2.turn_costs``). "cost" weighs each
    walk's warp steps and slots with B4a's SASS constants (``B4A_COSTS``)
    and "to_b4a" is its ratio to B4a's: the predicted ms of a walk is B4a's
    ms times it. "same_t": whether the warp packet's t (or occlusion)
    equals B4a's model's on every sampled ray."""
    import chip_smoke as cs
    import numpy as np
    import torch

    from dxrexperiments_torch.ops import traverse as tv
    from dxrexperiments_torch.ops import traverse2 as tv2

    tile, group, common_origin = packet
    n_tiles = max(1, cs.COUNT_PIXELS // tile)
    tiles = rng.choice(len(o) // tile, n_tiles, replace=False)
    sub = torch.as_tensor((tiles[:, None] * tile + np.arange(tile)).reshape(-1), device=o.device)
    tree = {k: scene["bvh"][k].cpu().numpy() for k in ("bvhf_rows", "mt_rows", "slot_tri")}
    o_s = cs.host_array(o[:1].expand_as(o)[sub] if common_origin else o[sub])
    args = (o_s, cs.host_array(d[sub]), cs.host_array(t_min),
            cs.host_array(cs.rows_of(t_max, sub)))
    c_turn, c_pair = B4A_COSTS[bool(occlusion)]
    fig, results = {}, {}
    for name, size in (("B4c tile", tile), ("B4c", tv.WARP)):
        res, c = tv.fat_packet_walk_numpy(tree, *args, tile, group, cull=cull,
                                          occlusion=occlusion, packet=size)
        results[name] = res
        fig[name] = {"lane_steps": int(c["ray_visits"].sum()),
                     "warp_steps": int(c["ray_visits"][::tv.WARP].sum()),
                     "slots": int(c["warp_slots"].sum()), "pairs": int(c["pair_tests"])}
    res, c = tv.fat_walk_numpy(tree, *args, cull=cull, occlusion=occlusion, postpone=True)
    w = tv2.turn_costs(c["turns"], len(sub))
    fig["B4a"] = {"lane_steps": int(c["visits"]), "warp_steps": int(w["postponed_turns"].sum()),
                  "slots": int(w["postponed_slots"].sum()), "pairs": int(c["pair_tests"])}
    for row in fig.values():
        row["cost"] = c_turn * row["warp_steps"] + c_pair * row["slots"]
    for row in fig.values():
        row["to_b4a"] = row["cost"] / max(fig["B4a"]["cost"], 1.0)
    key = "occluded" if occlusion else "t"
    fig["same_t"] = bool(np.array_equal(results["B4c"][key], res[key]))
    return fig


NO_FMAD = "-fmad=false"  # --no-fmad: nvcc contracts no multiply-add, in either tree


def library_name(key: str, flags: tuple = ()) -> str:
    """The build name of kernel ``key``'s source: its SOURCES name, with a
    suffix for a build without multiply-add contraction."""
    return SOURCES[key] + ("_no_fmad" if NO_FMAD in flags else "")


def build_trees(base_csrc: str, keys, this_csrc: str | None = None,
                flags: tuple = ()) -> tuple[dict, dict]:
    """Every source of ``keys`` in both trees (this one: this package's
    sources, or ``this_csrc``), one nvcc each with ``flags`` added, all at
    once: (trees {"base", "this"}: csrc dir, libs {(tree, key): CDLL, bound
    by the seam to this tree's entry points})."""
    from concurrent.futures import ThreadPoolExecutor

    from dxrexperiments_torch.ops import kernel as seam
    from dxrexperiments_torch.utils import cuda_build

    trees = {"base": base_csrc, "this": this_csrc or cuda_build.CSRC_DIR}
    jobs = [(tree, key) for tree in trees for key in keys]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: seam.kernels()[j[1]].build(
            library_name(j[1], flags), trees[j[0]], flags), jobs)))
    return trees, libs


def compare(base_csrc: str, card: str, dev, kernels, reps: int,
            same_entries: bool = False, this_csrc: str | None = None,
            flags: tuple = ()) -> dict:
    """Build, check and time (``reps`` launches a turn; 0: no times) both
    trees (main's work) for the cases of ``kernels`` (of COMPARED).
    ``same_entries``: the base's trace kernels have this tree's entry points
    (a variant of this tree), so they launch through this tree's wrappers.
    ``this_csrc``: build "this" from these sources (a variant with this
    tree's entry points) instead of this package's. ``flags``: nvcc options
    for every build of both trees (``NO_FMAD``)."""
    import numpy as np
    import torch

    from dxrexperiments_torch.ops.kernel import check_errors, raise_on_error
    from dxrexperiments_torch.utils import cuda_build

    trees, libs = build_trees(base_csrc, SOURCES, this_csrc, flags)

    def info(tree, key):
        d, name = trees[tree], library_name(key, flags)
        return cuda_build.BUILD_INFO[name if d == cuda_build.CSRC_DIR else f"{name}@{d}"]

    report = {"card": card, "ptxas": {}, "sass_loops": {}, "cases": []}
    for tree in trees:
        for key in SOURCES:
            counts = cuda_build.ptxas_counts(info(tree, key)["log"])
            report["ptxas"][f"{key} {tree}"] = counts
            for k in counts:
                print(f"ptxas {key} {tree}: {k}", flush=True)
    report["sass_identical"], report["mma_opcodes"] = {}, {}
    for key in SOURCES:
        if key in REDESIGNED:
            for tree in trees:
                ops = mma_opcodes(info(tree, key)["path"])
                report["mma_opcodes"][f"{key} {tree}"] = ops
                print(f"sass {key} {tree}: tensor-core instructions {ops}", flush=True)
            continue
        texts = [sass_text(info(tree, key)["path"]) for tree in trees]
        same = None if texts[0] is None else texts[0] == texts[1]
        report["sass_identical"][key] = same
        print(f"sass {key}: this build's instructions equal the base build's: {same}", flush=True)
    report["walk_loops"] = {}
    for tree in trees:
        for key in ("B1", "B3", "B5") + WALK_KERNELS:
            sass = sass_report(info(tree, key)["path"])
            report["sass_loops"][f"{key} {tree}"] = sass
            if "error" in sass:
                print(f"sass {key} {tree}: {sass['error']}", flush=True)
                continue
            for line in loop_summary(sass):
                print(f"sass {key} {tree}: {line}", flush=True)
            if key not in WALK_KERNELS:
                continue
            walks = walk_report(info(tree, key)["path"])
            report["walk_loops"][f"{key} {tree}"] = walks
            for fn, loops in sorted(walks.items()) if "error" not in walks else ():
                for lp in loops:
                    print(f"walk loop {key} {tree} {fn}: {lp['instructions']} instructions, "
                          f"{lp['own']} outside its inner loops, {lp['pair_loops']} pair-test "
                          f"loops", flush=True)

    launcher = this_trace_launch if same_entries else base_trace_launch
    if any(k in TRACED for k in kernels):
        for name, kernel, scene, traces, pipe, layout in trace_cases(dev, kernels):
            if reps and pipe is not None:  # the route's dispatch with either kernel, in turns
                routes = {True: BaseRoute(kernel, libs["base", kernel], launcher),
                          False: BaseRoute(kernel, libs["this", kernel], this_trace_launch)}
                turns = []
                for use_base in (True, False, False, True):
                    with routes[use_base]:
                        turns.append(dispatch_ms(pipe, reps))
                check_errors()
                row = {"case": f"{name}: ms per 4-sample dispatch", "kernel": kernel,
                       "base_ms": (turns[0] + turns[3]) / 2, "this_ms": (turns[1] + turns[2]) / 2,
                       "turns_ms": turns}
                report["cases"].append(row)
                print(f"dispatch {kernel} {name}: host ms per 4-sample dispatch (synchronised), "
                      f"base {row['base_ms']:.3f}, this {row['this_ms']:.3f} (turns "
                      f"{', '.join(f'{t:.3f}' for t in turns)}) [{card}]", flush=True)
            for batch, o, d, t_min, t_max, cull, occlusion in traces:
                label = f"{name}, {batch} ({len(o)} rays)"
                # B4c: the primary launch's rays share one origin, as phase 35 calls it
                packet = (*layout, batch == BATCHES[0]) if layout else ()
                base = launcher(kernel, libs["base", kernel], scene, o, d, t_min, t_max, cull,
                                occlusion, packet)
                mine = this_trace_launch(kernel, libs["this", kernel], scene, o, d, t_min, t_max,
                                         cull, occlusion, packet)
                for launch, *_ in (base, mine):
                    if launch() != 0:
                        raise RuntimeError(f"{label}: launch failed")
                torch.cuda.synchronize()
                fields = output_fields(kernel, occlusion, mine[1])
                diff = differing_rays(output_fields(kernel, occlusion, base[1]), fields)
                if kernel in ("B4d", "B4c"):  # against this tree's B4a on the same rays
                    fat = this_trace_launch("B4a", libs["this", "B4a"], scene, o, d, t_min,
                                            t_max, cull, occlusion)
                    if fat[0]() != 0:
                        raise RuntimeError(f"{label}: B4a launch failed")
                    torch.cuda.synchronize()
                    raise_on_error(fat[2], f"{label}: B4a")
                    vs_b4a = differing_rays(output_fields("B4a", occlusion, fat[1]), fields)
                    print(f"case {kernel} {label}: rays differing in any bit from this tree's "
                          f"B4a per output {vs_b4a} [{card}]", flush=True)
                fig = trace_figures(kernel, scene, o, d, t_min, t_max, cull, occlusion,
                                    np.random.default_rng(len(report["cases"])), packet)
                for k, v in fig.items():
                    line = (", ".join(f"{a} {b:.4f}" if isinstance(b, float) else f"{a} {b}"
                                      for a, b in v.items()) if isinstance(v, dict) else v)
                    print(f"figures {kernel} {label}: {k}: {line}", flush=True)
                row = {"case": label, "kernel": kernel, "batch": batch, "rays": len(o),
                       "differing_rays": diff, "figures": fig}
                if kernel in ("B4d", "B4c"):
                    row["differing_from_b4a"] = vs_b4a
                if reps:
                    turns = [time_ms(f, reps) for f in (base[0], mine[0], mine[0], base[0])]
                    row.update(base_ms=(turns[0] + turns[3]) / 2,
                               this_ms=(turns[1] + turns[2]) / 2, turns_ms=turns)
                if reps and kernel in YARDSTICKS:
                    row["yardstick_ms"] = yardstick_ms(kernel, scene, o, d, t_min, t_max, cull,
                                                       occlusion, reps)
                    print(f"yardsticks {kernel} {label}: ms per launch "
                          + ", ".join(f"{k} {v:.4f}" for k, v in row["yardstick_ms"].items())
                          + f" [{card}]", flush=True)
                    if kernel == "B4c":  # the packet model's ms: B4a's times its cost ratio
                        print(f"figures {kernel} {label}: modelled ms with B4a's "
                              + ", ".join(f"{k} {row['yardstick_ms']['B4a'] * fig[k]['to_b4a']:.4f}"
                                          for k in ("B4c tile", "B4c")), flush=True)
                report["cases"].append(row)
                times = (f"; ms base {row['base_ms']:.4f}, this {row['this_ms']:.4f} (turns "
                         f"{', '.join(f'{t:.4f}' for t in row['turns_ms'])})" if reps else "")
                print(f"case {kernel} {label}: rays differing in any bit per output "
                      f"{diff}{times} [{card}]", flush=True)
                for err in (base[2], mine[2]):
                    if err is not None:
                        raise_on_error(err, label)
            del scene, traces, pipe
            torch.cuda.empty_cache()

    if "B2" in kernels:
        for name, inp, guide, radius, axis in bilateral_cases(dev):
            base = bilateral_launch(libs["base", "B2"], inp, guide, radius, axis)
            mine = bilateral_launch(libs["this", "B2"], inp, guide, radius, axis)
            for launch, _ in (base, mine):
                if launch() != 0:
                    raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            diff = differing_channels(base[1], mine[1])
            row = {"case": name, "kernel": "B2", "radius": radius, "axis": axis,
                   "differing_pixels_per_channel": diff, "pixels": inp.shape[0] * inp.shape[1]}
            times = ""
            if reps:
                turns = [time_ms(f, 5 * reps) for f in (base[0], mine[0], mine[0], base[0])]
                row.update(base_ms=(turns[0] + turns[3]) / 2, this_ms=(turns[1] + turns[2]) / 2,
                           turns_ms=turns)
                times = (f"; ms base {row['base_ms']:.4f}, this {row['this_ms']:.4f} (turns "
                         f"{', '.join(f'{t:.4f}' for t in turns)})")
            report["cases"].append(row)
            print(f"case B2 {name}: pixels differing in any bit per channel {diff}{times} "
                  f"[{card}]", flush=True)
        torch.cuda.empty_cache()

    if "B7" in kernels:
        for name, case, inputs in roofline_cases(dev):
            base = roofline_launch(libs["base", "B7"], case, inputs)
            mine = roofline_launch(libs["this", "B7"], case, inputs)
            for launch, _ in (base, mine):
                if launch() != 0:
                    raise RuntimeError(f"B7 {name}: launch failed")
            torch.cuda.synchronize()
            diff = {k: int((base[1][k].view(torch.int32) != v.view(torch.int32)).sum())
                    for k, v in mine[1].items()}
            row = {"case": f"B7 {name}", "kernel": "B7", "differing_elements": diff,
                   "elements": {k: v.numel() for k, v in mine[1].items()}}
            times = ""
            if reps:
                turns = [time_ms(f, reps) for f in (base[0], mine[0], mine[0], base[0])]
                row.update(base_ms=(turns[0] + turns[3]) / 2, this_ms=(turns[1] + turns[2]) / 2,
                           turns_ms=turns)
                times = (f"; ms base {row['base_ms']:.4f}, this {row['this_ms']:.4f} (turns "
                         f"{', '.join(f'{t:.4f}' for t in turns)})")
            report["cases"].append(row)
            print(f"case B7 {name}: elements differing in any bit from the base build per output "
                  f"{diff}{times} [{card}]", flush=True)
        torch.cuda.empty_cache()

    if not any(k in ("B1", "B5") for k in kernels):
        return report
    for name, kernel, scene, options, cams, width, height, ek, realtime, n in (
            megakernel_cases(dev)):
        if kernel not in kernels:
            continue
        # the megakernels' entry points are the base's: this tree's wrapper serves both
        mine = this_launch(kernel, libs["this", kernel], scene, options, cams, width, height,
                           ek, realtime)
        base = this_launch(kernel, libs["base", kernel], scene, options, cams, width, height,
                           ek, realtime)
        # this build launched as the whole image's one row block: py0 0, full_height height
        rows = this_launch(kernel, libs["this", kernel], scene, options, cams, width, height,
                           ek, realtime, py0=0, full_height=height)
        for launch, *_ in (base, mine, rows):
            if launch() != 0:
                raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        diff = differing_pixels(base[1], mine[1], height, width)
        diff_rows = differing_pixels(base[1], rows[1], height, width)
        turns = [time_ms(f, n) for f in (base[0], mine[0], mine[0], base[0])]
        row = {"case": name, "kernel": kernel, "differing_pixels": diff,
               "differing_pixels_py0_0": diff_rows,
               "pixels": width * height, "base_ms": (turns[0] + turns[3]) / 2,
               "this_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns}
        report["cases"].append(row)
        print(f"case {name}: {diff} of {width * height} pixels differ from the base build "
              f"({diff_rows} launched as one row block, py0 0, full_height {height}); "
              f"ms base {row['base_ms']:.4f}, this {row['this_ms']:.4f} (turns "
              f"{', '.join(f'{t:.4f}' for t in turns)}) [{card}]", flush=True)
        for err in (base[2], mine[2], rows[2]):
            if err is not None:
                raise_on_error(err, name)
        if kernel != "B5":
            continue
        counts, outs = leaf_phase_counts(scene, options, cams, width, height, ek, realtime, flags)
        row["leaf_phases"] = counts
        row["differing_pixels_counting"] = differing_pixels(mine[1], outs, height, width)
        for kind, c in counts.items():
            for what in ("walks", "phases"):
                v = c[what]
                print(f"counts B5 {name}: {kind} {what} {v['count']}, lanes a warp mean "
                      f"{v['mean']:.2f}, shares " + ", ".join(
                          f"{k} {x:.3f}" for k, x in v.items() if k not in ("count", "mean"))
                      + f" (the counting build's outputs: {row['differing_pixels_counting']} "
                      f"pixels differ)", flush=True)
        if not realtime:
            continue
        cams1 = {k: v[0] for k, v in cams.items()}
        fig = b5_figures(scene, options, cams1, width, height, "cuda", np.random.default_rng(0))
        row["figures"] = fig
        for walk, f in fig.items():
            for model, v in (f.items() if walk != "total" else [("all walks", f)]):
                line = (", ".join(f"{a} {b:.4f}" if isinstance(b, float) else f"{a} {b}"
                                  for a, b in v.items()) if isinstance(v, dict) else v)
                print(f"figures B5 {name}: {walk}: {model}: {line}", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--base", required=True, help="a checkout of the commit to compare with")
    ap.add_argument("--json", default=None, help="also write the result here")
    ap.add_argument("--reps", type=int, default=10,
                    help="launches per timed turn of a trace case (0: no times)")
    ap.add_argument("--kernels", default=",".join(REDESIGNED),
                    help=f"the kernels whose cases run, of {', '.join(COMPARED)}")
    ap.add_argument("--this", default=None,
                    help="a checkout whose sources stand for this tree's (a variant with its C "
                         "entry points)")
    ap.add_argument("--no-fmad", action="store_true",
                    help="build both trees with nvcc -fmad=false: no multiply-add contraction, "
                         "so the same arithmetic in changed code agrees bit for bit")
    ap.add_argument("--same-entries", action="store_true",
                    help="the base is a variant of this tree with its C entry points: launch its "
                         "trace kernels through this tree's wrappers")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(COMPARED):
        ap.error(f"--kernels: expected some of {', '.join(COMPARED)}")

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(f"card: {card}", flush=True)
    base_csrc = os.path.join(os.path.abspath(args.base), "dxrexperiments_torch", "csrc")
    this_csrc = (os.path.join(os.path.abspath(args.this), "dxrexperiments_torch", "csrc")
                 if args.this else None)
    report = compare(base_csrc, card, dev, kernels, args.reps, args.same_entries, this_csrc,
                     (NO_FMAD,) if args.no_fmad else ())
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k not in ("sass_loops", "walk_loops")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
