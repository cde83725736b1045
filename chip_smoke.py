#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. the build of csrc/fused_sample.cu and csrc/bilateral.cu with nvcc
     (utils/cuda_build.py, both started together), with seconds and ptxas'
     registers and spills;
  3. kernel vs plain PyTorch parity on the card: the progressive megakernel
     on Cornell-glossy at 128^2, S = 4 samples per launch, for each option
     set of the CPU tests; the realtime megakernel at 128^2 (defaults,
     debug 2, gradient env, glowing walls, and an S = 2 frame batch against
     two single-frame launches, equal to 1e-6); the bilateral kernel (B2)
     on a 1080x1920 and a 37x53 image, both axes, radii 1, 7, 12 and 25;
  4. the progressive main path: ProgressiveRaytracingPipeline on cuda at
     512^2, 16 samples per frame, 8 frames (128 spp), which must launch the
     kernel exactly 8 times and give a finite image with mean > 0; the first
     frame's kernel sum against the plain version at 512^2; and the headless
     CLI at 512^2, 32 spp, as a subprocess;
  5. the realtime + denoise main path (BASELINE config 4): 1920x1080,
     RealtimeRaytracingPipeline + DenoiseCompositor at its defaults, 8
     frames of update / render / dispatch, which must count 8 realtime and
     16 bilateral launches and give a finite display image with mean > 0;
     frame 0's AOVs against the plain version at 1080p, and its display
     against the plain denoiser on the same AOVs; and the headless CLI with
     --pipeline realtime --denoise at 1080p, as a subprocess;
  6. times from CUDA events after a warm-up: ms per 16-sample progressive
     dispatch, per 1080p realtime frame and per bilateral pass, each beside
     its plain version; and the realtime + denoise frame on the host clock,
     with the host's enqueue time of update, render and dispatch and of the
     two per-frame packs.

Each main path is driven with every launch count set to 0 just before it
and read just after. The image gate is that of benchmarks/kernel_parity.py:
at most 1% of pixels differ by more than 1e-3 and the median |difference| is
at most 1e-5, taken on the per-sample mean (the launch's sum divided by S),
and on each realtime AOV (roughness as a one-channel image). The bilateral
gate is max |difference| <= 2e-5 (tests/test_bilateral_pallas.py).

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors and times. Without a CUDA device
the script exits non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_SIZE = 512
MAIN_S = 16
MAIN_FRAMES = 8
PARITY_SIZE = 128
PARITY_S = 4
RT_W, RT_H = 1920, 1080
RT_FRAMES = 8
BAD_TOL, BAD_FRAC, MEDIAN_MAX = 1e-3, 0.01, 1e-5
BILATERAL_TOL = 2e-5
BILATERAL_RADII = (1, 7, 12, 25)
AOVS = ("direct", "indirect_specular", "albedo", "color", "roughness")
OPTION_CASES = [
    ("defaults", {}, "const"),
    ("debug2", {"debug": 2}, "const"),
    ("no_indirect_diffuse", {"no_indirect_diffuse": True}, "const"),
    ("uniform_hemisphere", {"cosine_hemisphere_sampling": False}, "const"),
    ("albedo_only", {"show_gbuffer_albedo_only": True}, "const"),
    ("fresnel_term", {"show_fresnel_term": True}, "const"),
    ("gradient_env", {}, "gradient"),
]
REALTIME_CASES = [
    ("defaults", {}, "const"),
    ("debug2", {"debug": 2}, "const"),
    ("gradient_env", {}, "gradient"),
    ("emissive", {}, "emissive"),  # every wall glows: the realtime bounce drops emissive
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0].strip()


def image_gate(name, got, want, s_count):
    """Gate the per-sample means; returns the numbers and raises on failure."""
    diff = ((got - want) / s_count).abs()
    bad = float((diff > BAD_TOL).any(dim=-1).float().mean())
    med = float(diff.median())
    mx = float(diff.max())
    ok = bad <= BAD_FRAC and med <= MEDIAN_MAX and bool(got.isfinite().all())
    print(f"parity {name}: bad-pixel frac {bad:.6f} (<= {BAD_FRAC}), median |d| {med:.3e} "
          f"(<= {MEDIAN_MAX}), max |d| {mx:.4f} -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"kernel vs plain parity failed for {name}")
    return {"bad_pixel_frac": bad, "median_abs_diff": med, "max_abs_diff": mx}


def aov_gate(name, got, want):
    """The image gate on each realtime AOV; returns the largest max |d|."""
    worst = 0.0
    for k in AOVS:
        g, w = got[k], want[k]
        if g.dim() == 2:  # roughness: a one-channel image
            g, w = g[..., None], w[..., None]
        worst = max(worst, image_gate(f"{name} {k}", g, w, 1)["max_abs_diff"])
    return worst


def bilateral_gate(name, got, want):
    err = float((got - want).abs().max())
    ok = err <= BILATERAL_TOL and bool(got.isfinite().all())
    print(f"parity {name}: max |d| {err:.3e} (<= {BILATERAL_TOL}) -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise RuntimeError(f"bilateral kernel vs plain parity failed for {name}")
    return err


def time_ms(fn, reps: int, torch) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from dxrexperiments_torch.app.headless import build_scene
    from dxrexperiments_torch.core.camera import camera_params, stack_cameras
    from dxrexperiments_torch.core.device import setup_device
    from dxrexperiments_torch.models.denoise import DenoiseCompositor, denoise_composite
    from dxrexperiments_torch.models.progressive import ProgressiveRaytracingPipeline
    from dxrexperiments_torch.models.realtime import RealtimeRaytracingPipeline
    from dxrexperiments_torch.ops import bilateral as bl
    from dxrexperiments_torch.ops import fused_sample as fs
    from dxrexperiments_torch.scene import envmap
    from dxrexperiments_torch.trace.integrator import default_options
    from dxrexperiments_torch.utils import cuda_build

    def reset_counts():
        fs.LAUNCHES = fs.REALTIME_LAUNCHES = bl.LAUNCHES = 0

    # ---- 1. the card --------------------------------------------------------
    dev = setup_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device: {kind}", flush=True)

    # ---- 2. build: one nvcc per source, started together ------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        for fut in [pool.submit(fs._library), pool.submit(bl._library)]:
            fut.result()
    load_s = time.perf_counter() - t0
    for name in ("fused_sample", "bilateral"):
        info = cuda_build.BUILD_INFO[name]
        print(f"build {name}.cu: nvcc {info['seconds']:.2f}s (both builds together "
              f"{load_s:.2f}s) -> {os.path.relpath(info['path'], ROOT)}", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    rng = np.random.default_rng(0)

    def cameras(cam, width, height, s_count, frame0):
        return stack_cameras([
            camera_params(cam, jitter=((rng.random() - 0.5) / width,
                                       (rng.random() - 0.5) / height),
                          frame_count=frame0 + k)
            for k in range(s_count)
        ])

    def parity_scene(env):
        sc, cam = build_scene("cornell-glossy")
        sc.environment = (envmap.gradient_env() if env == "gradient"
                          else envmap.constant_env((0.05, 0.1, 0.2), strength=1.5))
        if env == "emissive":
            sc.materials = [dataclasses.replace(m, emissive=(0.2, 0.3, 0.4, 2.0))
                            for m in sc.materials]
        cam.set_aspect(PARITY_SIZE, PARITY_SIZE)
        return sc.build(dev), cam

    # ---- 3a. progressive kernel vs plain parity ----------------------------------
    for name, opts, env in OPTION_CASES:
        scene, cam = parity_scene(env)
        options = default_options(**opts)
        cams = cameras(cam, PARITY_SIZE, PARITY_SIZE, PARITY_S, 11)
        ek = scene["env"]["kind"]
        got = fs.fused_progressive_sum(scene, options, cams, PARITY_SIZE, PARITY_SIZE, ek)
        want = fs.fused_progressive_sum_reference(scene, options, cams, PARITY_SIZE, PARITY_SIZE, ek)
        torch.cuda.synchronize()
        image_gate(f"{name} {PARITY_SIZE}^2 S={PARITY_S}", got, want, PARITY_S)

    # ---- 3b. realtime kernel vs plain parity -------------------------------------
    for name, opts, env in REALTIME_CASES:
        scene, cam = parity_scene(env)
        options = default_options(**opts)
        cams = cameras(cam, PARITY_SIZE, PARITY_SIZE, 1, 2**31 + 5)
        ek = scene["env"]["kind"]
        got = fs.fused_realtime_outputs(scene, options, {k: v[0] for k, v in cams.items()},
                                        PARITY_SIZE, PARITY_SIZE, ek)
        want = fs.fused_realtime_outputs_reference(scene, options, cams, PARITY_SIZE,
                                                   PARITY_SIZE, ek)
        torch.cuda.synchronize()
        aov_gate(f"realtime {name} {PARITY_SIZE}^2", got, {k: v[0] for k, v in want.items()})
    scene, cam = parity_scene("gradient")
    options = default_options(debug=2)
    cams = cameras(cam, PARITY_SIZE, PARITY_SIZE, 2, 40)
    batch = fs.fused_realtime_outputs_batch(scene, options, cams, PARITY_SIZE, PARITY_SIZE, 1)
    batch_err = 0.0
    for f in range(2):
        single = fs.fused_realtime_outputs(scene, options, {k: v[f] for k, v in cams.items()},
                                           PARITY_SIZE, PARITY_SIZE, 1)
        for k in AOVS:
            batch_err = max(batch_err, float((batch[k][f] - single[k]).abs().max()))
    torch.cuda.synchronize()
    print(f"parity realtime S=2 batch vs 2 single launches: max |d| {batch_err:.3e} (<= 1e-6)",
          flush=True)
    if not batch_err <= 1e-6:
        raise RuntimeError("realtime S=2 batch differs from single-frame launches")

    # ---- 3c. bilateral kernel vs plain parity --------------------------------------
    bl_err = 0.0
    for h, w in ((RT_H, RT_W), (37, 53)):
        inp = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        guide = np.zeros((h, w, 3), np.float32)
        guide[:, w // 2:] = 0.8
        guide += rng.uniform(0, 0.05, (h, w, 3)).astype(np.float32)
        inp_t, guide_t = torch.from_numpy(inp).to(dev), torch.from_numpy(guide).to(dev)
        for axis in (1, 0):
            for radius in BILATERAL_RADII:
                got = bl.bilateral_pass(inp_t, guide_t, float(radius), axis)
                want = bl._bilateral_pass(inp_t, guide_t, float(radius), axis)
                torch.cuda.synchronize()
                bl_err = max(bl_err, bilateral_gate(
                    f"bilateral {h}x{w} axis {axis} radius {radius}", got, want))

    # ---- 4. the progressive main path ----------------------------------------------
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(MAIN_SIZE, MAIN_SIZE)
    pipe = ProgressiveRaytracingPipeline(MAIN_SIZE, MAIN_SIZE, seed=0, samples_per_frame=MAIN_S,
                                         device=dev)
    pipe.max_iterations = MAIN_S * MAIN_FRAMES
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    first_cams = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(MAIN_FRAMES):
        pipe.update(elapsed_time=f / 60.0, elapsed_frames=f)
        if first_cams is None:
            first_cams = pipe._camera_params
        pipe.render()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = fs.LAUNCHES
    img = pipe.get_output()
    finite = bool(img.isfinite().all())
    mean = float(img.mean())
    print(f"main path: {MAIN_FRAMES} frames x {MAIN_S} samples at {MAIN_SIZE}^2 "
          f"({pipe.accum_count} spp) in {main_s:.3f}s host clock, kernel launches {launches}, "
          f"image finite {finite}, mean {mean:.5f}", flush=True)
    if launches != MAIN_FRAMES:
        raise RuntimeError(f"expected {MAIN_FRAMES} kernel launches on the main path, got {launches}")
    if not finite or not mean > 0.0:
        raise RuntimeError("main path image is not finite with a positive mean")
    if pipe.accum_count != MAIN_S * MAIN_FRAMES:
        raise RuntimeError(f"accumulated {pipe.accum_count} samples")

    scene = pipe.scene_data
    options = pipe.options
    got = fs.fused_progressive_sum(scene, options, first_cams, MAIN_SIZE, MAIN_SIZE, 0)
    want = fs.fused_progressive_sum_reference(scene, options, first_cams, MAIN_SIZE, MAIN_SIZE, 0)
    torch.cuda.synchronize()
    main_gate = image_gate(f"main-path frame 0 {MAIN_SIZE}^2 S={MAIN_S}", got, want, MAIN_S)

    def headless(args, label):
        with tempfile.TemporaryDirectory() as tmp:
            png = os.path.join(tmp, "headless.png")
            cmd = [sys.executable, "-m", "dxrexperiments_torch.app.headless", *args,
                   "--device", "cuda", "-o", png]
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                                  check=False)
            for line in (proc.stdout + proc.stderr).strip().splitlines()[-4:]:
                print(f"  headless: {line}", flush=True)
            if proc.returncode != 0 or not os.path.exists(png):
                raise RuntimeError(f"headless {label} failed with exit code {proc.returncode}")
            print(f"headless {label} --device cuda: exit 0", flush=True)

    headless(["--scene", "cornell-glossy", "--size", f"{MAIN_SIZE}x{MAIN_SIZE}", "--spp", "32"],
             f"cornell-glossy {MAIN_SIZE}^2 32 spp")

    # ---- 5. the realtime + denoise main path (config 4) ----------------------------
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(RT_W, RT_H)
    rt = RealtimeRaytracingPipeline(RT_W, RT_H, seed=0, device=dev)
    rt.set_camera(cam)
    rt.set_scene(sc)
    denoiser = DenoiseCompositor(device=dev)
    frame0 = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(RT_FRAMES):
        rt.update(elapsed_time=f / 60.0, elapsed_frames=f)
        direct, spec = rt.render()
        display = denoiser.dispatch(direct, spec)
        if frame0 is None:
            frame0 = (rt._camera_params, direct, spec, display)
    torch.cuda.synchronize()
    rt_s = time.perf_counter() - t0
    rt_launches, bl_launches = fs.REALTIME_LAUNCHES, bl.LAUNCHES
    finite = bool(display.isfinite().all())
    mean = float(display.mean())
    print(f"realtime main path: {RT_FRAMES} frames at {RT_W}x{RT_H} (render + denoise) in "
          f"{rt_s:.3f}s host clock, realtime launches {rt_launches}, bilateral launches "
          f"{bl_launches}, display finite {finite}, mean {mean:.5f}", flush=True)
    if rt_launches != RT_FRAMES or bl_launches != 2 * RT_FRAMES:
        raise RuntimeError(f"expected {RT_FRAMES} realtime and {2 * RT_FRAMES} bilateral launches,"
                           f" got {rt_launches} and {bl_launches}")
    if not finite or not mean > 0.0:
        raise RuntimeError("realtime main path display is not finite with a positive mean")

    rt_scene, rt_options = rt.scene_data, rt.options
    cam0, direct0, spec0, display0 = frame0
    cams0 = {k: v[None] for k, v in cam0.items()}
    want = fs.fused_realtime_outputs_reference(rt_scene, rt_options, cams0, RT_W, RT_H, 0)
    got = {"direct": direct0, "indirect_specular": spec0}
    got.update({k: v[0] for k, v in fs.fused_realtime_outputs_batch(
        rt_scene, rt_options, cams0, RT_W, RT_H, 0).items() if k not in got})
    torch.cuda.synchronize()
    rt_err = aov_gate(f"realtime main-path frame 0 {RT_W}x{RT_H}", got,
                      {k: v[0] for k, v in want.items()})
    plain_display = denoise_composite(direct0, spec0, denoiser.params, impl="torch")
    torch.cuda.synchronize()
    disp_err = bilateral_gate("realtime main-path frame 0 display vs plain denoiser",
                              display0, plain_display)
    bl_err = max(bl_err, disp_err)

    headless(["--pipeline", "realtime", "--denoise", "--scene", "cornell-glossy", "--size",
              f"{RT_W}x{RT_H}"], f"realtime+denoise cornell-glossy {RT_W}x{RT_H}")

    # ---- 6. times -------------------------------------------------------------------
    rays = MAIN_SIZE * MAIN_SIZE * MAIN_S
    kern_ms = time_ms(lambda: fs.fused_progressive_sum(
        scene, options, first_cams, MAIN_SIZE, MAIN_SIZE, 0), 20, torch)
    plain_ms = time_ms(lambda: fs.fused_progressive_sum_reference(
        scene, options, first_cams, MAIN_SIZE, MAIN_SIZE, 0), 3, torch)
    for label, ms in (("kernel", kern_ms), ("plain", plain_ms)):
        print(f"time {label}: {ms:.3f} ms per {MAIN_S}-sample dispatch at {MAIN_SIZE}^2, "
              f"{rays / ms / 1e3:.2f} primary Mrays/s [{card}]", flush=True)

    rt_kern_ms = time_ms(lambda: fs.fused_realtime_outputs(
        rt_scene, rt_options, cam0, RT_W, RT_H, 0), 20, torch)
    rt_plain_ms = time_ms(lambda: fs.fused_realtime_outputs_reference(
        rt_scene, rt_options, cams0, RT_W, RT_H, 0), 3, torch)
    for label, ms in (("kernel", rt_kern_ms), ("plain", rt_plain_ms)):
        print(f"time realtime {label}: {ms:.3f} ms per {RT_W}x{RT_H} frame, "
              f"{RT_W * RT_H / ms / 1e3:.2f} primary Mrays/s [{card}]", flush=True)

    radius = float(denoiser.params["max_kernel_size"])
    bl_ms, bl_plain_ms = {}, {}
    for axis in (1, 0):
        bl_ms[axis] = time_ms(lambda: bl.bilateral_pass(spec0, direct0, radius, axis), 50, torch)
        bl_plain_ms[axis] = time_ms(lambda: bl._bilateral_pass(spec0, direct0, radius, axis), 3,
                                    torch)
        print(f"time bilateral axis {axis}: kernel {bl_ms[axis]:.4f} ms, plain "
              f"{bl_plain_ms[axis]:.3f} ms per {RT_W}x{RT_H} pass, radius {radius:g} [{card}]",
              flush=True)

    host_s = {"update": 0.0, "render": 0.0, "dispatch": 0.0}

    def frame():
        t_a = time.perf_counter()
        rt.update(elapsed_time=0.0, elapsed_frames=frame.count)
        t_b = time.perf_counter()
        aovs = rt.render()
        t_c = time.perf_counter()
        display = denoiser.dispatch(*aovs)
        t_d = time.perf_counter()
        host_s["update"] += t_b - t_a
        host_s["render"] += t_c - t_b
        host_s["dispatch"] += t_d - t_c
        frame.count += 1
        return display

    frame.count = RT_FRAMES
    frame()  # warm-up
    torch.cuda.synchronize()
    host_s.update(update=0.0, render=0.0, dispatch=0.0)
    n_frames = 50
    t0 = time.perf_counter()
    for _ in range(n_frames):
        frame()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / n_frames * 1e3
    print(f"time realtime+denoise end to end (update + render + dispatch, host clock, "
          f"synchronised, {n_frames} frames): {frame_ms:.3f} ms per {RT_W}x{RT_H} frame = "
          f"{1e3 / frame_ms:.1f} fps [{card}]", flush=True)
    print("time realtime+denoise host enqueue per frame (host clock, same frames): "
          + ", ".join(f"{k} {v / n_frames * 1e3:.3f} ms" for k, v in host_s.items())
          + f", total {sum(host_s.values()) / n_frames * 1e3:.3f} ms [{card}]", flush=True)

    # the host's share of render: the two packs, as _launch builds them each frame
    n_packs = 200
    t0 = time.perf_counter()
    for _ in range(n_packs):
        fs.pack_cameras(cams0, True)
    cam_us = (time.perf_counter() - t0) / n_packs * 1e6
    t0 = time.perf_counter()
    for _ in range(n_packs):
        fs.pack_consts(rt_scene, rt_options, 0)
    cst_us = (time.perf_counter() - t0) / n_packs * 1e6
    print(f"time host packs per realtime frame (host clock, {n_packs} calls each): "
          f"pack_cameras {cam_us:.1f} us, pack_consts {cst_us:.1f} us [{card}]", flush=True)

    kernels = [
        {
            "name": "fused_progressive_sum",
            "route": "cuda",
            "source": "dxrexperiments_torch/csrc/fused_sample.cu",
            "replaces": "dxrexperiments_tpu/ops/fused_sample_pallas.py:640",
            "launches": launches,
            "max_abs_err": main_gate["max_abs_diff"],
            "ms": kern_ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "fused_realtime_outputs",
            "route": "cuda",
            "source": "dxrexperiments_torch/csrc/fused_sample.cu",
            "replaces": "dxrexperiments_tpu/ops/fused_sample_pallas.py:640",
            "launches": rt_launches,
            "max_abs_err": rt_err,
            "ms": rt_kern_ms,
            "plain_ms": rt_plain_ms,
        },
        {
            "name": "bilateral_pass",
            "route": "cuda",
            "source": "dxrexperiments_torch/csrc/bilateral.cu",
            "replaces": "dxrexperiments_tpu/ops/bilateral_pallas.py:53",
            "launches": bl_launches,
            "max_abs_err": bl_err,
            "ms": (bl_ms[0] + bl_ms[1]) / 2,
            "plain_ms": (bl_plain_ms[0] + bl_plain_ms[1]) / 2,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
