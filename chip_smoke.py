#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. the build of csrc/ with nvcc (utils/cuda_build.py), with its seconds;
  3. kernel vs plain PyTorch parity on the card: Cornell-glossy at 128^2,
     S = 4 samples per launch, for each option set of the CPU tests;
  4. the main path: ProgressiveRaytracingPipeline on cuda at 512^2,
     16 samples per frame, 8 frames (128 spp), which must launch the kernel
     exactly 8 times and give a finite image with mean > 0; the first
     frame's kernel sum against the plain version at 512^2; and the headless
     CLI at 512^2, 32 spp, as a subprocess;
  5. times from CUDA events after a warm-up: ms per 16-sample dispatch and
     primary Mrays/s for the kernel and for the plain version.

The image gate is that of benchmarks/kernel_parity.py: at most 1% of pixels
differ by more than 1e-3 and the median |difference| is at most 1e-5,
taken on the per-sample mean (the launch's sum divided by S).

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors and times. Without a CUDA device
the script exits non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_SIZE = 512
MAIN_S = 16
MAIN_FRAMES = 8
PARITY_SIZE = 128
PARITY_S = 4
BAD_TOL, BAD_FRAC, MEDIAN_MAX = 1e-3, 0.01, 1e-5
OPTION_CASES = [
    ("defaults", {}, "const"),
    ("debug2", {"debug": 2}, "const"),
    ("no_indirect_diffuse", {"no_indirect_diffuse": True}, "const"),
    ("uniform_hemisphere", {"cosine_hemisphere_sampling": False}, "const"),
    ("albedo_only", {"show_gbuffer_albedo_only": True}, "const"),
    ("fresnel_term", {"show_fresnel_term": True}, "const"),
    ("gradient_env", {}, "gradient"),
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
    from dxrexperiments_torch.models.progressive import ProgressiveRaytracingPipeline
    from dxrexperiments_torch.ops import fused_sample as fs
    from dxrexperiments_torch.scene import envmap
    from dxrexperiments_torch.trace.integrator import default_options
    from dxrexperiments_torch.utils import cuda_build

    # ---- 1. the card --------------------------------------------------------
    dev = setup_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device: {kind}", flush=True)

    # ---- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    fs._library()
    info = cuda_build.BUILD_INFO["fused_sample"]
    print(f"build fused_sample.cu: nvcc {info['seconds']:.2f}s, load total "
          f"{time.perf_counter() - t0:.2f}s -> {os.path.relpath(info['path'], ROOT)}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    rng = np.random.default_rng(0)

    def cameras(cam, size, s_count, frame0):
        return stack_cameras([
            camera_params(cam, jitter=((rng.random() - 0.5) / size, (rng.random() - 0.5) / size),
                          frame_count=frame0 + k)
            for k in range(s_count)
        ])

    # ---- 3. kernel vs plain parity ---------------------------------------------
    for name, opts, env in OPTION_CASES:
        sc, cam = build_scene("cornell-glossy")
        sc.environment = (envmap.constant_env((0.05, 0.1, 0.2), strength=1.5) if env == "const"
                          else envmap.gradient_env())
        cam.set_aspect(PARITY_SIZE, PARITY_SIZE)
        scene = sc.build(dev)
        options = default_options(**opts)
        cams = cameras(cam, PARITY_SIZE, PARITY_S, 11)
        ek = scene["env"]["kind"]
        got = fs.fused_progressive_sum(scene, options, cams, PARITY_SIZE, PARITY_SIZE, ek)
        want = fs.fused_progressive_sum_reference(scene, options, cams, PARITY_SIZE, PARITY_SIZE, ek)
        torch.cuda.synchronize()
        image_gate(f"{name} {PARITY_SIZE}^2 S={PARITY_S}", got, want, PARITY_S)

    # ---- 4. the main path -------------------------------------------------------
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(MAIN_SIZE, MAIN_SIZE)
    pipe = ProgressiveRaytracingPipeline(MAIN_SIZE, MAIN_SIZE, seed=0, samples_per_frame=MAIN_S,
                                         device=dev)
    pipe.max_iterations = MAIN_S * MAIN_FRAMES
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    first_cams = None
    torch.cuda.synchronize()
    fs.LAUNCHES = 0
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

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "headless.png")
        cmd = [sys.executable, "-m", "dxrexperiments_torch.app.headless", "--scene",
               "cornell-glossy", "--size", f"{MAIN_SIZE}x{MAIN_SIZE}", "--spp", "32",
               "--device", "cuda", "-o", png]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                              check=False)
        for line in (proc.stdout + proc.stderr).strip().splitlines()[-4:]:
            print(f"  headless: {line}", flush=True)
        if proc.returncode != 0 or not os.path.exists(png):
            raise RuntimeError(f"headless run failed with exit code {proc.returncode}")
        print(f"headless cornell-glossy {MAIN_SIZE}^2 32 spp --device cuda: exit 0", flush=True)

    # ---- 5. times ---------------------------------------------------------------
    rays = MAIN_SIZE * MAIN_SIZE * MAIN_S
    kern_ms = time_ms(lambda: fs.fused_progressive_sum(
        scene, options, first_cams, MAIN_SIZE, MAIN_SIZE, 0), 20, torch)
    plain_ms = time_ms(lambda: fs.fused_progressive_sum_reference(
        scene, options, first_cams, MAIN_SIZE, MAIN_SIZE, 0), 3, torch)
    for label, ms in (("kernel", kern_ms), ("plain", plain_ms)):
        print(f"time {label}: {ms:.3f} ms per {MAIN_S}-sample dispatch at {MAIN_SIZE}^2, "
              f"{rays / ms / 1e3:.2f} primary Mrays/s [{card}]", flush=True)

    kernels = [{
        "name": "fused_progressive_sum",
        "route": "cuda",
        "source": "dxrexperiments_torch/csrc/fused_sample.cu",
        "replaces": "dxrexperiments_tpu/ops/fused_sample_pallas.py:640",
        "launches": launches,
        "max_abs_err": main_gate["max_abs_diff"],
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
