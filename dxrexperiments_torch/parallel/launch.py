"""Ranks of a sharded render: process groups, spawned workers, and the
sharded progressive and realtime renders of a named scene as one rank
drives them (the CLI's ``--shard``, the tests, ``chip_smoke.py``).

    init_ranks(rank, world, "tcp://localhost:29500", device="cuda")
    spawn(progressive_job, 2, (spec,), device="cpu")   # -> [rank 0's, rank 1's]

``spawn`` starts ``world`` worker processes with the ``spawn`` start method
(CUDA does not survive ``fork``), joins them in one process group and
returns each rank's return value; a rank that raises makes ``spawn`` raise
with its traceback. A group on CUDA uses NCCL for CUDA tensors and gloo for
CPU ones (``cpu:gloo,cuda:nccl``); ``backend="gloo"`` puts every tensor on
gloo, which lets ranks share one card. ``run_tiles`` runs the ranks of
an n x 1 mesh as threads of one process instead, their all-reduce summed
in process (a row-block check on one device). Nothing here imports JAX.
"""

from __future__ import annotations

import datetime
import queue as queue_mod
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops.kernel import launch_counts, reset_launch_counts  # noqa: F401 - the tools read them here

TIMEOUT_S = 300.0  # a collective or a rank that takes longer raises


def free_port() -> int:
    """A free TCP port on localhost for a group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_ranks(rank: int, world: int, init_method: str, device: str = "cuda",
               backend: str | None = None) -> None:
    """Join the process group: NCCL for CUDA tensors and gloo for CPU ones on
    a CUDA device, gloo on the CPU, unless ``backend`` says otherwise."""
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if str(device).startswith("cuda") else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _rank_main(rank, world, init_method, device, backend, fn, args, results):
    try:
        if not str(device).startswith("cuda"):
            # the ranks are the parallelism: ranks that each spin a pool of
            # intra-op threads over the same cores run 100x slower
            torch.set_num_threads(1)
        init_ranks(rank, world, init_method, device, backend)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, args: tuple = (), device: str = "cuda", backend: str | None = None,
          timeout: float = TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``world`` spawned ranks of one process group;
    returns the ranks' return values in rank order. ``fn`` and its return
    value must pickle (a module-level function; numpy arrays, not CUDA
    tensors). Raises with the traceback of every rank that failed, or when
    a rank does not answer within ``timeout`` seconds; every worker is
    stopped before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, init_method, device, backend, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank that died without a word (killed, or its start failed)
                for r, p in enumerate(procs):
                    if r not in got and r not in errors and p.exitcode not in (None, 0):
                        errors[r] = f"exited with code {p.exitcode} and no result"
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{world - len(got) - len(errors)} of {world} ranks gave "
                                       f"no result within {timeout:.0f} s") from None
                continue
            if ok:
                got[rank] = value
            else:
                errors[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("sharded ranks failed:\n" + "\n".join(
            f"rank {r}: {errors[r]}" for r in sorted(errors)))
    return [got[r] for r in range(world)]


def run_tiles(n_tile: int, job, device) -> list:
    """``job(mesh)`` for each rank of an n_tile x 1 mesh, run in this
    process, one thread a rank, on ``device``: each thread's mesh sums a
    buffer over "tile" by adding it to the other threads' (in the order the
    threads arrive) and reading the total back, as the all-reduce of
    ``torch.distributed`` does, so ``render``'s row-block code runs
    unchanged on one device without a process group. Returns the threads'
    results in tile order; a thread's exception is raised."""
    import threading

    from .render import RenderMesh

    lock, barrier, totals = threading.Lock(), threading.Barrier(n_tile, timeout=TIMEOUT_S), {}

    class ThreadMesh(RenderMesh):
        calls = 0

        def sum_tile(self, x):
            self.calls += 1
            with lock:
                if self.calls in totals:
                    totals[self.calls] += x
                else:
                    totals[self.calls] = x.clone()
            barrier.wait()
            return x.copy_(totals[self.calls])

    device = torch.device(device)
    results, errors = [None] * n_tile, []

    def run(t):
        try:
            results[t] = job(ThreadMesh(n_tile, 1, t, device, False))
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(t,)) for t in range(n_tile)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:  # the first cause, not a thread that the abort woke
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return results


def _setup(spec: dict):
    """(mesh, scene dict, camera) of a job spec on this rank: the mesh over
    the process group, the named scene (``app.headless.build_scene``, its
    env replaced by ``spec["env"]``) built and replicated from rank 0."""
    from ..app.headless import build_scene, parse_env
    from .render import make_render_mesh, replicate_scene

    n_tile, n_spp = spec["mesh"]
    mesh = make_render_mesh(n_tile, n_spp, device=spec.get("device", "cuda"))
    sc, cam = build_scene(spec["scene"])
    if spec.get("env"):
        sc.environment = parse_env(spec["env"])
    cam.set_aspect(spec["width"], spec["height"])
    scene = (sc.build_two_level(mesh.device) if spec.get("accel") == "two-level"
             else sc.build(mesh.device))
    return mesh, replicate_scene(scene, mesh), cam


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def progressive_job(spec: dict) -> dict:
    """This rank's part of a sharded progressive render
    (``make_sharded_progressive_step``). spec: ``scene``, ``width``,
    ``height``, ``mesh`` (n_tile, n_spp), ``steps`` (per step, its S
    cameras as (jitter_x, jitter_y, frame_count, accum_count)),
    ``max_iterations``, optional ``device``, ``env``, ``accel``, ``ao_only``.
    Returns {"image": the full accumulation as numpy on rank 0 (None
    elsewhere), "launches": this rank's kernel launches during the steps,
    "step_ms": host ms per step (synchronised), "rank"}."""
    from ..core.camera import camera_params, stack_cameras
    from ..trace.integrator import default_options
    from .render import gather_rows, make_sharded_progressive_step

    mesh, scene, cam = _setup(spec)
    width, height = spec["width"], spec["height"]
    s_count = len(spec["steps"][0])
    step = make_sharded_progressive_step(scene, width, height, mesh, samples_per_step=s_count,
                                         ao_only=spec.get("ao_only", False))
    accum = torch.zeros((height // mesh.n_tile, width, 3), dtype=torch.float32,
                        device=mesh.device)
    options = default_options()
    before = launch_counts()
    step_ms = []
    for cams in spec["steps"]:
        cameras = stack_cameras([camera_params(cam, jitter=(jx, jy), frame_count=fc,
                                               accum_count=ac) for jx, jy, fc, ac in cams])
        t0 = time.perf_counter()
        accum = step(accum, options, cameras, scene["lights"], scene["env"],
                     spec["max_iterations"])
        _sync(mesh.device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    image = gather_rows(accum, mesh)
    return {"image": image.cpu().numpy() if mesh.rank == 0 else None, "launches": launches,
            "step_ms": step_ms, "rank": mesh.rank}


def realtime_job(spec: dict) -> dict:
    """This rank's part of a sharded realtime frame
    (``make_sharded_realtime_step``). spec: ``scene``, ``width``,
    ``height``, ``mesh`` (n_tile, 1), ``camera`` (jitter_x, jitter_y,
    frame_count), ``denoise``, optional ``device``, ``env``,
    ``denoise_params``, ``repeat`` (frames rendered, the same each time;
    default 1). Returns {"outputs": the last frame's full AOVs (and
    ``display``) as numpy on rank 0, "launches" (all frames'),
    "frame_ms" (host ms per frame, synchronised), "rank"}."""
    from ..core.camera import camera_params
    from ..models.denoise import default_denoise_params
    from ..trace.integrator import default_options
    from .render import gather_rows, make_sharded_realtime_step

    mesh, scene, cam = _setup(spec)
    denoise = bool(spec.get("denoise", True))
    step = make_sharded_realtime_step(scene, spec["width"], spec["height"], mesh,
                                      denoise=denoise)
    jx, jy, fc = spec["camera"]
    camera = camera_params(cam, jitter=(jx, jy), frame_count=fc)
    params = spec.get("denoise_params") or default_denoise_params()
    before = launch_counts()
    frame_ms = []
    for _ in range(int(spec.get("repeat", 1))):
        t0 = time.perf_counter()
        out = step(default_options(), camera, scene["lights"], scene["env"], params)
        _sync(mesh.device)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    keys = sorted(out)
    full = gather_rows([out[k] for k in keys], mesh)
    outputs = {k: v.cpu().numpy() for k, v in zip(keys, full)} if mesh.rank == 0 else None
    return {"outputs": outputs, "launches": launches, "frame_ms": frame_ms, "rank": mesh.rank}


def run_jobs(jobs: list) -> list:
    """Run (function, spec) jobs in order on this rank; their results. A
    spawned world runs several sharded renders, on meshes of its own
    shape, in one start-up."""
    return [fn(spec) for fn, spec in jobs]


def camera_steps(rng: np.random.Generator, width: int, height: int, n_steps: int,
                 s_count: int) -> list:
    """Per step, S cameras as (jitter_x, jitter_y, frame_count,
    accum_count), the jitter drawn from ``rng`` in order as the pipelines
    draw it: frame step * S + k, accumulated count step * S."""
    return [[((rng.random() - 0.5) / width, (rng.random() - 0.5) / height, f * s_count + k,
              f * s_count) for k in range(s_count)] for f in range(n_steps)]
