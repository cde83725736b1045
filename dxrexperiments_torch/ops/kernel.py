"""The launch seam of the port's hand-written CUDA kernels: how each is
built, bound, enqueued, counted, traced and checked.

A wrapper in ``ops/`` declares its kernel once, as data: a ``Kernel`` with
its id (``"B1"`` ... ``"B7"``), its source in ``csrc/``, each C entry point
with its argument types, and its launch counters. The seam builds the
library at first use (``utils/cuda_build.load_library``) and keeps it;
``Kernel.bind`` sets the same argument types on another build of the
source (another commit's, or one with other nvcc flags), and
``Kernel.build`` makes one.

A launch has two halves, so that a caller can time the kernel alone: a
wrapper's ``prepare_launch`` checks, packs and allocates, and returns
``(launch, outs, err)``, whose ``launch()`` enqueues the entry point on the
device's current stream (``on_stream``) and returns the CUDA error code;
``Kernel.run`` makes that launch for the wrapper: it opens the span
``<id>.launch`` (``n``: the rays, or the frames) around the call, raises on
a non-zero code naming the kernel, counts the launch under its counter
names, and queues the read of the kernel's error flag (``err``, where it
has one). A run neither allocates, nor synchronises, nor reads the device.

Error flags: ``queue_error_check`` copies a launch's flag into pinned
memory behind an event, without waiting; ``check_errors`` reads the flags
of the launches that have finished (``wait=False``) or of all of them, and
raises for a set one. ``launch_counts`` and ``reset_launch_counts`` read
and clear every kernel's counters; ``kernels()`` lists the kernels.
``on_card`` is the one choice between a kernel and its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import annotate

MAX_STACK = 96  # per-ray stack entries of the walks (csrc/common.cuh kMaxStack)
# the walks' error flag values (csrc/common.cuh E_STACK, E_INDEX)
_ERRORS = {1: f"a ray's stack overflowed its {MAX_STACK} entries (64 in a TLAS walk)",
           2: "a node, instance or slot index lies outside the packed arrays"}

KERNELS: dict[str, Kernel] = {}  # every declared kernel, by id (``kernels()``)
_COUNTS: dict[str, int] = {}  # launches so far, by counter name


class Kernel:
    """One hand-written kernel: ``ident`` (its B-id, the span's prefix),
    ``source`` (``csrc/<source>.cu``, the library's name), ``entries`` (C
    entry point -> its argument types; every one returns a cudaError as an
    int) and ``counters`` (the names its launches are counted under)."""

    def __init__(self, ident: str, source: str, entries: dict[str, list], counters: tuple):
        self.ident, self.source, self.entries, self.counters = ident, source, entries, counters
        self.span = f"{ident}.launch"
        self.lib = None  # the package's build, loaded at first use
        KERNELS[ident] = self
        _COUNTS.update((name, 0) for name in counters)

    def bind(self, lib):
        """Set the argument types of the entry points of ``lib``, a build of
        this kernel's source; returns it."""
        for name, argtypes in self.entries.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return lib

    def build(self, name: str | None = None, csrc_dir: str | None = None, flags: tuple = ()):
        """A bound build of the source (``load_library``'s ``csrc_dir`` and
        ``flags``; give a build with flags a ``name`` of its own)."""
        from ..utils.cuda_build import CSRC_DIR, load_library

        return self.bind(load_library(name or self.source, [f"{self.source}.cu"],
                                      csrc_dir or CSRC_DIR, flags))

    def library(self):
        """The package's build of the source, built and bound at first use."""
        if self.lib is None:
            self.lib = self.build()
        return self.lib

    def run(self, launch, *counts: str, n: int | None = None, err=None) -> None:
        """Make a prepared launch: ``launch()`` inside the span
        ``<id>.launch`` (n: its rays, or its frames); raise unless it
        returns 0; count it once under each of ``counts``; queue the read
        of its error flag ``err`` (a device int32 [1]; None: the kernel has
        none)."""
        with annotate(self.span, n):
            rc = launch()
        if rc != 0:
            raise RuntimeError(f"{self.ident} ({self.source}) kernel launch failed: cudaError {rc}")
        for name in counts:
            _COUNTS[name] += 1
        if err is not None:
            with torch.cuda.device(err.device):
                queue_error_check(err, f"{self.ident} ({self.source}) kernel")


def on_stream(fn, device, *args) -> int:
    """``fn(*args, stream)``: a C entry point enqueued on the current stream
    of ``device``; returns its CUDA error code."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def on_card(device: torch.device) -> bool:
    """Whether tensors on ``device`` take the kernel (CUDA) or the plain
    version (the CPU); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def kernels() -> dict[str, Kernel]:
    """Every kernel of the port, by id: each wrapper module declares its
    own when it is imported."""
    from . import (  # noqa: F401 - each wrapper declares its kernels
        bilateral,
        fused_sample,
        fused_traverse,
        intersect_kernel,
        roofline,
        traverse,
        traverse2,
    )

    return KERNELS


def launch_counts() -> dict:
    """Every kernel's launches in this process, by counter name (``"B1"``,
    ``"B1 realtime"``, ``"B4a closest"``, ...), in name order."""
    kernels()
    return dict(sorted(_COUNTS.items()))


def reset_launch_counts() -> None:
    """Set every kernel's launch count in this process to 0."""
    for name in _COUNTS:
        _COUNTS[name] = 0


def raise_on_error(err: torch.Tensor, what: str) -> None:
    """Read a kernel's error flag (an int32 [1]); raise if it is set. On a
    device tensor the read waits for the kernel."""
    code = int(err.item())
    if code:
        raise RuntimeError(f"{what}: {_ERRORS.get(code, f'error {code}')}")


# Error flags of launches not read yet, oldest first: (event after the
# launch, pinned host copy of its flag, what launched).
_PENDING: list[tuple[torch.cuda.Event, torch.Tensor, str]] = []


def queue_error_check(err: torch.Tensor, what: str) -> None:
    """Queue the read of a launch's error flag (a device int32 [1]) on the
    current stream without waiting for the kernel: a non-blocking copy into
    pinned memory and an event. Then read the flags of the launches that
    have finished (``check_errors(wait=False)``)."""
    host = torch.empty(1, dtype=torch.int32, pin_memory=True)
    host.copy_(err, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    _PENDING.append((done, host, what))
    check_errors(wait=False)


def check_errors(wait: bool = True) -> None:
    """Raise if a queued launch set its error flag (a stack overflow, an
    index outside the arrays). wait=True waits for every queued launch,
    wait=False reads only those that have finished. The pipelines call it
    in get_output; a launch whose error is raised has already returned its
    outputs."""
    while _PENDING:
        done, host, what = _PENDING[0]
        if not wait and not done.query():
            return
        done.synchronize()
        _PENDING.pop(0)
        if int(host[0]):
            _PENDING.clear()
            raise_on_error(host, what)
