"""The kernel-launch seam (``ops/kernel.py``) on the CPU, for every kernel
the ops modules declare: its argument types are its C entry points' in
``csrc/``; every wrapper passes each entry point as many arguments as it
declares, through a stand-in library; a launch that returns a CUDA error
raises naming the kernel and counts nothing; a launch counts once under
each counter it names, and ``reset_launch_counts`` clears it; a set error
flag raises at ``check_errors``. The stream, the pinned copy and the event
are stand-ins too: a CPU build of torch has none of them."""

import contextlib
import ctypes
import functools
import os
import re
import types

import numpy as np
import pytest
import torch

from dxrexperiments_torch.app.headless import build_scene
from dxrexperiments_torch.core.camera import camera_params, stack_cameras
from dxrexperiments_torch.ops import bilateral, kernel
from dxrexperiments_torch.ops import fused_sample as fs
from dxrexperiments_torch.ops import fused_traverse as ft
from dxrexperiments_torch.ops import intersect_kernel as ik
from dxrexperiments_torch.ops import roofline as rf
from dxrexperiments_torch.ops import traverse as tv
from dxrexperiments_torch.ops import traverse2 as tv2
from dxrexperiments_torch.trace.integrator import default_options
from dxrexperiments_torch.utils.cuda_build import CSRC_DIR


class StandInEvent:
    """torch.cuda.Event for a launch still running until waited for."""

    def record(self):
        pass

    def query(self):
        return False

    def synchronize(self):
        pass


@pytest.fixture
def seam(monkeypatch):
    """The seam with fresh counts and error queue, and CPU stand-ins for
    the device, its stream, pinned memory and events."""
    empty = torch.empty
    monkeypatch.setattr(kernel, "_COUNTS", dict.fromkeys(kernel._COUNTS, 0))
    monkeypatch.setattr(kernel, "_PENDING", [])
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "Event", StandInEvent)
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **kw: empty(*a, **kw))
    return kernel


def stand_in(k, rc: dict, calls: list):
    """A library with ``k``'s entry points, each recording its arguments
    and returning rc["rc"]."""
    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return rc["rc"]
        return fn

    return types.SimpleNamespace(**{name: entry(name) for name in k.entries})


@pytest.mark.parametrize("ident", sorted(kernel.kernels()))
def test_every_kernel_launches_through_the_seam(seam, monkeypatch, ident):
    k = seam.KERNELS[ident]
    rc, calls = {"rc": 0}, []
    lib = k.bind(stand_in(k, rc, calls))
    for name, argtypes in k.entries.items():
        fn = getattr(lib, name)
        assert fn.argtypes == argtypes and fn.restype is seam.ctypes.c_int
    monkeypatch.setattr(k, "lib", lib)
    entry = next(iter(k.entries))

    def launch():
        return seam.on_stream(getattr(k.library(), entry), torch.device("cpu"), 1, 2)

    rc["rc"] = 700
    with pytest.raises(RuntimeError, match=rf"^{ident} \({k.source}\) kernel .* cudaError 700"):
        k.run(launch, k.counters[0], n=4)
    assert set(seam.launch_counts().values()) == {0}
    rc["rc"] = 0
    for name in k.counters:
        k.run(launch, name, n=4)
        assert {c: v for c, v in seam.launch_counts().items() if v} == {name: 1}
        seam.reset_launch_counts()
    assert calls[-1] == (entry, (1, 2, 7))  # the arguments, then the current stream
    err = torch.tensor([1], dtype=torch.int32)  # a set flag: a stack overflow
    k.run(launch, k.counters[-1], err=err)
    with pytest.raises(RuntimeError, match=rf"^{ident} \({k.source}\) kernel: .*stack overflowed"):
        seam.check_errors()
    seam.check_errors()  # raised once, then cleared
    k.run(launch, k.counters[-1], err=torch.zeros(1, dtype=torch.int32))
    seam.check_errors()


def test_on_card_chooses_by_device():
    assert kernel.on_card(torch.device("cuda", 0)) and not kernel.on_card(torch.device("cpu"))
    with pytest.raises(ValueError, match="unsupported device meta"):
        kernel.on_card(torch.device("meta"))


def c_signatures() -> dict:
    """Every ``extern "C"`` entry point of ``csrc/*.cu``: name -> the ctypes
    type of each parameter (a pointer or a stream: c_void_p)."""
    scalar = {"int": ctypes.c_int, "float": ctypes.c_float}
    out = {}
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith(".cu"):
            with open(os.path.join(CSRC_DIR, name)) as f:
                for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', f.read()):
                    params = [p.strip() for p in m.group(2).split(",")]
                    out[m.group(1)] = [ctypes.c_void_p if "*" in p or "cudaStream_t" in p
                                       else scalar[p.rsplit(None, 1)[0]] for p in params]
    return out


@pytest.mark.parametrize("ident", sorted(kernel.kernels()))
def test_every_kernel_declares_its_c_signature(ident):
    k = kernel.kernels()[ident]
    signatures = c_signatures()
    for name, argtypes in k.entries.items():
        assert argtypes == signatures[name], name


@pytest.fixture(scope="module")
def scenes():
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(16, 16)
    rng = np.random.default_rng(0)
    cams = stack_cameras([camera_params(cam, jitter=tuple(rng.random(2) - 0.5), frame_count=k)
                          for k in range(2)])
    inst = build_scene("instanced:1")[0]
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(64, 3)),
                                                      dtype=torch.float32), dim=1)
    return {"flat": sc.build("cpu"), "bvh": sc.build("cpu", accel="bvh"),
            "inst_bvh": inst.build("cpu", accel="bvh"), "two": inst.build_two_level("cpu"),
            "cams": cams, "o": torch.zeros(64, 3), "d": d}


def prepared_launches(ident: str, s: dict) -> list:
    """The launches of kernel ``ident`` that its wrappers prepare, every
    entry point and walk kind at least once."""
    opts, cams, o, d = default_options(), s["cams"], s["o"], s["d"]
    if ident == "B1":
        ek = int(s["flat"]["env"]["kind"])
        return [fs.prepare_launch(s["flat"], opts, cams, 16, 16, ek, rt, *knobs)[0]
                for rt in (False, True) for knobs in ((0, 0), (8, 16))]
    if ident == "B2":  # no prepare_launch: the wrapper launches through the seam
        inp = torch.rand(8, 9, 3)

        def bilateral_pass(axis):
            bilateral.bilateral_pass(inp, inp, 12.0, axis)
            return 0

        return [functools.partial(bilateral_pass, axis) for axis in (0, 1)]
    if ident == "B3":
        return [ik.prepare_launch(s["flat"], o, d, 1e-4, 1e38, False, occ)[0]
                for occ in (False, True)]
    if ident == "B5":
        ek = int(s["inst_bvh"]["env"]["kind"])
        return [ft.prepare_launch(s["inst_bvh"], opts, cams, 16, 16, ek, rt)[0]
                for rt in (False, True)]
    if ident == "B7":
        a, b, mt, rays = rf.probe_inputs("cpu")
        return [rf.prepare_vector(p, a, b, 1, 1)[0] for p in ("fma", "mix")] + [
            rf.prepare_overlap(a, b, mt, rays, True, True, 1, 1, 1, keep_product=True)[0]]
    walks = {w[0].ident: (kind, mod) for mod in (tv, tv2) for kind, w in mod.WALKS.items()}
    kind, mod = walks[ident]
    if mod is tv2:
        return [tv2.prepare_launch(s["two"]["tlas"], o, d, 1e-4, 1e38, False, occ, kind)[0]
                for occ in (False, True)]
    packet = (64, 2, False) if kind == "grouped" else ()
    return [tv.prepare_launch(s["bvh"], o, d, 1e-4, 1e38, False, occ, kind, packet)[0]
            for occ in (False, True)]


@pytest.mark.parametrize("ident", sorted(kernel.kernels()))
def test_every_wrapper_passes_its_declared_arguments(seam, monkeypatch, scenes, ident):
    k = seam.KERNELS[ident]
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, len(args)))
            return 0
        return fn

    monkeypatch.setattr(k, "lib", types.SimpleNamespace(**{n: entry(n) for n in k.entries}))
    monkeypatch.setattr(seam, "on_card", lambda device: True)
    for launch in prepared_launches(ident, scenes):
        assert launch() == 0
    assert {name for name, _ in calls} == set(k.entries)
    assert all(n == len(k.entries[name]) for name, n in calls), calls
