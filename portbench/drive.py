"""The one general traffic driver: runs a cell's traffic mix (a data file
under ``traffic/``) through the port's pipelines, as the CLI's and the
viewer's loops call them, and keeps what the comparison needs.

A *unit* is what the loop presents, synchronised: a progressive image (its
dispatches accumulated, then ``get_output``), or a realtime dispatch of K
frames (rendered, denoised, then presented). Each unit records its host
times; the units the comparison judges keep their outputs and what the
reference needs to render them again: camera poses, dispatch and frame
indices, instance angles.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from . import reference

ANCHOR = 16  # side of a compared unit's anchor tile of display pixels


class Spans:
    """Host spans (name, start, end, unit) around the benchmark's calls into
    each layer; the trace attributes each device operation to the span that
    holds its launch."""

    def __init__(self):
        self.items: list[tuple[str, float, float, int]] = []
        self.unit = -1
        self.profiling = False
        self.sync_refit = False  # a traced run ends each refit span with a synchronise

    def __call__(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.items.append((self.name, self.t0, time.perf_counter(), self.spans.unit))
        return False


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def pose(motion: dict, base: dict, p: int, p0: int) -> dict:
    """The camera of pose ``p``: the base framing turned about the vertical
    axis through its target, by ``arc`` * sin(2 pi (p + p0) / poses)
    ("swing") or by ``arc`` * (p + p0) / poses ("turn"); "fixed" keeps it.
    Every seed visits the same poses, from another start ``p0``."""
    kind = motion["kind"]
    if kind == "fixed":
        return dict(base)
    phase = (p + p0) / float(motion["poses"])
    ang = (float(motion["arc"]) * math.sin(2.0 * math.pi * phase) if kind == "swing"
           else float(motion["arc"]) * phase)
    eye, at = np.asarray(base["eye"], np.float64), np.asarray(base["at"], np.float64)
    rel = eye - at
    c, s = math.cos(ang), math.sin(ang)
    rel = np.array([c * rel[0] + s * rel[2], rel[1], -s * rel[0] + c * rel[2]])
    return dict(base, eye=tuple(float(x) for x in at + rel))


def port_scene(spec: dict):
    """The port's Scene of a scene spec, through its public API: one Mesh
    object per spec mesh (shared by its instances, so a two-level build
    keeps one BLAS for them)."""
    from dxrexperiments_torch.scene import envmap
    from dxrexperiments_torch.scene.lights import directional_light, point_light
    from dxrexperiments_torch.scene.materials import Material
    from dxrexperiments_torch.scene.mesh import Mesh
    from dxrexperiments_torch.scene.scene import Scene

    sc = Scene()
    for m in spec["materials"]:
        sc.add_material(Material(albedo=(*m["albedo"], 1.0), specular=(*m["specular"], 1.0),
                                 emissive=tuple(m["emissive"]), reflectivity=m["reflectivity"],
                                 roughness=m["roughness"], ior=m["ior"], type=m["type"]))
    meshes = [Mesh(m["positions"], m["normals"], m["indices"], material_ids=m["material_ids"])
              for m in spec["meshes"]]
    for inst in spec["instances"]:
        sc.add_model(meshes[inst["mesh"]], transform=inst["transform"], material=inst["material"])
    lt = spec["lights"]
    sc.lights = {
        "dir": directional_light(lt["dir"]["forward"],
                                 (*lt["dir"]["color"], lt["dir"]["intensity"])),
        "point": point_light(lt["point"]["position"],
                             (*lt["point"]["color"], lt["point"]["intensity"])),
    }
    env = spec["env"]
    if env["kind"] == "constant":
        sc.environment = envmap.constant_env(env["color"], strength=env["strength"])
    else:
        sc.environment = envmap.gradient_env(env["horizon"], env["zenith"],
                                             strength=env["strength"])
    return sc


class Driver:
    """One cell's traffic on one pipeline. ``seed`` seeds the pipeline's own
    jitter draws; the driver's draws (start pose, start angle, the compared
    units and pixels) come from ``numpy.random.default_rng([seed, 1])``."""

    def __init__(self, spec: dict, traffic: dict, seed: int, device, spans: Spans):
        self.spec, self.tr, self.seed = spec, traffic, int(seed)
        self.device, self.spans = torch.device(device), spans
        self.w, self.h = int(traffic["width"]), int(traffic["height"])
        self.realtime = traffic["pipeline"] == "realtime"
        self.s = 1 if self.realtime else int(traffic["samples_per_dispatch"])
        self.k = int(traffic.get("frames_per_dispatch", 1))
        self.per_image = int(traffic.get("dispatches_per_image", 1))
        rng = np.random.default_rng([self.seed, 1])
        motion = traffic["motion"]
        self.p0 = int(rng.integers(int(motion.get("poses", 1))))
        anim = traffic.get("animate")
        self.a0 = int(rng.integers(int(anim["period"]))) if anim else 0
        cmp_ = traffic["compare"]
        self.early = int(rng.integers(1, int(cmp_["early_span"]) + 1))
        self.pix = np.sort(rng.choice(self.w * self.h, size=min(int(cmp_["pixels"]),
                                                                self.w * self.h),
                                      replace=False))
        # a tile of display pixels a compared unit (early, last), whose
        # denoiser inputs are all compared too
        self.anchors = [(int(rng.integers(self.h - ANCHOR + 1)),
                         int(rng.integers(self.w - ANCHOR + 1))) for _ in range(2)]
        self.kept: dict[int, dict] = {}
        self.units: list[dict] = []
        self.dispatch = 0  # dispatches so far, warm-up included (the jitter stream's place)
        self.frame = 0  # realtime frames so far, warm-up included

    # ---------------------------------------------------------------- set-up
    def build(self, scene_data: dict | None = None) -> float:
        """Build the scene and the pipeline; returns the build's seconds
        (host clock, ended by a synchronise). ``scene_data``, a scene this
        spec already built on the device, is attached instead of a new
        build (the control's seeds share one)."""
        from dxrexperiments_torch.core.camera import Camera
        from dxrexperiments_torch.models.denoise import DenoiseCompositor, default_denoise_params
        from dxrexperiments_torch.models.progressive import ProgressiveRaytracingPipeline
        from dxrexperiments_torch.models.realtime import RealtimeRaytracingPipeline

        self.cam = Camera()
        self.cam.fov_y = float(self.spec["camera"]["fov_y"])
        self.cam.set_aspect(self.w, self.h)
        if self.realtime:
            self.pipe = RealtimeRaytracingPipeline(self.w, self.h, seed=self.seed,
                                                   device=self.device)
            radius = int(self.tr["denoise"]["max_kernel_size"])
            self.denoiser = DenoiseCompositor(default_denoise_params(max_kernel_size=radius),
                                              device=self.device)
        else:
            self.pipe = ProgressiveRaytracingPipeline(self.w, self.h, seed=self.seed,
                                                      samples_per_frame=self.s,
                                                      device=self.device)
            self.pipe.max_iterations = self.s * self.per_image
            self.denoiser = None
        self.pipe.set_camera(self.cam)
        self._set_pose(0)
        sc = port_scene(self.spec)
        t0 = time.perf_counter()
        with self.spans("scene_build"):
            if scene_data is not None:
                self.pipe.set_scene_data(scene_data)
            elif self.tr["accel"] == "two_level":
                self.pipe.set_scene_data(sc.build_two_level(self.pipe.device))
            else:
                self.pipe.set_scene(sc)
            sync(self.device)
        self.base_tf = np.stack([np.asarray(i["transform"], np.float32)
                                 for i in self.spec["instances"]])
        return time.perf_counter() - t0

    def route(self) -> str:
        from dxrexperiments_torch.models.base import select_route

        return select_route(self.pipe.scene_data, self.tr["pipeline"])

    # ----------------------------------------------------------------- units
    def _pose_of(self, p: int) -> dict:
        return pose(self.tr["motion"], self.spec["camera"], p, self.p0)

    def _set_pose(self, p: int) -> dict:
        c = self._pose_of(p)
        self.cam.set_eye_at_up(c["eye"], c["at"], c["up"])
        return c

    def angle(self, d: int) -> float:
        return float(self.tr["animate"]["yaw_per_dispatch"]) * (d + self.a0)

    def run_unit(self, index: int) -> dict:
        """One unit, presented; ``index`` < 0 for the warm-up. Returns its
        record: host start and end, frames, primary samples."""
        self.spans.unit = index
        t0 = time.perf_counter()
        rec = self._realtime_unit(index) if self.realtime else self._progressive_unit(index)
        rec.update(index=index, t0=t0, t1=time.perf_counter())
        return rec

    def _progressive_unit(self, index: int) -> dict:
        pipe, unit = self.pipe, len(self.units) if index >= 0 else 0
        per_image = self.tr["motion"].get("unit") == "image"  # else the pose set in build()
        pose = self._set_pose(unit) if per_image else self._pose_of(0)
        first = self.dispatch
        angles = []
        for _ in range(self.per_image):
            d = self.dispatch
            if "animate" in self.tr:
                angles.append(self.angle(d))
                tf = np.einsum("ij,njk->nik", reference.yaw(angles[-1]).astype(np.float32),
                               self.base_tf)
                with self.spans("refit"):
                    pipe.set_instance_transforms(tf)
                    if self.spans.sync_refit and not self.spans.profiling:
                        sync(self.device)
            with self.spans("update"):
                pipe.update(elapsed_time=d / 60.0, elapsed_frames=d)
            with self.spans("render"):
                pipe.render()
            self.dispatch += 1
        with self.spans("present"):
            img = pipe.get_output()
            sync(self.device)
        rec = {"frames": 1, "samples": self.w * self.h * self.s * self.per_image,
               "dispatches": self.per_image, "dispatch0": first, "pose": pose,
               "angles": angles}
        if index >= 0 and index == self.early:
            img = img.clone()
        if index >= 0:
            self.kept[index] = dict(rec, image=img)
            if index - 1 != self.early:
                self.kept.pop(index - 1, None)
        return rec

    def _realtime_unit(self, index: int) -> dict:
        pipe, first = self.pipe, self.frame
        poses = [self._set_pose(first)] * self.k  # render_frames holds one pose for its K frames
        if self.k == 1:
            with self.spans("update"):
                pipe.update(elapsed_time=first / 60.0, elapsed_frames=first)
            with self.spans("render"):
                direct, spec = pipe.render()
            with self.spans("denoise"):
                display = self.denoiser.dispatch(direct, spec)
            direct, spec, display = direct[None], spec[None], display[None]
        else:
            with self.spans("render"):
                direct, spec = pipe.render_frames(first, self.k)
            with self.spans("denoise"):
                display = self.denoiser.dispatch_frames(direct, spec)
        self.frame += self.k
        with self.spans("present"):
            pipe.get_output()
            sync(self.device)
        if index >= 0:
            outs = {"direct": direct, "indirect_specular": spec, "display": display}
            if index == self.early:
                outs = {k: v.clone() for k, v in outs.items()}
        rec = {"frames": self.k, "samples": self.w * self.h * self.k, "dispatches": 1,
               "frame0": first, "poses": poses}
        if index >= 0:
            self.kept[index] = dict(rec, **outs)
            if index - 1 != self.early:
                self.kept.pop(index - 1, None)
        return rec

    # ---------------------------------------------------------------- window
    def window(self, seconds: float, on_unit=None) -> tuple[float, float]:
        """Run units until ``seconds`` have passed, the early compared unit
        is done and ``on_unit`` (called before each unit with its index and
        the seconds so far, and once after the last with None) is ``done``;
        returns the window's host start and end."""
        t0 = time.perf_counter()
        i = 0
        while True:
            if on_unit is not None:
                on_unit(i, time.perf_counter() - t0)
            self.units.append(self.run_unit(i))
            i += 1
            if (time.perf_counter() - t0 >= seconds and i > self.early
                    and getattr(on_unit, "done", True)):
                break
        if on_unit is not None:
            on_unit(i, None)
        return t0, time.perf_counter()

    def compared(self) -> list[int]:
        """The units the comparison judges: the early one and the last."""
        last = len(self.units) - 1
        return sorted({self.early, last})

    def release(self) -> None:
        """Free the pipeline and its scene; the compared outputs stay."""
        self.pipe = self.denoiser = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
