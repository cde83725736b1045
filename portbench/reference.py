"""The plain reference renderer that decides ``correct``.

Plain PyTorch, written from the reference application's shading (the
DXRExperiments raygen, closest-hit, miss and shadow shaders as the port
documents them): it imports nothing of ``dxrexperiments_torch``, of
``dxrexperiments_tpu`` or of JAX, and takes nothing the port made. It works
out again what the port derives: world-space triangles from the scene spec,
the camera basis, the per-frame jitter (the pipelines' numpy draws), the TEA
pixel seeds and LCG draws, the Phong lobe, the shadow rays and the
denoiser. It finds hits by testing every triangle of the Cornell box and,
for an instanced scene, every triangle of each instance whose bounding
sphere the ray crosses: no BVH, no TLAS.

Every float is computed in ``dtype``: float32 for the reference, bfloat16
for the control (``control.py``). Integers (seeds, indices) stay int64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
RAY_EPSILON = 1.0e-4
RAY_MAX_T = 1.0e38
JITTER_SCALE = {"progressive": 30.0, "realtime": 10.0}
GROUP_MIN_TRIS = 64  # an instance of more triangles is culled by its bounding sphere
PAIR_BUDGET = 1 << 25  # ray x triangle tests per chunk


# ---------------------------------------------------------------- draws ----
def init_rand(v0: torch.Tensor, v1: torch.Tensor, backoff: int = 16) -> torch.Tensor:
    """TEA hash of two 32-bit values (int64 tensors holding [0, 2^32))."""
    v0, v1 = torch.broadcast_tensors(v0 & MASK, v1 & MASK)
    s0 = torch.zeros_like(v0)
    for _ in range(backoff):
        s0 = (s0 + 0x9E3779B9) & MASK
        v0 = (v0 + ((((v1 << 4) & MASK) + 0xA341316C & MASK) ^ ((v1 + s0) & MASK)
                    ^ (((v1 >> 5) + 0xC8013EA4) & MASK))) & MASK
        v1 = (v1 + ((((v0 << 4) & MASK) + 0xAD90777D & MASK) ^ ((v0 + s0) & MASK)
                    ^ (((v0 >> 5) + 0x7E95761E) & MASK))) & MASK
    return v0


def next_rand(seed: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """One LCG step: (seed, uniform draw in [0, 1) of 24 bits)."""
    seed = (seed * 1664525 + 1013904223) & MASK
    return seed, (seed & 0x00FFFFFF).to(dtype) / 16777216.0


def jitters(seed: int, skip: int, count: int, width: int, height: int) -> np.ndarray:
    """The pipelines' sub-pixel jitter: each frame or sample draws x then y
    from ``numpy.random.default_rng(seed)``; (r - 0.5) / size, as float32.
    Returns [count, 2] for the draws after the first ``skip`` frames."""
    r = np.random.default_rng(seed).random(2 * (skip + count))[2 * skip:].reshape(count, 2)
    return np.stack([(r[:, 0] - 0.5) / float(width), (r[:, 1] - 0.5) / float(height)],
                    axis=1).astype(np.float32)


# --------------------------------------------------------------- vectors ---
def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def normalize(a):
    n2 = dot(a, a)
    inv = torch.where(n2 > 1e-8, torch.rsqrt(torch.clamp(n2, min=1e-8)), torch.zeros_like(n2))
    return a * inv[..., None]


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def basis(n):
    """(tangent, bitangent) around n: bitangent = n x (the axis of n's
    smallest component), tangent = bitangent x n."""
    a = n.abs()
    ax, ay, az = a.unbind(-1)
    xm = ((ax - ay) < 0) & ((ax - az) < 0)
    ym = ((ay - az) < 0) & ~xm
    axis = torch.stack([xm, ym, ~(xm | ym)], -1).to(n.dtype)
    bitangent = cross(n, axis)
    return cross(bitangent, n), bitangent


def camera_basis(cam: dict, aspect: float) -> dict:
    """U, V, W of the pinhole camera (W the unit view direction, U and V
    scaled by tan(fov / 2) and the aspect), float64 then float32."""
    eye, at, up = (np.asarray(cam[k], np.float64) for k in ("eye", "at", "up"))
    w = at - eye
    w /= np.linalg.norm(w)
    right = np.cross(w, up)
    right /= np.linalg.norm(right)
    up_c = np.cross(right, w)
    u = np.cross(w, up_c)
    u /= np.linalg.norm(u)
    v = np.cross(u, w)
    v /= np.linalg.norm(v)
    vlen = math.tan(0.5 * float(cam["fov_y"]))
    return {"eye": eye.astype(np.float32), "u": (u * vlen * aspect).astype(np.float32),
            "v": (v * vlen).astype(np.float32), "w": w.astype(np.float32)}


# ------------------------------------------------------------------ scene --
def yaw(angle: float) -> np.ndarray:
    """4 x 4 rotation by ``angle`` about the y axis through the origin."""
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


class RefScene:
    """World-space triangles of a scene spec on ``device`` in ``dtype``:
    instances of at most GROUP_MIN_TRIS triangles are tested whole on every
    ray ("loose"), larger ones in groups behind their bounding spheres.
    ``transforms`` ([I, 4, 4], float64) replaces the spec's, as a refit
    does."""

    def __init__(self, spec: dict, device, dtype, transforms=None):
        self.device, self.dtype = torch.device(device), dtype
        mats = spec["materials"]
        f = lambda key, width=None: torch.tensor(  # noqa: E731
            [m[key][:width] if width else m[key] for m in mats], dtype=torch.float64)
        self.mat = {"albedo": f("albedo", 3), "specular": f("specular", 3),
                    "emissive": f("emissive", 3) * f("emissive")[:, 3:4],
                    "reflectivity": f("reflectivity"), "roughness": f("roughness"),
                    "type": torch.tensor([m["type"] for m in mats])}
        self.mat = {k: v.to(device, dtype if v.is_floating_point() else torch.int64)
                    for k, v in self.mat.items()}
        loose, groups = [], []
        for i, inst in enumerate(spec["instances"]):
            mesh = spec["meshes"][inst["mesh"]]
            t = np.asarray(inst["transform"] if transforms is None else transforms[i], np.float64)
            tris = self._world(mesh, t, inst["material"])
            (groups if len(mesh["indices"]) > GROUP_MIN_TRIS else loose).append(tris)
        self.loose = self._stack(loose, pad=False) if loose else None
        self.groups = self._stack(groups, pad=True) if groups else None
        if self.groups is not None:
            p = self.groups["v0"][..., None, :] + torch.stack(
                [torch.zeros_like(self.groups["e1"]), self.groups["e1"], self.groups["e2"]], -2)
            live = self.groups["live"][..., None, None]
            lo = torch.where(live, p, torch.full_like(p, math.inf)).amin((1, 2))
            hi = torch.where(live, p, torch.full_like(p, -math.inf)).amax((1, 2))
            self.center = (lo + hi) * 0.5
            r = torch.where(live[..., 0], (p - self.center[:, None, None]).norm(dim=-1),
                            torch.zeros_like(p[..., 0])).amax((1, 2))
            self.radius = r * 1.001 + 1e-4

    def _world(self, mesh, t, override):
        pos = np.asarray(mesh["positions"], np.float64) @ t[:3, :3].T + t[:3, 3]
        rot = t[:3, :3]
        nm = np.linalg.inv(rot).T if abs(np.linalg.det(rot)) > 1e-12 else rot
        nrm = np.asarray(mesh["normals"], np.float64) @ nm.T
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        idx = np.asarray(mesh["indices"])
        mid = (np.full(len(idx), override) if override is not None
               else np.asarray(mesh["material_ids"]))
        p0, p1, p2 = (pos[idx[:, k]] for k in range(3))
        return {"v0": p0, "e1": p1 - p0, "e2": p2 - p0, "n0": nrm[idx[:, 0]],
                "n1": nrm[idx[:, 1]], "n2": nrm[idx[:, 2]], "mat": mid}

    def _stack(self, items, pad: bool):
        n = max(len(x["mat"]) for x in items)
        out = {}
        for k in ("v0", "e1", "e2", "n0", "n1", "n2", "mat"):
            rows = []
            for x in items:
                a = np.asarray(x[k])
                if pad and len(a) < n:
                    a = np.concatenate([a, np.zeros((n - len(a),) + a.shape[1:], a.dtype)])
                rows.append(a)
            a = np.stack(rows) if pad else np.concatenate(rows)
            out[k] = torch.as_tensor(a).to(self.device, torch.int64 if k == "mat" else self.dtype)
        if pad:
            counts = torch.tensor([len(x["mat"]) for x in items], device=self.device)
            out["live"] = torch.arange(n, device=self.device)[None] < counts[:, None]
        return out


def _pair_test(o, d, v0, e1, e2, t_min, t_max, cull: bool):
    """Möller-Trumbore over broadcast ray and triangle tensors: (t with inf
    where no hit, u, v)."""
    p = cross(d, e2)
    det = dot(e1, p)
    alive = det > 1e-12 if cull else det.abs() > 1e-12
    inv = 1.0 / torch.where(alive, det, torch.ones_like(det))
    tv = o - v0
    u = dot(tv, p) * inv
    q = cross(tv, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    ok = alive & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min) & (t < t_max)
    return torch.where(ok, t, torch.full_like(t, math.inf)), u, v


def _candidates(scene: RefScene, o, d, t_min, t_max):
    """(ray, group) pairs whose bounding sphere the ray's window crosses (a
    bounce direction need not be of unit length)."""
    oc = o[:, None, :] - scene.center[None]
    a = dot(d, d)[:, None]
    b = dot(oc, d[:, None, :])
    disc = b * b - a * (dot(oc, oc) - scene.radius[None] ** 2)
    root = torch.sqrt(torch.clamp(disc, min=0))
    near, far = (-b - root) / a, (-b + root) / a
    keep = (disc >= 0) & (far > t_min[:, None]) & (near < t_max[:, None])
    return keep.nonzero(as_tuple=True)


def trace(scene: RefScene, o, d, t_min, t_max, cull: bool, any_hit: bool):
    """Closest hit ((hit, t, source, index) with source 0 loose and 1
    grouped, index the triangle's row or (group, row) flattened) or, with
    ``any_hit``, the occlusion flags, for rays [N, 3] and windows [N]."""
    n = o.shape[0]
    best = torch.full((n,), math.inf, dtype=scene.dtype, device=o.device)
    src = torch.zeros(n, dtype=torch.int64, device=o.device)
    idx = torch.zeros(n, dtype=torch.int64, device=o.device)
    if scene.loose is not None:
        lt = scene.loose
        step = max(PAIR_BUDGET // max(len(lt["mat"]), 1), 1)
        for a in range(0, n, step):
            sl = slice(a, a + step)
            t, _, _ = _pair_test(o[sl, None], d[sl, None], lt["v0"][None], lt["e1"][None],
                                 lt["e2"][None], t_min[sl, None], t_max[sl, None], cull)
            tb, ti = t.min(1)
            best[sl], idx[sl] = tb, ti
    if scene.groups is not None:
        g = scene.groups
        rows = g["v0"].shape[1]
        ray, grp = _candidates(scene, o, d, t_min, torch.minimum(t_max, best))
        step = max(PAIR_BUDGET // rows, 1)
        for a in range(0, len(ray), step):
            r, gi = ray[a:a + step], grp[a:a + step]
            t, _, _ = _pair_test(o[r, None], d[r, None], g["v0"][gi], g["e1"][gi], g["e2"][gi],
                                 t_min[r, None], t_max[r, None], cull)
            tb, ti = t.min(1)
            new = best.scatter_reduce(0, r, tb, "amin")
            won = (tb == new[r]) & (tb < best[r])
            src[r[won]] = 1
            idx[r[won]] = gi[won] * rows + ti[won]
            best = new
    hit = torch.isfinite(best)
    return hit if any_hit else (hit, src, idx)


def hit_attributes(scene: RefScene, o, d, hit, src, idx):
    """Exact (t, u, v) on the winning triangle, the position, the
    interpolated unit normal and the material rows."""
    def pick(key):
        out = None
        for s, table in ((0, scene.loose), (1, scene.groups)):
            if table is None:
                continue
            flat = table[key].reshape(-1, *table[key].shape[2 if s else 1:])
            i = torch.clamp(torch.where(src == s, idx, torch.zeros_like(idx)), max=len(flat) - 1)
            val = flat[i]
            out = val if out is None else torch.where(
                (src == s).reshape(-1, *([1] * (val.dim() - 1))), val, out)
        return out

    v0, e1, e2 = pick("v0"), pick("e1"), pick("e2")
    p = cross(d, e2)
    det = dot(e1, p)
    inv = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
    tv = o - v0
    u = dot(tv, p) * inv
    q = cross(tv, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    w = 1.0 - u - v
    normal = normalize(w[:, None] * pick("n0") + u[:, None] * pick("n1")
                       + v[:, None] * pick("n2"))
    mid = torch.where(hit, pick("mat"), torch.zeros_like(idx))
    mat = {k: val[mid] for k, val in scene.mat.items()}
    return o + t[:, None] * d, normal, mat


# ---------------------------------------------------------------- shading --
class Renderer:
    """The reference application's shading over a RefScene, for a set of
    pixels; ``rays`` counts the rays each trace was given with a non-empty
    window (for the benchmark's B1 roofline)."""

    def __init__(self, scene: RefScene, spec: dict):
        self.s, self.dtype, self.dev = scene, scene.dtype, scene.device
        lt = spec["lights"]
        t = lambda x: torch.tensor(x, dtype=torch.float64).to(self.dev, self.dtype)  # noqa: E731
        self.l_dir = normalize(-t(lt["dir"]["forward"]))
        self.c_dir = t(lt["dir"]["color"]) * lt["dir"]["intensity"]
        self.p_pos = t(lt["point"]["position"])
        self.c_pnt = t(lt["point"]["color"]) * lt["point"]["intensity"]
        env = spec["env"]
        self.env = env["kind"]
        if self.env == "constant":
            self.env_c = t(env["color"]) * env["strength"]
        else:
            self.env_h, self.env_z = t(env["horizon"]), t(env["zenith"])
            self.env_s = env["strength"]
        self.rays = {"closest": 0, "any": 0}

    def environment(self, d):
        if self.env == "constant":
            return self.env_c.expand(d.shape)
        k = torch.clamp(d[:, 1] * 0.5 + 0.5, 0.0, 1.0)[:, None]
        return (self.env_h * (1 - k) + self.env_z * k) * self.env_s

    def closest(self, o, d, t_min, t_max, cull):
        self.rays["closest"] += int((t_max > t_min).sum())
        hit, src, idx = trace(self.s, o, d, t_min, t_max, cull, False)
        pos, nrm, mat = hit_attributes(self.s, o, d, hit, src, idx)
        return hit, pos, nrm, mat

    def direct(self, pos, nrm, active):
        """Directional + point light with one shadow ray each."""
        n = pos.shape[0]
        full = lambda x: torch.full((n,), x, dtype=self.dtype, device=self.dev)  # noqa: E731
        path = self.p_pos - pos
        dist = torch.sqrt(torch.clamp(dot(path, path), min=0))
        l_pnt = normalize(path)
        o2 = torch.cat([pos, pos])[torch.cat([active, active])]
        d2 = torch.cat([self.l_dir.expand(n, 3), l_pnt])[torch.cat([active, active])]
        tmax = torch.cat([full(RAY_MAX_T), torch.clamp(dist - RAY_EPSILON, min=RAY_EPSILON)])
        tmax = tmax[torch.cat([active, active])]
        self.rays["any"] += int((tmax > RAY_EPSILON).sum())
        t_min = torch.full((len(o2),), RAY_EPSILON, dtype=self.dtype, device=self.dev)
        occ = trace(self.s, o2, d2, t_min, tmax, False, True)
        vis = torch.zeros(2 * n, dtype=torch.bool, device=self.dev)
        vis[torch.cat([active, active])] = ~occ
        vis = vis.to(self.dtype)
        nol_d = saturate(dot(nrm, self.l_dir.expand(n, 3)))
        nol_p = saturate(dot(nrm, l_pnt))
        fall = 1.0 / (2.0 * math.pi * torch.clamp(dist * dist, min=1e-12))
        return (self.c_dir * (nol_d * vis[:n])[:, None]
                + self.c_pnt * (nol_p * vis[n:] * fall)[:, None])

    def secondary(self, pos, dirs, active, realtime: bool):
        """Radiance along bounce rays: the hit's direct light (and emission
        in progressive mode), the env on a miss, 0 on inactive lanes."""
        out = torch.zeros_like(pos)
        o, d = pos[active], dirs[active]
        n = o.shape[0]
        if n == 0:
            return out
        hit, p, nrm, mat = self.closest(
            o, d, torch.full((n,), RAY_EPSILON, dtype=self.dtype, device=self.dev),
            torch.full((n,), RAY_MAX_T, dtype=self.dtype, device=self.dev), False)
        col = mat["albedo"] * self.direct(p, nrm, hit) / math.pi
        if not realtime:
            col = mat["emissive"] + col
        out[active] = torch.where(hit[:, None], col, self.environment(d))
        return out

    def sample(self, o, d, seeds, realtime: bool):
        """One sample of primary rays: the color (progressive) or the
        (direct, indirect_specular) AOVs (realtime)."""
        n = o.shape[0]
        hit, pos, nrm, mat = self.closest(
            o, d, torch.zeros(n, dtype=self.dtype, device=self.dev),
            torch.full((n,), RAY_MAX_T, dtype=self.dtype, device=self.dev), True)
        env = self.environment(d)
        direct = self.direct(pos, nrm, hit)
        seed = seeds
        if not realtime:
            seed, r0, r1 = self._draw2(seed)
            tg, bt = basis(nrm)
            phi = 2.0 * math.pi * r1
            rr = torch.sqrt(r0)
            diff_dir = ((rr * torch.cos(phi))[:, None] * tg
                        + torch.sqrt(torch.clamp(1.0 - r0, min=0.0))[:, None] * nrm
                        + (rr * torch.sin(phi))[:, None] * bt)
        spec_on = hit & ((mat["type"] == 1) | (mat["type"] == 2)) & (mat["reflectivity"] > 0.001)
        expo = torch.exp((1.0 - mat["roughness"]) * 12.0)
        mirror = normalize(d - 2.0 * dot(d, nrm)[:, None] * nrm)
        seed, r0, r1 = self._draw2(seed)
        tg, bt = basis(mirror)
        cos_t = torch.pow(r0, 1.0 / (expo + 1.0))
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = 2.0 * math.pi * r1
        powered = torch.pow(cos_t, expo)
        pdf = (expo + 1.0) / (2.0 * math.pi) * powered
        brdf = (expo + 2.0) / (2.0 * math.pi) * powered
        spec_dir = ((sin_t * torch.cos(phi))[:, None] * tg + cos_t[:, None] * mirror
                    + (sin_t * torch.sin(phi))[:, None] * bt)
        spec_rad = self.secondary(pos, spec_dir, spec_on, realtime)
        ratio = torch.where(pdf > 1e-30, brdf / torch.clamp(pdf, min=1e-30),
                            (expo + 2.0) / (expo + 1.0))
        zero = torch.zeros_like(spec_rad)
        specular = torch.where(spec_on[:, None], spec_rad * ratio[:, None], zero)
        cosi = saturate(dot(-d, nrm))
        fres = mat["specular"] + (1.0 - mat["specular"]) * torch.pow(1.0 - cosi, 5.0)[:, None]
        fres = torch.where(spec_on[:, None], fres, zero)
        spec_term = mat["reflectivity"][:, None] * specular * fres
        if realtime:
            return (_sanitize(torch.where(hit[:, None], mat["albedo"] * direct / math.pi, env)),
                    _sanitize(torch.where(hit[:, None], spec_term, zero)))
        indirect = self.secondary(pos, diff_dir, hit, False) * math.pi
        color = mat["emissive"] + mat["albedo"] * (direct + indirect) / math.pi + spec_term
        return _sanitize(torch.where(hit[:, None], color, env))

    def _draw2(self, seed):
        seed, r0 = next_rand(seed, self.dtype)
        seed, r1 = next_rand(seed, self.dtype)
        return seed, r0, r1

    def primary(self, samples: list, pix, width, height, mode):
        """Primary rays and pixel seeds of the pixels ``pix`` (flat indices)
        for each of ``samples`` ([(camera basis, jitter, frame_count)]),
        sample-major: [len(samples) * len(pix)]."""
        f32 = lambda key: torch.as_tensor(  # noqa: E731
            np.stack([np.asarray(c[key], np.float32) for c, _, _ in samples])).to(self.dev,
                                                                                  self.dtype)
        g, n = len(samples), len(pix)
        px, py = pix % width, pix // width
        dx = ((px.to(self.dtype) + 0.5) / width * 2.0 - 1.0)[None, :, None]
        dy = ((py.to(self.dtype) + 0.5) / height * 2.0 - 1.0)[None, :, None]
        d = dx * f32("u")[:, None] + (-dy) * f32("v")[:, None] + f32("w")[:, None]
        d = d / torch.sqrt(dot(d, d))[..., None]
        jit = torch.as_tensor(np.stack([np.asarray(j, np.float32) for _, j, _ in samples])).to(
            self.dev, self.dtype) * JITTER_SCALE[mode]
        o = f32("eye") + torch.cat([jit, torch.zeros((g, 1), dtype=self.dtype, device=self.dev)], 1)
        frames = torch.tensor([int(f) & MASK for _, _, f in samples], device=self.dev)
        seeds = init_rand(((px + py * width) & MASK)[None, :], frames[:, None])
        return (o[:, None, :].expand(g, n, 3).reshape(-1, 3), d.reshape(-1, 3),
                seeds.reshape(-1))


def _sanitize(c):
    return torch.where(torch.isnan(c), torch.zeros_like(c), torch.clamp(c, min=0.0))


def render_progressive(rend: Renderer, cams: list, pix, width, height, batch: int = 1 << 16):
    """The mean over the samples ``cams`` ([(camera basis, jitter,
    frame_count)]) of the pixels ``pix``: [P, 3]."""
    total = torch.zeros((len(pix), 3), dtype=rend.dtype, device=rend.dev)
    per = max(batch // max(len(pix), 1), 1)
    for a in range(0, len(cams), per):
        group = cams[a:a + per]
        o, d, s = rend.primary(group, pix, width, height, "progressive")
        col = rend.sample(o, d, s, realtime=False)
        total = total + col.reshape(len(group), len(pix), 3).sum(0)
    return total / float(len(cams))


def render_realtime(rend: Renderer, cam, jitter, frame_count, pix, width, height):
    """The (direct, indirect_specular) AOVs of one frame at pixels ``pix``."""
    o, d, s = rend.primary([(cam, jitter, frame_count)], pix, width, height, "realtime")
    return rend.sample(o, d, s, realtime=True)


# --------------------------------------------------------------- denoiser --
TAP_TABLE = (1.0, 1.0, 0.9, 0.75, 0.6, 0.5, 0.0)
MAX_EXTENT = 25
LUMA = (0.299, 0.587, 0.114)


def tap_weight(i: int, radius: float) -> float:
    """The compositor's disk-like tap weight (its precalculated table)."""
    f32 = np.float32
    x = f32(abs(i)) * f32(5) / (f32(0.001) + abs(f32(radius) * f32(0.8)))
    return TAP_TABLE[min(max(int(x), 0), 6)]


def extent(radius: float) -> int:
    """The farthest tap of non-zero weight: a display pixel reads its
    inputs within this many pixels along each axis."""
    return max(i for i in range(MAX_EXTENT + 1) if tap_weight(i, radius) > 0.0)


def bilateral(inp, joint, radius: float, axis: int):
    """One joint-bilateral pass along ``axis`` of [H, W, 3] (0 vertical, 1
    horizontal): taps -25..25, out-of-image samples 0."""
    pad = [0, 0, MAX_EXTENT, MAX_EXTENT] if axis == 1 else [0, 0, 0, 0, MAX_EXTENT, MAX_EXTENT]
    ip = torch.nn.functional.pad(inp, pad)
    jp = torch.nn.functional.pad(joint, pad)
    color = torch.zeros_like(inp)
    weight = torch.zeros(inp.shape[:-1], dtype=inp.dtype, device=inp.device)
    n = inp.shape[axis]
    for i in range(-MAX_EXTENT, MAX_EXTENT + 1):
        s_in = ip.narrow(axis, MAX_EXTENT + i, n)
        s_j = jp.narrow(axis, MAX_EXTENT + i, n)
        w = tap_weight(i, radius) * (1.0 - torch.clamp((joint - s_j).abs().sum(-1) * 10.0,
                                                       0.0, 1.0))
        color = color + s_in * w[..., None]
        weight = weight + w
    return color / torch.clamp(weight, min=1e-8)[..., None]


def denoise(direct, indirect, radius: float):
    """The compositor: horizontal then vertical pass over indirect specular
    guided by direct light, plus direct light, then luma Reinhard."""
    c = bilateral(bilateral(indirect, direct, radius, 1), direct, radius, 0) + direct
    lum = c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1] + c[..., 2] * LUMA[2]
    scale = torch.where(lum > 1e-12, (lum / (lum + 1.0)) / torch.clamp(lum, min=1e-12),
                        torch.zeros_like(lum))
    return torch.clamp(c * scale[..., None], min=0.0)
