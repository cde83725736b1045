"""CUDA kernel vs its plain PyTorch version, on the card.

Marked ``cuda``; each test skips without an NVIDIA GPU (a CUDA kernel has no
CPU mode). The file imports no JAX, so it runs on a machine that has the
card and not JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Gates: the image gate of benchmarks/kernel_parity.py on the per-sample mean
(at most 1% of pixels differ by more than 1e-3, median |difference| <= 1e-5)
for both megakernels (B1, B5) in both modes, each realtime AOV on its own:
knife-edge pairs may flip under FMA contraction. The BVH walks (B4a fat,
B4b binary, B4d 8-wide, and B6a fat, B6b binary on two-level scenes): the
hit gates of benchmarks/kernel_parity.py
(relative t on lanes that hit the same triangle: median <= 1e-6, p99.9 <=
1e-4, max <= 0.05; lanes whose hit differs <= 1%; occlusion disagreement <=
1%); B6a's and B6b's instance equal on the lanes that hit the same
triangle; zero-direction shadow rays never occluded. The
brute-force trace kernels (B3): the same hit and occlusion gates, and on
lanes that hit the same triangle the normal within 1e-5 on 99.9% of lanes,
the position over max(1, t) within the hit gate's bounds on t (it is
o + t d), material rows and ids equal; whole brute-force samples on the
image gate. Texture envs (lat-long, cubemap): B1 and B5 with the lookup
inside the kernel, on the image gate against the plain versions, which
sample the env in torch. B5's area-light mode (both pipelines) and
albedo-texture mode (progressive) on the image gate against the plain
versions, which trace every area sample and sample the albedo textures in
torch.
The bilateral kernel: max
|difference| <= 2e-5 (tests/test_bilateral_pallas.py's tolerance), the sums
differing only by rounding; an inf or NaN input sample at a tap of table
weight 0, which the kernel skips, does not reach its output. The grouped packet walk (B4c): the hit gates
against B4a (t and occlusion equal to B4a's on a launch of 509 rays, a
ragged last warp), and against the host model of its walk
(``fat_packet_walk_numpy(packet=32)``) the hit or slot off on <= 1% of
rays, t within rtol 1e-4. The 8-wide walk (B4d): a stack overflow while a
lane holds a leaf raises after the leaf is tested (``wide_ladder``). B1's opt-in
instantiations: bit-equal to the base kernel. The roofline probes (B7):
relative 1e-4 against their plain versions, the split-TF32 product within
2 K float32 ulps of the sum of |terms|; across the overlap settings the
chains, the accumulator and the product equal bit for bit. Row-block
launches of B1 and B5 (py0, full_height) put together, B2's vertical pass
on halo-padded row blocks, and the frames-in-flight batch: bit-equal to the
whole launch, the whole pass and sequential renders. A live material edit
(``rebake_material``): every tensor equal to a fresh build's, the images
through B1 and B5 bit-equal; a mesh file through the CLI (B3): bit-equal
to the same mesh built in memory. A re-bake of instances on the card
(``bake_instances``): every array within 1e-6 of the CPU bake; the device
BVH build: ``order`` equal to the host build's; the sorted walks (B4a, B4b)
and the PRIME-seeded walks (B4a, B6a): every hit field and occlusion flag
equal to the plain order's and the unseeded window's, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dxrexperiments_torch.app.headless import build_scene
from dxrexperiments_torch.core.camera import camera_params, stack_cameras
from dxrexperiments_torch.models.denoise import DenoiseCompositor, denoise_composite
from dxrexperiments_torch.models.progressive import ProgressiveRaytracingPipeline
from dxrexperiments_torch.models.realtime import RealtimeRaytracingPipeline
from dxrexperiments_torch.accel import tlas
from dxrexperiments_torch.core.camera import primary_ray_grid
from dxrexperiments_torch.ops import bilateral, intersect, intersect_kernel, traverse, traverse2
from dxrexperiments_torch.ops import fused_sample as fs
from dxrexperiments_torch.ops import fused_traverse as ft
from dxrexperiments_torch.ops.kernel import check_errors, launch_counts
from dxrexperiments_torch.scene import Scene, envmap
from dxrexperiments_torch.scene.procedural import quad
from dxrexperiments_torch.scene.mesh import Mesh
from dxrexperiments_torch.trace.integrator import default_options, render_sample

SIZE = 64
S = 2
BILATERAL_RADII = (1, 7, 12, 25)  # chip_smoke.BILATERAL_RADII; 12 is the denoiser's default
OPTION_CASES = [
    ("defaults", {}, "const"),
    ("debug2", {"debug": 2}, "const"),
    ("no_indirect_diffuse", {"no_indirect_diffuse": True}, "const"),
    ("uniform_hemisphere", {"cosine_hemisphere_sampling": False}, "const"),
    ("albedo_only", {"show_gbuffer_albedo_only": True}, "const"),
    ("fresnel_term", {"show_fresnel_term": True}, "const"),
    ("direct_only", {"show_direct_lighting_only": True}, "const"),
    ("indirect_specular_only", {"show_indirect_specular_only": True}, "const"),
    ("indirect_diffuse_only", {"show_indirect_diffuse_only": True}, "const"),
    ("gradient_env", {}, "gradient"),
]


def launches(*names):
    """The launch counts of the kernels ``names`` (one name: its count)."""
    got = launch_counts()
    return got[names[0]] if len(names) == 1 else tuple(got[k] for k in names)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


REALTIME_CASES = [
    ("defaults", {}, "const"),
    ("debug2", {"debug": 2}, "const"),
    ("gradient_env", {}, "gradient"),
    ("emissive", {}, "emissive"),  # every wall glows: the realtime bounce drops emissive
]
AOVS = ("color", "direct", "indirect_specular", "albedo", "roughness")


def _setup(device, env, s_count=S):
    sc, cam = build_scene("cornell-glossy")
    sc.environment = (envmap.gradient_env() if env == "gradient"
                      else envmap.constant_env((0.05, 0.1, 0.2), strength=1.5))
    if env == "emissive":
        sc.materials = [dataclasses.replace(m, emissive=(0.2, 0.3, 0.4, 2.0))
                        for m in sc.materials]
    cam.set_aspect(SIZE, SIZE)
    rng = np.random.default_rng(5)
    cams = stack_cameras([
        camera_params(cam, jitter=((rng.random() - 0.5) / SIZE, (rng.random() - 0.5) / SIZE),
                      frame_count=2**31 + 3 + k)  # uint32 counters >= 2^31
        for k in range(s_count)
    ])
    return sc.build(device), cams


def _gate(got, want, s_count=S):
    if got.dim() == want.dim() == 2:  # roughness: a one-channel image
        got, want = got[..., None], want[..., None]
    diff = ((got - want) / s_count).abs()
    assert bool(got.isfinite().all())
    assert float((diff > 1e-3).any(dim=-1).float().mean()) <= 0.01
    assert float(diff.median()) <= 1e-5


def _bilateral_data(device, h=37, w=53, seed=3):
    rng = np.random.default_rng(seed)
    inp = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    guide = np.zeros((h, w, 3), np.float32)
    guide[:, w // 2:] = 0.8
    guide += rng.uniform(0, 0.05, (h, w, 3)).astype(np.float32)
    return torch.from_numpy(inp).to(device), torch.from_numpy(guide).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("name,opts,env", OPTION_CASES, ids=[c[0] for c in OPTION_CASES])
def test_kernel_matches_plain(cuda_device, name, opts, env):
    scene, cams = _setup(cuda_device, env)
    options = default_options(**opts)
    ek = scene["env"]["kind"]
    before = launches("B1")
    got = fs.fused_progressive_sum(scene, options, cams, SIZE, SIZE, ek)
    assert launches("B1") == before + 1
    want = fs.fused_progressive_sum_reference(scene, options, cams, SIZE, SIZE, ek)
    torch.cuda.synchronize()
    _gate(got, want)


@pytest.mark.cuda
def test_wrapper_checks_inputs(cuda_device):
    scene, cams = _setup(cuda_device, "const")
    options = default_options()
    bad = dict(scene, attr_pack=scene["attr_pack"].double())
    with pytest.raises(TypeError):
        fs.fused_progressive_sum(bad, options, cams, SIZE, SIZE, 0)
    bad = dict(scene, attr_pack=scene["attr_pack"].t().contiguous().t())
    with pytest.raises(ValueError):
        fs.fused_progressive_sum(bad, options, cams, SIZE, SIZE, 0)


@pytest.mark.cuda
def test_pipeline_launches_once_per_frame(cuda_device):
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(SIZE, SIZE)
    pipe = ProgressiveRaytracingPipeline(SIZE, SIZE, seed=1, samples_per_frame=4,
                                         device=cuda_device)
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    before = launches("B1")
    for f in range(3):
        pipe.update(elapsed_time=0.0, elapsed_frames=f)
        pipe.render()
    torch.cuda.synchronize()
    assert launches("B1") == before + 3
    img = pipe.get_output()
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name,opts,env", REALTIME_CASES, ids=[c[0] for c in REALTIME_CASES])
def test_realtime_kernel_matches_plain(cuda_device, name, opts, env):
    scene, cams = _setup(cuda_device, env, s_count=1)
    options = default_options(**opts)
    cam = {k: v[0] for k, v in cams.items()}
    ek = scene["env"]["kind"]
    before = launches("B1 realtime")
    got = fs.fused_realtime_outputs(scene, options, cam, SIZE, SIZE, ek)
    assert launches("B1 realtime") == before + 1
    want = fs.fused_realtime_outputs_reference(scene, options, cams, SIZE, SIZE, ek)
    torch.cuda.synchronize()
    for k in AOVS:
        _gate(got[k], want[k][0], s_count=1)


@pytest.mark.cuda
def test_realtime_batch_equals_single_launches(cuda_device):
    scene, cams = _setup(cuda_device, "gradient", s_count=2)
    options = default_options(debug=2)
    batch = fs.fused_realtime_outputs_batch(scene, options, cams, SIZE, SIZE, 1)
    for s in range(2):
        single = fs.fused_realtime_outputs(
            scene, options, {k: v[s] for k, v in cams.items()}, SIZE, SIZE, 1
        )
        for k in AOVS:
            torch.testing.assert_close(batch[k][s], single[k], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 12, 25])
@pytest.mark.parametrize("axis", [0, 1])
def test_bilateral_kernel_matches_plain(cuda_device, axis, radius):
    inp, guide = _bilateral_data(cuda_device, seed=axis * 31 + radius)
    before = launches("B2")
    got = bilateral.bilateral_pass(inp, guide, float(radius), axis)
    assert launches("B2") == before + 1
    want = bilateral._bilateral_pass(inp, guide, float(radius), axis)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2e-5


# image shapes around B2's tiles (csrc/bilateral.cu): 32 lanes across the
# axis, 64 outputs along it, staged with a 25-pixel apron on either side
BILATERAL_SHAPES = [(1, 200), (200, 1), (37, 53), (5, 63), (5, 65), (63, 5), (65, 5), (31, 33),
                    (33, 31), (3, 113), (3, 115), (113, 3), (115, 3), (70, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("radius", BILATERAL_RADII)
@pytest.mark.parametrize("shape", BILATERAL_SHAPES, ids=[f"{h}x{w}" for h, w in BILATERAL_SHAPES])
def test_bilateral_kernel_tile_edges(cuda_device, shape, radius):
    """Both passes on images whose sides end on, before and after a tile
    and a tile plus its apron, within 2e-5 of the plain version."""
    inp, guide = _bilateral_data(cuda_device, *shape, seed=shape[0] * 7 + shape[1] + radius)
    for axis in (0, 1):
        got = bilateral.bilateral_pass(inp, guide, float(radius), axis)
        want = bilateral._bilateral_pass(inp, guide, float(radius), axis)
        torch.cuda.synchronize()
        assert bool(got.isfinite().all())
        assert float((got - want).abs().max()) <= 2e-5, (shape, radius, axis)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_bilateral_kernel_skips_zero_weight_taps(cuda_device, axis):
    """B2 skips the taps whose table weight is 0 (at radius 12: |i| >= 12).
    With an inf and a NaN input sample, an output that reaches them only
    through such taps equals the plain version's on the image with those
    samples set to 0 (the plain version's own is NaN there, 0 x inf); an
    output within 11 taps of one is not finite in its channel in either;
    every other output equals the plain version's within 2e-5."""
    h, w = 40, 90
    inp, guide = _bilateral_data(cuda_device, h, w, seed=17)
    bad_px = ((20, 45, 1, float("inf")), (7, 10, 0, float("nan")))
    bad, zeroed = inp.clone(), inp.clone()
    near = torch.zeros(h, w, 3, dtype=torch.bool, device=cuda_device)
    far = near.clone()
    for y, x, c, v in bad_px:
        bad[y, x, c], zeroed[y, x, c] = v, 0.0
        for i in range(-25, 26):
            yy, xx = (y + i, x) if axis == 0 else (y, x + i)
            if 0 <= yy < h and 0 <= xx < w:
                (near if abs(i) <= 11 else far)[yy, xx, c] = True
    far &= ~near
    got = bilateral.bilateral_pass(bad, guide, 12.0, axis)
    plain = bilateral._bilateral_pass(bad, guide, 12.0, axis)
    want = bilateral._bilateral_pass(zeroed, guide, 12.0, axis)
    torch.cuda.synchronize()
    assert int(far.sum()) > 20 and int(near.sum()) > 20
    assert not bool(got[near].isfinite().any()) and not bool(plain[near].isfinite().any())
    assert bool(plain[far].isnan().all())
    assert float((got[~near] - want[~near]).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_realtime_denoise_pipeline(cuda_device):
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(SIZE, SIZE)
    pipe = RealtimeRaytracingPipeline(SIZE, SIZE, seed=2, device=cuda_device)
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    denoiser = DenoiseCompositor(device=cuda_device)
    rt0, bl0 = launches("B1 realtime", "B2")
    for f in range(2):
        pipe.update(elapsed_time=0.0, elapsed_frames=f)
        direct, spec = pipe.render()
        img = denoiser.dispatch(direct, spec)
    torch.cuda.synchronize()
    assert launches("B1 realtime") == rt0 + 2 and launches("B2") == bl0 + 4
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.0
    want = denoise_composite(direct, spec, denoiser.params, impl="torch")
    assert float((img - want).abs().max()) <= 2e-5


# ---- BVH scenes: kernels B4a (fat-node walk) and B5 (fused traversal) ------

BVH_SCENE = "instanced:2"  # 3,842 triangles, through a BVH with accel="bvh"


def _bvh_setup(device, env="gradient", s_count=S):
    sc, cam = build_scene(BVH_SCENE)
    if env == "const":
        sc.environment = envmap.constant_env((0.05, 0.1, 0.2), strength=1.5)
    cam.set_aspect(SIZE, SIZE)
    rng = np.random.default_rng(9)
    cams = stack_cameras([
        camera_params(cam, jitter=((rng.random() - 0.5) / SIZE, (rng.random() - 0.5) / SIZE),
                      frame_count=2**31 + 11 + k)
        for k in range(s_count)
    ])
    return sc.build(device, accel="bvh"), cams


def hit_gate(got, want):
    """benchmarks/kernel_parity.py's closest-hit gate; returns its numbers."""
    same = (got["hit"] == want["hit"]) & (~got["hit"] | (got["tri"] == want["tri"]))
    both = same & got["hit"]
    rel = ((got["t"] - want["t"]).abs() / want["t"].abs().clamp(min=1.0))[both].double()
    out = {
        "median": float(rel.median()) if both.any() else 0.0,
        "p999": float(torch.quantile(rel, 0.999)) if both.any() else 0.0,
        "max": float(rel.max()) if both.any() else 0.0,
        "tie_frac": float((~same).float().mean()),
    }
    assert out["median"] <= 1e-6 and out["p999"] <= 1e-4, out
    assert out["max"] <= 0.05 and out["tie_frac"] <= 0.01, out
    return out


def _primary_and_shadow_rays(scene, cams):
    o, d = primary_ray_grid({k: v[0] for k, v in cams.items()}, SIZE, SIZE, 30.0)
    o = o.reshape(-1, 3).to(scene["v0"].device)
    d = d.reshape(-1, 3).to(scene["v0"].device)
    hits = intersect.intersect_closest(scene, o, d, 0.0, 1e38, cull_backface=True)
    pos = o + hits["t"].clamp(min=0.0)[:, None] * d
    to_light = torch.tensor([3.0, 6.0, 2.0], device=o.device) - pos
    sd = torch.where(hits["hit"][:, None], torch.nn.functional.normalize(to_light, dim=1), 0.0)
    return o, d, pos, sd, to_light.norm(dim=1) - 1e-4


@pytest.mark.cuda
def test_traverse_fat_matches_plain(cuda_device):
    scene, cams = _bvh_setup(cuda_device)
    o, d, pos, sd, dist = _primary_and_shadow_rays(scene, cams)
    c0, a0 = launches("B4a closest", "B4a any")
    got = traverse.traverse_fat_closest(scene, o, d, 0.0, 1e38, cull_backface=True)
    occ = traverse.traverse_fat_any(scene, pos, sd, 1e-4, dist)
    assert launches("B4a closest", "B4a any") == (c0 + 1, a0 + 1)
    want = traverse.traverse_fat_closest_reference(scene, o, d, 0.0, 1e38, cull_backface=True)
    occ_want = traverse.traverse_fat_any_reference(scene, pos, sd, 1e-4, dist)
    torch.cuda.synchronize()
    assert float(got["hit"].float().mean()) > 0.2
    hit_gate(got, want)
    assert 0.0 < float(occ.float().mean()) < 1.0
    assert float((occ != occ_want).float().mean()) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("name,opts,env", OPTION_CASES, ids=[c[0] for c in OPTION_CASES])
def test_fused_traverse_matches_plain(cuda_device, name, opts, env):
    scene, cams = _bvh_setup(cuda_device, env)
    options = default_options(**opts)
    ek = scene["env"]["kind"]
    before = launches("B5")
    got = ft.fused_traverse_progressive_sum(scene, options, cams, SIZE, SIZE, ek)
    assert launches("B5") == before + 1
    want = ft.fused_traverse_progressive_sum_reference(scene, options, cams, SIZE, SIZE, ek)
    torch.cuda.synchronize()
    _gate(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,opts,env", REALTIME_CASES[:3],
                         ids=[c[0] for c in REALTIME_CASES[:3]])
def test_fused_traverse_realtime_matches_plain(cuda_device, name, opts, env):
    scene, cams = _bvh_setup(cuda_device, env, s_count=2)
    options = default_options(**opts)
    ek = scene["env"]["kind"]
    before = launches("B5 realtime")
    got = ft.realtime_aovs(scene, options, cams, SIZE, SIZE, ek)
    assert launches("B5 realtime") == before + 1
    want = ft.fused_traverse_realtime_outputs_reference(scene, options, cams, SIZE, SIZE, ek)
    torch.cuda.synchronize()
    for k in fs.AOV_KEYS:
        for f in range(2):
            _gate(got[k][f], want[k][f], s_count=1)


B5_MODES = ("base", "cubemap", "area", "textured")


def _instanced4_mode(device, mode):
    """'instanced:4' (15,362 triangles) in one of B5's modes: the base mode
    (gradient env, 1 directional + 1 point light), a seeded cubemap env, 1
    directional + 1 area light, or the floor under a checker albedo texture
    with planar UVs."""
    from dxrexperiments_torch.scene.lights import area_light
    from dxrexperiments_torch.scene.materials import Material
    from dxrexperiments_torch.scene.textures import checker_texture, planar_uvs

    sc, cam = build_scene("instanced:4")
    if mode == "cubemap":
        rs = np.random.default_rng(6)
        sc.environment = envmap.cubemap_env(rs.uniform(0.1, 1.5, (6, 16, 16, 3)).astype(np.float32))
    elif mode == "area":
        sc.lights = {"dir": sc.lights["dir"], "point": [],
                     "area": [area_light((-2.0, 8.0, -2.0), (4.0, 0, 0), (0, 0, 4.0),
                                         (1.0, 0.95, 0.85, 10.0))]}
    elif mode == "textured":
        floor = sc.instances[-1]
        planar_uvs(floor.mesh, scale=4.0)
        floor.material_override = sc.add_material(Material(
            albedo=(0.85, 0.85, 0.85, 1.0), albedo_texture=checker_texture(8, size=64)))
    cam.set_aspect(SIZE, SIZE)
    cams = stack_cameras([camera_params(cam, frame_count=31 + k) for k in range(S)])
    return sc.build(device), cams


@pytest.mark.cuda
@pytest.mark.parametrize("mode", B5_MODES)
def test_fused_traverse_dense_records_every_mode(cuda_device, mode):
    """B5 reads its leaves from the dense arrays ft_test and ft_attr
    (ops/traverse.leaf_records, equal to mt_rows' lanes): on 'instanced:4'
    in each mode, progressive (with and without the debug==2 pick) and,
    except with albedo textures (outside the gate, as in JAX), realtime
    against the plain version on the image gate."""
    scene, cams = _instanced4_mode(cuda_device, mode)
    bvh = scene["bvh"]
    assert torch.equal(bvh["ft_test"][:, :19], bvh["mt_rows"][:, list(traverse.COEF_LANES)])
    assert torch.equal(bvh["ft_attr"], bvh["mt_rows"][:, 64:80])
    ek = scene["env"]["kind"]
    for opts in ({}, {"debug": 2}):
        options = default_options(**opts)
        got = ft.fused_traverse_progressive_sum(scene, options, cams, SIZE, SIZE, ek)
        want = ft.fused_traverse_progressive_sum_reference(scene, options, cams, SIZE, SIZE, ek)
        torch.cuda.synchronize()
        _gate(got, want)
    if mode != "textured":
        options = default_options()
        got = ft.realtime_aovs(scene, options, cams, SIZE, SIZE, ek)
        want = ft.fused_traverse_realtime_outputs_reference(scene, options, cams, SIZE, SIZE, ek)
        torch.cuda.synchronize()
        for k in fs.AOV_KEYS:
            for f in range(S):
                _gate(got[k][f], want[k][f], s_count=1)
    check_errors()


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["dir", "point"])
def test_fused_traverse_one_light_rig(cuda_device, group):
    scene, cams = _bvh_setup(cuda_device)
    scene = dict(scene, lights={group: scene["lights"][group]})
    options = default_options(debug=2)  # one light: the pick changes nothing
    got = ft.fused_traverse_progressive_sum(scene, options, cams, SIZE, SIZE, 1)
    want = ft.fused_traverse_progressive_sum_reference(scene, options, cams, SIZE, SIZE, 1)
    torch.cuda.synchronize()
    _gate(got, want)


def _warps(mask: torch.Tensor) -> torch.Tensor:
    """[H, W] per-pixel flags as B5's warps [H/2 * W/16, 32]: 16 x 2 pixels
    of a 16 x 16 tile each (H even, W a multiple of 16)."""
    h, w = mask.shape
    return mask.reshape(h // 2, 2, w // 16, 16).permute(0, 2, 1, 3).reshape(-1, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("realtime", [False, True], ids=["progressive", "realtime"])
def test_fused_traverse_divergent_warps_match_plain(cuda_device, realtime):
    """B5's walks vote per warp over the lanes that make them: on a frame of
    'instanced:4' whose warps diverge (some hold sky and geometry, some
    glossy and matte hits, so the shadow rays and the specular bounce walk
    in part of a warp), both pipelines equal the plain version on the image
    gate, with and without the debug==2 pick."""
    scene, cams = _instanced4_mode(cuda_device, "base")
    ek = scene["env"]["kind"]
    for opts in ({}, {"debug": 2}):
        options = default_options(**opts)
        ref = ft.fused_traverse_realtime_outputs_reference(scene, options, cams, SIZE, SIZE, ek)
        albedo = ref["albedo"][0]
        hit = albedo.abs().sum(-1) > 0
        glossy = hit & (albedo[..., 1] < 0.5)  # the red glossy spheres; the rest white
        wh, wg = _warps(hit), _warps(glossy)
        assert bool((wh.any(1) & ~wh.all(1)).any())
        assert bool((wg.any(1) & (wh & ~wg).any(1)).any())
        if realtime:
            got = ft.realtime_aovs(scene, options, cams, SIZE, SIZE, ek)
            torch.cuda.synchronize()
            for k in fs.AOV_KEYS:
                for f in range(S):
                    _gate(got[k][f], ref[k][f], s_count=1)
        else:
            got = ft.fused_traverse_progressive_sum(scene, options, cams, SIZE, SIZE, ek)
            want = ft.fused_traverse_progressive_sum_reference(scene, options, cams, SIZE, SIZE,
                                                               ek)
            torch.cuda.synchronize()
            _gate(got, want)
    check_errors()


@pytest.mark.cuda
def test_bvh_routes_launch_counts(cuda_device):
    sc, cam = build_scene(BVH_SCENE)
    cam.set_aspect(SIZE, SIZE)
    pipe = ProgressiveRaytracingPipeline(SIZE, SIZE, seed=1, samples_per_frame=2,
                                         device=cuda_device)
    pipe.set_camera(cam)
    pipe.set_scene(sc)  # 3,842 triangles: 'auto' keeps them brute force
    assert "bvh" not in pipe.scene_data
    pipe.scene_data = sc.build(cuda_device, accel="bvh")
    b1, b5 = launches("B1", "B5")
    for f in range(2):
        pipe.update(elapsed_time=0.0, elapsed_frames=f)
        pipe.render()
    torch.cuda.synchronize()
    assert launches("B1", "B5") == (b1, b5 + 2)
    assert bool(pipe.get_output().isfinite().all()) and float(pipe.get_output().mean()) > 0.0
    c0, a0 = launches("B4a closest", "B4a any")
    cam0 = {k: v[0] for k, v in pipe._camera_params.items()}
    out = render_sample(pipe.scene_data, pipe.options, cam0, SIZE, SIZE, impl="cuda")
    assert (launches("B4a closest") - c0, launches("B4a any") - a0) == (2, 2)
    assert bool(out["color"].isfinite().all())


def chain_scene(levels: int = 120, right_deep: bool = False):
    """A one-triangle scene under a degenerate BVH whose near-first walk
    needs a stack as deep as `levels`: every chain node's near child is the
    next chain node and its far child a two-leaf subtree, all boxes the
    same, so each visit pushes two nodes and pops one. right_deep: the
    chain goes on in each node's right child, which the binary walk (it
    walks the right child first) follows as deep."""
    sc = Scene()
    pos, idx = quad([-1, -1, 5], [1, -1, 5], [1, 1, 5], [-1, 1, 5])
    sc.add_model(Mesh(pos, None, idx[:1]))
    base = sc.build_numpy(accel="none")
    child = [[0, 0]]
    cur = 0
    for _ in range(levels):
        nxt, far, l0, l1 = range(len(child), len(child) + 4)
        child += [[0, 0], [l0, l1], [-1, 1], [-1, 1]]
        child[cur] = [far, nxt] if right_deep else [nxt, far]
        cur = nxt
    child[cur] = [-1, 1]
    m = len(child)
    nodes = {"nodes_lo": np.full((m, 3), -10.0, np.float32),
             "nodes_hi": np.full((m, 3), 10.0, np.float32),
             "child": np.asarray(child, np.int32), "order": np.zeros(1, np.int32)}
    packed = traverse.pack_for_traversal(nodes, base, 32)
    return base, packed


def wide_ladder(levels: int = 20):
    """chain_scene's triangle under a hand-built 8-wide tree (bvh8_rows)
    whose walk overflows its stack while it holds a leaf: wide node k's
    child 0 is a leaf (slot block k, which holds the triangle), children 1-6
    a wide node with only empty children and child 7 wide node k + 1, every
    box the same. A visit holds its leaf, pushes seven nodes and pops one,
    so the walk of a ray through the box overflows at child 7 of node 15,
    after the leaf of child 0."""
    base, packed = chain_scene(levels)
    empty = levels + 1
    rows = np.zeros(((levels + 2) * 8, 8), np.float32)
    rows[:, 0:3], rows[:, 3:6] = -10.0, 10.0
    rows[8 * levels + 1 :, 0:6] = traverse.BIG  # the last node's children 1-7 and the empty node
    for k in range(levels + 1):
        rows[8 * k, 6:8] = (-32 * k - 1, 1)
        if k < levels:
            rows[8 * k + 1 : 8 * k + 7, 6:8] = (empty, -1)
            rows[8 * k + 7, 6:8] = (k + 1, -1)
    return base, dict(packed, bvh8_rows=rows, bvh8_nodes=rows)


def chain_fat_bvh(packed: dict, device) -> dict:
    """The arrays B4a reads of a chain_scene BVH, on ``device``: bvhf_rows,
    the records ft_test of mt_rows, mt_rows and slot_tri."""
    bvh = {k: torch.as_tensor(packed[k]).to(device) for k in ("bvhf_rows", "mt_rows", "slot_tri")}
    bvh["ft_test"] = traverse.coef_records(bvh["mt_rows"])
    return bvh


@pytest.mark.cuda
def test_traverse_fat_reads_records(cuda_device):
    """B4a reads the BVH's ft_test: on a scene whose mt_rows are zeroed
    after its records were built it still equals the plain version (which
    reads the triangles), and a BVH without ft_test, or with one record
    fewer than mt_rows' rows, raises ValueError before any launch."""
    scene, cams = _bvh_setup(cuda_device)
    o, d, pos, sd, dist = _primary_and_shadow_rays(scene, cams)
    bvh = scene["bvh"]
    blind = dict(scene, bvh=dict(bvh, mt_rows=torch.zeros_like(bvh["mt_rows"])))
    got = traverse.traverse_fat_closest(blind, o, d, 0.0, 1e38, cull_backface=True)
    occ = traverse.traverse_fat_any(blind, pos, sd, 1e-4, dist)
    want = traverse.traverse_fat_closest_reference(scene, o, d, 0.0, 1e38, cull_backface=True)
    occ_want = traverse.traverse_fat_any_reference(scene, pos, sd, 1e-4, dist)
    torch.cuda.synchronize()
    check_errors()
    assert float(got["hit"].float().mean()) > 0.2
    hit_gate(got, want)
    assert 0.0 < float(occ.float().mean()) < 1.0
    assert float((occ != occ_want).float().mean()) <= 0.01
    before = launches("B4a closest", "B4a any")
    for bad, match in (({k: v for k, v in bvh.items() if k != "ft_test"}, "ft_test missing"),
                       (dict(bvh, ft_test=bvh["ft_test"][:-1].contiguous()), "one record per")):
        with pytest.raises(ValueError, match=match):
            traverse.check_bvh(bad, o.device, "fat")
        with pytest.raises(ValueError, match=match):
            traverse.traverse_fat_closest(dict(scene, bvh=bad), o, d, 0.0, 1e38)
        with pytest.raises(ValueError, match=match):
            traverse.traverse_fat_any(dict(scene, bvh=bad), pos, sd, 1e-4, dist)
    assert launches("B4a closest", "B4a any") == before


@pytest.mark.cuda
def test_traverse_stack_overflow_raises(cuda_device):
    base, packed = chain_scene()
    scene = {k: torch.as_tensor(base[k]).to(cuda_device) for k in ("v0", "e1", "e2")}
    scene["bvh"] = chain_fat_bvh(packed, cuda_device)
    o = torch.zeros((4, 3), device=cuda_device)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4, device=cuda_device)
    for trace in (traverse.traverse_fat_closest, traverse.traverse_fat_any):
        # the flag is read once the kernel has finished: by the wrapper's own
        # poll if it already has, else by check_errors, which waits
        with pytest.raises(RuntimeError, match="stack overflowed"):
            trace(scene, o, d, 0.0, 1e38)
            check_errors()
    shallow_base, shallow = chain_scene(levels=40)
    scene["bvh"] = chain_fat_bvh(shallow, cuda_device)
    hits = traverse.traverse_fat_closest(scene, o, d, 0.0, 1e38)
    check_errors()
    assert bool(hits["hit"].all()) and torch.allclose(hits["t"], torch.full_like(hits["t"], 5.0))


def chain_b5_scene(levels: int, device) -> tuple[dict, dict]:
    """chain_scene's triangle and tree as a whole scene for B5 (the default
    rig, gradient env; the BVH's fat nodes from chain_fat_bvh, ft_attr from
    its mt_rows) and one SIZE x SIZE camera at z = 9 looking down -z at the
    triangle's front face, off its axis so that no pixel centre lies on
    the triangle's diagonal edge. Every ray's walk meets the chain."""
    from dxrexperiments_torch.core.camera import Camera
    from dxrexperiments_torch.scene.lights import default_lights

    sc = Scene()
    pos, idx = quad([-1, -1, 5], [1, -1, 5], [1, 1, 5], [-1, 1, 5])
    sc.add_model(Mesh(pos, None, idx[:1]))
    sc.lights = default_lights()
    sc.environment = envmap.gradient_env()
    scene = sc.build(device, accel="bvh")
    bvh = chain_fat_bvh(chain_scene(levels)[1], device)
    scene["bvh"] = dict(scene["bvh"], **bvh, bvhf_nodes=bvh["bvhf_rows"].T,
                        ft_attr=bvh["mt_rows"][:, 64:80].contiguous())
    cam = Camera()
    cam.set_eye_at_up((0.0137, -0.0291, 9.0), (0.0137, -0.0291, 5.0), (0.0, 1.0, 0.0))
    cam.set_aspect(SIZE, SIZE)
    return scene, stack_cameras([camera_params(cam, frame_count=7)])


@pytest.mark.cuda
def test_fused_traverse_stack_overflow_raises(cuda_device):
    """B5's postponed walks on chain_scene's tree: 120 levels overflow the
    96-entry stack in both pipelines, which raises after the launch (a fat
    visit that holds a leaf pops one node and pushes at most one, so the
    overflow comes at a visit that holds none, in a warp whose every lane
    meets it); 40 levels overflow nothing, and the images equal the plain
    version's on the image gate."""
    scene, cams = chain_b5_scene(120, cuda_device)
    options = default_options()
    for run in (ft.realtime_aovs, ft.fused_traverse_progressive_sum):
        with pytest.raises(RuntimeError, match="stack overflowed"):
            run(scene, options, cams, SIZE, SIZE, 1)
            check_errors()
    scene, cams = chain_b5_scene(40, cuda_device)
    got = ft.realtime_aovs(scene, options, cams, SIZE, SIZE, 1)
    img = ft.fused_traverse_progressive_sum(scene, options, cams, SIZE, SIZE, 1)
    check_errors()
    want = ft.fused_traverse_realtime_outputs_reference(scene, options, cams, SIZE, SIZE, 1)
    assert 0.05 < float((want["albedo"][0].abs().sum(-1) > 0).float().mean()) < 0.95
    for k in fs.AOV_KEYS:
        _gate(got[k][0], want[k][0], s_count=1)
    _gate(img, ft.fused_traverse_progressive_sum_reference(scene, options, cams, SIZE, SIZE,
                                                           1), s_count=1)


# ---- two-level scenes: kernel B6a (fat two-level walk) -----------------------


def tf(translate=(0.0, 0.0, 0.0), yaw=0.0, scale=1.0):
    """4x4 float32: a turn of `yaw` about y, a uniform scale, a translation."""
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    m[:3, :3] *= scale
    m[:3, 3] = translate
    return m


FIVE_TRANSFORMS = [tf((0, 0, 0)), tf((2.5, 0.2, 0), yaw=0.7), tf((-2.5, 0, 0.5), yaw=-0.4, scale=1.4),
                   tf((0, 0, 2.5), scale=0.8), tf((0, 1.5, -2.5), yaw=2.0)]


def five_instance_scene(scene_cls, material_cls, box_mesh, sphere_mesh, transforms=None):
    """tests/test_tlas.py's scene: 2 unique meshes (a box, a sphere), 5
    instances turned, moved and scaled, each with a material override.
    Takes either package's classes."""
    sc = scene_cls()
    white = sc.add_material(material_cls(albedo=(0.73, 0.73, 0.73, 1.0)))
    red = sc.add_material(material_cls(albedo=(0.9, 0.1, 0.1, 1.0)))
    box = box_mesh((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    sph = sphere_mesh((0.0, 0.0, 0.0), 0.6, lat=6, lon=8)
    tfs = FIVE_TRANSFORMS if transforms is None else transforms
    for mesh, t, mat in zip((box, box, sph, sph, box), tfs, (white, red, white, red, white)):
        sc.add_model(mesh, transform=t, material=mat)
    return sc


def port_five():
    from dxrexperiments_torch.scene import Material
    from dxrexperiments_torch.scene.procedural import box_mesh, sphere_mesh

    return five_instance_scene(Scene, Material, box_mesh, sphere_mesh)


def probe_rays(n, seed, radius=8.0, spread=1.8):
    """n rays from a sphere of `radius`, aimed at points scattered by
    `spread` around the origin (tests/test_tlas.py's probe)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * radius
    d = rng.normal(scale=spread, size=(n, 3)).astype(np.float32) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def chain_two_level(levels: int = 120, device="cpu", right_deep: bool = False):
    """A one-instance two-level scene whose BLAS is chain_scene's degenerate
    tree (fat and binary): its walk needs a BLAS stack as deep as
    `levels`."""
    _, packed = chain_scene(levels, right_deep)
    sc = Scene()
    pos, idx = quad([-1, -1, 5], [1, -1, 5], [1, 1, 5], [-1, 1, 5])
    sc.add_model(Mesh(pos, None, idx[:1]))
    scene = sc.build_two_level(device)
    tl = dict(scene["tlas"], **{k: torch.as_tensor(packed[src]).to(device) for k, src in (
        ("blasf_rows", "bvhf_rows"), ("blas_rows", "bvh_rows"), ("mt_rows", "mt_rows"),
        ("slot_tri", "slot_tri"))})
    tl["blas_test"] = traverse.coef_records(tl["mt_rows"])  # B6a's records of the new rows
    return dict(scene, tlas=tl)


def _two_level_setup(device, kind):
    if kind == "five":
        scene = port_five().build_two_level(device)
        o, d = probe_rays(SIZE * SIZE, 0)
    else:
        scene = build_scene(kind)[0].build_two_level(device)
        o, d = probe_rays(SIZE * SIZE, 1, radius=12.0, spread=3.0)
    return scene, torch.as_tensor(o, device=device), torch.as_tensor(d, device=device)


def _shadow_rays(o, d, hits, light):
    pos = o + hits["t"].clamp(min=0.0)[:, None] * d
    path = torch.tensor(light, device=o.device) - pos
    sd = torch.where(hits["hit"][:, None], torch.nn.functional.normalize(path, dim=1), 0.0)
    return pos, sd, (path.norm(dim=1) - 1e-4).clamp(min=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["five", "instanced:4"])
def test_traverse2_fat_matches_plain(cuda_device, kind):
    scene, o, d = _two_level_setup(cuda_device, kind)
    c0, a0 = launches("B6a closest", "B6a any")
    got = traverse2.traverse2_fat_closest(scene, o, d, 1e-4, 3.0e37)
    want = traverse2.two_level_closest_reference(scene, o, d, 1e-4, 3.0e37)
    pos, sd, dist = _shadow_rays(o, d, want, (2.0, 6.0, 1.5))
    occ = traverse2.traverse2_fat_any(scene, pos, sd, 1e-4, dist)
    occ_want = traverse2.two_level_any_reference(scene, pos, sd, 1e-4, dist)
    torch.cuda.synchronize()
    check_errors()
    assert launches("B6a closest", "B6a any") == (c0 + 1, a0 + 1)
    assert float(got["hit"].float().mean()) > 0.1
    hit_gate(got, want)
    same = got["hit"] & want["hit"] & (got["tri"] == want["tri"])
    assert torch.equal(got["inst"][same], want["inst"][same])
    assert 0.0 < float(occ_want.float().mean()) < 1.0
    assert float((occ != occ_want).float().mean()) <= 0.01


@pytest.mark.cuda
def test_traverse2_single_instance(cuda_device):
    from dxrexperiments_torch.scene.procedural import sphere_mesh

    sc = Scene()
    sc.add_model(sphere_mesh((0.0, 0.0, 0.0), 1.0), transform=tf((0.3, 0, 0), yaw=0.4, scale=1.2))
    scene = sc.build_two_level(cuda_device)
    assert scene["tlas"]["tlasf_rows"][0, 12:].tolist() == [0.0, 1.0, 0.0, 0.0]
    o, d = (torch.as_tensor(x, device=cuda_device) for x in probe_rays(SIZE * SIZE, 2, spread=0.8))
    got = traverse2.traverse2_fat_closest(scene, o, d)
    want = traverse2.two_level_closest_reference(scene, o, d)
    occ = traverse2.traverse2_fat_any(scene, o, d, 1e-4, 7.5)
    occ_want = traverse2.two_level_any_reference(scene, o, d, 1e-4, 7.5)
    torch.cuda.synchronize()
    check_errors()
    hit_gate(got, want)
    assert bool((got["inst"][got["hit"]] == 0).all())
    assert float((occ != occ_want).float().mean()) <= 0.01


@pytest.mark.cuda
def test_traverse2_stack_overflow_raises(cuda_device):
    o = torch.zeros((4, 3), device=cuda_device)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4, device=cuda_device)
    scene = chain_two_level(120, cuda_device)
    for trace in (traverse2.traverse2_fat_closest, traverse2.traverse2_fat_any):
        with pytest.raises(RuntimeError, match="stack overflowed"):
            trace(scene, o, d, 0.0, 1e38)
            check_errors()
    hits = traverse2.traverse2_fat_closest(chain_two_level(40, cuda_device), o, d, 0.0, 1e38)
    check_errors()
    assert bool(hits["hit"].all()) and torch.allclose(hits["t"], torch.full_like(hits["t"], 5.0))


@pytest.mark.cuda
def test_traverse2_zero_direction_shadow_rays(cuda_device):
    scene, o, d = _two_level_setup(cuda_device, "five")
    d = d.clone()
    d[::3] = 0.0
    occ = traverse2.traverse2_fat_any(scene, o, d, 1e-4, 3.0e37)
    want = traverse2.two_level_any_reference(scene, o, d, 1e-4, 3.0e37)
    torch.cuda.synchronize()
    assert not bool(occ[::3].any()) and not bool(want[::3].any())
    assert float((occ != want).float().mean()) <= 0.01


@pytest.mark.cuda
def test_traverse2_queue_edges_and_index_error(cuda_device):
    """B6a's single loop and live-ray queue: fewer rays than a warp, a
    batch of zero-direction shadow rays (an empty queue), and an index
    outside the arrays (an instance's BLAS root past the BLAS nodes) in
    both modes."""
    scene, o, d = _two_level_setup(cuda_device, "five")
    for n in (5, 31):
        got = traverse2.traverse2_fat_closest(scene, o[:n], d[:n], 1e-4, 3.0e37)
        want = traverse2.two_level_closest_reference(scene, o[:n], d[:n], 1e-4, 3.0e37)
        occ = traverse2.traverse2_fat_any(scene, o[:n], d[:n], 1e-4, 7.5)
        occ_want = traverse2.two_level_any_reference(scene, o[:n], d[:n], 1e-4, 7.5)
        torch.cuda.synchronize()
        check_errors()
        assert torch.equal(got["hit"], want["hit"]) and torch.equal(got["tri"], want["tri"])
        assert torch.equal(got["inst"], want["inst"]) and torch.equal(occ, occ_want)
    occ = traverse2.traverse2_fat_any(scene, o, torch.zeros_like(d), 1e-4, 3.0e37)
    check_errors()
    assert not bool(occ.any())
    rows = scene["tlas"]["inst_rows_t"].clone()
    rows[:, 15] = 1.0e6
    bad = dict(scene, tlas=dict(scene["tlas"], inst_rows_t=rows))
    for trace in (traverse2.traverse2_fat_closest, traverse2.traverse2_fat_any):
        with pytest.raises(RuntimeError, match="outside the packed arrays"):
            trace(bad, o, d, 1e-4, 3.0e37)
            check_errors()


@pytest.mark.cuda
def test_two_level_pipeline_launch_counts(cuda_device):
    sc, cam = build_scene("instanced:2")
    cam.set_aspect(SIZE, SIZE)
    pipe = ProgressiveRaytracingPipeline(SIZE, SIZE, seed=1, samples_per_frame=2,
                                         device=cuda_device)
    pipe.set_camera(cam)
    pipe.set_scene_data(sc.build_two_level(cuda_device))
    counts0 = launches("B1", "B5", "B4a closest", "B4a any", "B6a closest", "B6a any")
    base_tf = np.stack([inst.transform for inst in sc.instances])
    for f in range(2):
        pipe.set_instance_transforms(np.einsum("ij,njk->nik", tf(yaw=0.05 * f), base_tf))
        pipe.update(elapsed_time=0.0, elapsed_frames=f)
        pipe.render()
    torch.cuda.synchronize()
    counts = launches("B1", "B5", "B4a closest", "B4a any", "B6a closest", "B6a any")
    assert tuple(b - a for a, b in zip(counts0, counts)) == (0, 0, 0, 0, 8, 8)
    img = pipe.get_output()
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.0


# ---- packs without fat nodes: kernels B4b, B4d (binary, 8-wide) and B6b -------

FAT_BVH = ("bvhf_nodes", "bvhf_rows")
FAT_TLAS = ("tlasf_nodes", "tlasf_rows")


def _drop(tree: dict, keys) -> dict:
    return {k: v for k, v in tree.items() if k not in keys}


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["binary", "wide"])
def test_traverse_binary_and_wide_match_plain(cuda_device, walk):
    scene, cams = _bvh_setup(cuda_device)
    o, d, pos, sd, dist = _primary_and_shadow_rays(scene, cams)
    closest, any_, counters = (
        (traverse.traverse_closest, traverse.traverse_any, ("B4b closest", "B4b any"))
        if walk == "binary" else
        (traverse.traverse8_closest, traverse.traverse8_any, ("B4d closest", "B4d any")))
    before = launches(*counters)
    got = closest(scene, o, d, 0.0, 1e38, cull_backface=True)
    sd = sd.clone()
    sd[::3] = 0.0  # zero directions: never occluded
    occ = any_(scene, pos, sd, 1e-4, dist)
    want = traverse.traverse_fat_closest_reference(scene, o, d, 0.0, 1e38, cull_backface=True)
    occ_want = traverse.traverse_fat_any_reference(scene, pos, sd, 1e-4, dist)
    torch.cuda.synchronize()
    check_errors()
    assert launches(*counters) == tuple(b + 1 for b in before)
    assert float(got["hit"].float().mean()) > 0.2
    hit_gate(got, want)
    assert not bool(occ[::3].any())
    assert 0.0 < float(occ_want.float().mean()) < 1.0
    assert float((occ != occ_want).float().mean()) <= 0.01


def chain_bvh_scene(levels: int, right_deep: bool, device):
    """chain_scene's triangle and binary BVH as a scene for B4b and its
    plain version: the triangle arrays, the BVH arrays B4b reads (bvh_rows,
    the records ft_test of mt_rows) and slot_tri."""
    base, packed = chain_scene(levels, right_deep)
    scene = {k: torch.as_tensor(v).to(device) for k, v in base.items()
             if isinstance(v, np.ndarray)}
    scene["num_tris"] = base["num_tris"]
    scene["bvh"] = {k: torch.as_tensor(packed[k]).to(device)
                    for k in ("bvh_rows", "mt_rows", "slot_tri")}
    scene["bvh"]["ft_test"] = traverse.coef_records(scene["bvh"]["mt_rows"])
    return scene


@pytest.mark.cuda
def test_binary_walks_stack_overflow_raises(cuda_device):
    o = torch.zeros((4, 3), device=cuda_device)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4, device=cuda_device)
    scene = chain_bvh_scene(120, True, cuda_device)
    deep2 = chain_two_level(120, cuda_device, right_deep=True)
    for trace, sc in ((traverse.traverse_closest, scene), (traverse.traverse_any, scene),
                      (traverse2.traverse2_closest, deep2), (traverse2.traverse2_any, deep2)):
        with pytest.raises(RuntimeError, match="stack overflowed"):
            trace(sc, o, d, 0.0, 1e38)
            check_errors()
    scene = chain_bvh_scene(40, True, cuda_device)
    for hits in (traverse.traverse_closest(scene, o, d, 0.0, 1e38),
                 traverse2.traverse2_closest(chain_two_level(40, cuda_device, True), o, d, 0.0,
                                             1e38)):
        check_errors()
        assert bool(hits["hit"].all()) and torch.allclose(hits["t"], torch.full_like(hits["t"],
                                                                                     5.0))


@pytest.mark.cuda
@pytest.mark.parametrize("levels,right_deep", [(40, True), (90, True), (120, False)])
def test_binary_walks_match_plain_on_chains(cuda_device, levels, right_deep):
    """B4b and B6b on chain_scene's degenerate trees (every box the same,
    so every child is pushed), against their plain versions: rays through
    the triangle, beside it, and shadow rays, a third of them dead."""
    rng = np.random.default_rng(levels)
    o = torch.as_tensor((rng.uniform(-1.2, 1.2, (256, 3)) * [1, 1, 0]).astype(np.float32),
                        device=cuda_device)
    d = torch.nn.functional.normalize(
        torch.as_tensor((rng.normal(size=(256, 3)) * 0.1 + [0, 0, 1]).astype(np.float32),
                        device=cuda_device), dim=1)
    tmax = torch.as_tensor(rng.uniform(3.0, 12.0, 256).astype(np.float32), device=cuda_device)
    d_any = d.clone()
    d_any[::3] = 0.0  # dead shadow rays
    flat = chain_bvh_scene(levels, right_deep, cuda_device)
    two = chain_two_level(levels, cuda_device, right_deep)
    for closest, any_, ref_c, ref_a, sc in (
            (traverse.traverse_closest, traverse.traverse_any,
             traverse.traverse_fat_closest_reference, traverse.traverse_fat_any_reference, flat),
            (traverse2.traverse2_closest, traverse2.traverse2_any,
             traverse2.two_level_closest_reference, traverse2.two_level_any_reference, two)):
        got = closest(sc, o, d, 1e-4, 3.0e37)
        want = ref_c(sc, o, d, 1e-4, 3.0e37)
        occ = any_(sc, o, d_any, 1e-4, tmax)
        occ_want = ref_a(sc, o, d_any, 1e-4, tmax)
        torch.cuda.synchronize()
        check_errors()
        assert 0.1 < float(want["hit"].float().mean()) < 0.9
        hit_gate(got, want)
        assert not bool(occ[::3].any())
        assert 0.1 < float(occ_want.float().mean()) < 0.9
        assert float((occ != occ_want).float().mean()) <= 0.01


@pytest.mark.cuda
def test_binary_walks_check_records(cuda_device):
    """B4b reads the BVH's ft_test, B6b the two-level blas_test: a missing
    array, a record array with one row fewer than mt_rows or of another
    width raises ValueError before any launch."""
    o = torch.zeros((4, 3), device=cuda_device)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4, device=cuda_device)
    flat = chain_bvh_scene(8, False, cuda_device)
    two = chain_two_level(8, cuda_device)
    before = launches("B4b closest", "B6b closest")
    for trace, sc, key, name in ((traverse.traverse_closest, flat, "bvh", "ft_test"),
                                 (traverse2.traverse2_closest, two, "tlas", "blas_test")):
        rec = sc[key][name]
        for bad, match in (({k: v for k, v in sc[key].items() if k != name}, "missing"),
                           (dict(sc[key], **{name: rec[:-1].contiguous()}), "one record per"),
                           (dict(sc[key], **{name: rec[:, :16].contiguous()}), "expected float32")):
            with pytest.raises(ValueError, match=match):
                trace(dict(sc, **{key: bad}), o, d, 0.0, 1e38)
    assert launches("B4b closest", "B6b closest") == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["five", "instanced:4", "single"])
def test_traverse2_binary_matches_plain(cuda_device, kind):
    if kind == "single":
        from dxrexperiments_torch.scene.procedural import sphere_mesh

        sc = Scene()
        sc.add_model(sphere_mesh((0.0, 0.0, 0.0), 1.0),
                     transform=tf((0.3, 0, 0), yaw=0.4, scale=1.2))
        scene = sc.build_two_level(cuda_device)
        o, d = (torch.as_tensor(x, device=cuda_device)
                for x in probe_rays(SIZE * SIZE, 2, spread=0.8))
    else:
        scene, o, d = _two_level_setup(cuda_device, kind)
    scene = dict(scene, tlas=_drop(scene["tlas"], FAT_TLAS))
    c0, a0 = launches("B6b closest", "B6b any")
    f0 = launches("B6a closest", "B6a any")
    got = traverse2.traverse2_closest(scene, o, d, 1e-4, 3.0e37)
    want = traverse2.two_level_closest_reference(scene, o, d, 1e-4, 3.0e37)
    pos, sd, dist = _shadow_rays(o, d, want, (2.0, 6.0, 1.5))
    sd[::3] = 0.0  # zero directions: never occluded
    occ = traverse2.traverse2_any(scene, pos, sd, 1e-4, dist)
    occ_want = traverse2.two_level_any_reference(scene, pos, sd, 1e-4, dist)
    torch.cuda.synchronize()
    check_errors()
    assert launches("B6b closest", "B6b any") == (c0 + 1, a0 + 1)
    assert launches("B6a closest", "B6a any") == f0
    assert float(got["hit"].float().mean()) > 0.1
    hit_gate(got, want)
    same = got["hit"] & want["hit"] & (got["tri"] == want["tri"])
    assert torch.equal(got["inst"][same], want["inst"][same])
    assert not bool(occ[::3].any())
    assert float((occ != occ_want).float().mean()) <= 0.01


@pytest.mark.cuda
def test_fatless_routes_launch_counts(cuda_device):
    """Both pipelines on a BVH without fat nodes launch B4b, on a TLAS
    without fat nodes B6b (refits included), and nothing else walks."""
    sc, cam = build_scene("instanced:2")
    cam.set_aspect(SIZE, SIZE)
    flat = sc.build(cuda_device, accel="bvh")
    two = sc.build_two_level(cuda_device)
    cases = ((dict(flat, bvh=_drop(flat["bvh"], FAT_BVH)), ("B4b closest", "B4b any")),
             (dict(two, tlas=_drop(two["tlas"], FAT_TLAS)), ("B6b closest", "B6b any")))
    others = lambda: launches("B1", "B5", "B4a closest", "B4a any", "B6a closest",  # noqa: E731
                              "B6a any")
    base_tf = np.stack([inst.transform for inst in sc.instances])
    for scene, counters in cases:
        pipe = ProgressiveRaytracingPipeline(SIZE, SIZE, seed=1, samples_per_frame=2,
                                             device=cuda_device)
        pipe.set_camera(cam)
        pipe.set_scene_data(scene)
        before, other0 = launches(*counters), others()
        for f in range(2):
            if "tlas" in scene:
                pipe.set_instance_transforms(np.einsum("ij,njk->nik", tf(yaw=0.05 * f), base_tf))
            pipe.update(elapsed_time=0.0, elapsed_frames=f)
            pipe.render()
        torch.cuda.synchronize()
        assert [c - b for c, b in zip(launches(*counters), before)] == [8, 8]
        assert others() == other0
        img = pipe.get_output()
        assert bool(img.isfinite().all()) and float(img.mean()) > 0.0
        rt = RealtimeRaytracingPipeline(SIZE, SIZE, seed=0, device=cuda_device)
        rt.set_camera(cam)
        rt.set_scene_data(scene)
        before = launches(*counters)
        rt.update(0.0, 0)
        direct, spec = rt.render()
        torch.cuda.synchronize()
        check_errors()
        assert [c - b for c, b in zip(launches(*counters), before)] == [2, 2]
        assert bool((direct + spec).isfinite().all())


# ---- brute-force scenes: kernel B3 (closest + any) ---------------------------


def _brute_scene(kind, device):
    """'cornell' (36 triangles, 40 padded) or a soup of `kind` triangles:
    256 and 512 end on a tile and a padding edge, 513 crosses both."""
    if kind == "cornell":
        return build_scene("cornell-glossy")[0].build(device)
    from dxrexperiments_torch.scene.procedural import random_triangle_soup

    sc = Scene()
    sc.add_model(random_triangle_soup(kind, seed=2, extent=2.0))
    return sc.build(device, accel="none")


def _brute_rays(kind, device, n=SIZE * SIZE, scene=None):
    """Probe rays, every fifth with a zero direction, every third with t_max
    4: inside the Cornell box in random directions, or from a sphere of
    radius 6 at the soup's triangles (three in four at a centroid)."""
    rng = np.random.default_rng(7)
    if kind == "cornell":
        o = rng.uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)
        o[:, 1] = rng.uniform(0.1, 1.9, size=n)
        d = rng.normal(size=(n, 3)).astype(np.float32)
    else:
        o = rng.normal(size=(n, 3))
        o = (6.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
        v0, e1, e2 = (scene[k][:kind].cpu().numpy() for k in ("v0", "e1", "e2"))
        target = (v0 + (e1 + e2) / 3.0)[rng.integers(0, kind, n)]
        target[::4] = rng.uniform(-2.0, 2.0, size=(len(target[::4]), 3))
        d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::5] = 0.0
    tmax = np.where(np.arange(n) % 3 == 0, 4.0, 1e38).astype(np.float32)
    return (torch.as_tensor(o, device=device), torch.as_tensor(d, device=device),
            torch.as_tensor(tmax, device=device))


def attr_gate(got, want):
    """B3's fused attributes against the plain version's on lanes that hit
    the same triangle: the normal within 1e-5 on 99.9% of lanes, the
    position (over max(1, t)) within the hit gate's bounds on t, material
    rows and ids equal. Returns the largest differences."""
    same = got["hit"] & want["hit"] & (got["tri"] == want["tri"])
    scale = want["t"][same].abs().clamp(min=1.0)[:, None]
    errs = {"normal": (got["normal"] - want["normal"])[same].abs().amax(dim=1).double(),
            "position": ((got["position"] - want["position"])[same].abs() / scale)
            .amax(dim=1).double()}
    assert float(torch.quantile(errs["normal"], 0.999)) <= 1e-5, errs["normal"].max()
    assert float(errs["position"].median()) <= 1e-6
    assert float(torch.quantile(errs["position"], 0.999)) <= 1e-4
    for e in errs.values():
        assert float(e.max()) <= 0.05
    for k in (*intersect_kernel.MATERIAL_KEYS, "mat_id"):
        assert torch.equal(got[k][same], want[k][same]), k
    return {k: float(e.max()) for k, e in errs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("kind", ["cornell", 256, 512, 513])
def test_intersect_brute_matches_plain(cuda_device, kind, cull):
    scene = _brute_scene(kind, cuda_device)
    o, d, tmax = _brute_rays(kind, cuda_device, scene=scene)
    c0, a0 = launches("B3 closest", "B3 any")
    got = intersect_kernel.trace_closest(scene, o, d, 1e-4, tmax, cull_backface=cull)
    occ = intersect_kernel.trace_any(scene, o, d, 1e-4, tmax)
    assert launches("B3 closest", "B3 any") == (c0 + 1, a0 + 1)
    want = intersect_kernel.trace_closest_reference(scene, o, d, 1e-4, tmax, cull_backface=cull)
    occ_want = intersect_kernel.trace_any_reference(scene, o, d, 1e-4, tmax)
    torch.cuda.synchronize()
    assert all(v.is_contiguous() for v in got.values())  # row-major fields, as the plain's
    assert float(got["hit"].float().mean()) > 0.1
    assert not bool(got["hit"][::5].any()) and not bool(occ[::5].any())
    hit_gate(got, want)
    attr_gate(got, want)
    miss = ~got["hit"]
    assert bool((got["t"][miss] == -1).all()) and bool((got["tri"][miss] == -1).all())
    assert 0.0 < float(occ_want.float().mean()) < 1.0
    assert float((occ != occ_want).float().mean()) <= 0.01


@pytest.mark.cuda
def test_intersect_brute_windows_and_empty_batches(cuda_device):
    scene = _brute_scene(513, cuda_device)
    o, d, _ = _brute_rays(513, cuda_device, n=700, scene=scene)
    scalar = intersect_kernel.trace_closest(scene, o, d, 1e-4, 4.0)
    per_ray = intersect_kernel.trace_closest(scene, o, d, torch.full((700,), 1e-4, device=o.device),
                                             torch.full((700,), 4.0, device=o.device))
    for k in scalar:
        assert torch.equal(scalar[k], per_ray[k]), k
    # an empty window (the integrator's inactive lanes) never hits
    dead = intersect_kernel.trace_closest(scene, o, d, 1e-4, 0.0)
    assert not bool(dead["hit"].any())
    c0, a0 = launches("B3 closest", "B3 any")
    empty = torch.zeros((0, 3), device=o.device)
    assert intersect_kernel.trace_closest(scene, empty, empty)["t"].shape == (0,)
    assert intersect_kernel.trace_any(scene, empty, empty).shape == (0,)
    assert launches("B3 closest", "B3 any") == (c0, a0)
    bad = dict(scene, mt_pack=scene["mt_pack"].double())
    with pytest.raises(TypeError):
        intersect_kernel.trace_any(bad, o, d)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 31, 33])
def test_intersect_brute_queue_edges(cuda_device, n):
    """B3 through its live-ray queue: fewer rays than a warp or one past a
    warp, a batch with no live ray (an empty queue: every output written by
    the queue kernel) and a batch whose every ray is occluded."""
    scene = _brute_scene(513, cuda_device)
    o, d, tmax = _brute_rays(513, cuda_device, n=n, scene=scene)
    got = intersect_kernel.trace_closest(scene, o, d, 1e-4, tmax)
    want = intersect_kernel.trace_closest_reference(scene, o, d, 1e-4, tmax)
    occ = intersect_kernel.trace_any(scene, o, d, 1e-4, tmax)
    torch.cuda.synchronize()
    assert torch.equal(got["hit"], want["hit"]) and torch.equal(got["tri"], want["tri"])
    assert torch.allclose(got["t"], want["t"], rtol=1e-4, atol=1e-5)
    assert torch.equal(occ, intersect_kernel.trace_any_reference(scene, o, d, 1e-4, tmax))
    dead = intersect_kernel.trace_closest(scene, o, d, 1e-4, 0.0)  # every window empty
    miss = intersect_kernel.miss_outputs(o, d)
    for k, v in miss.items():
        a, b = dead[k], v
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k
    assert not bool(intersect_kernel.trace_any(scene, o, torch.zeros_like(d), 1e-4, 1e38).any())
    v0, e1, e2 = (scene[k][:513] for k in ("v0", "e1", "e2"))
    pick = torch.arange(n, device=cuda_device) * 7 % 513
    nrm = torch.nn.functional.normalize(torch.linalg.cross(e1, e2, dim=1)[pick], dim=1)
    cen = (v0 + (e1 + e2) / 3.0)[pick]
    assert bool(intersect_kernel.trace_any(scene, cen + nrm, -nrm, 1e-4, 1e38).all())


BRUTE_CASES = [("instanced:1", "progressive", {}), ("instanced:1", "realtime", {}),
               ("cornell", "progressive", {"ao_only": True}),
               ("cornell-glass", "progressive", {"refraction": True}),
               ("cornell+area", "progressive", {})]


def area_rig():
    """2 directional + 2 point + 1 area light (the port's light dicts)."""
    from dxrexperiments_torch.scene.lights import area_light, directional_light, point_light

    return {"dir": [directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
                    directional_light((0.5, -0.7, 0.2), (0.3, 0.5, 0.9, 0.4))],
            "point": [point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
                      point_light((-0.6, 1.2, 0.5), (0.4, 0.9, 0.5, 3.0))],
            "area": [area_light((-0.3, 1.95, -0.3), (0.6, 0.0, 0.0), (0.0, 0.0, 0.6),
                                (1.0, 0.9, 0.8, 8.0))]}


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode,kw", BRUTE_CASES, ids=["progressive", "realtime", "ao_only",
                                                           "refraction", "area_rig"])
def test_brute_wavefront_matches_plain(cuda_device, name, mode, kw):
    sc, cam = build_scene(name.split("+")[0])
    if name.endswith("+area"):
        sc.lights = area_rig()
    cam.set_aspect(SIZE, SIZE)
    scene = sc.build(cuda_device)
    assert "bvh" not in scene
    cp = camera_params(cam, jitter=(0.2 / SIZE, -0.1 / SIZE), frame_count=2**31 + 9)
    js = 10.0 if mode == "realtime" else 30.0
    c0, a0 = launches("B3 closest", "B3 any")
    got = render_sample(scene, default_options(), cp, SIZE, SIZE, mode=mode, jitter_scale=js,
                        impl="cuda", **kw)
    counted = (launches("B3 closest") - c0, launches("B3 any") - a0)
    assert counted == ((1, 4) if kw.get("ao_only") else (2, 2))
    want = render_sample(scene, default_options(), cp, SIZE, SIZE, mode=mode, jitter_scale=js,
                         impl="torch", **kw)
    torch.cuda.synchronize()
    for k in got:
        _gate(got[k], want[k], s_count=1)
    assert float(got["color"].mean()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bvh", "two_level"])
@pytest.mark.parametrize("option", ["ao_only", "area_refraction"])
def test_other_routes_take_the_new_options(cuda_device, kind, option):
    """AO, area lights and refraction through B4a and B6a, against the
    plain versions."""
    sc, cam = build_scene("instanced:2")
    if option == "area_refraction":
        rig = area_rig()
        sc.lights = {"area": rig["area"] * 2}  # two area lights: B5's gate declines
    scene = sc.build(cuda_device, accel="bvh") if kind == "bvh" else sc.build_two_level(cuda_device)
    cam.set_aspect(SIZE, SIZE)
    cp = camera_params(cam, jitter=(0.2 / SIZE, -0.1 / SIZE), frame_count=5)
    kw = {"ao_only": True} if option == "ao_only" else {"refraction": True}
    got = render_sample(scene, default_options(), cp, SIZE, SIZE, impl="cuda", **kw)["color"]
    want = render_sample(scene, default_options(), cp, SIZE, SIZE, impl="torch", **kw)["color"]
    torch.cuda.synchronize()
    check_errors()
    _gate(got, want, s_count=1)
    assert float(got.mean()) > 0.0


@pytest.mark.cuda
def test_brute_pipelines_launch_counts(cuda_device):
    sc, cam = build_scene("instanced:1")
    cam.set_aspect(SIZE, SIZE)
    pipe = ProgressiveRaytracingPipeline(SIZE, SIZE, seed=1, samples_per_frame=2,
                                         device=cuda_device)
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    counts0 = launches("B1", "B5", "B4a closest", "B4a any", "B3 closest", "B3 any")
    for f in range(2):
        pipe.update(elapsed_time=0.0, elapsed_frames=f)
        pipe.render()
    rt = RealtimeRaytracingPipeline(SIZE, SIZE, seed=1, device=cuda_device)
    rt.set_camera(cam)
    rt.set_scene(sc)
    rt.update(elapsed_time=0.0, elapsed_frames=0)
    direct, spec = rt.render()
    display = DenoiseCompositor(device=cuda_device).dispatch(direct, spec)
    torch.cuda.synchronize()
    counts = launches("B1", "B5", "B4a closest", "B4a any", "B3 closest", "B3 any")
    assert tuple(b - a for a, b in zip(counts0, counts)) == (0, 0, 0, 0, 10, 10)
    img = pipe.get_output()
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.0
    assert bool((direct + spec).isfinite().all()) and float(direct.mean()) > 0.0
    assert bool(display.isfinite().all())


@pytest.mark.cuda
def test_cuda_tensors_never_reach_plain_versions(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((traverse, "traverse_fat_closest_reference"),
                      (traverse, "traverse_fat_any_reference"),
                      (ft, "fused_traverse_progressive_sum_reference"),
                      (ft, "fused_traverse_realtime_outputs_reference"),
                      (traverse2, "two_level_closest_reference"),
                      (traverse2, "two_level_any_reference"),
                      (tlas, "two_level_closest_reference"), (tlas, "two_level_any_reference"),
                      (intersect_kernel, "trace_closest_reference"),
                      (intersect_kernel, "trace_any_reference"),
                      (intersect, "intersect_closest"), (intersect, "intersect_any")):
        monkeypatch.setattr(mod, name, refuse)
    scene, cams = _bvh_setup(cuda_device)
    options = default_options()
    ek = scene["env"]["kind"]
    ft.fused_traverse_progressive_sum(scene, options, cams, SIZE, SIZE, ek)
    ft.realtime_aovs(scene, options, cams, SIZE, SIZE, ek)
    render_sample(scene, options, {k: v[0] for k, v in cams.items()}, SIZE, SIZE, impl="cuda")
    two = build_scene(BVH_SCENE)[0].build_two_level(cuda_device)
    for mode in ("progressive", "realtime"):
        render_sample(two, options, {k: v[0] for k, v in cams.items()}, SIZE, SIZE, mode=mode,
                      impl="cuda")
    brute = build_scene("instanced:1")[0].build(cuda_device)
    for kw in ({"mode": "progressive"}, {"mode": "realtime"}, {"ao_only": True},
               {"refraction": True}):
        render_sample(brute, options, {k: v[0] for k, v in cams.items()}, SIZE, SIZE,
                      impl="cuda", **kw)
    torch.cuda.synchronize()


# ---- texture envs: the lat-long and cubemap lookups inside B1 and B5 ---------

TEX_SCENES = {"cornell": "fused", "cornell_bvh": "fused_traverse", "instanced:2": "fused_traverse"}


def _tex_env(kind):
    rs = np.random.default_rng(3)
    if kind == "latlong":
        img = rs.uniform(0, 2, (32, 64, 3)).astype(np.float32)
        img[10:13, 20:24] = 50.0  # a small bright sun
        return envmap.latlong_env(img, strength=1.3)
    return envmap.cubemap_env(rs.uniform(0, 2, (6, 16, 16, 3)).astype(np.float32), strength=1.3)


def _tex_setup(device, kind, case, s_count=S):
    """A scene with a texture env and cameras that see it: Cornell-glossy
    (B1, through its routing BVH), the same with a BVH of its own (B5), and
    'instanced:2' (B5, through its routing BVH)."""
    sc, cam = build_scene("instanced:2" if case == "instanced:2" else "cornell-glossy")
    sc.environment = _tex_env(kind)
    if case != "instanced:2":  # past the box's open side, into the env
        cam.set_eye_at_up((1.2, 1.5, 3.6), (0.1, 1.3, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(SIZE, SIZE)
    rng = np.random.default_rng(13)
    cams = stack_cameras([
        camera_params(cam, jitter=((rng.random() - 0.5) / SIZE, (rng.random() - 0.5) / SIZE),
                      frame_count=2**31 + 7 + k)
        for k in range(s_count)
    ])
    scene = sc.build(device, accel="bvh" if case == "cornell_bvh" else "auto")
    from dxrexperiments_torch.models.base import select_route

    assert select_route(scene, "progressive") == TEX_SCENES[case]
    return scene, cams


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["progressive", "realtime"])
@pytest.mark.parametrize("case", sorted(TEX_SCENES))
@pytest.mark.parametrize("kind", ["latlong", "cubemap"])
def test_texture_env_kernels_match_plain(cuda_device, kind, case, mode):
    scene, cams = _tex_setup(cuda_device, kind, case)
    assert scene["env"][("latlong" if kind == "latlong" else "cube")].device.type == "cuda"
    options = default_options()
    ek = scene["env"]["kind"]
    mod = fs if TEX_SCENES[case] == "fused" else ft
    ident = "B1" if mod is fs else "B5"
    if mode == "progressive":
        before = launches(ident)
        got = (fs.fused_progressive_sum if mod is fs else ft.fused_traverse_progressive_sum)(
            scene, options, cams, SIZE, SIZE, ek)
        assert launches(ident) == before + 1
        want = fs.fused_progressive_sum_reference(scene, options, cams, SIZE, SIZE, ek)
        torch.cuda.synchronize()
        _gate(got, want)
        return
    before = launches(f"{ident} realtime")
    got = mod.realtime_aovs(scene, options, cams, SIZE, SIZE, ek)
    assert launches(f"{ident} realtime") == before + 1
    want = fs.fused_realtime_outputs_reference(scene, options, cams, SIZE, SIZE, ek)
    torch.cuda.synchronize()
    for k in fs.AOV_KEYS:
        for f in range(S):
            _gate(got[k][f], want[k][f], s_count=1)
    if case != "instanced:2":
        assert bool((got["albedo"].abs().sum(-1) == 0).any())  # primary misses: the env


@pytest.mark.cuda
def test_texture_env_launch_arguments(cuda_device):
    """A texture kind without its texture, or with empty dimensions, is
    refused by the entry points (cudaErrorInvalidValue); a texture that is
    not on the scene's device raises in the wrappers, which never copy it
    and never take the plain version."""
    scene, cams = _tex_setup(cuda_device, "latlong", "cornell")
    out = torch.empty((SIZE, SIZE, 3), device=cuda_device)
    params = torch.zeros(64, device=cuda_device)
    lib = fs.B1.library()
    stream = torch.cuda.current_stream().cuda_stream
    tex = scene["env"]["latlong"]
    rec, n_live = scene["tri_records"], int(scene["num_tris"])
    head = (params.data_ptr(), params.data_ptr(), params.data_ptr(), rec.data_ptr(),
            scene["attr_pack"].data_ptr(), out.data_ptr(), 1, int(scene["mt_pack"].shape[1]),
            n_live, SIZE, SIZE)
    for kind, ptr, w, h in ((2, None, 64, 32), (3, None, 16, 16), (2, tex.data_ptr(), 0, 32),
                            (3, tex.data_ptr(), 16, 8), (4, tex.data_ptr(), 16, 16)):
        # no cluster boxes, no block order
        assert lib.dxr_fused_progressive_sum(*head, kind, ptr, w, h, None, 0, 0, 0,
                                             stream) == 1  # InvalidValue
    ft_lib = ft.B5.library()
    err = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    bvh = build_scene("instanced:2")[0].build(cuda_device, accel="bvh")
    nodes, test, attr = (bvh["bvh"][k] for k in ("bvhf_rows", "ft_test", "ft_attr"))
    assert ft_lib.dxr_fused_traverse_progressive_sum(
        params.data_ptr(), params.data_ptr(), params.data_ptr(), params.data_ptr(),
        nodes.data_ptr(), test.data_ptr(), attr.data_ptr(), bvh["material_pack"].data_ptr(),
        out.data_ptr(), 1, nodes.shape[0], test.shape[0], SIZE, SIZE, 2, 3, None, 64, 32, None,
        None, 0, 0, err.data_ptr(), stream) == 1
    options = default_options()
    for kernel in (fs.fused_progressive_sum, ft.fused_traverse_progressive_sum):
        target = scene if kernel is fs.fused_progressive_sum else dict(
            bvh, env=scene["env"], lights=scene["lights"])
        off_device = dict(target, env=dict(scene["env"], latlong=tex.cpu()))
        with pytest.raises(ValueError, match="device"):
            kernel(off_device, options, cams, SIZE, SIZE, 2)
        with pytest.raises(ValueError, match="texture leaf"):
            kernel(dict(target, env=envmap.constant_env()), options, cams, SIZE, SIZE, 2)


@pytest.mark.cuda
def test_texture_env_pipelines_launch_counts(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the main path reached a plain version")

    monkeypatch.setattr(fs, "fused_progressive_sum_reference", refuse)
    monkeypatch.setattr(fs, "fused_realtime_outputs_reference", refuse)
    sc, cam = build_scene("cornell-glossy")
    sc.environment = _tex_env("latlong")
    cam.set_aspect(SIZE, SIZE)
    pipe = ProgressiveRaytracingPipeline(SIZE, SIZE, seed=1, samples_per_frame=4,
                                         device=cuda_device)
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    counts = launches("B1", "B5", "B3 closest")
    for f in range(3):
        pipe.update(elapsed_time=0.0, elapsed_frames=f)
        pipe.render()
    torch.cuda.synchronize()
    assert launches("B1", "B5", "B3 closest") == (
        counts[0] + 3, counts[1], counts[2])
    img = pipe.get_output()
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.0
    rt = RealtimeRaytracingPipeline(SIZE, SIZE, seed=2, device=cuda_device)
    rt.set_camera(cam)
    rt.set_scene(sc)
    before = launches("B1 realtime")
    rt.update(elapsed_time=0.0, elapsed_frames=0)
    direct, spec = rt.render()
    torch.cuda.synchronize()
    assert launches("B1 realtime") == before + 1 and bool((direct + spec).isfinite().all())


# ---- B5's area-light and albedo-texture modes -------------------------------

def _area_setup(device, case, s_count=S):
    """The area Cornell (tests/test_fused_traverse.py's: the glossy tall box,
    1 directional + 1 area light) with its own BVH, untextured under the
    gradient env or textured under a seeded cubemap; or the CLI's
    cornell-tex, built as the CLI builds it (its routing BVH)."""
    from dxrexperiments_torch.scene import cornell_box
    from dxrexperiments_torch.scene.lights import area_light, directional_light

    if case == "cornell-tex":
        sc, cam = build_scene("cornell-tex")
        scene = sc.build(device)
    else:
        mesh, mats = cornell_box(glossy_tall_box=True, textured_floor=case == "textured_cube")
        sc, cam = Scene(), build_scene("cornell")[1]
        for m in mats:
            sc.add_material(m)
        sc.add_model(mesh)
        sc.lights = {"dir": [directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.3))],
                     "area": [area_light((-0.4, 1.96, -0.4), (0.8, 0, 0), (0, 0, 0.8),
                                         (1.0, 0.9, 0.7, 4.0))]}
        sc.environment = (_tex_env("cubemap") if case == "textured_cube"
                          else envmap.gradient_env())
        scene = sc.build(device, accel="bvh")
    cam.set_aspect(SIZE, SIZE)
    rng = np.random.default_rng(17)
    cams = stack_cameras([
        camera_params(cam, jitter=((rng.random() - 0.5) / SIZE, (rng.random() - 0.5) / SIZE),
                      frame_count=2**31 + 21 + k)
        for k in range(s_count)
    ])
    return scene, cams


AREA_OPTIONS = [("defaults", {}), ("debug2", {"debug": 2}),
                ("no_indirect_diffuse", {"no_indirect_diffuse": True}),
                ("albedo_only", {"show_gbuffer_albedo_only": True})]


@pytest.mark.cuda
@pytest.mark.parametrize("name,opts", AREA_OPTIONS, ids=[c[0] for c in AREA_OPTIONS])
@pytest.mark.parametrize("case", ["area", "cornell-tex", "textured_cube"])
def test_fused_traverse_area_and_texture_modes_match_plain(cuda_device, case, name, opts):
    scene, cams = _area_setup(cuda_device, case)
    options = default_options(**opts)
    ek = scene["env"]["kind"]
    before = launches("B5")
    got = ft.fused_traverse_progressive_sum(scene, options, cams, SIZE, SIZE, ek)
    assert launches("B5") == before + 1
    want = ft.fused_traverse_progressive_sum_reference(scene, options, cams, SIZE, SIZE, ek)
    torch.cuda.synchronize()
    check_errors()
    _gate(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,opts", AREA_OPTIONS[:2], ids=[c[0] for c in AREA_OPTIONS[:2]])
def test_fused_traverse_area_realtime_matches_plain(cuda_device, name, opts):
    scene, cams = _area_setup(cuda_device, "area")
    options = default_options(**opts)
    before = launches("B5 realtime")
    got = ft.realtime_aovs(scene, options, cams, SIZE, SIZE, 1)
    assert launches("B5 realtime") == before + 1
    want = ft.fused_traverse_realtime_outputs_reference(scene, options, cams, SIZE, SIZE, 1)
    torch.cuda.synchronize()
    for k in fs.AOV_KEYS:
        for f in range(S):
            _gate(got[k][f], want[k][f], s_count=1)


@pytest.mark.cuda
def test_fused_traverse_new_mode_arguments(cuda_device):
    """The entry point refuses an area rig without its pack and a texel
    table without its meta; the wrapper raises for a texel table off the
    scene's device and for a textured realtime frame (outside the gate)."""
    scene, cams = _area_setup(cuda_device, "cornell-tex")
    options = default_options()
    lib = ft.B5.library()
    params = torch.zeros(64, device=cuda_device)
    out = torch.empty((SIZE, SIZE, 3), device=cuda_device)
    err = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    nodes, test, attr = (scene["bvh"][k] for k in ("bvhf_rows", "ft_test", "ft_attr"))
    texels = scene["textures"]["texels"]
    stream = torch.cuda.current_stream().cuda_stream
    for area, rig, tex in ((None, 5, (None, None, 0, 0)),
                           (params.data_ptr(), 5, (texels.data_ptr(), None, 4, 6))):
        assert lib.dxr_fused_traverse_progressive_sum(
            params.data_ptr(), params.data_ptr(), params.data_ptr(), area, nodes.data_ptr(),
            test.data_ptr(), attr.data_ptr(), scene["material_pack"].data_ptr(),
            out.data_ptr(), 1, nodes.shape[0], test.shape[0], SIZE, SIZE, 0, rig, None, 0, 0,
            *tex, err.data_ptr(), stream) == 1
    off = dict(scene, textures=dict(scene["textures"], texels=texels.cpu()))
    with pytest.raises(ValueError, match="device"):
        ft.fused_traverse_progressive_sum(off, options, cams, SIZE, SIZE, 0)
    with pytest.raises(NotImplementedError, match="scope"):
        ft.realtime_aovs(scene, options, cams, SIZE, SIZE, 0)


@pytest.mark.cuda
def test_cornell_tex_pipelines_launch_counts(cuda_device, monkeypatch):
    """cornell-tex: the progressive pipeline launches B5 once per dispatch
    (its routing BVH); a realtime frame takes the wavefront route (B4a)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the main path reached a plain version")

    monkeypatch.setattr(ft, "fused_traverse_progressive_sum_reference", refuse)
    sc, cam = build_scene("cornell-tex")
    cam.set_aspect(SIZE, SIZE)
    pipe = ProgressiveRaytracingPipeline(SIZE, SIZE, seed=1, samples_per_frame=2,
                                         device=cuda_device)
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    counts = launches("B1", "B5", "B4a closest")
    for f in range(3):
        pipe.update(elapsed_time=0.0, elapsed_frames=f)
        pipe.render()
    torch.cuda.synchronize()
    assert launches("B1", "B5", "B4a closest") == (
        counts[0], counts[1] + 3, counts[2])
    img = pipe.get_output()
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.0
    rt = RealtimeRaytracingPipeline(SIZE, SIZE, seed=2, device=cuda_device)
    rt.set_camera(cam)
    rt.set_scene(sc)
    before = launches("B5 realtime", "B4a closest", "B4a any")
    rt.update(elapsed_time=0.0, elapsed_frames=0)
    direct, spec = rt.render()
    torch.cuda.synchronize()
    assert launches("B5 realtime", "B4a closest", "B4a any") == (
        before[0], before[1] + 2, before[2] + 2)
    assert bool((direct + spec).isfinite().all())


# ---- the grouped packet walk (B4c), B1's opt-ins, the roofline probes (B7) ---

GROUPINGS = [(256, 2), (1024, 2), (1024, 8), (2048, 4)]  # (tile, group)


def _model_agree(got, model):
    """A kernel against its host model on the same rays: the hit and the
    slot differ on at most 1% of rays (knife edges under FMA contraction),
    t within rtol 1e-4 where both hit the same slot."""
    hit = got["hit"].cpu().numpy()
    slot = got["slot"].cpu().numpy()
    same = (hit == model["hit"]) & (~hit | (slot == model["slot"]))
    assert float((~same).mean()) <= 0.01
    both = same & hit
    np.testing.assert_allclose(got["t"].cpu().numpy()[both], model["t"][both], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,group", GROUPINGS)
def test_grouped_walk_matches_fat_and_model(cuda_device, tile, group):
    scene, cams = _bvh_setup(cuda_device)
    o, d, pos, sd, dist = _primary_and_shadow_rays(scene, cams)
    assert bool((o == o[0]).all())  # pinhole primaries: a common origin
    sd = sd.clone()
    sd[::3] = 0.0  # zero directions: never occluded
    before = launches("B4c closest", "B4c any", "B4a closest", "B4a any")
    got = traverse.traverse_fat_closest(scene, o, d, 0.0, 1e38, cull_backface=True, tile=tile,
                                        group=group)
    shared = traverse.traverse_fat_closest(scene, o, d, 0.0, 1e38, cull_backface=True,
                                           tile=tile, group=group, common_origin=True)
    occ = traverse.traverse_fat_any(scene, pos, sd, 1e-4, dist, tile=tile, group=group)
    after = launches("B4c closest", "B4c any", "B4a closest", "B4a any")
    assert after == (before[0] + 2, before[1] + 1, before[2], before[3])
    fat = traverse.traverse_fat_closest(scene, o, d, 0.0, 1e38, cull_backface=True)
    fat_occ = traverse.traverse_fat_any(scene, pos, sd, 1e-4, dist)
    torch.cuda.synchronize()
    check_errors()
    assert float(got["hit"].float().mean()) > 0.2
    hit_gate(got, fat)
    hit_gate(shared, fat)
    assert not bool(occ[::3].any())
    assert 0.0 < float(fat_occ.float().mean()) < 1.0
    assert float((occ != fat_occ).float().mean()) <= 0.01
    # the host model of the card's walk: each warp a packet
    bvh_np = {k: scene["bvh"][k].cpu().numpy() for k in ("bvhf_rows", "mt_rows")}
    host = [x.cpu().numpy() for x in (o, d, pos, sd, dist)]
    model, counts = traverse.fat_packet_walk_numpy(bvh_np, host[0], host[1], 0.0, 1e38, tile,
                                                   group, cull=True, packet=32)
    _model_agree(got, model)
    model_occ, _ = traverse.fat_packet_walk_numpy(bvh_np, host[2], host[3], 1e-4, host[4], tile,
                                                  group, occlusion=True, packet=32)
    assert float((occ.cpu().numpy() != model_occ["occluded"]).mean()) <= 0.01
    assert 1 <= counts["max_stack"] <= traverse.MAX_STACK


@pytest.mark.cuda
def test_grouped_walk_stack_overflow_and_layouts(cuda_device):
    o = torch.zeros((64, 3), device=cuda_device)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 64, device=cuda_device)

    def chain(levels):
        base, packed = chain_scene(levels)
        scene = {k: torch.as_tensor(base[k]).to(cuda_device) for k in ("v0", "e1", "e2")}
        scene["bvh"] = chain_fat_bvh(packed, cuda_device)
        return scene

    deep = chain(120)
    for trace in (traverse.traverse_fat_closest, traverse.traverse_fat_any):
        with pytest.raises(RuntimeError, match="stack overflowed"):
            trace(deep, o, d, 0.0, 1e38, tile=64, group=2)
            check_errors()
    hits = traverse.traverse_fat_closest(chain(40), o, d, 0.0, 1e38, tile=64, group=2)
    check_errors()
    assert bool(hits["hit"].all()) and torch.allclose(hits["t"], torch.full_like(hits["t"], 5.0))
    # the C entry point refuses a layout the wrapper would refuse
    fn = traverse.WALKS["grouped"][0].library().dxr_traverse_fat_grouped
    rays = traverse.pack_rays(o, d, 0.0, 1e38)
    err = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    out = torch.empty(64, device=cuda_device)
    slot = torch.empty(64, dtype=torch.int32, device=cuda_device)
    nodes, rec = deep["bvh"]["bvhf_rows"], deep["bvh"]["ft_test"]
    for tile, group in ((64, 4), (96, 2), (4096, 2), (1056, 33)):
        assert fn(rays.data_ptr(), nodes.data_ptr(), rec.data_ptr(), 64, nodes.shape[0],
                  rec.shape[0], 0, 0, tile, group, 0, out.data_ptr(), slot.data_ptr(),
                  out.data_ptr(), out.data_ptr(), None, err.data_ptr(),
                  torch.cuda.current_stream().cuda_stream) == 1  # InvalidValue


@pytest.mark.cuda
def test_grouped_walk_ragged_launch_and_common_origin(cuda_device):
    """B4c on 509 rays (every eighth pixel of the 64^2 image, the last warp
    short by three lanes) at each layout: t and occlusion equal B4a's on
    every ray, and with common_origin every ray starts at origins[0] (the
    others moved away), as B4a's does."""
    scene, cams = _bvh_setup(cuda_device)
    pick = torch.arange(509, device=cuda_device) * 8
    o, d, pos, sd, dist = (x[pick] for x in _primary_and_shadow_rays(scene, cams))
    sd = sd.clone()
    sd[::3] = 0.0
    moved = o.clone()
    moved[1:] += 5.0
    fat = traverse.traverse_fat_closest(scene, o, d, 0.0, 1e38, cull_backface=True)
    fat_occ = traverse.traverse_fat_any(scene, pos, sd, 1e-4, dist)
    for tile, group in GROUPINGS:
        got = traverse.traverse_fat_closest(scene, o, d, 0.0, 1e38, cull_backface=True,
                                            tile=tile, group=group)
        shared = traverse.traverse_fat_closest(scene, moved, d, 0.0, 1e38, cull_backface=True,
                                               tile=tile, group=group, common_origin=True)
        occ = traverse.traverse_fat_any(scene, pos, sd, 1e-4, dist, tile=tile, group=group)
        torch.cuda.synchronize()
        check_errors()
        assert float(fat["hit"].float().mean()) > 0.2
        for res in (got, shared):
            assert torch.equal(res["hit"], fat["hit"]) and torch.equal(res["t"], fat["t"])
            assert float((res["slot"] != fat["slot"]).float().mean()) <= 0.01
        assert torch.equal(occ, fat_occ)


def wide_ladder_scene(levels: int, device) -> dict:
    """wide_ladder's tree as a scene for B4d: bvh8_rows, the records ft_test
    of mt_rows, mt_rows and slot_tri."""
    _, packed = wide_ladder(levels)
    bvh = {k: torch.as_tensor(packed[k]).to(device) for k in ("bvh8_rows", "mt_rows", "slot_tri")}
    bvh["ft_test"] = traverse.coef_records(bvh["mt_rows"])
    return {"bvh": bvh}


@pytest.mark.cuda
def test_wide_walk_overflow_after_held_leaves(cuda_device):
    """B4d on wide_ladder's tree: the stack overflows at a visit whose leaf
    the lane holds. The closest walk through the triangle tests that leaf
    and raises; the occlusion walk through it ends at the first leaf and
    raises nothing; beside the triangle both walks raise. One level short,
    nothing overflows and every ray hits at t = 5."""
    o = torch.zeros((40, 3), device=cuda_device)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 40, device=cuda_device)
    beside = o + torch.tensor([5.0, 0.0, 0.0], device=cuda_device)
    deep = wide_ladder_scene(20, cuda_device)
    for trace, origin in ((traverse.traverse8_closest, o), (traverse.traverse8_closest, beside),
                          (traverse.traverse8_any, beside)):
        with pytest.raises(RuntimeError, match="stack overflowed"):
            trace(deep, origin, d, 0.0, 1e38)
            check_errors()
    occ = traverse.traverse8_any(deep, o, d, 0.0, 1e38)
    check_errors()
    assert bool(occ.all())
    hits = traverse.traverse8_closest(wide_ladder_scene(15, cuda_device), o, d, 0.0, 1e38)
    check_errors()
    assert bool(hits["hit"].all()) and torch.equal(hits["t"], torch.full_like(hits["t"], 5.0))


@pytest.mark.cuda
def test_wide_and_grouped_walks_check_records(cuda_device):
    """B4d and B4c read the BVH's ft_test: a BVH without it, or with one
    record fewer than mt_rows' rows, raises ValueError before any launch."""
    scene, cams = _bvh_setup(cuda_device)
    o, d = _primary_and_shadow_rays(scene, cams)[:2]
    bvh = scene["bvh"]
    before = launches("B4d closest", "B4d any", "B4c closest", "B4c any")
    for bad, match in (({k: v for k, v in bvh.items() if k != "ft_test"}, "ft_test missing"),
                       (dict(bvh, ft_test=bvh["ft_test"][:-1].contiguous()), "one record per")):
        sc = dict(scene, bvh=bad)
        for call in (lambda: traverse.traverse8_closest(sc, o, d),
                     lambda: traverse.traverse8_any(sc, o, d),
                     lambda: traverse.traverse_fat_closest(sc, o, d, tile=1024, group=4),
                     lambda: traverse.traverse_fat_any(sc, o, d, tile=1024, group=4)):
            with pytest.raises(ValueError, match=match):
                call()
    assert launches("B4d closest", "B4d any", "B4c closest", "B4c any") == before


OPT_INS = [(8, 0), (16, 0), (24, 0), (0, 8), (0, 16), (0, 32), (16, 16)]  # (rows, block_w)


@pytest.mark.cuda
@pytest.mark.parametrize("name,opts,env", [OPTION_CASES[0], OPTION_CASES[1], OPTION_CASES[2],
                                           OPTION_CASES[-1]],
                         ids=["defaults", "debug2", "no_indirect_diffuse", "gradient_env"])
def test_fused_opt_ins_equal_base(cuda_device, name, opts, env):
    """The CLUSTERED and BLOCKED instantiations give the base kernel's
    outputs bit for bit (Cornell pads to 40 rows, so 8, 16 and 24 rows per
    cluster all gate)."""
    scene, cams = _setup(cuda_device, env)
    options = default_options(**opts)
    ek = scene["env"]["kind"]
    before = launches("B1", "B1 realtime", "B1 clustered", "B1 blocked")
    base = fs.fused_progressive_sum(scene, options, cams, SIZE, SIZE, ek, cluster_rows=0,
                                    block_w=0)
    base_rt = fs.realtime_aovs(scene, options, cams, SIZE, SIZE, ek, cluster_rows=0, block_w=0)
    for rows, block_w in OPT_INS:
        got = fs.fused_progressive_sum(scene, options, cams, SIZE, SIZE, ek, cluster_rows=rows,
                                       block_w=block_w)
        got_rt = fs.realtime_aovs(scene, options, cams, SIZE, SIZE, ek, cluster_rows=rows,
                                  block_w=block_w)
        torch.cuda.synchronize()
        assert torch.equal(got, base), (rows, block_w)
        for k in fs.AOV_KEYS:
            assert torch.equal(got_rt[k], base_rt[k]), (rows, block_w, k)
    n = 1 + len(OPT_INS)
    clustered = 2 * sum(rows > 0 for rows, _ in OPT_INS)  # progressive and realtime
    blocked = 2 * sum(block_w > 0 for _, block_w in OPT_INS)
    assert launches("B1", "B1 realtime", "B1 clustered", "B1 blocked") == (
        before[0] + n, before[1] + n, before[2] + clustered, before[3] + blocked)
    want = fs.fused_progressive_sum_reference(scene, options, cams, SIZE, SIZE, ek)
    _gate(base, want)


@pytest.mark.cuda
def test_fused_clusters_above_48k_shared_memory(cuda_device):
    """256 rows in clusters of one row: the boxes beside the triangles take
    (44 + 6) x 256 x 4 = 51,200 bytes of shared memory (records, attribute
    rows, boxes), above the default 48 KB. The launch raises the kernel's
    limit and gives the base kernel's outputs bit for bit."""
    from dxrexperiments_torch.scene.procedural import random_triangle_soup

    sc, cam = build_scene("cornell-glossy")
    sc.add_model(random_triangle_soup(250 - 36, seed=3, extent=0.4))
    scene = sc.build(cuda_device)
    assert int(scene["num_tris"]) == 250 and int(scene["mt_pack"].shape[1]) == 256
    cam.set_aspect(SIZE, SIZE)
    cams = stack_cameras([camera_params(cam, frame_count=7 + k) for k in range(2)])
    options = default_options()
    ek = scene["env"]["kind"]
    base = fs.fused_progressive_sum(scene, options, cams, SIZE, SIZE, ek, cluster_rows=0,
                                    block_w=0)
    base_rt = fs.realtime_aovs(scene, options, cams, SIZE, SIZE, ek, cluster_rows=0, block_w=0)
    before = launches("B1 clustered")
    got = fs.fused_progressive_sum(scene, options, cams, SIZE, SIZE, ek, cluster_rows=1,
                                   block_w=0)
    got_rt = fs.realtime_aovs(scene, options, cams, SIZE, SIZE, ek, cluster_rows=1, block_w=0)
    torch.cuda.synchronize()
    assert launches("B1 clustered") == before + 2
    assert torch.equal(got, base)
    for k in fs.AOV_KEYS:
        assert torch.equal(got_rt[k], base_rt[k]), k


@pytest.mark.cuda
def test_fused_records_c256_clusters_of_one_match_plain(cuda_device):
    """C = 256, the largest scene B1 stages, in clusters of one row: the
    largest shared-memory request (records, attribute rows and boxes, 51,200
    bytes). The base and the CLUSTERED kernel against the plain version on
    the image gate, progressive and realtime (every AOV)."""
    from dxrexperiments_torch.scene.procedural import random_triangle_soup

    sc, cam = build_scene("cornell-glossy")
    sc.add_model(random_triangle_soup(256 - 36, seed=4, extent=0.4))
    scene = sc.build(cuda_device)
    assert int(scene["mt_pack"].shape[1]) == 256 and int(scene["num_tris"]) == 256
    cam.set_aspect(SIZE, SIZE)
    cams = stack_cameras([camera_params(cam, frame_count=11 + k) for k in range(S)])
    options = default_options()
    ek = scene["env"]["kind"]
    want = fs.fused_progressive_sum_reference(scene, options, cams, SIZE, SIZE, ek)
    want_rt = fs.fused_realtime_outputs_reference(scene, options, cams, SIZE, SIZE, ek)
    for rows in (0, 1):
        got = fs.fused_progressive_sum(scene, options, cams, SIZE, SIZE, ek, cluster_rows=rows,
                                       block_w=0)
        got_rt = fs.realtime_aovs(scene, options, cams, SIZE, SIZE, ek, cluster_rows=rows,
                                  block_w=0)
        torch.cuda.synchronize()
        _gate(got, want)
        for k in fs.AOV_KEYS:
            for f in range(S):
                _gate(got_rt[k][f], want_rt[k][f], s_count=1)


# one light blocked from inside the Cornell box, the other not: each
# shadow ray's sweep ends on its own
PARTED_RIGS = {
    # the sun straight above (the ceiling blocks it), a point light inside
    "directional_blocked": ((0.0, -1.0, 0.0), (0.0, 1.6, 0.3)),
    # the sun through the open front, a point light outside the right wall
    "point_blocked": ((0.0, -0.3, -1.0), (3.0, 1.0, 0.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("rig", list(PARTED_RIGS))
def test_fused_parted_lights_match_plain(cuda_device, rig):
    """B1 on a rig where, from most shading points, one light is blocked and
    the other is not (checked with the plain any-hit trace on the primary
    hits; the points on the wall or ceiling between a light and the box see
    it): progressive with and without the debug==2 pick, and realtime,
    against the plain version on the image gate; the CLUSTERED kernel bit
    for bit with the base one."""
    from dxrexperiments_torch.core.camera import primary_ray_grid
    from dxrexperiments_torch.scene.lights import directional_light, point_light

    forward, position = PARTED_RIGS[rig]
    sc, cam = build_scene("cornell-glossy")
    sc.lights = {"dir": directional_light(forward, (1.0, 0.95, 0.9, 2.0)),
                 "point": point_light(position, (1.0, 0.9, 0.8, 6.0))}
    scene = sc.build(cuda_device)
    cam.set_aspect(SIZE, SIZE)
    cams = stack_cameras([camera_params(cam, frame_count=21 + k) for k in range(S)])
    o, d = primary_ray_grid({k: v[0] for k, v in cams.items()}, SIZE, SIZE)
    o, d = o.reshape(-1, 3).to(cuda_device), d.reshape(-1, 3).to(cuda_device)
    hits = intersect.intersect_closest(scene, o, d, 0.0, 3.0e37, True)
    pos = (o + hits["t"][:, None] * d)[hits["hit"]]
    to_sun = -torch.tensor(forward, device=cuda_device) / float(np.linalg.norm(forward))
    to_pt = torch.tensor(position, device=cuda_device) - pos
    dist = to_pt.norm(dim=1)
    sun = intersect.intersect_any(scene, pos, to_sun.expand_as(pos).contiguous(), 1e-4, 3.0e37)
    pt = intersect.intersect_any(scene, pos, to_pt / dist[:, None], 1e-4, dist - 1e-4)
    blocked, other = (sun, pt) if rig == "directional_blocked" else (pt, sun)
    assert float(blocked.float().mean()) > 0.6 and float(other.float().mean()) < 0.4
    ek = scene["env"]["kind"]
    for opts in ({}, {"debug": 2}):
        options = default_options(**opts)
        got = fs.fused_progressive_sum(scene, options, cams, SIZE, SIZE, ek, cluster_rows=0,
                                       block_w=0)
        gated = fs.fused_progressive_sum(scene, options, cams, SIZE, SIZE, ek, cluster_rows=8,
                                         block_w=0)
        want = fs.fused_progressive_sum_reference(scene, options, cams, SIZE, SIZE, ek)
        torch.cuda.synchronize()
        assert torch.equal(gated, got)
        _gate(got, want)
    options = default_options()
    got_rt = fs.realtime_aovs(scene, options, cams, SIZE, SIZE, ek)
    want_rt = fs.fused_realtime_outputs_reference(scene, options, cams, SIZE, SIZE, ek)
    torch.cuda.synchronize()
    for k in fs.AOV_KEYS:
        for f in range(S):
            _gate(got_rt[k][f], want_rt[k][f], s_count=1)


@pytest.mark.cuda
def test_fused_opt_in_arguments(cuda_device):
    """The entry points refuse opt-ins that do not fit (cudaErrorInvalidValue):
    a block width that does not divide the 256-thread block or the image,
    boxes that do not cover the triangles."""
    scene, cams = _setup(cuda_device, "const")
    out = torch.empty((SIZE, SIZE, 3), device=cuda_device)
    params = torch.zeros(64, device=cuda_device)
    lib = fs.B1.library()
    stream = torch.cuda.current_stream().cuda_stream
    c = int(scene["mt_pack"].shape[1])
    boxes = fs.cluster_aabbs(scene, 16)
    rec, n_live = scene["tri_records"], int(scene["num_tris"])
    head = (params.data_ptr(), params.data_ptr(), params.data_ptr(), rec.data_ptr(),
            scene["attr_pack"].data_ptr(), out.data_ptr(), 1, c, n_live, SIZE, SIZE, 0, None, 0,
            0)
    for ptr, k, rows, block_w in ((None, 0, 0, 48), (None, 0, 0, 256), (None, 0, 0, -8),
                                  (boxes.data_ptr(), 2, 16, 0), (boxes.data_ptr(), 3, 8, 0),
                                  (boxes.data_ptr(), 3, 0, 0)):
        assert lib.dxr_fused_progressive_sum(*head, ptr, k, rows, block_w, stream) == 1


@pytest.mark.cuda
def test_roofline_probes_match_plain(cuda_device):
    from dxrexperiments_torch.ops import roofline as rf

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain product in full float32
    a, b, mt, rays = rf.probe_inputs(cuda_device, seed=3)
    it, grid, m_it = rf.SMOKE_ITERS, rf.SMOKE_GRID, rf.SMOKE_M_ITERS
    before = launches("B7 fma", "B7 mix", "B7 overlap")
    for fn, ref in ((rf.fma_peak, rf.fma_peak_reference), (rf.pair_mix, rf.pair_mix_reference)):
        got, want = fn(a, b, it, grid), ref(a, b, it, grid)
        torch.cuda.synchronize()
        assert float(((got - want).abs() / want.abs()).max()) <= 1e-4
    scale_of = mt.abs() @ rays.abs()
    for do_vector, do_matrix, scale in ((True, True, 1), (True, True, 4), (False, True, 1),
                                        (True, False, 2)):
        got = rf.overlap(a, b, mt, rays, do_vector, do_matrix, scale, m_it, grid,
                         keep_product=True)
        want = rf.overlap_reference(a, b, mt, rays, do_vector, do_matrix, scale, m_it, grid)
        torch.cuda.synchronize()
        assert float(((got["o"] - want["o"]).abs() / want["o"].abs()).max()) <= 1e-4
        assert float(((got["t"] - want["t"]).abs() / want["t"].abs()).max()) <= 1e-6
        if do_matrix:  # split TF32 keeps float32 accuracy: 2 K ulps of sum |terms|
            err = (got["product"] - want["product"]).abs() / scale_of
            assert float(err.max()) <= 2 * rf.K * 2.0**-23
        else:
            assert not bool(got["product"].any())
    assert launches("B7 fma", "B7 mix", "B7 overlap") == (
        before[0] + 1, before[1] + 1, before[2] + 4)
    # roofline.py's full size, on inputs whose elements differ and on which
    # the chains stay finite (a trip count or a grid block off shows)
    a_mix, b_mix = rf.mix_inputs(cuda_device, seed=4)
    for fn, ref, args in ((rf.fma_peak, rf.fma_peak_reference, (a, b)),
                          (rf.pair_mix, rf.pair_mix_reference, (a_mix, b_mix))):
        got, want = fn(*args), ref(*args)
        torch.cuda.synchronize()
        assert tuple(got.shape) == (rf.SUB, rf.LANES * rf.GRID) and bool(want.isfinite().all())
        assert rf.max_rel_diff(got, want) <= 1e-4
    got = rf.overlap(a, b, mt, rays, True, True, 4, keep_product=True)
    want = rf.overlap_reference(a, b, mt, rays, True, True, 4)
    torch.cuda.synchronize()
    assert rf.max_rel_diff(got["o"], want["o"]) <= 1e-4
    assert rf.max_rel_diff(got["t"], want["t"]) <= 1e-6
    assert float(((got["product"] - want["product"]).abs() / scale_of).max()) <= 2 * rf.K * 2.0**-23


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["interpret", "full"])
def test_roofline_overlap_settings_agree(cuda_device, size):
    """The overlap kernel (wgmma) at roofline.py's --interpret and full
    sizes, all seven settings: the FMA chains do not depend on the product
    nor the product on the chains (o of both equal to vector alone's, t and
    the product to matrix alone's, bit for bit); the product over all 1,024
    columns, a later column tile's among them, within 2 K float32 ulps of
    sum |terms|; t against the plain version, the last column tile too.
    Then the four settings with a product on inputs where it shows in t
    (b = 0, mt and rays ~ 1e15, so that t sums rows 0..7 of the products
    times 1e-30 and the column scale stays 1): t of every column, each
    later column tile and persistent pass among them, within M_ITERS x 2 K
    ulps of sum |terms| x 1e-30 of the exact sum, plus half an ulp of each
    float32 add into t (the plain version's t is held to the same gate)."""
    from dxrexperiments_torch.ops import roofline as rf

    torch.backends.cuda.matmul.allow_tf32 = False
    m_it, grid = ((rf.SMOKE_M_ITERS, rf.SMOKE_GRID) if size == "interpret"
                  else (rf.M_ITERS, rf.GRID))
    a, b, mt, rays = rf.probe_inputs(cuda_device, seed=5)
    cases = [(False, True, 1)] + [(v, m, s) for s in (1, 2, 4)
                                  for v, m in ((True, False), (True, True))]
    got = {c: rf.overlap(a, b, mt, rays, *c, m_it, grid, keep_product=True) for c in cases}
    torch.cuda.synchronize()
    matrix = got[False, True, 1]
    for s in (1, 2, 4):
        assert torch.equal(got[True, True, s]["o"], got[True, False, s]["o"])
        assert torch.equal(got[True, True, s]["t"], matrix["t"])
        assert torch.equal(got[True, True, s]["product"], matrix["product"])
        assert torch.equal(got[True, False, s]["t"], b.repeat(1, grid))  # no product: t stays b
    want = rf.overlap_reference(a, b, mt, rays, False, True, 1, m_it, grid)
    err = (matrix["product"] - want["product"]).abs() / (mt.abs() @ rays.abs())
    gate = 2 * rf.K * 2.0**-23
    assert float(err.max()) <= gate
    tile = 64  # a warpgroup's column tile
    later = slice(5 * tile, 6 * tile)  # column tile 5 of grid block 0
    assert bool(matrix["product"][:, later].abs().gt(0).all()) and float(err[:, later].max()) <= gate
    assert rf.max_rel_diff(matrix["t"], want["t"]) <= 1e-6
    last = slice(rf.LANES * grid - tile, rf.LANES * grid)  # the last warpgroup tile
    assert rf.max_rel_diff(matrix["t"][:, last], want["t"][:, last]) <= 1e-6

    b_v, mt_v, rays_v = torch.zeros_like(b), mt * 1e15, rays * 1e15
    exact = (mt_v[:rf.SUB].double() @ rays_v.double()).repeat(1, grid) * 1e-30 * m_it
    sum_abs = (mt_v[:rf.SUB].abs().double() @ rays_v.abs().double()).repeat(1, grid) * 1e-30
    t_gate = (m_it * gate + 2.0**-24 * m_it * (m_it + 3) / 2) * sum_abs
    want = rf.overlap_reference(a, b_v, mt_v, rays_v, False, True, 1, m_it, grid)
    assert float(exact.abs().max()) > 1.0  # the products do show
    assert bool(((want["t"].double() - exact).abs() <= t_gate).all())
    for case in [c for c in cases if c[1]]:
        got = rf.overlap(a, b_v, mt_v, rays_v, *case, m_it, grid, keep_product=True)
        torch.cuda.synchronize()
        assert bool(((got["t"].double() - exact).abs() <= t_gate).all())
        err = (got["product"] - want["product"]).abs() / (mt_v.abs() @ rays_v.abs())
        assert float(err.max()) <= gate


def _row_blocks(prepare, height: int, n: int, row_axis: int):
    """The outputs of n row-block launches (py0, full_height) put together."""
    rows = height // n
    blocks = [prepare(i * rows, rows) for i in range(n)]
    return [torch.cat([b[o] for b in blocks], dim=row_axis) for o in range(len(blocks[0]))]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B1", "B5"])
@pytest.mark.parametrize("realtime", [False, True])
def test_row_block_launches_equal_the_whole_launch(cuda_device, kernel, realtime):
    """B1 and B5 launched as 2 and 4 row blocks (the full image's NDC and
    TEA seeds) reproduce one whole launch bit for bit, and the whole image
    launched as one block (py0 0, full_height its height) too."""
    if kernel == "B1":
        scene, cams = _setup(cuda_device, "gradient")
        mod = fs
    else:
        scene, cams = _bvh_setup(cuda_device)
        mod = ft
    if realtime:
        cams = {k: v[:1] for k, v in cams.items()}
    ek = int(scene["env"]["kind"])

    def prepare(py0, rows):
        args = (scene, default_options(), cams, SIZE, rows, ek, realtime)
        launch, outs, *_ = (mod.prepare_launch(*args, 0, 0, py0=py0, full_height=SIZE)
                            if kernel == "B1" else
                            mod.prepare_launch(*args, py0=py0, full_height=SIZE))
        assert launch() == 0
        return outs

    whole = prepare(None, SIZE)
    torch.cuda.synchronize()
    for n in (1, 2, 4):
        got = _row_blocks(prepare, SIZE, n, 1 if realtime else 0)
        torch.cuda.synchronize()
        for g, w in zip(got, whole):
            assert torch.equal(g, w), (kernel, realtime, n)
    check_errors()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 16])
def test_bilateral_halo_row_blocks_equal_the_whole_pass(cuda_device, n):
    """The sharded denoiser's row blocks, one thread a block
    (``launch.run_tiles``): B2's vertical pass on each block padded by
    ``render._halo_rows`` equals the whole pass, and ``render._denoise_local``
    (the halo path, or at n = 16, 13-row blocks, the short-block path:
    ``gather_rows`` and the full columns) equals the whole frame's
    denoise_composite, bit for bit."""
    from dxrexperiments_torch.models.denoise import default_denoise_params, denoise_composite
    from dxrexperiments_torch.parallel import launch, render

    inp, guide = _bilateral_data(cuda_device, h=208, w=53, seed=8)
    params = default_denoise_params()
    radius = float(params["max_kernel_size"])
    r = bilateral.MAX_EXTENT
    pass0 = bilateral.bilateral_pass(inp, guide, radius, 1)
    whole = bilateral.bilateral_pass(pass0, guide, radius, 0)
    h = 208 // n

    def job(mesh):
        a, b = mesh.tile * h, (mesh.tile + 1) * h
        vert = None
        if h >= r:
            padded = render._halo_rows([pass0[a:b], guide[a:b]], r, mesh)
            vert = bilateral.bilateral_pass(*padded, radius, 0)[r:-r]
        return vert, render._denoise_local(guide[a:b], inp[a:b], params, mesh, h)

    tiles = launch.run_tiles(n, job, cuda_device)
    torch.cuda.synchronize()
    if h >= r:
        assert torch.equal(torch.cat([t[0] for t in tiles]), whole)
    assert torch.equal(torch.cat([t[1] for t in tiles]), denoise_composite(guide, inp, params))


@pytest.mark.cuda
def test_render_frames_one_launch_equals_sequential(cuda_device):
    """The frames-in-flight batch: K = 3 frames in one B1 launch equal three
    sequential renders bit for bit."""
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(SIZE, SIZE)
    pipes = []
    for _ in range(2):
        p = RealtimeRaytracingPipeline(SIZE, SIZE, seed=3, device=cuda_device)
        p.set_camera(cam)
        p.set_scene(sc)
        pipes.append(p)
    before = launches("B1 realtime")
    d_k, s_k = pipes[0].render_frames(0, 3)
    assert launches("B1 realtime") == before + 1
    for f in range(3):
        pipes[1].update(0.0, f)
        d, s = pipes[1].render()
        assert torch.equal(d, d_k[f]) and torch.equal(s, s_k[f])


def _tensor_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensor_leaves(v, f"{path}/{k}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name,accel,kernel", [("cornell-glossy", "auto", "B1"),
                                                      ("instanced:4", "auto", "B5")])
def test_rebake_material_equals_fresh_build(cuda_device, scene_name, accel, kernel):
    """The viewer's live material edit on the card: every tensor of the
    rebaked scene equals a fresh build's with the edited material, and the
    two scenes render bit-equal images through B1 (Cornell) and B5
    (instanced:4 flattened)."""
    from dxrexperiments_torch.scene.scene import rebake_material

    sc, cam = build_scene(scene_name)
    cam.set_aspect(SIZE, SIZE)
    base = sc.build(cuda_device, accel=accel)
    edited = dataclasses.replace(sc.materials[0], albedo=(0.2, 0.8, 0.4, 1.0), roughness=0.3,
                                 reflectivity=0.6)
    sc.materials[0] = edited
    fresh = sc.build(cuda_device, accel=accel)
    got = rebake_material(base, 0, edited)
    want = dict(_tensor_leaves(fresh))
    have = dict(_tensor_leaves(got))
    assert sorted(have) == sorted(want)
    for k, v in want.items():
        assert have[k].device == v.device and torch.equal(have[k], v), k
    images = []
    for scene in (got, fresh):
        pipe = ProgressiveRaytracingPipeline(SIZE, SIZE, seed=5, samples_per_frame=S,
                                             device=cuda_device)
        pipe.set_camera(cam)
        pipe.set_scene_data(scene)
        before = launches("B1", "B5")
        pipe.update(0.0, 0)
        images.append(pipe.render().clone())
        after = launches("B1", "B5")
        assert after[0] - before[0] == (kernel == "B1") and after[1] - before[1] == (
            kernel == "B5")
    check_errors()
    assert torch.equal(images[0], images[1])


@pytest.mark.cuda
def test_mesh_file_cli_render_equals_in_memory(cuda_device, tmp_path):
    """The CLI on a 960-triangle sphere PLY (the brute-force wavefront route,
    B3) equals the same mesh built in memory and framed by ``mesh_scene``,
    bit for bit, and launches B3."""
    from chip_smoke import write_ply
    from dxrexperiments_torch.app import headless
    from dxrexperiments_torch.scene.procedural import sphere_mesh

    base = sphere_mesh((0.0, 0.0, 0.0), 1.0, lat=16, lon=32)
    mesh = Mesh(base.positions, None, base.indices[:, [0, 2, 1]])
    path, out = str(tmp_path / "sphere.ply"), str(tmp_path / "cli.npy")
    write_ply(path, mesh)
    before = launches("B3 closest")
    assert headless.main(["--scene", path, "--size", f"{SIZE}x{SIZE}", "--spp", "2",
                          "--device", "cuda", "-o", out]) == 0
    assert launches("B3 closest") - before == 2 * 2
    sc, cam = headless.mesh_scene(mesh)
    cam.set_aspect(SIZE, SIZE)
    pipe = ProgressiveRaytracingPipeline(SIZE, SIZE, seed=0, device=cuda_device)
    pipe.max_iterations = 2
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    for f in range(2):
        pipe.update(elapsed_time=f / 60.0, elapsed_frames=f)
        pipe.render()
    got = np.load(out)
    assert np.isfinite(got).all() and got.max() > 0.0
    np.testing.assert_array_equal(got, pipe.get_output().cpu().numpy())


# ---- re-baked instances, the device BVH build, ray sorting, PRIME seeding ----


@pytest.fixture
def one_thread():
    """One intra-op thread a test, for the CPU tests that import it: the
    suite runs several workers on few cores, where torch's default of one
    thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def floor_mesh(mesh_cls, ext=20.0):
    """A 2-triangle floor of side 2 * ext at y = 0 (tests/test_prime_seed.py's)."""
    return mesh_cls(np.array([[-ext, 0, -ext], [-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext]],
                             np.float32), None, np.array([[0, 1, 2], [0, 2, 3]], np.int32))


def grid_scene(scene_cls, material_cls, mesh_cls, sphere_mesh, k=3):
    """k x k unit spheres at y = 1 over a large floor, a small instanced:K
    (tests/test_prime_seed.py's _grid_scene); takes either package's
    classes."""
    sc = scene_cls()
    white = sc.add_material(material_cls(albedo=(0.73, 0.73, 0.73, 1.0)))
    sph = sphere_mesh((0.0, 0.0, 0.0), 1.0, lat=6, lon=8)
    for i in range(k):
        for j in range(k):
            t = np.eye(4, dtype=np.float32)
            t[0, 3], t[1, 3], t[2, 3] = (i - k / 2) * 2.5, 1.0, (j - k / 2) * 2.5
            sc.add_model(sph, transform=t, material=white)
    sc.add_model(floor_mesh(mesh_cls), material=white)
    return sc


def port_grid(k=3):
    from dxrexperiments_torch.scene import Material
    from dxrexperiments_torch.scene.procedural import sphere_mesh

    return grid_scene(Scene, Material, Mesh, sphere_mesh, k)


def bounce_rays(n=512, seed=3):
    """Incoherent bounce-like rays (numpy): origins among the spheres,
    random directions (down-facing ones meet the floor)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4.0, 4.0, size=(n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 2.5, size=n).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def yaw_grid(n, spacing=3.0, yaw0=0.0):
    """[n, 4, 4] float32: instance i turned by yaw0 + i about y and moved
    i * spacing along x, 0.3 i up (tests/test_dynamic.py's grid)."""
    ts = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        c, s = np.cos(yaw0 + i), np.sin(yaw0 + i)
        ts[i] = np.eye(4, dtype=np.float32)
        ts[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        ts[i, 0, 3], ts[i, 1, 3] = i * spacing, 0.3 * i
    return ts


def bake_base_scene(scene_cls, material_cls, box_mesh, device=None):
    """The base mesh of a bake: one box (12 triangles, 16 rows), two
    materials. ``device`` None builds the JAX package's scene."""
    sc = scene_cls()
    sc.add_material(material_cls(albedo=(0.9, 0.3, 0.2, 1.0)))
    sc.add_material(material_cls(albedo=(0.2, 0.4, 0.9, 1.0), reflectivity=0.5, type=1))
    sc.add_model(box_mesh((0.0, 0.5, 0.0), (1.0, 1.0, 1.0), 0), material=0)
    return sc.build(accel="none") if device is None else sc.build(device, accel="none")


@pytest.mark.cuda
def test_bake_instances_cuda_matches_cpu(cuda_device):
    """16 boxes re-baked on the card equal the CPU bake within 1e-6
    (full float32: no TF32 in the bake), with their B1 records."""
    from dxrexperiments_torch.scene import Material
    from dxrexperiments_torch.scene.dynamic import bake_instances, prepare_base
    from dxrexperiments_torch.scene.procedural import box_mesh

    tfs = yaw_grid(16)
    over = np.array([-1, 1] * 8, np.int64)
    bakes = [bake_instances(prepare_base(bake_base_scene(Scene, Material, box_mesh, dev), 16), tfs,
                            over) for dev in ("cpu", cuda_device)]
    cpu, gpu = bakes
    assert gpu["num_tris"] == cpu["num_tris"] == 256 and gpu["mt_pack"].is_cuda
    for k, v in cpu.items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_allclose(gpu[k].cpu().numpy(), v.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert torch.equal(gpu["tri_records"], traverse.tri_records(gpu["mt_pack"]))


@pytest.mark.cuda
def test_build_bvh_device_cuda_order(cuda_device):
    """The Morton build on the card: ``order`` equal to the host build's,
    the node boxes bit-equal."""
    from dxrexperiments_torch.accel import bvh as tbvh

    scene = port_grid(4).build("cpu", accel="none")
    n = scene["num_tris"]
    v0, e1, e2 = (scene[k].numpy() for k in ("v0", "e1", "e2"))
    host = tbvh.build_bvh(v0, e1, e2, n, 8)
    dev = tbvh.build_bvh_device(*(torch.as_tensor(x, device=cuda_device) for x in (v0, e1, e2)),
                                n, 8)
    assert dev["levels"] == host["levels"] and dev["order"].is_cuda
    np.testing.assert_array_equal(dev["order"].cpu().numpy(), host["order"])
    np.testing.assert_array_equal(dev["nodes_lo"].cpu().numpy(), host["nodes_lo"])
    np.testing.assert_array_equal(dev["nodes_hi"].cpu().numpy(), host["nodes_hi"])


def _assert_same_outputs(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["fat", "binary"])
def test_sorted_walks_equal_unsorted(cuda_device, walk):
    """B4a and B4b over rays in _ray_sort_order, scattered back: every hit
    field and occlusion flag equal to the launch in the rays' own order."""
    from dxrexperiments_torch.trace import integrator as tint

    scene = port_grid().build(cuda_device, accel="bvh")
    if walk == "binary":
        scene = dict(scene, bvh=_drop(scene["bvh"], ("bvhf_nodes", "bvhf_rows")))
    closest, any_ = tint.walk_functions(scene, "cuda")
    o, d = (torch.as_tensor(x, device=cuda_device) for x in bounce_rays(2048))
    t_max = torch.as_tensor(np.random.default_rng(3).uniform(0.5, 20.0, 2048).astype(np.float32),
                            device=cuda_device)
    order = tint._ray_sort_order(scene, o, d)
    assert not torch.equal(order, torch.arange(2048, device=cuda_device))
    _assert_same_outputs(tint._sorted_trace(scene, closest, o, d, 1e-4, 3.0e37,
                                            cull_backface=False),
                         closest(scene, o, d, 1e-4, 3.0e37, cull_backface=False))
    _assert_same_outputs(tint._sorted_trace(scene, any_, o, d, 1e-4, t_max),
                         any_(scene, o, d, 1e-4, t_max))
    check_errors()


@pytest.mark.cuda
@pytest.mark.parametrize("build", ["flat", "two_level"])
def test_prime_seeded_walks_equal_unseeded(cuda_device, build):
    """B4a (flat) and B6a (two-level) on bounce rays with the PRIME-seeded
    t_max: every hit field equal to the unseeded walk's, and the seed
    engaged on the down-facing rays."""
    from dxrexperiments_torch.trace import integrator as tint

    sc = port_grid()
    scene = sc.build(cuda_device, accel="bvh") if build == "flat" else sc.build_two_level(
        cuda_device)
    closest = tint.walk_functions(scene, "cuda")[0]
    o, d = (torch.as_tensor(x, device=cuda_device) for x in bounce_rays(2048))
    active = torch.ones(2048, dtype=torch.bool, device=cuda_device)
    active[::7] = False
    t_full = torch.where(active, tint.RAY_MAX_T, 0.0)
    t_seeded = tint._prime_seed_tmax(scene, o, d, t_full)
    assert int((t_seeded[active] < tint.RAY_MAX_T * 0.5).sum()) > 200
    assert bool((t_seeded <= t_full).all())
    _assert_same_outputs(closest(scene, o, d, tint.RAY_EPSILON, t_seeded, cull_backface=False),
                         closest(scene, o, d, tint.RAY_EPSILON, t_full, cull_backface=False))
    check_errors()
