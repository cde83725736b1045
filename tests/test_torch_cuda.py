"""CUDA kernel vs its plain PyTorch version, on the card.

Marked ``cuda``; each test skips without an NVIDIA GPU (a CUDA kernel has no
CPU mode). The file imports no JAX, so it runs on a machine that has the
card and not JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Gates: the image gate of benchmarks/kernel_parity.py on the per-sample mean
(at most 1% of pixels differ by more than 1e-3, median |difference| <= 1e-5)
for the megakernel in both modes, each realtime AOV on its own: knife-edge
pairs may flip under FMA contraction. The bilateral kernel: max |difference|
<= 2e-5 (tests/test_bilateral_pallas.py's tolerance), the sums differing
only by rounding.
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
from dxrexperiments_torch.ops import bilateral
from dxrexperiments_torch.ops import fused_sample as fs
from dxrexperiments_torch.scene import envmap
from dxrexperiments_torch.trace.integrator import default_options

SIZE = 64
S = 2
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
    before = fs.LAUNCHES
    got = fs.fused_progressive_sum(scene, options, cams, SIZE, SIZE, ek)
    assert fs.LAUNCHES == before + 1
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
    before = fs.LAUNCHES
    for f in range(3):
        pipe.update(elapsed_time=0.0, elapsed_frames=f)
        pipe.render()
    torch.cuda.synchronize()
    assert fs.LAUNCHES == before + 3
    img = pipe.get_output()
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name,opts,env", REALTIME_CASES, ids=[c[0] for c in REALTIME_CASES])
def test_realtime_kernel_matches_plain(cuda_device, name, opts, env):
    scene, cams = _setup(cuda_device, env, s_count=1)
    options = default_options(**opts)
    cam = {k: v[0] for k, v in cams.items()}
    ek = scene["env"]["kind"]
    before = fs.REALTIME_LAUNCHES
    got = fs.fused_realtime_outputs(scene, options, cam, SIZE, SIZE, ek)
    assert fs.REALTIME_LAUNCHES == before + 1
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
    before = bilateral.LAUNCHES
    got = bilateral.bilateral_pass(inp, guide, float(radius), axis)
    assert bilateral.LAUNCHES == before + 1
    want = bilateral._bilateral_pass(inp, guide, float(radius), axis)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_realtime_denoise_pipeline(cuda_device):
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(SIZE, SIZE)
    pipe = RealtimeRaytracingPipeline(SIZE, SIZE, seed=2, device=cuda_device)
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    denoiser = DenoiseCompositor(device=cuda_device)
    rt0, bl0 = fs.REALTIME_LAUNCHES, bilateral.LAUNCHES
    for f in range(2):
        pipe.update(elapsed_time=0.0, elapsed_frames=f)
        direct, spec = pipe.render()
        img = denoiser.dispatch(direct, spec)
    torch.cuda.synchronize()
    assert fs.REALTIME_LAUNCHES == rt0 + 2 and bilateral.LAUNCHES == bl0 + 4
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.0
    want = denoise_composite(direct, spec, denoiser.params, impl="torch")
    assert float((img - want).abs().max()) <= 2e-5
