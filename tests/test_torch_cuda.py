"""CUDA kernel vs its plain PyTorch version, on the card.

Marked ``cuda``; each test skips without an NVIDIA GPU (a CUDA kernel has no
CPU mode). The file imports no JAX, so it runs on a machine that has the
card and not JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Gate: the image gate of benchmarks/kernel_parity.py on the per-sample mean
(at most 1% of pixels differ by more than 1e-3, median |difference| <= 1e-5):
knife-edge pairs may flip under FMA contraction.
"""

import numpy as np
import pytest
import torch

from dxrexperiments_torch.app.headless import build_scene
from dxrexperiments_torch.core.camera import camera_params, stack_cameras
from dxrexperiments_torch.models.progressive import ProgressiveRaytracingPipeline
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


def _setup(device, env):
    sc, cam = build_scene("cornell-glossy")
    sc.environment = (envmap.constant_env((0.05, 0.1, 0.2), strength=1.5) if env == "const"
                      else envmap.gradient_env())
    cam.set_aspect(SIZE, SIZE)
    rng = np.random.default_rng(5)
    cams = stack_cameras([
        camera_params(cam, jitter=((rng.random() - 0.5) / SIZE, (rng.random() - 0.5) / SIZE),
                      frame_count=2**31 + 3 + k)  # uint32 counters >= 2^31
        for k in range(S)
    ])
    return sc.build(device), cams


def _gate(got, want):
    diff = ((got - want) / S).abs()
    assert bool(got.isfinite().all())
    assert float((diff > 1e-3).any(dim=-1).float().mean()) <= 0.01
    assert float(diff.median()) <= 1e-5


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
