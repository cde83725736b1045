"""Port ops/fused_sample.py vs the TPU megakernel.

On the CPU the port's ``fused_progressive_sum`` takes its plain version (a
loop over the wavefront integrator); it is held against the JAX Pallas
kernel run in interpret mode, on the Cornell scene at 32^2 with S = 2
samples per launch. Gate (tests/test_fused_sample.py): at most 0.5% of
pixels differ by more than 1e-3, median |difference| < 1e-5; knife-edge
pairs may resolve differently once the float32 sums are reassociated.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py, which imports no JAX so that it runs where the
card is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.ops import fused_sample as tfs
from dxrexperiments_torch.scene.convert import (
    camera_from_numpy,
    options_from_numpy,
    scene_from_numpy,
)
from dxrexperiments_tpu.core.camera import Camera, camera_params
from dxrexperiments_tpu.ops import fused_sample_pallas as jfs
from dxrexperiments_tpu.scene import Scene, cornell_box, envmap
from dxrexperiments_tpu.scene.lights import directional_light, point_light
from dxrexperiments_tpu.trace import default_options

W = H = 32
S = 2

OPTION_CASES = [
    ("defaults", {}, "const"),
    ("debug2", {"debug": 2}, "const"),
    ("no_indirect_diffuse", {"no_indirect_diffuse": True}, "const"),
    ("uniform_hemisphere", {"cosine_hemisphere_sampling": False}, "const"),
    ("albedo_only", {"show_gbuffer_albedo_only": True}, "const"),
    ("fresnel_term", {"show_fresnel_term": True}, "const"),
    ("gradient_env", {}, "gradient"),
]


def jax_scene(env="const"):
    mesh, materials = cornell_box(glossy_tall_box=True)
    sc = Scene()
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh)
    sc.lights = {
        "dir": directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
        "point": point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
    }
    if env == "const":
        sc.environment = envmap.constant_env((0.05, 0.1, 0.2), strength=1.5)
    else:
        sc.environment = envmap.gradient_env()
    return sc.build()


def jax_cameras():
    cam = Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(W, H)
    jit = [(0.3 / W, -0.2 / H), (-0.15 / W, 0.35 / H)]
    cams = [camera_params(cam, jitter=jit[k], frame_count=7 + k) for k in range(S)]
    return jax.tree.map(lambda *x: jnp.stack(x), *cams)


def both_sides(opts, env, device="cpu"):
    """(JAX scene, options, cameras) and the port's copies on ``device``."""
    scene = jax_scene(env)
    options = default_options(**opts)
    cams = jax_cameras()
    npy = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    port = (
        scene_from_numpy(npy(scene), device),
        options_from_numpy(npy(options)),
        camera_from_numpy(npy(cams)),
    )
    return (scene, options, cams), port


def assert_images_match(got, want, frac):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    bad = (diff > 1e-3).any(axis=-1).mean()
    assert bad <= frac, f"{bad:.4%} pixels differ by more than 1e-3"
    assert float(np.median(diff)) < 1e-5


@pytest.mark.parametrize("name,opts,env", OPTION_CASES, ids=[c[0] for c in OPTION_CASES])
def test_plain_matches_pallas_interpret(name, opts, env):
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides(opts, env)
    ek = int(jscene["env"]["kind"])
    want = jfs.fused_progressive_sum(jscene, jopts, jcams, W, H, ek, interpret=True)
    before = tfs.LAUNCHES
    got = tfs.fused_progressive_sum(tscene, topts, tcams, W, H, ek)
    assert tfs.LAUNCHES == before  # the CPU path launches no kernel
    assert tuple(got.shape) == (H, W, 3) and got.dtype == torch.float32
    assert_images_match(got.numpy(), want, frac=0.005)


def test_packs_match_jax():
    (jscene, jopts, jcams), (tscene, topts, tcams) = both_sides({"debug": 2}, "gradient")
    np.testing.assert_array_equal(
        tfs.pack_cameras(tcams).numpy(), np.asarray(jfs.pack_cameras(jcams, False))
    )
    np.testing.assert_allclose(
        tfs.pack_consts(tscene, topts, 1).numpy(),
        np.asarray(jfs.pack_consts(jscene, jopts, 1)),
        rtol=1e-6, atol=1e-7,
    )


def test_cpu_wrapper_is_the_plain_version():
    _, (tscene, topts, tcams) = both_sides({}, "const")
    got = tfs.fused_progressive_sum(tscene, topts, tcams, W, H, 0)
    want = tfs.fused_progressive_sum_reference(tscene, topts, tcams, W, H, 0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_unported_modes_raise():
    _, (tscene, topts, tcams) = both_sides({}, "const")
    with pytest.raises(NotImplementedError):
        tfs.fused_progressive_sum(tscene, topts, tcams, W, H, 2)
    with pytest.raises(NotImplementedError):
        tfs.fused_progressive_sum(tscene, topts, tcams, W, H, 0, realtime=True)
    with pytest.raises(NotImplementedError):
        tfs.fused_progressive_sum(tscene, topts, tcams, W, H, 0, light_mc=True)
    one_light = dict(tscene, lights={"dir": tscene["lights"]["dir"]})
    assert not tfs.supports_fused(one_light, "progressive", False)
    with pytest.raises(NotImplementedError):
        tfs.fused_progressive_sum(one_light, topts, tcams, W, H, 0)
