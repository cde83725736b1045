"""Port denoiser (B2's plain version, the compositor) vs the JAX package, on
the CPU, and the realtime + denoise slice as a whole.

Tolerance: atol 2e-5, that of tests/test_bilateral_pallas.py, for the
bilateral passes (against the JAX XLA reference and the Pallas kernel in
interpret mode) and for the composited image; the tap weights and the
parameter conversion are exact. Inputs come from np.random.default_rng.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.core.camera import Camera as TCamera
from dxrexperiments_torch.models import denoise as tden
from dxrexperiments_torch.models.realtime import RealtimeRaytracingPipeline as TPipeline
from dxrexperiments_torch.ops import bilateral as tbil
from dxrexperiments_torch.ops.kernel import launch_counts
from dxrexperiments_torch.scene import Scene as TScene
from dxrexperiments_torch.scene import cornell_box as t_cornell_box
from dxrexperiments_torch.scene.convert import denoise_params_from_numpy
from dxrexperiments_tpu.core.camera import Camera
from dxrexperiments_tpu.models import denoise as jden
from dxrexperiments_tpu.models.realtime import RealtimeRaytracingPipeline as JPipeline
from dxrexperiments_tpu.ops.bilateral_pallas import bilateral_pass as j_bilateral_pallas
from dxrexperiments_tpu.scene import Scene, cornell_box

ATOL = 2e-5


def _data(h=40, w=52, seed=0):
    """The inputs of tests/test_bilateral_pallas.py: a uniform image and a
    guide with a hard vertical edge plus noise."""
    rs = np.random.default_rng(seed)
    inp = rs.uniform(0, 1, (h, w, 3)).astype(np.float32)
    guide = np.zeros((h, w, 3), np.float32)
    guide[:, w // 2 :] = 0.8
    guide += rs.uniform(0, 0.05, (h, w, 3)).astype(np.float32)
    return inp, guide


def _hdr_pair(h=24, w=36, seed=4):
    """A dark HDR direct image (so the colour weights stay open) and a
    sparse indirect-specular image."""
    rs = np.random.default_rng(seed)
    direct = (rs.uniform(0, 0.08, (h, w, 3)) * rs.uniform(0, 4, (h, w, 1))).astype(np.float32)
    spec = (rs.uniform(0, 2, (h, w, 3)) * (rs.uniform(0, 1, (h, w, 1)) > 0.6)).astype(np.float32)
    return direct, spec


@pytest.mark.parametrize("radius", [1, 7, 12, 25])
@pytest.mark.parametrize("axis", [0, 1])
def test_plain_pass_matches_jax(axis, radius):
    inp, guide = _data(seed=axis * 10 + radius)
    got = tden._bilateral_pass(torch.from_numpy(inp), torch.from_numpy(guide), float(radius), axis)
    r = jnp.asarray(float(radius))
    want_xla = np.asarray(jden._bilateral_pass(jnp.asarray(inp), jnp.asarray(guide), r, axis=axis))
    want_pallas = np.asarray(j_bilateral_pallas(jnp.asarray(inp), jnp.asarray(guide), r,
                                                axis=axis, interpret=True))
    np.testing.assert_allclose(got.numpy(), want_xla, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=ATOL, rtol=0)


def test_tap_weights_match_jax():
    for radius in (0.0, 1.0, 2.5, 7.0, 12.0, 19.3, 25.0):
        got = np.float32([tden._tap_weight(i, radius) for i in range(-25, 26)])
        want = np.float32([jden._tap_weight(i, jnp.float32(radius)) for i in range(-25, 26)])
        np.testing.assert_array_equal(got, want, err_msg=str(radius))


def test_cpu_wrapper_is_the_plain_version():
    inp, guide = _data(37, 53, seed=9)
    a, b = torch.from_numpy(inp), torch.from_numpy(guide)
    before = launch_counts()["B2"]
    for axis in (0, 1):
        got = tbil.bilateral_pass(a, b, 12.0, axis)
        torch.testing.assert_close(got, tden._bilateral_pass(a, b, 12.0, axis), rtol=0, atol=0)
    assert launch_counts()["B2"] == before  # the CPU path launches no kernel
    with pytest.raises(ValueError):
        tbil.bilateral_pass(a, b, 12.0, 2)
    with pytest.raises(TypeError):
        tbil.bilateral_pass(a.double(), b, 12.0, 0)
    with pytest.raises(ValueError):
        tbil.bilateral_pass(a, b[:-1], 12.0, 0)


def _as_f32(params):
    """Float leaves rounded to float32, the precision both packages use."""
    return {k: np.float32(v) if isinstance(v, float) else v for k, v in params.items()}


def test_params_from_numpy():
    jp = jden.default_denoise_params(max_kernel_size=7, tonemap=False, exposure=1.3)
    got = denoise_params_from_numpy(jax.tree.map(np.asarray, jp))
    assert _as_f32(got) == _as_f32(
        tden.default_denoise_params(max_kernel_size=7, tonemap=False, exposure=1.3)
    )
    assert isinstance(got["max_kernel_size"], int) and isinstance(got["tonemap"], bool)
    assert isinstance(got["gamma"], float) and got["exposure"] == float(np.float32(1.3))
    assert _as_f32(denoise_params_from_numpy(
        jax.tree.map(np.asarray, jden.default_denoise_params())
    )) == _as_f32(tden.default_denoise_params())


@pytest.mark.parametrize("gamma_correct", [False, True], ids=["linear", "gamma"])
@pytest.mark.parametrize("tonemap", [False, True], ids=["raw", "tonemap"])
@pytest.mark.parametrize("debug", [0, 1, 2, 3])
def test_composite_matches_jax(debug, tonemap, gamma_correct):
    direct, spec = _hdr_pair(seed=debug)
    jp = jden.default_denoise_params(debug_visualize=debug, tonemap=tonemap,
                                     gamma_correct=gamma_correct, exposure=1.5,
                                     max_kernel_size=9)
    want = jden.denoise_composite(jnp.asarray(direct), jnp.asarray(spec), jp, impl="jnp")
    params = denoise_params_from_numpy(jax.tree.map(np.asarray, jp))
    got = tden.denoise_composite(torch.from_numpy(direct), torch.from_numpy(spec), params)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_compositor_temporal_and_mocks_match_jax():
    jc = jden.DenoiseCompositor(temporal_alpha=0.3)
    tc = tden.DenoiseCompositor(temporal_alpha=0.3, device="cpu")
    for f in range(3):
        if f == 2:
            jc.reset_history()
            tc.reset_history()
        for k in range(2):
            direct, spec = _hdr_pair(seed=20 + 2 * f + k)
            want = jc.dispatch(jnp.asarray(direct), jnp.asarray(spec))
            got = tc.dispatch(torch.from_numpy(direct), torch.from_numpy(spec))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

    direct, spec = _hdr_pair(seed=31)
    jm = jden.DenoiseCompositor()
    tm = tden.DenoiseCompositor(device="cpu")
    with pytest.raises(ValueError):
        tm.dispatch()
    jm.load_mock_resources(direct, spec)
    tm.load_mock_resources(direct, spec)
    assert tm.mock_inputs[0].device.type == "cpu"
    np.testing.assert_allclose(tm.dispatch().numpy(), np.asarray(jm.dispatch()),
                               atol=ATOL, rtol=0)


def test_realtime_denoise_slice_matches_jax():
    """Pipeline + compositor, 2 frames at 32x24: each frame's AOVs pass the
    image gate of tests/test_torch_realtime.py, and the display image is
    held against the JAX slice's to 2e-5 (no AOV pixel of this scene is a
    knife-edge case, so the denoised image agrees everywhere)."""
    w, h = 32, 24
    pipes = []
    for pipe_cls, cam_cls, sc_cls, box, kw in (
        (JPipeline, Camera, Scene, cornell_box, {}),
        (TPipeline, TCamera, TScene, t_cornell_box, {"device": "cpu"}),
    ):
        sc = sc_cls()
        mesh, materials = box(glossy_tall_box=True)
        for m in materials:
            sc.add_material(m)
        sc.add_model(mesh)
        cam = cam_cls()
        cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
        cam.set_aspect(w, h)
        pipe = pipe_cls(w, h, seed=5, **kw)
        pipe.set_camera(cam)
        pipe.set_scene(sc)
        pipes.append(pipe)
    jpipe, tpipe = pipes
    jc = jden.DenoiseCompositor()
    tc = tden.DenoiseCompositor(device="cpu")
    for f in range(2):
        jpipe.update(0.0, f)
        tpipe.update(0.0, f)
        jd, js = jpipe.render()
        td, ts = tpipe.render()
        for got, want in ((td, jd), (ts, js)):
            diff = np.abs(got.numpy() - np.asarray(want))
            assert (diff > 1e-3).any(axis=-1).mean() <= 0.005
            assert float(np.median(diff)) < 1e-5
        got = tc.dispatch(td, ts).numpy()
        assert np.isfinite(got).all() and got.mean() > 0.0
        np.testing.assert_allclose(got, np.asarray(jc.dispatch(jd, js)), atol=ATOL, rtol=0)
