"""The port's graft entry (``dxrexperiments_torch/entry.py``) and
``models.progressive.progressive_step`` against the JAX package's.

``progressive_step`` renders through the integrator with the scene as an
argument: at 16^2 on the Cornell box its plain path is held against JAX's
jitted step (jnp on the CPU) at tests/test_torch_progressive.py's
cross-framework gate (>= 99% of pixels within 1e-3, mean |d| <= 1e-4), for
a first sample and for one folded into an accumulation. ``entry("cpu")``
runs its step; ``dryrun_multichip(2)`` runs the three sharded paths on two
spawned gloo ranks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch import entry as tentry
from dxrexperiments_torch.core import camera as tcam
from dxrexperiments_torch.models.progressive import progressive_step as t_step
from dxrexperiments_tpu.core import camera as jcam
from dxrexperiments_tpu.models.progressive import progressive_step as j_step
from dxrexperiments_tpu.scene import Scene as JScene
from dxrexperiments_tpu.scene import cornell_box as j_cornell
from dxrexperiments_tpu.scene import envmap as jenv
from dxrexperiments_tpu.scene.lights import directional_light, point_light
from dxrexperiments_tpu.trace import default_options as j_default_options

N = 16


def jax_setup():
    """JAX's ``__graft_entry__._cornell_setup`` at N^2."""
    mesh, materials = j_cornell(glossy_tall_box=True)
    sc = JScene()
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh)
    sc.lights = {
        "dir": directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
        "point": point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
    }
    sc.environment = jenv.constant_env((0.0, 0.0, 0.0))
    cam = jcam.Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(N, N)
    return sc.build(), cam


def assert_progressive_gate(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert np.isfinite(np.asarray(got)).all()
    assert (diff <= 1e-3).all(axis=-1).mean() >= 0.99
    assert diff.mean() <= 1e-4


@pytest.mark.parametrize("count", [0, 3], ids=["first_sample", "folded"])
def test_progressive_step_matches_jax(count):
    jscene, jcamera = jax_setup()
    tscene, _, _, _ = tentry._cornell_setup(N, N, 1, "cpu")
    tcamera = tcam.Camera()
    tcamera.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    tcamera.set_aspect(N, N)
    rng = np.random.default_rng(11)
    accum = rng.uniform(0, 1, (N, N, 3)).astype(np.float32) if count else np.zeros(
        (N, N, 3), np.float32)
    jitter = (0.1 / N, -0.2 / N)
    want = j_step(jscene, j_default_options(),
                  jcam.camera_params(jcamera, jitter=jitter, frame_count=5, accum_count=count),
                  jnp.asarray(accum), jnp.asarray(1024, jnp.int32), width=N, height=N)
    got = t_step(tscene, tentry.default_options(),
                 tcam.camera_params(tcamera, jitter=jitter, frame_count=5, accum_count=count),
                 torch.from_numpy(accum), 1024, N, N)
    assert_progressive_gate(got.numpy(), want)


def test_progressive_step_stops_at_max_iterations():
    scene, options, cams, accum = tentry._cornell_setup(N, N, 1, "cpu")
    cam = dict(cams[0], accum_count=torch.tensor(8.0))
    out = t_step(scene, options, cam, accum + 0.5, 8, N, N)
    assert torch.equal(out, accum + 0.5)


def test_entry_runs_on_the_cpu():
    fn, args = tentry.entry("cpu")
    scene, options, camera, accum, max_iterations = args
    assert accum.shape == (128, 128, 3) and accum.device.type == "cpu"
    out = fn(*args)
    assert out.shape == (128, 128, 3)
    assert bool(torch.isfinite(out).all()) and float(out.max()) > 0.0


def test_entry_defaults_to_the_card():
    """entry() builds on the card unless asked for the CPU; without a card
    it raises (no fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="cuda"):
        tentry.entry()


def test_dryrun_multichip_two_gloo_ranks(capsys):
    tentry.dryrun_multichip(2)
    out = capsys.readouterr().out
    for line in ("dryrun 1 (wavefront progressive, mesh 1x2) OK",
                 "dryrun 2 (sharded megakernel progressive) OK",
                 "dryrun 3 (realtime + halo denoise over 2 row blocks) OK",
                 "dryrun_multichip OK: 2 ranks, 3 paths green"):
        assert line in out
