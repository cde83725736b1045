"""Port the PRIME t_max table and its seeding against the JAX package's
(tests/test_prime_seed.py), on the same numpy-seeded scenes and rays.

Selection: the port's flat BVH build and two-level build carry the same
PRIME table as JAX's (equal arrays), and a triangle soup none.
``_prime_seed_tmax`` against JAX's within rtol 1e-6, with the same set of
seeded lanes except lanes within 1e-6 of a margin of the pre-test (the
barycentric and t margins, recomputed in float64), which are counted and
printed. The seed only tightens t_max, engages on the down-facing rays and
changes no closest hit of the plain walk (every field bit-equal), flat,
two-level and after a refit. A two-level render under ``DXR_PRIME=1``
equals one without it, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch.core import camera as tcam
from dxrexperiments_torch.scene import Material as TMaterial
from dxrexperiments_torch.scene import Scene as TScene
from dxrexperiments_torch.scene import scene as tscene
from dxrexperiments_torch.scene.dynamic import refit_scene_instances
from dxrexperiments_torch.scene.mesh import Mesh as TMesh
from dxrexperiments_torch.scene.procedural import random_triangle_soup as t_soup
from dxrexperiments_torch.scene.procedural import sphere_mesh as t_sphere
from dxrexperiments_torch.trace import integrator as tint
from dxrexperiments_tpu.scene import Scene as JScene
from dxrexperiments_tpu.scene import scene as jscene
from dxrexperiments_tpu.scene.materials import Material as JMaterial
from dxrexperiments_tpu.scene.mesh import Mesh as JMesh
from dxrexperiments_tpu.scene.procedural import sphere_mesh as j_sphere
from dxrexperiments_tpu.trace import integrator as jint
from test_torch_cuda import bounce_rays, grid_scene, one_thread  # noqa: F401

PRIME_KEYS = ("prime_v0", "prime_e1", "prime_e2")


pytestmark = pytest.mark.usefixtures("one_thread")


def both(build):
    jsc = grid_scene(JScene, JMaterial, JMesh, j_sphere)
    tsc = grid_scene(TScene, TMaterial, TMesh, t_sphere)
    if build == "flat":
        return jsc.build(accel="bvh"), tsc.build("cpu", accel="bvh")
    return jsc.build_two_level(), tsc.build_two_level("cpu")


def masked_tmax(n):
    active = np.ones((n,), bool)
    active[::7] = False  # the production stage's inactive lanes: t_max = 0
    return active, np.where(active, tint.RAY_MAX_T, 0.0).astype(np.float32)


def margin_lanes(pv0, pe1, pe2, o, d, tol=1e-6):
    """Rays whose pre-test against some PRIME triangle lies within `tol`
    of one of its margins (u, v >= 1e-3, u + v <= 1 - 1e-3, t >= 2 t_min),
    in float64: float32 evaluation order may decide those either way."""
    o, d = o[:, None].astype(np.float64), d[:, None].astype(np.float64)
    v0, e1, e2 = (x[None].astype(np.float64) for x in (pv0, pe1, pe2))
    pvec = np.cross(d, e2)
    det = np.sum(e1 * pvec, -1)
    inv = 1.0 / np.where(np.abs(det) > 1e-12, det, 1.0)
    tvec = o - v0
    qvec = np.cross(tvec, e1)
    u = np.sum(tvec * pvec, -1) * inv
    v = np.sum(d * qvec, -1) * inv
    t = np.sum(e2 * qvec, -1) * inv
    near = [np.abs(x) <= tol for x in (u - 1e-3, v - 1e-3, 1.0 - 1e-3 - u - v,
                                       t - 2.0 * tint.RAY_EPSILON)]
    return np.logical_or.reduce(near).any(axis=1)


def test_prime_selection_flat_and_soup():
    assert (tscene.PRIME_MAX, tscene.PRIME_AREA_FRAC) == (jscene.PRIME_MAX, jscene.PRIME_AREA_FRAC)
    jd, td = both("flat")
    for k in PRIME_KEYS:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]), err_msg=k)
    areas = 0.5 * np.linalg.norm(np.cross(td["prime_e1"].numpy(), td["prime_e2"].numpy()), axis=-1)
    assert areas.max() > 100.0  # the floor's two 800-area triangles
    v0, e1, e2 = (td[k].numpy() for k in ("v0", "e1", "e2"))
    np.testing.assert_array_equal(tscene.select_prime_triangles(v0, e1, e2),
                                  jscene.select_prime_triangles(v0, e1, e2))
    soup = TScene()
    soup.add_model(t_soup(5000, seed=0, extent=10.0))
    assert "prime_v0" not in soup.build("cpu", accel="bvh")  # nothing dominates
    assert len(tscene.select_prime_triangles(v0[:0], e1[:0], e2[:0])) == 0


def test_prime_selection_two_level():
    jd, td = both("two_level")
    for k in PRIME_KEYS:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]), err_msg=k)
    src = td["tlas_meta"]["prime_src"]
    assert len(src["inst"]) == len(td["prime_v0"]) and src["inst"].dtype == torch.int64


@pytest.mark.parametrize("build", ["flat", "two_level"])
def test_seed_matches_jax_and_changes_no_hit(build):
    jd, td = both(build)
    o, d = bounce_rays()
    active, t_full = masked_tmax(len(o))
    want = np.asarray(jint._prime_seed_tmax(jd, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(t_full)))
    to, tdir, tfull = (torch.as_tensor(x) for x in (o, d, t_full))
    got = tint._prime_seed_tmax(td, to, tdir, tfull).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    seeded_got, seeded_want = got < t_full, want < t_full
    near = margin_lanes(*(td[k].numpy() for k in PRIME_KEYS), o, d)
    differ = seeded_got != seeded_want
    print(f"{build}: seeded lanes {int(seeded_got.sum())} (JAX {int(seeded_want.sum())}), "
          f"differing {int(differ.sum())}, of which within 1e-6 of a margin "
          f"{int((differ & near).sum())}; lanes within 1e-6 of a margin {int(near.sum())}")
    assert not (differ & ~near).any()
    assert seeded_got[active].sum() > 50 and (got[~active] == 0.0).all()
    assert (got <= t_full).all()
    h0 = tint._trace_closest(td, to, tdir, tint.RAY_EPSILON, tfull, cull=False, impl="torch")
    h1 = tint._trace_closest(td, to, tdir, tint.RAY_EPSILON, torch.as_tensor(got), cull=False,
                             impl="torch")
    for a, b in zip(h0[:3], h1[:3]):
        assert torch.equal(a, b)
    for k in h0[3]:
        assert torch.equal(h0[3][k], h1[3][k]), k


def test_seeding_parity_after_refit():
    td = both("two_level")[1]
    tfs = np.stack([inst.transform for inst in grid_scene(
        TScene, TMaterial, TMesh, t_sphere).instances]).copy()
    tfs[:, 1, 3] += 0.75
    scene = refit_scene_instances(td, tfs)
    o, d = (torch.as_tensor(x) for x in bounce_rays(seed=11))
    t_full = torch.full((o.shape[0],), tint.RAY_MAX_T)
    t_seeded = tint._prime_seed_tmax(scene, o, d, t_full)
    assert int((t_seeded < tint.RAY_MAX_T * 0.5).sum()) > 50
    h0 = tint.walk_functions(scene, "torch")[0](scene, o, d, tint.RAY_EPSILON, t_full)
    h1 = tint.walk_functions(scene, "torch")[0](scene, o, d, tint.RAY_EPSILON, t_seeded)
    for k in h0:
        assert torch.equal(h0[k], h1[k]), k


def test_two_level_render_with_prime_equals_without(monkeypatch):
    scene = both("two_level")[1]
    cam = tcam.Camera()
    cam.set_eye_at_up((6.0, 5.0, 7.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(24, 24)
    params = tcam.camera_params(cam, jitter=(0.1 / 24, 0.2 / 24), frame_count=7)
    calls = []
    seed_fn = tint._prime_seed_tmax
    monkeypatch.setattr(tint, "_prime_seed_tmax", lambda *a: calls.append(1) or seed_fn(*a))
    images = []
    for prime in ("0", "1"):
        monkeypatch.setenv("DXR_PRIME", prime)
        images.append(tint.render_sample(scene, tint.default_options(), params, 24, 24,
                                         impl="torch")["color"])
    assert len(calls) == 1 and float(images[0].mean()) > 0.0
    assert torch.equal(images[0], images[1])
