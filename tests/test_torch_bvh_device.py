"""Port ``accel.bvh.build_bvh_device`` (the Morton build in torch on the
tensors' device) against the JAX package's ``build_bvh_device`` and the
host ``build_bvh``: ``order`` equal as integers to both, the node boxes
equal (after ``nan_to_num``), on a triangle soup, a re-baked scene with its
degenerate padding rows, and no triangle at all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrexperiments_torch import accel as taccel
from dxrexperiments_torch.accel import bvh as tbvh
from dxrexperiments_torch.scene import Material as TMaterial
from dxrexperiments_torch.scene import Scene as TScene
from dxrexperiments_torch.scene.dynamic import bake_instances, prepare_base
from dxrexperiments_torch.scene.procedural import box_mesh, random_triangle_soup
from dxrexperiments_tpu.accel import bvh as jbvh
from test_torch_cuda import bake_base_scene, one_thread, yaw_grid  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_thread")


def soup(n):
    m = random_triangle_soup(n, seed=3, extent=10.0)
    p = m.positions[m.indices]
    return p[:, 0].astype(np.float32), (p[:, 1] - p[:, 0]).astype(np.float32), (
        p[:, 2] - p[:, 0]).astype(np.float32)


def baked():
    base = prepare_base(bake_base_scene(TScene, TMaterial, box_mesh, "cpu"), 16)
    scene = bake_instances(base, yaw_grid(16))
    return tuple(scene[k].numpy() for k in ("v0", "e1", "e2"))


def finite(x):
    return np.nan_to_num(np.asarray(x), posinf=1e30, neginf=-1e30)


@pytest.mark.parametrize("case,leaf_size", [("soup", 8), ("soup", 32), ("baked", 8)])
def test_device_build_matches_jax_and_host(case, leaf_size):
    v0, e1, e2 = soup(700) if case == "soup" else baked()
    n = len(v0)
    got = taccel.build_bvh_device(*(torch.as_tensor(x) for x in (v0, e1, e2)), n, leaf_size)
    want = jbvh.build_bvh_device(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2), n, leaf_size)
    host = tbvh.build_bvh(v0, e1, e2, n, leaf_size)
    assert got["levels"] == want["levels"] == host["levels"]
    assert got["leaf_size"] == leaf_size and got["order"].dtype == torch.int32
    np.testing.assert_array_equal(got["order"].numpy(), np.asarray(want["order"]))
    np.testing.assert_array_equal(got["order"].numpy(), host["order"])
    for k in ("nodes_lo", "nodes_hi"):
        np.testing.assert_array_equal(finite(got[k]), finite(want[k]), err_msg=k)
        np.testing.assert_array_equal(finite(got[k]), finite(host[k]), err_msg=k)


def test_device_build_without_triangles():
    v0 = torch.zeros((8, 3))
    got = tbvh.build_bvh_device(v0, v0, v0, 0)
    host = tbvh.build_bvh(v0.numpy(), v0.numpy(), v0.numpy(), 0)
    np.testing.assert_array_equal(got["order"].numpy(), host["order"])
    np.testing.assert_array_equal(finite(got["nodes_lo"]), finite(host["nodes_lo"]))
