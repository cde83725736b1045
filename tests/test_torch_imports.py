"""The port imports torch and numpy only: no module under dxrexperiments_torch/,
nor chip_smoke.py or kernel_ab.py, may load jax or dxrexperiments_tpu. Checked in a
fresh interpreter, since this test process has both loaded already."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import dxrexperiments_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke", "kernel_ab"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "dxrexperiments_tpu")))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parallel_modules_are_walked():
    """The multi-GPU modules are among the modules the check above imports."""
    import pkgutil

    import dxrexperiments_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    assert {"dxrexperiments_torch.parallel", "dxrexperiments_torch.parallel.render",
            "dxrexperiments_torch.parallel.launch"} <= names


def test_front_end_modules_are_walked():
    """The front ends, the loaders, the entry and the input helpers are among
    the modules the check above imports."""
    import pkgutil

    import dxrexperiments_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    assert {f"dxrexperiments_torch.{m}" for m in (
        "entry", "app.viewer", "app.headless", "scene.mesh", "scene.gltf", "scene.fbx",
        "scene.collada", "core.timer", "core.camera_controller", "core.gamepad",
        "utils.profiling", "utils.native")} <= names
