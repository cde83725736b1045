"""The port imports torch and numpy only: no module under dxrexperiments_torch/,
nor chip_smoke.py, may load jax or dxrexperiments_tpu. Checked in a fresh interpreter, since
this test process has both loaded already."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import dxrexperiments_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke"]:
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
