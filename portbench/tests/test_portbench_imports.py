"""Nothing the benchmark runs loads JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the reference renderer loads nothing of the port."""

import json
import os
import subprocess
import sys

from conftest import ROOT, SMALL

FORBIDDEN = {"jax", "jaxlib", "flax", "dxrexperiments_tpu"}


def top_level(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = ("import sys, json, io, contextlib; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "with contextlib.redirect_stdout(io.StringIO()):\n"
            "    harness.run(['--workload', 'cornell512_progressive', '--seed', '3', "
            "'--seconds', '0.1'], device='cpu', overrides=%r)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % (ROOT, SMALL["cornell512_progressive"]))
    mods = top_level(code)
    assert "dxrexperiments_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import portbench.reference, portbench.judge, portbench.roofline\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % ROOT)
    mods = top_level(code)
    assert not mods & (FORBIDDEN | {"dxrexperiments_torch"})


def test_forbidden_names_are_compared_whole():
    from portbench import harness

    sys.modules.setdefault("jaxlike_stub_for_test", type(sys)("jaxlike_stub_for_test"))
    assert "jaxlike_stub_for_test" not in harness.forbidden_modules()
    assert not (set(harness.forbidden_modules()) - FORBIDDEN)
    assert os.path.basename(ROOT)
