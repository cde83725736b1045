"""On the card: a short run of each cell at a small size goes through the
route's kernels and reads correct (marked ``cuda``; skips without a card)."""

import io
import json
from contextlib import redirect_stdout

import pytest
from conftest import SMALL

from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_small_run_on_the_card(root, cell, cuda_device):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.run(["--workload", cell, "--seed", "2147483659", "--seconds", "0.5"],
                         device=cuda_device, overrides=SMALL[cell], root=root)
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
