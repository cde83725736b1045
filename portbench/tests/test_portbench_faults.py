"""The comparison that decides ``correct`` fails where it must: the
bfloat16 control (the reference in the program's place) and each fault a
cell can have, planted under the timed path of a whole run on the CPU at a
small size, read not correct under the committed limits; sound runs read
correct."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch
from conftest import SMALL

from portbench import control, harness

CELLS = list(SMALL)


def run_cell(root, cell, fault=None, seed=20260101):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds", "0.2"],
                         device="cpu", overrides=SMALL[cell], fault=fault, root=root)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = run_cell(root, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    limits = harness.cell_parts(harness.manifest(root), cell, root)["limits"]["numbers"]
    for r in control.readings(cell, [5, 6, 7], 0.2, device="cpu", overrides=SMALL[cell],
                              root=root):
        assert harness.judge.verdict(r["program"], limits)[0], r
        assert not harness.judge.verdict(r["control"], limits)[0], r


def unchanged(monkeypatch):
    """A step that returns its state unchanged: the accumulation, or the
    frames of the first dispatch, from then on."""
    from dxrexperiments_torch.models import realtime as rt_mod

    real = rt_mod.realtime_frames
    first = {}

    def frames(*a, **kw):
        if "out" not in first:
            first["out"] = real(*a, **kw)
        return first["out"]

    monkeypatch.setattr(rt_mod, "realtime_frames", frames)

    def plant(drv):
        if not drv.realtime:
            drv.pipe.render = lambda: drv.pipe.accum
    return plant


def half_batch(monkeypatch):
    """Half of the samples of a dispatch left out, the mean taken over the
    rest (progressive); half of the frames of a K-frame dispatch left out,
    the last rendered one shown in their place (realtime)."""
    from dxrexperiments_torch.models import progressive as prog_mod
    from dxrexperiments_torch.models import realtime as rt_mod
    from dxrexperiments_torch.ops import fused_sample

    def halve(fn):
        def sample_sum(scene, options, cameras, *a, **kw):
            keep = max(int(cameras["eye"].shape[0]) // 2, 1)
            scale = cameras["eye"].shape[0] / keep
            return fn(scene, options, {k: v[:keep] for k, v in cameras.items()}, *a, **kw) * scale
        return sample_sum

    monkeypatch.setattr(fused_sample, "fused_progressive_sum",
                        halve(fused_sample.fused_progressive_sum))
    monkeypatch.setattr(prog_mod, "progressive_sample_sum", halve(prog_mod.progressive_sample_sum))
    real = rt_mod.realtime_frames

    def frames(scene, options, cameras, *a, **kw):
        k = int(cameras["eye"].shape[0])
        keep = max(k // 2, 1)
        out = real(scene, options, {n: v[:keep] for n, v in cameras.items()}, *a, **kw)
        return {n: torch.cat([v, v[-1:].expand(k - keep, *v.shape[1:])]) for n, v in out.items()}

    monkeypatch.setattr(rt_mod, "realtime_frames", frames)
    return lambda drv: None


def altered(monkeypatch):
    """An answer altered where it is produced: the presented image, or the
    rendered direct light, 1% brighter."""
    from dxrexperiments_torch.models import realtime as rt_mod

    real = rt_mod.realtime_frames

    def frames(*a, **kw):
        out = dict(real(*a, **kw))
        out["direct"] = out["direct"] * 1.01
        return out

    monkeypatch.setattr(rt_mod, "realtime_frames", frames)

    def plant(drv):
        if not drv.realtime:
            get = drv.pipe.get_output
            drv.pipe.get_output = lambda index=0: get(index) * 1.01
    return plant


def aov_off_sample(monkeypatch):
    """Direct light 1% brighter at every pixel outside the sampled ones,
    where only the denoiser's inputs of the anchor tiles can see it."""
    from dxrexperiments_torch.models import realtime as rt_mod

    real, state = rt_mod.realtime_frames, {}

    def frames(*a, **kw):
        out = dict(real(*a, **kw))
        k = out["direct"].shape[0]
        flat = out["direct"].reshape(k, -1, 3).clone()
        off = torch.ones(flat.shape[1], dtype=torch.bool)
        off[state["pix"]] = False
        flat[:, off] *= 1.01
        out["direct"] = flat.reshape(out["direct"].shape)
        return out

    monkeypatch.setattr(rt_mod, "realtime_frames", frames)

    def plant(drv):
        state["pix"] = torch.as_tensor(drv.pix)
    return plant


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered,
          "aov_off_sample": aov_off_sample}


# Half of the batch exists where a dispatch holds several samples or frames:
# not in the one-frame realtime cell; AOVs, in the realtime cells alone.
REALTIME = ("instanced32_1080_realtime", "cornell1080_realtime_fif3")
CASES = [(c, f) for c in CELLS for f in FAULTS
         if not (f == "half_batch" and c == "instanced32_1080_realtime")
         and not (f == "aov_off_sample" and c not in REALTIME)]


@pytest.mark.parametrize(("cell", "fault"), CASES)
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    out = run_cell(root, cell, FAULTS[fault](monkeypatch))
    assert not out["correct"], out["checks"]
