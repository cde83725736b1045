"""The host side of ``kernel_ab.py`` (the megakernels against another
commit's sources on the card) and of ``utils/cuda_build.ptxas_counts`` on
the CPU: ptxas' counts, the sweep loops of a SASS listing and their summary
per pair test, and the count of pixels that differ in any bit.
"""

import torch

import kernel_ab as ab
from dxrexperiments_torch.utils import cuda_build

PTXAS_LOG = """ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPf
    56 bytes stack frame, 20 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers
"""

# one function with a 2-instruction loop that does no float work (skipped),
# and a sweep loop: 2 shared loads, 8 FFMAs, one pair test (its FSETP against
# 1e-12), branching back to its head
_FFMAS = "".join(f"        /*{0x50 + 16 * k:04x}*/  FFMA R4, R5, R6, R4 ;\n" for k in range(8))
SASS = """
        Function : _Z6kernelPf
        /*0000*/  MOV R1, c[0x0][0x28] ;
        /*0010*/  IADD3 R2, R2, 0x1, RZ ;
        /*0020*/  @P0 BRA 0x10 ;
        /*0030*/  LDS.128 R4, [R3] ;
        /*0040*/  LDS.128 R8, [R3+0x10] ;
""" + _FFMAS + """        /*00d0*/  FSETP.GT.AND P1, PT, R4, 9.9999999600419720025e-13, PT ;
        /*00e0*/  @!P1 BRA 0x30 ;
        /*00f0*/  EXIT ;
"""


def test_ptxas_counts():
    got = cuda_build.ptxas_counts(PTXAS_LOG)
    assert got == [
        {"kernel": "_Z6kernelPf", "stack": 56, "spill_stores": 20, "spill_loads": 36,
         "registers": 80},
        {"kernel": "_Z5otherv", "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 12},
    ]


def test_sweep_loops_and_summary():
    funcs = ab.sass_functions(SASS)
    assert list(funcs) == ["_Z6kernelPf"] and len(funcs["_Z6kernelPf"]) == 16
    loops = ab.loop_counts(funcs["_Z6kernelPf"])
    assert loops == [{"span": [0x30, 0xE0], "instructions": 12, "pair_tests": 1,
                      "counts": {"BRA": 1, "FFMA": 8, "FSETP": 1, "LDS.128": 2}}]
    (line,) = ab.loop_summary({"_Z6kernelPf": loops})
    assert line.startswith("1 loops of 1 pair test; per pair test 12 instructions: LDS.128 2, 9")


def test_differing_pixels_counts_bits():
    h, w = 4, 5
    a = (torch.zeros(2, h, w, 3), torch.zeros(2, h, w))  # a realtime pair: 2 frames
    b = (a[0].clone(), a[1].clone())
    assert ab.differing_pixels(a, b, h, w) == 0
    b[0][0, 0, 0, 2] = -0.0  # equal as a float, not as bits
    b[1][1, 2, 3] = 1.0
    b[1][0, 2, 3] = 1.0  # the same pixel in the other frame
    assert ab.differing_pixels(a, b, h, w) == 2
    img = torch.zeros(h, w, 3)  # a progressive sum
    other = img.clone()
    other[3, 4, 0] = 1e-30
    assert ab.differing_pixels((img,), (other,), h, w) == 1


def test_every_kernel_source_is_compared():
    """kernel_ab builds every CUDA source of the port in both trees: the
    trace kernels redesigned case by case, every other one held to the
    base's instructions."""
    import os

    sources = {f[:-3] for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cu")}
    assert set(ab.SOURCES.values()) == sources
    assert set(ab.REDESIGNED) <= set(ab.COMPARED) <= set(ab.SOURCES)
    assert ab.SOURCES["B3"] == "intersect_brute" and ab.SOURCES["B6a"] == "traverse2_fat"


def test_output_fields_and_differing_rays():
    from dxrexperiments_torch.ops import intersect_kernel as ik

    r = 6
    scal, vec, ids = torch.zeros(7, r), torch.zeros(5, r, 3), torch.zeros(3, r, dtype=torch.int64)
    fields = ab.output_fields("B3", False, (scal, vec, ids))
    assert list(fields) == [*ik.SCALARS, *ik.VECTORS, *ik.IDS]
    assert fields["position"].shape == (r, 3) and fields["tri"].dtype == torch.int64
    occ = torch.zeros(r, dtype=torch.bool)
    assert list(ab.output_fields("B6a", True, (occ,))) == ["occluded"]
    walk = ab.output_fields("B6a", False, tuple(torch.zeros(r) for _ in range(5)))
    assert list(walk) == ["t", "slot", "u", "v", "inst"]
    other = {k: v.clone() for k, v in fields.items()}
    assert set(ab.differing_rays(fields, other).values()) == {0}
    other["t"][1] = -0.0  # equal as a float, not as bits
    other["normal"][2, 1] = 1.0
    other["normal"][2, 2] = 1.0  # the same ray twice
    other["tri"][5] = -1
    diff = ab.differing_rays(fields, other)
    assert (diff["t"], diff["normal"], diff["tri"], diff["u"]) == (1, 1, 1, 0)
    occ2 = occ.clone()
    occ2[[0, 3]] = True
    assert ab.differing_rays({"occluded": occ}, {"occluded": occ2}) == {"occluded": 2}


def test_base_route_swaps_the_wrappers_launch():
    from dxrexperiments_torch.ops import intersect_kernel as ik
    from dxrexperiments_torch.ops import traverse2 as tv2

    for kernel, mod in (("B3", ik), ("B6a", tv2)):
        before = mod._launch
        route = ab.BaseRoute(kernel, lib=None)
        with route:
            assert mod._launch == route.launch
        assert mod._launch is before


def test_walk_loops_count_a_turn_outside_its_pair_tests():
    """A walk's loop over nodes (0x00-0xf0) holds the 2-instruction loop
    and the pair-test loop (0x30-0xe0): 16 instructions, 2 outside both."""
    code = ab.sass_functions(SASS.replace("/*00f0*/  EXIT ;",
                                          "/*00f0*/  BRA 0x0 ;\n        /*0100*/  EXIT ;"))
    code = code["_Z6kernelPf"]
    assert ab.walk_loops(code) == [{"span": [0x0, 0xF0], "instructions": 16, "own": 2,
                                    "pair_loops": 1}]
    assert ab.inside((0x30, 0xE0), (0x0, 0xF0)) and not ab.inside((0x0, 0xF0), (0x0, 0xF0))


def test_redesigned_kernels_and_b2_radii():
    """This tree's redesigns are B7 (the overlap probe on wgmma) and B5 (its
    walks postpone leaf tests per warp), compared case by case; B4d and B4c
    keep their trace cases beside B4a's (B4c one per packet layout of
    chip_smoke.GROUPINGS) and B4a as a yardstick; B2 keeps its bilateral
    cases at chip_smoke.py's radii; B1, B4a, B4b, B4c, B4d, B6b and B2 are
    held to the base's instructions."""
    import chip_smoke

    assert ab.REDESIGNED == ("B7", "B5")
    assert "B5" in ab.COMPARED and "B5" not in ab.TRACED
    assert "B7" in ab.COMPARED and "B7" not in ab.TRACED
    assert {"B4a", "B4d", "B4c"} <= set(ab.TRACED) and "B2" in ab.COMPARED
    assert "B2" not in ab.TRACED
    assert not {"B1", "B4a", "B4b", "B4c", "B4d", "B6b", "B2"} & set(ab.REDESIGNED)
    assert ab.B2_RADII == chip_smoke.BILATERAL_RADII and 12 in ab.B2_RADII
    assert set(ab.YARDSTICKS["B4a"]) == {("B4b", "binary"), ("B4d", "wide")}
    assert ("B4a", "fat") in ab.YARDSTICKS["B4d"] and ab.YARDSTICKS["B4c"] == (("B4a", "fat"),)
    assert {"B4c", "B4d"} <= set(ab.WALK_KERNELS)


def test_roofline_cases_cover_the_probes():
    """B7's cases: the FMA peak, the pair mix (on inputs where it stays
    finite) and chip_smoke.py's seven overlap settings, at roofline.py's
    size on seeded inputs."""
    from dxrexperiments_torch.ops import roofline as rf

    cases = list(ab.roofline_cases("cpu"))
    assert [c[1] for c in cases[:2]] == ["fma", "mix"]
    overlap = [c[1] for c in cases[2:]]
    assert overlap == [(False, True, 1)] + [(v, m, s) for s in (1, 2, 4)
                                            for v, m in ((True, False), (True, True))]
    a, b, mt, rays = cases[2][2]
    assert tuple(a.shape) == (rf.SUB, rf.LANES) and tuple(mt.shape) == (4 * rf.C_TRIS, rf.K)
    assert len(torch.unique(a)) > rf.SUB * rf.LANES // 2  # seeded: the elements differ
    assert torch.equal(cases[1][2][0], rf.mix_inputs("cpu", seed=37)[0])


def test_differing_channels_counts_bits():
    a = torch.zeros(4, 5, 3)
    b = a.clone()
    assert ab.differing_channels(a, b) == [0, 0, 0]
    b[0, 0, 0] = -0.0  # equal as a float, not as bits
    b[1, 2, 2] = 1e-30
    b[3, 4, 2] = float("nan")
    assert ab.differing_channels(a, b) == [1, 0, 2]


def test_base_route_swaps_the_fat_walk(monkeypatch):
    """B4a's route: ops.traverse's _launch while active, the other walks of
    the module (kind "binary", "grouped") passed on to the saved one."""
    from dxrexperiments_torch.ops import traverse as tv

    seen = []

    def wrapper(*a):
        seen.append(a[7])
        return "passed on"

    monkeypatch.setattr(tv, "_launch", wrapper)
    route = ab.BaseRoute("B4a", lib=None)
    assert (route.mod, route.kind) == (tv, "fat")
    with route:
        assert tv._launch == route.launch
        assert route.launch({}, None, None, 0.0, 1.0, False, False, "binary") == "passed on"
    assert seen == ["binary"] and tv._launch is wrapper


def test_walk_figures_of_the_fat_walk():
    """kernel_ab's step-1 figures of a B4a launch on the CPU (Cornell, 8,192
    rays, chip_smoke.COUNT_PIXELS of them in sampled warps): the postponed
    model returns the unpostponed walk's hits, tests no more pair slots and
    takes no fewer traversal turns; B4b's walk beside it."""
    import numpy as np

    from dxrexperiments_torch.app.headless import build_scene

    scene = build_scene("cornell-glossy")[0].build("cpu", accel="bvh")
    rng = np.random.default_rng(5)
    n = 8192
    lo, hi = scene["bvh"]["bvh_rows"][0, 0:3].numpy(), scene["bvh"]["bvh_rows"][0, 3:6].numpy()
    centre, size = (lo + hi) / 2, float((hi - lo).max())
    o = (centre + rng.normal(size=(n, 3)) * size).astype(np.float32)
    d = (centre + rng.uniform(-0.4, 0.4, (n, 3)) * size - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for occlusion in (False, True):
        fig = ab.walk_figures("B4a", scene, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                              torch.full((n,), 3.0e37 if not occlusion else 2.0), False,
                              occlusion, np.random.default_rng(1))
        assert fig["same_hits"] is True
        assert set(fig) == {"B4a unpostponed", "B4a", "B4b", "same_hits"}
        post, own = fig["B4a"], fig["B4a unpostponed"]
        assert post["pairs"] == own["pairs"] and post["turns"] == own["turns"] > 0
        assert post["p_slots"] <= own["slots"] and post["p_turns"] >= own["turns"]
        assert "p_slots" not in own


def _soup_rays(n: int, seed: int):
    """A 2,000-triangle soup's BVH on the CPU and n rays aimed at it."""
    import numpy as np

    from dxrexperiments_torch.app.headless import build_scene

    scene = build_scene("soup:2000")[0].build("cpu", accel="bvh")
    rng = np.random.default_rng(seed)
    lo, hi = scene["bvh"]["bvh_rows"][0, 0:3].numpy(), scene["bvh"]["bvh_rows"][0, 3:6].numpy()
    centre, size = (lo + hi) / 2, float((hi - lo).max())
    o = (centre + rng.normal(size=(n, 3)) * size).astype(np.float32)
    d = (centre + rng.uniform(-0.4, 0.4, (n, 3)) * size - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return scene, torch.as_tensor(o), torch.as_tensor(d)


def test_walk_figures_of_the_wide_walk():
    """kernel_ab's step-1 figures of a B4d launch on the CPU (a soup, 8,192
    rays, chip_smoke.COUNT_PIXELS of them in sampled warps): the postponed
    8-wide model returns the unpostponed walk's hits and makes its pair
    tests in no fewer traversal rounds; B4a's postponed walk beside it."""
    import numpy as np

    scene, o, d = _soup_rays(8192, 5)
    for occlusion in (False, True):
        fig = ab.walk_figures("B4d", scene, o, d, 1e-4,
                              torch.full((len(o),), 3.0e37 if not occlusion else 2.0), False,
                              occlusion, np.random.default_rng(1))
        assert fig["same_hits"] is True
        assert set(fig) == {"B4d unpostponed", "B4d", "B4a", "same_hits"}
        post, own = fig["B4d"], fig["B4d unpostponed"]
        assert post["pairs"] == own["pairs"] and post["turns"] == own["turns"] > 0
        assert post["p_turns"] >= own["turns"] and "p_slots" not in own


def test_packet_figures_of_the_grouped_walk():
    """kernel_ab's step-1 figures of a B4c launch on the CPU (a soup, 8,192
    rays, four sampled tiles of 1,024): warp packets walk fewer lane steps
    than tile packets, every figure's cost is its warp steps and slots
    weighed by B4a's constants, and the warp packet's t and occlusion equal
    B4a's model's."""
    import numpy as np

    scene, o, d = _soup_rays(8192, 6)
    for occlusion in (False, True):
        fig = ab.packet_figures(scene, o, d, 1e-4,
                                torch.full((len(o),), 3.0e37 if not occlusion else 2.0), False,
                                occlusion, np.random.default_rng(2), (1024, 4, False))
        assert set(fig) == {"B4c tile", "B4c", "B4a", "same_t"} and fig["same_t"] is True
        warp, tile = fig["B4c"], fig["B4c tile"]
        assert 0 < warp["lane_steps"] < tile["lane_steps"]
        assert warp["warp_steps"] * 32 == warp["lane_steps"]
        c_turn, c_pair = ab.B4A_COSTS[occlusion]
        for row in (warp, tile, fig["B4a"]):
            assert row["cost"] == c_turn * row["warp_steps"] + c_pair * row["slots"]
        assert fig["B4a"]["to_b4a"] == 1.0


def test_b5_lanes_are_warps_of_tiles():
    """B5's threads in launch order: 16 x 16 tiles in blockIdx order, a
    tile's threads row-major, so each warp of 32 is 16 x 2 pixels; threads
    past the image's right or bottom edge are -1, and every pixel is one
    thread."""
    import numpy as np

    w, h = 40, 20
    lanes = ab.b5_lanes(w, h)
    assert lanes.shape == (3 * 2 * 256,)
    np.testing.assert_array_equal(lanes[:16], np.arange(16))
    np.testing.assert_array_equal(lanes[16:32], w + np.arange(16))
    np.testing.assert_array_equal(lanes[256:272], 16 + np.arange(16))
    np.testing.assert_array_equal(lanes[512:520], 32 + np.arange(8))
    assert (lanes[520:528] == -1).all()  # x 40..47
    assert (lanes[768 + 4 * 16:1024] == -1).all()  # rows 20..31 of the second tile row
    np.testing.assert_array_equal(np.sort(lanes[lanes >= 0]), np.arange(w * h))


def _instanced2_frame(size=64):
    """'instanced:2' through a BVH on the CPU, and the realtime pipeline's
    frame-0 options and camera at size x size."""
    from dxrexperiments_torch.app.headless import build_scene
    from dxrexperiments_torch.models.realtime import RealtimeRaytracingPipeline

    sc, cam = build_scene("instanced:2")
    cam.set_aspect(size, size)
    rt = RealtimeRaytracingPipeline(size, size, seed=0, device="cpu")
    rt.set_camera(cam)
    rt.set_scene_data(sc.build("cpu", accel="bvh"))
    rt.update(elapsed_time=0.0, elapsed_frames=0)
    return rt.scene_data, rt.options, rt._camera_params


def test_walk_figures_of_b5_walks():
    """kernel_ab's figures of B5's realtime frame on the CPU ('instanced:2',
    64 x 64: every thread in sampled warps of B5's tiles): for each walk of
    the ray tree, the postponed model returns the unpostponed one's hits,
    makes the same pair tests and costs no more, and the sum over the walks
    costs less; every primary lane walks, the bounce and its shadow rays in
    fewer lanes a warp."""
    import numpy as np

    scene, options, camera = _instanced2_frame()
    fig = ab.b5_figures(scene, options, camera, 64, 64, "torch", np.random.default_rng(1))
    walks = ["primary closest", "depth-0 directional shadow", "depth-0 point shadow",
             "specular bounce closest", "depth-1 directional shadow", "depth-1 point shadow"]
    assert list(fig) == walks + ["total"]
    for walk in walks:
        f = fig[walk]
        assert f["same_hits"] is True, walk
        own, post = f["B5 unpostponed"], f["B5"]
        assert post["pairs"] == own["pairs"] and post["turns"] == own["turns"] > 0, walk
        assert post["p_cost"] <= own["cost"] and post["p_slots"] <= own["slots"], walk
        assert own["warps"] == post["warps"] > 0
    assert fig["primary closest"]["B5"]["lanes"] == 32.0
    assert fig["specular bounce closest"]["B5"]["lanes"] < 32.0
    total = fig["total"]
    assert total["lanes"] == 4096 and 0.0 < total["ratio"] < 1.0
    assert total["p_cost"] == sum(fig[w]["B5"]["p_cost"] for w in walks)


def test_b5_walks_live_lanes_and_rejected_rigs():
    """b5_walks on a few pixels: a shadow ray walks where its pixel's
    primary hits, a bounce where the hit is specular (a subset of the
    hits); an area light or the debug==2 estimator raises."""
    import pytest

    from dxrexperiments_torch.scene.lights import area_light

    scene, options, camera = _instanced2_frame(32)
    pixels = list(range(0, 1024, 7))
    walks = {w[0]: w for w in ab.b5_walks(scene, options, camera, 32, 32, pixels, "torch")}
    assert len(walks) == 6
    hit = walks["depth-0 directional shadow"][7]
    assert torch.equal(hit, walks["depth-0 point shadow"][7]) and 0 < int(hit.sum()) < len(pixels)
    assert bool(walks["primary closest"][7].all()) and walks["primary closest"][5] is True
    spec = walks["specular bounce closest"][7]
    assert bool((hit | ~spec).all()) and 0 < int(spec.sum()) < int(hit.sum())
    assert not bool((walks["depth-1 point shadow"][7] & ~spec).any())
    with pytest.raises(NotImplementedError):
        ab.b5_walks(scene, dict(options, debug=2), camera, 32, 32, pixels, "torch")
    rig = dict(scene, lights={"dir": scene["lights"]["dir"], "point": [],
                              "area": [area_light((0, 4, 0), (1, 0, 0), (0, 0, 1),
                                                  (1, 1, 1, 1))]})
    with pytest.raises(NotImplementedError):
        ab.b5_walks(rig, options, camera, 32, 32, pixels, "torch")


def test_lane_summary_of_a_histogram():
    """The engagement counter's figures: warps with a lane, their mean
    lanes and the share in each bin of LANE_BINS; a bin 0 count (no lane)
    is left out."""
    h = [0] * 33
    h[0], h[1], h[3], h[32] = 5, 2, 1, 1
    got = ab.lane_summary(h)
    assert got["count"] == 4 and got["mean"] == (2 + 3 + 32) / 4
    assert got["1-1"] == 0.5 and got["2-4"] == 0.25 and got["32-32"] == 0.25
    assert got["9-16"] == 0.0 and abs(sum(got[f"{a}-{b}"] for a, b in ab.LANE_BINS) - 1) < 1e-12
    assert ab.lane_summary([0] * 33) == {"count": 0, "mean": 0.0,
                                         **{f"{a}-{b}": 0.0 for a, b in ab.LANE_BINS}}


def test_builds_without_contraction_have_names_of_their_own():
    """--no-fmad builds every source of both trees with nvcc -fmad=false
    under a name of its own, so a build with contraction is never loaded
    in its place (cuda_build keys its loaded libraries by name)."""
    assert ab.library_name("B5") == "fused_traverse"
    assert ab.library_name("B5", (ab.NO_FMAD,)) == "fused_traverse_no_fmad"
    assert ab.library_name("B4a", ()) == ab.SOURCES["B4a"]
    assert ab.NO_FMAD == "-fmad=false" and ab.NO_FMAD not in cuda_build.NVCC_FLAGS
