#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. the build of every csrc/*.cu with nvcc (utils/cuda_build.py) and of
     csrc/sah_bvh.cpp with g++, all started together, with seconds and
     ptxas' registers, stack frames and spills per kernel;
  3. kernel vs plain PyTorch parity on the card: the progressive megakernel
     on Cornell-glossy at 128^2, S = 4 samples per launch, for each option
     set of the CPU tests; the realtime megakernel at 128^2 (defaults,
     debug 2, gradient env, glowing walls, and an S = 2 frame batch against
     two single-frame launches, equal to 1e-6); the bilateral kernel (B2)
     on a 1080x1920 and a 37x53 image, both axes, radii 1, 7, 12 and 25;
  4. the progressive main path: ProgressiveRaytracingPipeline on cuda at
     512^2, 16 samples per frame, 8 frames (128 spp), which must launch the
     kernel exactly 8 times and give a finite image with mean > 0; the first
     frame's kernel sum against the plain version at 512^2; and the headless
     CLI at 512^2, 32 spp, as a subprocess;
  5. the realtime + denoise main path (BASELINE config 4): 1920x1080,
     RealtimeRaytracingPipeline + DenoiseCompositor at its defaults, 8
     frames of update / render / dispatch, which must count 8 realtime and
     16 bilateral launches and give a finite display image with mean > 0;
     frame 0's AOVs against the plain version at 1080p, and its display
     against the plain denoiser on the same AOVs; and the headless CLI with
     --pipeline realtime --denoise at 1080p, as a subprocess;
  6. times from CUDA events after a warm-up: ms per 16-sample progressive
     dispatch, per 1080p realtime frame and per bilateral pass, each beside
     its plain version; and the realtime + denoise frame on the host clock,
     with the host's enqueue time of update, render and dispatch and of the
     two per-frame packs;
  7. BVH kernels vs plain on 'instanced:4' (15,362 triangles) at 128^2: the
     fat-node walk (B4a, csrc/traverse_fat.cu) closest hits on primary rays
     and occlusion on shadow rays against the brute-force sweep; the
     fused-traversal kernel (B5, csrc/fused_traverse.cu) progressive, S = 4,
     for the 7 option sets of phase 3, and realtime on every AOV (the 4
     cases of phase 3, and an S = 2 batch against two single launches);
  8. the BVH main path at full width, 'instanced:32' (BASELINE config 5
     flattened, 983,042 triangles) at 512^2: the build (its seconds and the
     builder, SAH or Morton), ProgressiveRaytracingPipeline for 4 dispatches
     of S = 4 (must count 4 B5 and 0 B1 launches), one render_sample frame
     through the wavefront route (must count 2 closest and 2 any B4a
     launches; their inputs are kept), B5's 1-sample image against that
     frame on the image gate, B5's and that frame's pixels against the plain
     version (the integrator with brute-force traces) on 4,096 sampled
     pixels, B4a closest against the brute-force sweep on 4,096 sampled rays
     of each of the frame's closest launches (primary, bounce) and any on
     shadow rays toward SHADOW_LIGHT, and the headless CLI on the same scene
     at 512^2, 8 spp;
  9. realtime + denoise on 'instanced:32' at 1920x1080, 4 frames (must count
     4 B5 realtime and 8 bilateral launches), frame 0's AOVs against the
     wavefront route's, and B5's every AOV against the plain version on
     4,096 sampled pixels, and the headless CLI with --pipeline realtime
     --denoise on the same scene at 1080p;
 10. BVH times: B5 ms per sample (progressive) and per 1080p frame, B4a ms
     for each of the wavefront frame's four launches on its own inputs, each
     with its plain version and the kernel again at the plain version's
     shape ('instanced:4', 128^2); the host ms per frame of both pipelines,
     the realtime one with the kernels' error flags read later (as the
     wrappers do) and read right after each B5 launch;
 11. the two-level walk (B6a, csrc/traverse2_fat.cu) vs its plain version
     (every instance's triangles in object space) on 128^2 probe rays:
     closest hits (hit gate, and the instance slot on rays that hit the
     same triangle) and occlusion on shadow rays toward SHADOW_LIGHT, on
     tests/test_tlas.py's 5-instance scene (a third of its shadow rays with
     zero directions, never occluded), 'instanced:4' two-level and a
     single-instance TLAS;
 12. the two-level main path at full width: 'instanced:32' through
     Scene.build_two_level (BASELINE config 5 as written: 1,025 instances
     of 2 meshes, 983,042 triangles), its build seconds and bytes on the
     card, ProgressiveRaytracingPipeline for 4 dispatches of S = 4 (must
     count 32 closest and 32 any B6a launches and no B1, B4a or B5 launch);
     the first dispatch's first sample through the wavefront route against
     phase 8's B5 image of the flattened scene on the image gate (same
     camera, same seeds); B6a against the plain versions on 4,096 sampled
     rays of each of that frame's four launches; 4 animated frames
     (set_instance_transforms with the CLI's yaw, 0.05 rad per frame; must
     count 16 + 16 B6a launches), then B6a's closest hits on 4,096 sampled
     primary rays against a brute-force sweep of the flattened scene built
     at the last frame's transforms (hit/miss disagreement <= 1%, relative
     t within the hit gate's bounds; triangle ids differ between the
     builds); and the headless CLI with --accel two-level
     --animate-instances at 512^2, 8 spp;
 13. realtime + denoise at 1920x1080 on the two-level scene, 2 frames (must
     count 4 closest and 4 any B6a and 4 bilateral launches; AOVs and the
     display finite);
 14. two-level times: B6a ms for each of the wavefront frame's four launches
     on its own inputs with the host model's walk counts (ops/traverse2.
     fat_walk2_numpy) on 4,096 rays of sampled spans of whole warps, its
     bound and its ratio to the bound, each launch's live-ray share and the
     warp figures (walk2_figures: a walk nested per level against one loop
     over both, the idle lane shares), the host ms per refit and per
     progressive dispatch, and B6a beside its plain versions at
     'instanced:4' two-level, 128^2;
 15. the brute-force trace kernels (B3, csrc/intersect_brute.cu) vs their
     plain versions at 128^2 on Cornell-glossy (40 padded triangles),
     'instanced:1' (962 -> 1,024) and 'instanced:2' (3,842 -> 4,096):
     closest on primary rays (culled) and on bounce rays (not culled, the
     inactive lanes' window empty), on the hit gate with the fused
     attributes (normal within 1e-5 on 99.9% of rays, the position within
     the hit gate's bounds, material rows equal); any on shadow rays toward
     a point light, a third at zero direction, with per-ray t_max;
 16. the brute-force wavefront main path at full width, 'instanced:2' (the
     largest procedural scene below the BVH threshold, nothing cut) at
     512^2: ProgressiveRaytracingPipeline for 4 dispatches of S = 4 (must
     count 32 closest and 32 any B3 launches and no B1, B4a, B5 or B6a
     launch); the first sample through the wavefront route, against the
     plain version on 4,096 sampled pixels, and B3 against the plain
     versions on every ray of each of its four launches (the plain sweep in
     slices of PLAIN_SLICE rays; the hit, attribute and occlusion gates on
     the whole launch, so that no draw decides them), with a census of each
     closest launch's tail (tail_census: the grazing angle and origin
     distance of the hits whose t or normal errors exceed 1e-5) and, not
     gated, the attribute numbers on a 4,096-ray draw; realtime
     + denoise at 1920x1080, 2 frames (4 + 4 B3 and 4 B2 launches); Cornell
     with --ao-only (1 closest and 4 any per sample) and cornell-glass with
     --refraction (a 3N-ray bounce launch) at 512^2, and Cornell with a
     2 directional + 2 point + 1 area rig at 128^2, each a 4-sample
     dispatch against the plain version on 4,096 sampled pixels; the
     headless CLI for 'instanced:2', --ao-only and cornell-glass
     --refraction;
 17. B3 times: each of the four launches of one 'instanced:2' wavefront
     sample on its own inputs (kernel alone and through the wrapper), the
     plain versions at 128^2, the pair tests for the bound (every pair of a
     live ray for closest; up to the first blocker for any; counted on
     every ray from the plain sweep's verdicts), the ratio to the bound, the
     live-ray share and the lane figures (ops/intersect_kernel.
     sweep_figures), and the host ms per progressive dispatch, enqueued and
     synchronised.

 18. texture envs: an 8192x4096 lat-long radiance (the size of the 8K
     lat-long the JAX package's config-3 run loads; a sky gradient, a small
     sun of radiance 50, seeded noise) written as an RLE .hdr and a
     6x512x512 R16G16B16A16_FLOAT DX10 cubemap .dds, both from a seed into
     a temporary directory, read back through the CLI's parse_env;
 19. B1 with each texture env vs plain on Cornell-glossy at 128^2 (a camera
     that sees the env past the box; the scene routes to B1 through its
     tex_autoroute BVH): progressive, S = 4, the 7 option sets of phase 3;
     realtime, every AOV, the 4 cases of phase 3 and an S = 2 batch against
     two single launches;
 20. B5 with each texture env vs plain on 'instanced:4' at 128^2, the same
     cases;
 21. BASELINE config 3: Cornell-glossy with phase 18's lat-long env,
     ProgressiveRaytracingPipeline on cuda at
     1920x1080 for 128 dispatches of S = 8 (1,024 spp), which must count
     128 B1 launches and no B3, B4a, B5 or B6a launch and give a finite
     image with mean > 0; the first dispatch's sum against the plain version
     at full size; the headless CLI with --env latlong:PATH at 1080p;
 22. realtime + denoise with the lat-long env at 1920x1080, 4 frames (must
     count 4 B1 realtime and 8 bilateral launches), frame 0's AOVs against
     the plain version, the CLI with --pipeline realtime --denoise;
 23. B5 with the cubemap at full width: phase 8's 'instanced:32' build with
     the cubemap swapped in, 512^2, 2 dispatches of S = 4 (exactly 2 B5
     launches), a sample against the plain version on 4,096 sampled pixels,
     the same pixels and camera with the gradient env against its plain
     version, each pixel off with the cubemap beside the wavefront route
     (B4a's walk with the plain lookup) on the same rays and where that
     route's path and the plain one part (a triangle, a bounce's hit, a
     shadow ray, a miss direction, a cube-face tie) or a trace lies on a
     knife edge (phase 28's census), failing if B5 parts from that route
     where neither holds; and B5's time with the cubemap
     and with the gradient env on the same cameras, in turns;
 24. the wavefront routes with the lat-long env at 128^2 against the plain
     version: Cornell with the 2 directional + 2 point + 1 area rig (B3) and
     'instanced:4' two-level (B6a);
 25. config 3 times: B1 ms per 8-sample 1080p dispatch with the lat-long env
     and with the black constant env on the same scene and cameras, in
     turns; the plain version's; the host ms per dispatch, enqueued and
     synchronised; the seconds to 1,024 spp of phase 21.

 26. B5's area-light mode vs plain at 128^2: tests/test_fused_traverse.py's
     area Cornell (its own BVH, 1 directional + 1 area light), progressive
     S = 4 on the 7 option sets of phase 3, realtime on every AOV (the 4
     cases of phase 3) and an S = 2 batch against two single launches;
     'instanced:4' with its rig set to 1 directional + 1 area light (3
     option sets, 2 realtime cases, the batch); the kernel's and the plain
     version's times there;
 27. B5's albedo-texture mode vs plain at 128^2: cornell-tex built as the
     CLI builds it (its tex_autoroute BVH) and the area Cornell with a
     textured floor under phase 18's cubemap, progressive S = 4 with the
     options {}, debug 2, no_indirect_diffuse and show_gbuffer_albedo_only;
 28. the config-2 stand-in at full size, the slice's main path (BASELINE
     config 2's shape without its files: a 960-triangle sphere for
     susanne, a 20 x 20 quad ground grid with the checker texture for
     ground.fbx, phase 18's cubemap for CathedralRadiance.dds, 1
     directional + 1 area light; 1,760 triangles):
     ProgressiveRaytracingPipeline at 512^2 for 8 dispatches of S = 8,
     which must count exactly 8 B5 launches and no B1, B3, B4a, B6a or B5
     realtime launch; the first dispatch against the plain version on
     4,096 sampled pixels, each of its samples also launched alone (the 8
     launches must add up to the dispatch) and held, pixel by pixel,
     against the plain version and the wavefront route on the same rays:
     each pixel-sample off by more than 1e-3 gets its cause (where the
     wavefront route's path and the plain one part: a triangle, a bounce's
     hit, an area light's or another shadow ray, a miss direction, a
     cube-face tie; else a knife edge, a trace of it that a perturbation of
     1e-4 of its direction and 1e-6 x max(1, |o|) of its origin flips), failing if B5 parts from that route where the path
     agrees and no trace lies on a knife edge; B5 ms per dispatch (the
     launch alone and through the wrapper), spp/s, the plain version's ms
     per sample, the host ms per dispatch enqueued and synchronised, the
     bound; then 2 realtime + denoise frames at 1080p (the wavefront route,
     B4a + the albedo glue + B2: exactly 4 + 4 B4a and 4 bilateral
     launches), frame 0's AOVs against the plain version on 4,096 sampled
     pixels (the route on those pixels' rays, and the pipeline's own
     direct and specular AOVs);
 29. B5's area mode at config 5's size: phase 8's 'instanced:32' with its
     rig set to 1 directional + 1 area light, 2 dispatches of S = 4 at
     512^2 (exactly 2 B5 launches), a sample against the plain version on
     4,096 sampled pixels with phase 28's census of the pixels off, B5's
     time with the area rig, with phase 8's
     1 directional + 1 point rig (the base mode) and with that rig plus the
     area light on the same cameras, in turns; 2 realtime frames at 1080p
     (2 B5 realtime launches), frame 0's
     AOVs against the plain version on 4,096 sampled pixels, its time;
 30. the wavefront routes with albedo textures at 128^2 against the plain
     version: cornell-tex brute force (B3), two-level (B6a) and realtime
     (B4a, its routing BVH);
 31. the CLI in process: --scene cornell-tex --size 512x512 --spp 16
     --device cuda, whose B5 launch count must rise.

 32. the flattened route without fat nodes at full width (run after phase
     10a, on its state): phase 8's 'instanced:32' scene with bvhf_nodes and
     bvhf_rows dropped from a shallow copy of its bvh, which both gates
     send to the wavefront route; ProgressiveRaytracingPipeline for 4
     dispatches of S = 4 (exactly 32 closest and 32 any launches of the
     binary walk B4b, csrc/traverse_binary.cu, and no other kernel's); its
     first sample against phase 8's B4a frame (same cameras and seeds) on
     the image gate and against the plain version on phase 8's 4,096
     sampled pixels; B4b and the 8-wide walk B4d (csrc/traverse8.cu,
     direct calls: exactly 2 + 2 launches) on each of phase 8's four launch
     inputs, against B4a on all rays and against the plain version on
     4,096 sampled rays; each launch alone, B4a, B4b and B4d in turns, with
     the host models' walk counts (ops/traverse.binary_walk_numpy,
     wide_walk_numpy), the bound, the deepest stack and the leaf-weighted
     warp figures on sampled warps (ops/traverse2.turn_costs: loop turns and
     pair slots; B4b's and B4d's of their kernels' walks,
     ops/traverse.parent_walk_numpy and wide_walk_numpy with leaf
     postponement, with and without it); the host ms per
     dispatch, enqueued and synchronised; realtime + denoise at 1080p, 2
     frames (4 + 4 B4b and 4 bilateral launches), frame 0's direct and
     specular AOVs against the plain version on 4,096 sampled pixels;
 33. B4b, B4d and the binary two-level walk B6b (csrc/traverse2_binary.cu)
     vs their plain versions at 128^2 (run after phase 11): 'instanced:4'
     without fat nodes on phase 7's primary rays, culled and not, and
     shadow rays toward SHADOW_LIGHT (a third at zero direction, never
     occluded, per-ray t_max); the two-level cases of phase 11 without fat
     TLAS nodes, closest (culled and not; the instance slot where the
     triangle is equal) and shadow rays the same way; B4b's and B4d's
     times at phase 10b's shape;
 34. the two-level route without fat nodes at full width (run after phase
     14): phase 12's scene with tlasf_nodes and tlasf_rows dropped, 4
     dispatches of S = 4 (exactly 32 + 32 B6b launches and no other
     kernel's), its first sample against phase 12's B6a frame on the image
     gate, B6b on each of that frame's four launch inputs against B6a on
     all rays and the plain versions on 4,096 sampled rays, 4 animated
     frames (the refit keeps the TLAS without fat nodes: exactly 16 + 16
     B6b launches) and B6b against B6a on 4,096 primary rays at the last
     refit, each launch alone beside B6a in turns with the host model's
     counts (ops/traverse2.binary_walk2_numpy) and the bound, the host ms
     per dispatch, B6b at phase 14's shape, and realtime + denoise at
     1080p, 2 frames (4 + 4 B6b and 4 bilateral launches).

 35. the grouped fat-node packet walk B4c (csrc/traverse_fat_grouped.cu;
     run inside phase 32, on its state): phase 8's four launch inputs, B4a
     on each first, then B4c at tile 1024 with groups 2, 4 and 8 and at tile
     2048 with group 4 (the primary launch with common_origin; exactly one
     B4c launch per input and layout, no other kernel's); against B4a on all
     rays (the hit gate, occlusion disagreement <= 1%, the share of rays
     whose t is bit-equal to B4a's); B4c and B4a against the plain version
     on GROUPED_PLAIN_RAYS (65,536) random rays drawn once per launch (some
     14,000 bounce hits, so that p99.9 is a quantile; with B4a's tail
     census), and on the GROUPED_MODEL_RAYS rays of whole sampled packets
     (occlusion knife-edge-aware, as on the host model, since a packet of
     floor pixels holds many knife edges); against the host model of the
     card's walk (ops/traverse.fat_packet_walk_numpy with packet=32, one
     warp a packet; hits and slots, and t with the hits that a
     float32-sized nudge of the origin moves beyond 1e-4 excused,
     model_hit_gate) on those packets; each launch alone, B4a and B4c in
     turns, with the bound (B4a's, phase 10a: the same function of the same
     rays), the warp packet model's counts, and the JAX kernel's tile
     packet model's counts and redundant-work bound beside them, and the
     deepest stack; B4c
     against the plain version on 'instanced:4' at 128^2 (phase 7's rays),
     and its times there. The phase draws from its own generator;
 36. B1's opt-ins (run after phase 6): Cornell-glossy's progressive
     pipeline at 512^2, 2 dispatches of S = 16 each with no knob,
     FUSED_CLUSTERS=16 and FUSED_BLOCK_W=16 set in the environment (exactly
     6 B1 launches, 2 of them CLUSTERED and 2 BLOCKED; the three images
     equal bit for bit); the CLUSTERED (8, 16 and 24 rows per cluster, C =
     40) and BLOCKED (block_w 8, 16, 32) instantiations against the base
     one, bit for bit, on phase 3's option sets at 128^2, config 1's first
     512^2 dispatch and phase 5's 1080p realtime frame 0 (every AOV); config
     1's first dispatch with 16 rows per cluster against the plain version;
     ms per 16-sample 512^2 dispatch for each setting, in turns with the
     base;
 37. the roofline probes B7 (csrc/roofline.cu; run after phase 31): the
     FMA chains, the pair-test mix and the overlap probe (vector and matrix,
     matrix alone, vector alone, at vector scales 1, 2 and 4) against their
     plain versions at roofline.py's --interpret size (iters 2, grid 2) on
     seeded inputs: relative 1e-4 for the chains and the mix, the split-TF32
     product within 2 K float32 ulps of the sum of |terms| (K = 16) of the
     float32 product; then roofline.py's size and inputs (exactly 1 + 1 + 7
     launches), their outputs against the plain versions on the same
     tensors (the mix overflows to inf there: equal non-finite values pass),
     and every probe and setting again at full size on seeded inputs (the
     mix's a near its neutral growth, ops/roofline.mix_inputs), where a trip
     count, a grid block or the product's schedule off shows, with the same
     tolerances; the four settings with a product at full size on inputs
     where it shows in t (b = 0, mt and rays ~ 1e15): t of all 65,536
     columns within M_ITERS x 2 K ulps of sum |terms| x 1e-30 of the exact
     sum, plus half an ulp of each float32 multiply and add into t; each of
     the main path's launches alone timed: the FFMA TFLOP/s (an FMA counted
     as two), the mix's ops/s; the seven overlap settings in B7_ROUNDS rounds
     in turns, and the timing point s* = round(matrix / vector at scale 1,
     medians of those rounds) (vector alone and both, in B7_ROUNDS rounds
     of their own with the matrix alone; o there equal to vector alone's and
     t to matrix alone's, bit for bit), each time's median and spread, the
     overlap fraction's per round; the product's TFLOP/s alone, its share of
     the bound (the data sheet's 494.7 TFLOP/s dense TF32, stated at 1,830
     MHz) and of the TF32 peak at 1,980 MHz (535.3 TFLOP/s), ptxas' counts
     and any wgmma serialisation of the overlap kernel, and the library
     yardstick (torch.bmm, M_ITERS calls, float32 and one TF32 pass); a rate
     above 105% of the card's peak at 1,980 MHz (67 TFLOP/s float32, 33.5 T
     instructions/s, 535.3 TFLOP/s dense TF32) fails the phase.
 38. the redesigned kernels (run after phase 37): ptxas' registers,
     spills and stack frames of every kernel of B1, B5, B3, B6a, B4b, B6b,
     B4a, B2, B4d and B4c; B1's triangle records (the scene's tri_records,
     five float4s a triangle) of configs 1 and 3 against their mt_pack, and
     B5's leaf arrays ft_test (every one-level walk's too) and ft_attr
     (ops/traverse.leaf_records) of
     'instanced:32' and the config-2 stand-in against their mt_rows, equal
     bit for bit on the card, with their bytes; the launch alone (CUDA
     events) on config 1's and config 3's first dispatch, config 4's frame 0
     (B1), beside phase 10's and 28's B5 times, each with its bound.
 39. row-block launches (run after phase 37): B1 progressive on config 1's
     first dispatch (Cornell-glossy 512^2, S = 16), B1 realtime on config
     4's frame 0 (1080p), B5 progressive on phase 8's first dispatch
     ('instanced:32' 512^2, S = 4, 983,042 triangles) and B5 realtime on an
     'instanced:32' 1080p frame, each launched whole and as 2 and 4 row
     blocks (py0, full_height) put together: bit-equal expected (the same
     float operations on the same integers), else the max |difference| and
     the share of differing pixels are printed and the gate is
     tests/test_parallel.py's (atol 1e-6 on the progressive mean, 1e-5 on
     the realtime AOVs); B2 on config 4's frame 0 split into 2, 4 and 72
     row blocks in this process, one thread a block, each thread driving
     parallel/render.py's code on its block of a 1-spp mesh whose
     all-reduce over "tile" sums the threads' buffers: the vertical pass on
     the block padded by _halo_rows (2 and 4 blocks) against the full pass,
     and _denoise_local (2 and 4 blocks: the halo path; 72 blocks of 15
     rows: the short-block path, gather_rows and the full columns) against
     denoise_composite on the whole frame, bit-equal expected (else 1e-5);
     each launch alone timed, the blocks' sum beside the full launch.
 40. sharded steps through torch.distributed (parallel/render.py): a world
     of one rank on NCCL in this process: make_sharded_progressive_step on
     config 1 (512^2, 16 samples a step, 8 steps; exactly 8 B1 launches)
     against ProgressiveRaytracingPipeline's image, and
     make_sharded_realtime_step with the denoiser at 1080p (1 B1 realtime +
     2 B2 launches) against the pipeline's frame and DenoiseCompositor, bit
     for bit; then two spawned ranks sharing the card over gloo (the only
     collectives: broadcast and all-reduce on CUDA tensors): config 1 on
     meshes 2x1 and 1x2 (8 B1 launches a rank) and realtime + denoise 2x1
     at 1080p, 5 frames (5 B1 realtime + 10 B2 a rank; 540-row blocks,
     the halo path) and at 1920x48, 2 frames (24-row blocks: the
     short-block path's all-reduce of CUDA tensors), rank 0's gathered
     image against the single-process one, bit
     for bit on tile-only meshes and within 1e-5 + 1e-6 |want| where
     samples split (the spp sum reassociated); each step's host ms; and the
     headless CLI with --shard 1x1, as a subprocess.
 41. frames in flight (models/realtime.py): render_frames with K = 4 at
     1080p on Cornell-glossy (exactly 1 B1 realtime launch) and on
     'instanced:32' (1 B5 realtime launch), each bit-equal to 4 sequential
     render() calls; make_realtime_denoise_frames_step with K = 4 (1 B1
     realtime + 8 B2 launches) against the sequential denoiser;
     DenoiseCompositor.dispatch_frames with temporal alpha 0.2 against 4
     sequential dispatch() calls; the host ms per frame (host clock,
     synchronised, and the host's enqueue alone) at K = 1, 2, 4 and 8
     beside the kernels' ms per frame (CUDA events: the K-frame B1 launch
     over K, plus two B2 passes) and the card's busy ms per frame
     (torch.profiler over 8 frames: every kernel and copy, the composite's
     elementwise torch ops included) with the idle share of the frame; the
     host enqueue split into frame_cameras and the step, and the step, in a
     second pass, into realtime_frames and denoise_composite_frames; and the
     pipeline's one-frame path (update + render + DenoiseCompositor.dispatch,
     48 frames) before and after the K sweep, its enqueue split the same way.
 42. mesh files (run after phase 41): the script writes into a temporary
     directory the Cornell box as OBJ + MTL, a 960-triangle sphere (the
     instanced grids' sphere, wound outward, smooth normals) as binary PLY,
     GLB, glTF with a data URI, binary FBX and COLLADA, and 'instanced:32'
     flattened (983,042 triangles; normals renormalised to a fixed point of
     the loaders' float64 renormalisation) as GLB and as OBJ without vt;
     loads each with scene.mesh.load_mesh(path, on_error="raise") against
     the mesh written (corner positions exact, indices exact but for the
     OBJ's vertex welding, material ids exact for the OBJ, normals within
     1e-6), with the write and load seconds and the loader (the large OBJ
     must take the native parser, csrc/mesh_io.cpp, built in phase 2);
     then the headless CLI in process (app.headless.main, -o .npy) on the
     Cornell OBJ progressive at 512^2, 16 spp (exactly 16 B1 launches),
     the same file realtime + denoise at 1920x1080 (1 B1 realtime + 2 B2),
     the sphere PLY progressive at 512^2, 4 spp (8 + 8 B3) and the large
     GLB progressive at 512^2, 4 spp (4 B5): each image bit-equal to the
     written mesh built in memory, framed by mesh_scene and rendered by the
     pipeline as the CLI does, and, at 64^2 on the same scene, one kernel
     sample (or realtime frame: every AOV and the display) against the plain
     path on the image gate; the host seconds and the route of each; and
     --checkpoint-every 4 on 8 spp, the render stopped in frame 6 and
     resumed from its frame-4 checkpoint, bit-equal to the uninterrupted
     render;
 43. live edits, the graft entry and the viewer: rebake_material on
     Cornell-glossy (B1) and 'instanced:4' flattened (B5): every tensor
     equal to a fresh build's with the edited material, one S = 4 dispatch
     of each at 128^2 bit-equal; entry()'s fn(*example_args) on the card
     (128^2 Cornell progressive_step: 2 + 2 B3 launches) against
     entry("cpu") on tests/test_torch_progressive.py's gate (>= 99% of
     pixels within 1e-3, mean |d| <= 1e-4; the share within 2e-5 printed);
     app.viewer.main at 640x480 with --display kitty, stdout captured,
     --auto-checkpoint every frame, on cornell-glossy with a key script
     (movement and a mouse drag, material and light edits, an AOV, the
     realtime pipeline with denoiser edits, a resize to the terminal's size
     and back, the progressive pipeline again; exactly one B1 launch a
     progressive frame, one B1 realtime and two B2 a realtime frame) and on
     'instanced:8' --animate-instances (two-level, a TLAS refit a
     progressive frame: B6a closest and any launches, two B2 a realtime
     frame, no other kernel): exit 0, zero recoveries, every presented
     frame finite with max > 0, the ms per frame (host clock, synchronised);
     and one realtime + denoise viewer frame under utils.profiling.
     device_trace in a fresh process, whose kernels must include B1's
     realtime kernel and both B2 passes (the same trace in this process is
     printed, not gated: late in a full run it has lost the ctypes-launched
     kernels);
 44. re-baked instances, PRIME seeding, ray sorting and the device BVH build
     (run after phase 43): (a) 16 boxes (12 triangles in 16 rows each: 256
     rows, B1's limit) re-baked on the card by scene.dynamic.bake_instances
     for each of 8 dispatches (the CLI's yaw, 0.05 rad a dispatch), passed
     as geometry= to one make_progressive_step at 512^2, S = 16: exactly 8
     B1 launches, each bake (host clock, synchronised) and dispatch (CUDA
     events) timed, dispatch 0's bake equal to the CPU's within 1e-6 and
     its image against the B1 image of a host Scene.build of the same 16
     boxes on the image gate, dispatch 7's image differing from dispatch
     0's; (b) 4 spheres of 960 triangles (1,024 rows each: 4,096 rows, the
     largest brute-force size with records) the same way, 4 dispatches of
     S = 4 through the wavefront route: exactly 32 + 32 B3 launches,
     dispatch 0 against the host build's image and its first sample
     against the plain path on 4,096 sampled pixels; (c) PRIME on config 5:
     one two-level dispatch of S = 4 (B6a) and one flattened wavefront
     frame (B4a) with DXR_PRIME=1 and without, bit-equal, the bounce
     launch's hits bit-equal with the seeded t_max, the share of active
     bounce lanes seeded, the bounce launch alone seeded and unseeded in 5
     turns, and _prime_seed_tmax's ms; (d) the flattened frame's bounce
     closest and depth-0 shadow any launches sorted by _ray_sort_order
     (trace.integrator._sorted_trace, and through sort_rays=True) against
     the launch order, bit-equal, the walk alone and the walk with the
     argsort, gather and scatter in 5 turns; (e) accel.bvh.build_bvh_device
     on the card over the 983,042 flattened triangles and over each (b)
     bake: order equal to the host Morton build_bvh's, nodes within 1e-6,
     the seconds of both.

Every kernel's bound (bound_ms) is the larger of its operations over the
H100's float32 peak (67 TFLOP/s without tensor cores, an FMA counted as two
operations; NVIDIA's H100 SXM data sheet) and its bytes over 3.35 TB/s.
Phase 37 measures the peak this card reaches (FFMA TFLOP/s) and prints it
beside the data sheet's; the bounds keep the data sheet's peak, which is
the published one, and PERF.md sets the two side by side. The overlap
probe's bound is the larger of its FMAs over the float32 peak and its three
TF32 products over 494.7 TFLOP/s (the units may run at once). B4c computes
B4a's function on the same rays, so its bound is B4a's (phase 10a); its
packet model's counts, with the work the packets add, are printed beside.
The brute-force megakernel's pair tests and env lookups (the closest-hit
rays that miss, each 4 texels of 12 bytes, together at most the texture's
bytes) are counted on its plain run (B5's the same way, and its closest
hits on textured materials, 4 texels of 12 bytes each, at most the texel
table's bytes), B3's
from its launches' rays as phase 17 says (its bytes: each ray's own input
and output and each triangle's 19 coefficients and 24 attribute words);
the BVH
kernels' slab and pair tests by a host model of their per-ray walk
(ops/traverse.fat_walk_numpy) over 4,096 sampled pixels of the main path
(B5) or 4,096 sampled rays of each launch (B4a), scaled to the frame or
the launch; B6a's slab and pair tests and instance transforms by the host
model of the two-level walk (ops/traverse2.fat_walk2_numpy) on 4,096 rays
of sampled spans of whole warps of each launch;
B4b's, B4d's and B6b's by their host models on 4,096 sampled rays of each
launch, the nodes touched counted at 32 bytes (binary) or 256 bytes (one
8-wide node, eight 32-byte child rows). B4b's is counted in the JAX
kernel's order (ops/traverse.binary_walk_numpy, B6b's walk): the work the
function needs, not the redesigned kernel's own walk, which tests both
children of a node it expands.
No single PyTorch call computes any of these functions but B7's product,
so library_ms is null but for the overlap probe: torch.bmm of mt, broadcast
over the grid blocks, with the scaled rays, M_ITERS calls (float32; one
TF32 pass beside it), which writes every product to memory where the probe
keeps it in registers.

Each main path is driven with every launch count set to 0 just before it
and read just after. The hit gate of the BVH walk is that of
benchmarks/kernel_parity.py: on rays that hit the same triangle, the
relative t has median <= 1e-6, p99.9 <= 1e-4 and max <= 0.05; rays whose hit
differs <= 1%; occlusion disagrees on <= 1% of rays. The image gate is that
of benchmarks/kernel_parity.py:
at most 1% of pixels differ by more than 1e-3 and the median |difference| is
at most 1e-5, taken on the per-sample mean (the launch's sum divided by S),
and on each realtime AOV (roughness as a one-channel image). The bilateral
gate is max |difference| <= 2e-5 (tests/test_bilateral_pallas.py).

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors and times. Without a CUDA device
the script exits non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_SIZE = 512
B7_ROUNDS = 9  # rounds of the overlap settings timed in turns (phase 37)
MAIN_S = 16
MAIN_FRAMES = 8
PARITY_SIZE = 128
PARITY_S = 4
RT_W, RT_H = 1920, 1080
RT_FRAMES = 8
BAD_TOL, BAD_FRAC, MEDIAN_MAX = 1e-3, 0.01, 1e-5
BILATERAL_TOL = 2e-5
HIT_MEDIAN, HIT_P999, HIT_MAX, TIE_FRAC = 1e-6, 1e-4, 0.05, 0.01
BVH_PARITY_SCENE, BVH_PARITY_SIZE = "instanced:4", 128
BVH_MAIN_SCENE, BVH_S, BVH_DISPATCHES, BVH_RT_FRAMES = "instanced:32", 4, 4, 4
F42_BIG = BVH_MAIN_SCENE  # phase 42's large file: its flattened geometry, 983,042 triangles
F42_CORNELL_SPP, F42_SPP, F42_PARITY = 16, 4, 64  # phase 42's spp; its parity renders' size
VIEWER_W, VIEWER_H = 640, 480  # phase 43's viewer runs
# phase 43's key scripts (one event a frame; a mouse drag and Alt-Enter are
# escape sequences): no look keys, which turn the camera off the box
VIEWER_SCRIPT = ("21wrRbBuUh" + "\x1b[<0;10;5M\x1b[<32;12;5M\x1b[<0;12;5m" + "]nNoO"
                 + "\x1b\rs\x1b\rda[")
VIEWER_SCRIPT_TWO = "wd]sa[w"
SHADOW_LIGHT = (2.0, 6.0, 1.5)  # the B4a occlusion checks' point light
COUNT_PIXELS = 4096  # sampled pixels whose walks the host model counts
WARP = 32  # the host figures' warps: WARP consecutive rays of a launch
WARP_SPAN = 512  # consecutive rays of each sampled span of warps
FP32_PEAK = 67e12  # H100 SXM float32 FLOP/s without tensor cores (FMA = 2), at 1,980 MHz
# H100 SXM dense TF32 FLOP/s on the tensor cores: the data sheet's figure,
# which is 132 SMs x 2,048 flop a clock at 1,830 MHz, and the same at the
# 1,980 MHz of FP32_PEAK (the clock the card holds unthrottled)
TF32_PEAK = 494.7e12
TF32_PEAK_1980 = 132 * 2048 * 1.98e9
HBM_RATE = 3.35e12  # H100 SXM bytes/s
OPS_PAIR = 50  # float32 operations of one Möller–Trumbore pair test (csrc/common.cuh)
OPS_SLAB = 25  # of one child-box slab test
OPS_TAP = 24  # of one bilateral tap (guide distance, weight, 3-channel sum)
OPS_INST = 45  # of one instance entry of B6a: o' = A o + b, d' = A d, o' x d', 1 / d'
TWO_LEVEL_PARITY = ("five", "instanced:4")  # B6a's parity scenes (tests/test_torch_cuda.py)
TWO_LEVEL_FRAMES = 4  # animated frames of the two-level main path
TWO_LEVEL_RT_FRAMES = 2  # realtime + denoise frames on the two-level scene
BRUTE_PARITY = ("cornell-glossy", "instanced:1", "instanced:2")  # B3's parity scenes
BRUTE_MAIN_SCENE = "instanced:2"  # 3,842 triangles: the largest below the BVH threshold
BRUTE_RT_FRAMES = 2  # realtime + denoise frames on the brute-force scene
RIG_SIZE = 128  # the 2 directional + 2 point + 1 area rig's image
BILATERAL_RADII = (1, 7, 12, 25)
HDR_W, HDR_H = 8192, 4096  # config 3's lat-long radiance (the reference's 8K size), an RLE .hdr
CUBE_S = 512  # the cubemap's face size (R16G16B16A16_FLOAT .dds, the reference probe's format)
C3_W, C3_H, C3_S, C3_DISPATCHES = 1920, 1080, 8, 128  # BASELINE config 3: 1024 spp at 1080p
C3_RT_FRAMES = 4  # realtime + denoise frames with the HDR env
C3_B5_DISPATCHES = 2  # B5 dispatches of S = 4 on instanced:32 with the cubemap
TEX_PARITY_EYE = ((1.2, 1.5, 3.6), (0.1, 1.3, 0.0))  # sees the box and, past it, the env
ENV_LOOKUP_BYTES = 4 * 12  # one bilinear env lookup: four float32 RGB texels
TIE_REL = 1e-4  # a cube lookup "near a face tie": its two largest |components| within this
DIR_PART = 1e-5  # two traces' miss directions "part" past this (float noise is ~1e-7)
# a knife edge: a trace whose outcome PROBE_TRIALS random perturbations of
# its unit direction by PROBE_EPS and of its origin by PROBE_ORIGIN * max(1,
# |o|) (about 8 float32 ulps, far inside the 1e-4 ray offset) can flip
PROBE_EPS, PROBE_ORIGIN, PROBE_TRIALS = 1e-4, 1e-6, 8
C2_S, C2_DISPATCHES = 8, 8  # the config-2 stand-in: 8 dispatches of S = 8 at 512^2
C2_RT_FRAMES = 2  # realtime + denoise frames on the config-2 stand-in
C5_AREA_DISPATCHES, C5_AREA_RT_FRAMES = 2, 2  # instanced:32 with the area rig
FAT_BVH = ("bvhf_nodes", "bvhf_rows")  # dropped: the route takes the binary walk (B4b)
FAT_TLAS = ("tlasf_nodes", "tlasf_rows")  # dropped: the two-level route takes B6b
BIN_RT_FRAMES = 2  # realtime + denoise frames on the routes without fat nodes
GROUPINGS = ((1024, 2), (1024, 4), (1024, 8), (2048, 4))  # B4c's (tile, group) layouts
PLAIN_SLICE = 65536  # rays per call of a plain sweep over a whole launch
GROUPED_MODEL_RAYS = 4096  # rays (whole packets) of each launch the packet model walks
# random rays of each launch B4c and B4a are held against the plain version on
# (one draw for every layout): some 14,000 bounce hits, so that the hit gate's
# p99.9 is the 14th largest relative t error, not the largest of a few
GROUPED_PLAIN_RAYS = 16 * 4096
AOVS = ("direct", "indirect_specular", "albedo", "color", "roughness")
OPTION_CASES = [
    ("defaults", {}, "const"),
    ("debug2", {"debug": 2}, "const"),
    ("no_indirect_diffuse", {"no_indirect_diffuse": True}, "const"),
    ("uniform_hemisphere", {"cosine_hemisphere_sampling": False}, "const"),
    ("albedo_only", {"show_gbuffer_albedo_only": True}, "const"),
    ("fresnel_term", {"show_fresnel_term": True}, "const"),
    ("gradient_env", {}, "gradient"),
]
REALTIME_CASES = [
    ("defaults", {}, "const"),
    ("debug2", {"debug": 2}, "const"),
    ("gradient_env", {}, "gradient"),
    ("emissive", {}, "emissive"),  # every wall glows: the realtime bounce drops emissive
]


def sky_image(width: int, height: int, seed: int):
    """A lat-long sky [height, width, 3] float32: a horizon-to-zenith
    gradient over a dark ground, a small sun of radiance 50 and seeded
    noise (the repository holds no HDR asset)."""
    import numpy as np

    rs = np.random.default_rng(seed)
    v = ((np.arange(height, dtype=np.float32) + 0.5) / height)[:, None, None]  # 0: zenith
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)
    sky = (1.0 - up) * np.array([0.9, 0.85, 0.8], np.float32) + up * np.array(
        [0.25, 0.45, 0.9], np.float32)
    img = np.where(v > 0.5, np.array([0.15, 0.12, 0.1], np.float32), sky)
    img = img * np.ones((1, width, 1), np.float32)
    img = img * (1.0 + rs.normal(0.0, 0.05, img.shape)).astype(np.float32)
    r, cy, cx = max(width // 256, 2), height // 4, width // 3
    img[cy - r:cy + r, cx - r:cx + r] = 50.0
    return np.clip(img, 0.0, None).astype(np.float32)


def cube_faces(size: int, seed: int):
    """A cubemap probe [6, size, size, 3] float32: a tint per face, a ramp
    down each face and seeded noise."""
    import numpy as np

    rs = np.random.default_rng(seed)
    ramp = np.linspace(1.5, 0.2, size, dtype=np.float32)[None, :, None, None]
    tint = rs.uniform(0.3, 1.5, (6, 1, 1, 3)).astype(np.float32)
    faces = tint * ramp * np.ones((6, size, size, 3), np.float32)
    return (faces * (1.0 + rs.normal(0.0, 0.05, faces.shape))).astype(np.float32)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0].strip()


def image_gate(name, got, want, s_count):
    """Gate the per-sample means; returns the numbers and raises on failure."""
    diff = ((got - want) / s_count).abs()
    bad = float((diff > BAD_TOL).any(dim=-1).float().mean())
    med = float(diff.median())
    mx = float(diff.max())
    ok = bad <= BAD_FRAC and med <= MEDIAN_MAX and bool(got.isfinite().all())
    print(f"parity {name}: bad-pixel frac {bad:.6f} (<= {BAD_FRAC}), median |d| {med:.3e} "
          f"(<= {MEDIAN_MAX}), max |d| {mx:.4f} -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"kernel vs plain parity failed for {name}")
    return {"bad_pixel_frac": bad, "median_abs_diff": med, "max_abs_diff": mx}


def aov_gate(name, got, want):
    """The image gate on each realtime AOV; returns the largest max |d|."""
    worst = 0.0
    for k in AOVS:
        g, w = got[k], want[k]
        if g.dim() == 2:  # roughness: a one-channel image
            g, w = g[..., None], w[..., None]
        worst = max(worst, image_gate(f"{name} {k}", g, w, 1)["max_abs_diff"])
    return worst


def bilateral_gate(name, got, want):
    err = float((got - want).abs().max())
    ok = err <= BILATERAL_TOL and bool(got.isfinite().all())
    print(f"parity {name}: max |d| {err:.3e} (<= {BILATERAL_TOL}) -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise RuntimeError(f"bilateral kernel vs plain parity failed for {name}")
    return err


def hit_gate(name, got, want, torch):
    """The closest-hit gate on rays [R]; returns the numbers, raises on failure."""
    same = (got["hit"] == want["hit"]) & (~got["hit"] | (got["tri"] == want["tri"]))
    both = same & got["hit"]
    rel = ((got["t"] - want["t"]).abs() / want["t"].abs().clamp(min=1.0))[both].double()
    g = {"median_rel_t": float(rel.median()), "p999_rel_t": float(torch.quantile(rel, 0.999)),
         "max_rel_t": float(rel.max()), "tie_break_frac": float((~same).float().mean()),
         "max_abs_t": float((got["t"] - want["t"])[both].abs().max()),
         "hit_frac": float(got["hit"].float().mean())}
    ok = (g["median_rel_t"] <= HIT_MEDIAN and g["p999_rel_t"] <= HIT_P999
          and g["max_rel_t"] <= HIT_MAX and g["tie_break_frac"] <= TIE_FRAC and both.sum() > 0)
    print(f"parity {name}: hit frac {g['hit_frac']:.4f}, relative t median {g['median_rel_t']:.2e}"
          f" p99.9 {g['p999_rel_t']:.2e} max {g['max_rel_t']:.2e}, tie-break frac "
          f"{g['tie_break_frac']:.5f} -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"kernel vs plain hit gate failed for {name}")
    return g


def tail_census(name, got, want, scene, o, d, normal_tail: bool = False):
    """Prints where the tail of a closest-hit comparison lies (rays that hit
    the same triangle): the count of rays whose relative t error (or, with
    normal_tail, whose largest normal component error) is above 1e-5 and
    above 1e-4, and the median over them and over all such rays of |cos|,
    the cosine between the ray and the triangle's normal (grazing hits have a
    small one), and of |o| / max(1, t) (a far origin cancels in the
    barycentrics and t). Returns those numbers."""
    import torch

    same = got["hit"] & want["hit"] & (got["tri"] == want["tri"])
    if normal_tail:
        err = (got["normal"] - want["normal"]).abs().amax(dim=1)[same]
    else:
        err = ((got["t"] - want["t"]).abs() / want["t"].abs().clamp(min=1.0))[same]
    pn = scene["pn"][want["tri"][same]]
    ds = d[same]
    cos = ((ds * pn).sum(-1).abs() / (ds.norm(dim=-1) * pn.norm(dim=-1)).clamp(min=1e-30))
    far = o[same].norm(dim=-1) / want["t"][same].clamp(min=1.0)
    out = {"hits": int(same.sum()), "above_1e-5": int((err > 1e-5).sum()),
           "above_1e-4": int((err > 1e-4).sum())}
    for key, sel in (("all", torch.ones_like(err, dtype=torch.bool)), ("tail", err > 1e-5)):
        out[f"median_cos_{key}"] = float(cos[sel].median()) if bool(sel.any()) else None
        out[f"median_far_{key}"] = float(far[sel].median()) if bool(sel.any()) else None
    what = "normal |d|" if normal_tail else "relative t"
    print(f"tail {name}: of {out['hits']} same-triangle hits, {what} > 1e-5 on "
          f"{out['above_1e-5']}, > 1e-4 on {out['above_1e-4']}; median |cos| (ray, normal) "
          f"{out['median_cos_tail']} on those, {out['median_cos_all']} on all; median |o| / "
          f"max(1, t) {out['median_far_tail']} on those, {out['median_far_all']} on all",
          flush=True)
    return out


def attr_gate(name, got, want, torch, gated: bool = True):
    """B3's fused attributes against the plain version's on rays that hit
    the same triangle: the normal within 1e-5 on 99.9% of rays, the position
    over max(1, t) within the hit gate's bounds (it is o + t d), the
    material rows and ids equal. Returns the largest differences; raises on
    failure unless gated is False (a census: the numbers are printed)."""
    from dxrexperiments_torch.ops.intersect_kernel import MATERIAL_KEYS

    same = got["hit"] & want["hit"] & (got["tri"] == want["tri"])
    scale = want["t"][same].abs().clamp(min=1.0)[:, None]
    nrm = (got["normal"] - want["normal"])[same].abs().amax(dim=1).double()
    pos = ((got["position"] - want["position"])[same].abs() / scale).amax(dim=1).double()
    mats = all(torch.equal(got[k][same], want[k][same]) for k in (*MATERIAL_KEYS, "mat_id"))
    g = {"normal_p999": float(torch.quantile(nrm, 0.999)), "normal_max": float(nrm.max()),
         "position_median": float(pos.median()), "position_p999": float(torch.quantile(pos, 0.999)),
         "position_max": float(pos.max())}
    ok = (g["normal_p999"] <= 1e-5 and g["position_median"] <= HIT_MEDIAN
          and g["position_p999"] <= HIT_P999 and max(g["normal_max"], g["position_max"]) <= HIT_MAX
          and mats)
    print(f"parity {name} attributes: normal |d| p99.9 {g['normal_p999']:.2e} max "
          f"{g['normal_max']:.2e}, position |d| / max(1, t) median {g['position_median']:.2e} "
          f"p99.9 {g['position_p999']:.2e} max {g['position_max']:.2e}, material rows equal "
          f"{mats} -> {('ok' if ok else 'FAIL') if gated else 'not gated'}", flush=True)
    if gated and not ok:
        raise RuntimeError(f"B3 attribute gate failed for {name}")
    return g


def inst_gate(name, got, want):
    """B6a's instance slot equals the plain version's on rays that hit the
    same triangle."""
    same = got["hit"] & want["hit"] & (got["tri"] == want["tri"])
    if not bool((got["inst"][same] == want["inst"][same]).all()):
        raise RuntimeError(f"B6a instance slots differ from the plain version's for {name}")


def flat_gate(name, got, want, torch):
    """B6a's closest hits against a sweep of another build of the same
    surfaces, whose triangle ids differ: hit/miss disagreement <= 1%, and on
    rays both hit the relative t of the hit gate."""
    both = got["hit"] & want["hit"]
    rel = ((got["t"] - want["t"]).abs() / want["t"].abs().clamp(min=1.0))[both].double()
    g = {"hit_miss_frac": float((got["hit"] != want["hit"]).float().mean()),
         "median_rel_t": float(rel.median()), "p999_rel_t": float(torch.quantile(rel, 0.999)),
         "max_rel_t": float(rel.max()), "hit_frac": float(want["hit"].float().mean())}
    ok = (g["hit_miss_frac"] <= TIE_FRAC and g["median_rel_t"] <= HIT_MEDIAN
          and g["p999_rel_t"] <= HIT_P999 and g["max_rel_t"] <= HIT_MAX and both.sum() > 0)
    print(f"parity {name}: hit frac {g['hit_frac']:.4f}, hit/miss disagreement "
          f"{g['hit_miss_frac']:.5f}, relative t median {g['median_rel_t']:.2e} p99.9 "
          f"{g['p999_rel_t']:.2e} max {g['max_rel_t']:.2e} -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"gate failed for {name}")
    return g


def occlusion_gate(name, got, want):
    frac = float((got != want).float().mean())
    ok = frac <= TIE_FRAC and 0.0 < float(want.float().mean()) < 1.0
    print(f"parity {name}: occluded {float(want.float().mean()):.4f}, disagreement {frac:.5f} "
          f"(<= {TIE_FRAC}) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"kernel vs plain occlusion gate failed for {name}")
    return frac


def transform(translate=(0.0, 0.0, 0.0), yaw=0.0, scale=1.0):
    """4x4 float32: a turn of `yaw` about y, a uniform scale, a translation."""
    import numpy as np

    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    m[:3, :3] *= scale
    m[:3, 3] = translate
    return m


# tests/test_tlas.py's 5 instances: (translate, yaw, scale)
FIVE_TRANSFORMS = [((0, 0, 0), 0.0, 1.0), ((2.5, 0.2, 0), 0.7, 1.0), ((-2.5, 0, 0.5), -0.4, 1.4),
                   ((0, 0, 2.5), 0.0, 0.8), ((0, 1.5, -2.5), 2.0, 1.0)]


def probe_rays(n, seed, radius, spread, device):
    """n rays from a sphere of `radius`, aimed at points scattered by
    `spread` around the origin (tests/test_torch_cuda.py's probe)."""
    import numpy as np
    import torch

    rs = np.random.default_rng(seed)
    o = rs.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * radius
    d = rs.normal(scale=spread, size=(n, 3)).astype(np.float32) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(o, device=device), torch.as_tensor(d.astype(np.float32), device=device)


def tensors_of(tree):
    """Every tensor in a nested dict/list, and in a refit context's cache."""
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)
    elif hasattr(tree, "_on_device"):
        yield from tensors_of(tree._on_device)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of operations over the float32 peak
    and bytes over the memory rate."""
    t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def env_bytes(lookups: float, texture) -> float:
    """The bytes a call's env lookups must read: four float32 RGB texels
    each, but at most the texture's own bytes (each texel read once)."""
    return min(lookups * ENV_LOOKUP_BYTES, texture.numel() * texture.element_size())


def face_tie(directions, rel: float):
    """[N] bool: the cube lookup of each direction lies near a face tie (its
    two largest |components| within `rel` of each other), where rounding
    may pick another face."""
    a = directions.abs().sort(dim=-1, descending=True).values
    return (a[:, 0] - a[:, 1]) <= rel * a[:, 0]


class TraceLog:
    """Records every trace made while active through ops.traverse's
    closest and any functions `names` (B4a's wrappers, or their plain
    versions with PLAIN): ("closest", directions, hit, tri, live) and
    ("any", occluded) in `calls`, and each call's rays (origins,
    directions, t_min, t_max, cull or None for any) in `rays`, in call
    order; the traces still run."""

    B4A = ("traverse_fat_closest", "traverse_fat_any")
    PLAIN = ("traverse_fat_closest_reference", "traverse_fat_any_reference")

    def __init__(self, tv, names=B4A):
        self.tv, self.names, self.calls, self.rays = tv, names, [], []

    def __enter__(self):
        import torch

        self.fns = [getattr(self.tv, n) for n in self.names]
        closest_fn, any_fn = self.fns

        def closest(scene, o, d, t_min=1e-4, t_max=3.0e37, cull_backface=False):
            hits = closest_fn(scene, o, d, t_min, t_max, cull_backface)
            live = torch.as_tensor(t_max, device=d.device).expand(d.shape[0]) > t_min
            self.calls.append(("closest", d, hits["hit"], hits["tri"], live))
            self.rays.append((o, d, t_min, t_max, cull_backface))
            return hits

        def any_(scene, o, d, t_min=1e-4, t_max=3.0e37):
            occ = any_fn(scene, o, d, t_min, t_max)
            self.calls.append(("any", occ))
            self.rays.append((o, d, t_min, t_max, None))
            return occ

        setattr(self.tv, self.names[0], closest)
        setattr(self.tv, self.names[1], any_)
        return self

    def __exit__(self, *exc):
        for n, fn in zip(self.names, self.fns):
            setattr(self.tv, n, fn)


def path_census(log_a, log_b, pixels: int, rel_tie: float):
    """Per pixel of a batch of `pixels` primary rays traced twice (logs
    log_a, log_b of the same integrator run on two trace backends), where
    the two paths part: the primary hit's triangle, a bounce's hit or
    triangle, a shadow ray's occlusion, and the largest |difference| of
    the two traces' unit directions on a live lane that misses in both
    (where the env is looked up; about the angle in radians); and whether
    such a lane of log_b lies near a cube-face tie. Lane j of a call
    belongs to pixel j % pixels."""
    import torch

    def per_pixel(lanes):
        return lanes.reshape(-1, pixels)

    out = {}
    closest = [(a, b) for a, b in zip(log_a.calls, log_b.calls) if a[0] == "closest"]
    shadow = [(a, b) for a, b in zip(log_a.calls, log_b.calls) if a[0] == "any"]
    (_, _, ha, ta, _), (_, _, hb, tb, _) = closest[0]
    out["primary_tri"] = (ha != hb) | (ha & (ta != tb))
    bounce_hit = torch.zeros_like(out["primary_tri"])
    bounce_tri = torch.zeros_like(bounce_hit)
    dir_diff = torch.zeros(pixels, device=ha.device)
    tie = torch.zeros_like(bounce_hit)
    for (_, da, ha, ta, la), (_, db, hb, tb, lb) in closest:
        bounce_hit |= per_pixel((ha != hb) & la).any(dim=0)
        bounce_tri |= per_pixel(ha & hb & (ta != tb)).any(dim=0)
        miss = la & lb & ~ha & ~hb
        gap = torch.where(miss, (da - db).norm(dim=-1), torch.zeros_like(da[:, 0]))
        dir_diff = torch.maximum(dir_diff, per_pixel(gap).max(dim=0).values)
        tie |= per_pixel(face_tie(db, rel_tie) & miss).any(dim=0)
    out["bounce_hit"], out["bounce_tri"] = bounce_hit, bounce_tri
    out["shadow"] = torch.zeros_like(bounce_hit)
    for (_, oa), (_, ob) in shadow:
        out["shadow"] |= per_pixel(oa != ob).any(dim=0)
    out["miss_dir_diff"], out["near_face_tie"] = dir_diff, tie
    return out


def light_counts(scene) -> tuple[int, int, int]:
    """A scene's rig: its (directional, point, area) light counts."""
    from dxrexperiments_torch.scene.lights import normalize_lights

    rig = normalize_lights(scene["lights"])
    return (int(rig["dir"]["forward"].shape[0]), int(rig["point"]["position"].shape[0]),
            int(rig["area"]["corner"].shape[0]))


def area_rows(reps: int, lights) -> list[bool]:
    """Which rows of a shadow call's lanes ([reps, pixels]) are an area
    light's: trace.integrator._direct_lighting stacks the rays light by
    light (directional, point, then AREA_LIGHT_SAMPLES per area light),
    each over the call's reps // rays-per-point stacked batches."""
    d, p, a = lights
    per_point = d + p + 4 * a
    return [r // max(reps // per_point, 1) >= d + p for r in range(reps)]


def knife_edges(tv, scene, log, pixel_ids, pixels: int, lights):
    """For each pixel j of pixel_ids (lanes j + k * pixels of log's calls):
    whether one of its traces lies on a knife edge, that is one of
    PROBE_TRIALS random perturbations of its origin (by PROBE_ORIGIN *
    max(1, |o|)) and unit direction (by PROBE_EPS) flips its outcome (hit,
    triangle or occlusion) on the plain version; and whether such a trace
    is an area light's shadow ray. Lanes with a zero direction or an empty
    window are not traced and stay as they are."""
    import torch

    dev = log.rays[0][0].device
    ids = torch.as_tensor(pixel_ids, device=dev)
    n = len(pixel_ids)
    edge = torch.zeros(n, dtype=torch.bool, device=dev)
    area_edge = torch.zeros_like(edge)
    gen = torch.Generator(device=dev).manual_seed(7)

    def unit(shape):
        g = torch.randn(shape, generator=gen, device=dev)
        return g / g.norm(dim=-1, keepdim=True).clamp(min=1e-12)

    for o, d, t_min, t_max, cull in log.rays:
        reps = d.shape[0] // pixels
        lanes = (ids[None, :] + pixels * torch.arange(reps, device=dev)[:, None]).reshape(-1)
        o_l, d_l = o[lanes].repeat(PROBE_TRIALS, 1), d[lanes].repeat(PROBE_TRIALS, 1)
        t0 = rows_of(t_min, lanes)
        t1 = rows_of(t_max, lanes)
        t0 = t0.repeat(PROBE_TRIALS) if hasattr(t0, "dim") and t0.dim() else t0
        t1 = t1.repeat(PROBE_TRIALS) if hasattr(t1, "dim") and t1.dim() else t1
        traced = d_l.abs().sum(dim=-1, keepdim=True) > 0
        o_p = o_l + PROBE_ORIGIN * o_l.norm(dim=-1, keepdim=True).clamp(min=1.0) * unit(o_l.shape)
        d_p = d_l + PROBE_EPS * unit(d_l.shape)
        d_p = torch.where(traced, d_p / d_p.norm(dim=-1, keepdim=True), d_l)
        if cull is None:
            flip = (tv.traverse_fat_any_reference(scene, o_l, d_l, t0, t1)
                    != tv.traverse_fat_any_reference(scene, o_p, d_p, t0, t1))
        else:
            a = tv.traverse_fat_closest_reference(scene, o_l, d_l, t0, t1, cull)
            b = tv.traverse_fat_closest_reference(scene, o_p, d_p, t0, t1, cull)
            flip = (a["hit"] != b["hit"]) | (a["hit"] & (a["tri"] != b["tri"]))
        flip = flip.reshape(PROBE_TRIALS, reps, n).any(dim=0)  # [reps, n]
        edge |= flip.any(dim=0)
        if cull is None:
            rows = torch.as_tensor(area_rows(reps, lights), device=dev)
            area_edge |= (flip & rows[:, None]).any(dim=0)
    return edge, area_edge


def ray_knife_edges(tv, scene, o, d, t_min, t_max):
    """[n] bool: the occlusion of each shadow ray o, d flips on the plain
    version under one of PROBE_TRIALS random perturbations of its origin
    (by PROBE_ORIGIN * max(1, |o|)) and unit direction (by PROBE_EPS), as
    knife_edges probes a pixel's traces. Zero directions are not traced."""
    import torch

    gen = torch.Generator(device=d.device).manual_seed(11)

    def unit(shape):
        g = torch.randn(shape, generator=gen, device=d.device)
        return g / g.norm(dim=-1, keepdim=True).clamp(min=1e-12)

    base = tv.traverse_fat_any_reference(scene, o, d, t_min, t_max)
    traced = d.abs().sum(dim=-1, keepdim=True) > 0
    edge = torch.zeros_like(base)
    for _ in range(PROBE_TRIALS):
        o_p = o + PROBE_ORIGIN * o.norm(dim=-1, keepdim=True).clamp(min=1.0) * unit(o.shape)
        d_p = d + PROBE_EPS * unit(d.shape)
        d_p = torch.where(traced, d_p / d_p.norm(dim=-1, keepdim=True), d)
        edge |= tv.traverse_fat_any_reference(scene, o_p, d_p, t_min, t_max) != base
    return edge


def model_hit_gate(name, got, model, torch, unstable_of):
    """Closest hits against a host model on the same rays, whose float32
    arithmetic differs from the kernel's (no FMA contraction): the hit or
    the leaf slot differs on at most 1% of rays, and on rays with the same
    slot the relative t has median <= HIT_MEDIAN and max <= HIT_MAX, and
    above HIT_P999 lie at most 0.1% of those hits (rounded down) that are
    not ill-conditioned: unstable_of(idx) gives ray_t_unstable of the rays
    idx (a grazing hit or a far origin, whose t a float32-sized nudge of the
    origin moves by more than HIT_P999). On the few hits of some packets'
    samples a p99.9 is their largest error, so the count is the steady
    statistic, as knife_occlusion_gate's is for occlusion. A sample of whole
    packets may hold no hit at all: then only the flags are compared.
    Returns the slot disagreement fraction."""
    hit = got["hit"]
    m_hit = torch.as_tensor(model["hit"], device=hit.device)
    m_slot = torch.as_tensor(model["slot"], device=hit.device)
    same = (hit == m_hit) & (~hit | (got["slot"] == m_slot))
    both = same & hit
    frac = float((~same).float().mean())
    rel_all = ((got["t"] - torch.as_tensor(model["t"], device=hit.device)).abs()
               / got["t"].abs().clamp(min=1.0))
    rel = rel_all[both].double()
    g = {"median": 0.0, "p999": 0.0, "max": 0.0}
    above = (both & (rel_all > HIT_P999)).nonzero()[:, 0]
    hard = int((~unstable_of(above)).sum()) if len(above) else 0
    if bool(both.any()):
        g = {"median": float(rel.median()), "p999": float(torch.quantile(rel, 0.999)),
             "max": float(rel.max())}
    ok = (frac <= TIE_FRAC and g["median"] <= HIT_MEDIAN and g["max"] <= HIT_MAX
          and hard <= int(0.001 * int(both.sum())))
    print(f"parity {name}: hit frac {float(hit.float().mean()):.4f}, hit or slot differs on "
          f"{frac:.5f} (<= {TIE_FRAC}), relative t median {g['median']:.2e} p99.9 "
          f"{g['p999']:.2e} max {g['max']:.2e}; above {HIT_P999:.0e} {len(above)} of "
          f"{int(both.sum())} hits, of which well-conditioned {hard} (<= 0.1%) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"kernel vs host model hit gate failed for {name}")
    return frac


def ray_t_unstable(tv, scene, o, d, t_min, t_max, cull):
    """[n] bool: the closest-hit t of each ray o, d moves by more than
    HIT_P999 relative (over max(1, t)) on the plain version under one of
    PROBE_TRIALS random nudges of its origin by PROBE_ORIGIN * max(1, |o|),
    some 16 float32 ulps of it: its t is ill-conditioned in float32 (a
    grazing hit, a far origin), as ray_knife_edges finds knife edges. A ray
    whose hit comes or goes under a nudge counts as unstable too."""
    import torch

    gen = torch.Generator(device=d.device).manual_seed(13)
    base = tv.traverse_fat_closest_reference(scene, o, d, t_min, t_max, cull_backface=cull)
    unstable = torch.zeros_like(base["hit"])
    for _ in range(PROBE_TRIALS):
        g = torch.randn(o.shape, generator=gen, device=d.device)
        o_p = o + PROBE_ORIGIN * o.norm(dim=-1, keepdim=True).clamp(min=1.0) * (
            g / g.norm(dim=-1, keepdim=True).clamp(min=1e-12))
        nudged = tv.traverse_fat_closest_reference(scene, o_p, d, t_min, t_max,
                                                   cull_backface=cull)
        moved = (nudged["t"] - base["t"]).abs() / base["t"].abs().clamp(min=1.0) > HIT_P999
        unstable |= (nudged["hit"] != base["hit"]) | (base["hit"] & moved)
    return unstable


def knife_occlusion_gate(name, got, want, knife_of):
    """Occlusion against a host model whose float32 arithmetic differs from
    the kernel's (no FMA contraction): the rays where the two disagree and
    that lie on no knife edge <= 1%; knife_of(idx) gives ray_knife_edges of
    the rays idx. Returns the disagreement fraction."""
    off = got != want
    idx = off.nonzero()[:, 0]
    hard_n = int((~knife_of(idx)).sum()) if len(idx) else 0
    frac, hard = float(off.float().mean()), hard_n / len(off)
    ok = hard <= TIE_FRAC
    print(f"parity {name}: occluded {float(want.float().mean()):.4f}, disagreement {frac:.5f}, "
          f"of which on no knife edge {hard:.5f} (<= {TIE_FRAC}) -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise RuntimeError(f"kernel vs host model occlusion gate failed for {name}")
    return frac


def bad_pixel_census(tv, scene, lights, kernel, wave, plain, wave_log, plain_log, pixel_ids,
                     sample: int = 0, extra=None):
    """One row per pixel of a batch where the kernel's sample (kernel [N, 3])
    and the plain version's (plain) differ by more than BAD_TOL, with what
    tells them apart: where the wavefront route's path (B4a's walks with the
    plain shading, `wave`, logged in wave_log) and the plain version's
    (plain_log) part (path_census; `area_shadow`: an area light's shadow
    ray), whether a trace of the pixel lies on a knife edge (knife_edges),
    and its `cause`, the first of these that holds. A row whose path agrees
    (cause "none") and whose kernel value parts from the wavefront route's
    is a fault (census_verdict). `lights` is the rig's (directional, point,
    area) counts; `extra` maps more column names to per-pixel values [N]."""
    import torch

    pixels = kernel.shape[0]

    def diff(a, b):
        return (a - b).abs().max(dim=-1).values

    bad = torch.nonzero(diff(kernel, plain) > BAD_TOL).flatten()
    if bad.numel() == 0:
        return []
    paths = path_census(wave_log, plain_log, pixels, TIE_REL)
    area_shadow = torch.zeros(pixels, dtype=torch.bool, device=kernel.device)
    for (ka, *a), (_, *b) in zip(wave_log.calls, plain_log.calls):
        if ka == "any":
            flips = (a[0] != b[0]).reshape(-1, pixels)
            rows = torch.as_tensor(area_rows(flips.shape[0], lights), device=kernel.device)
            area_shadow |= (flips & rows[:, None]).any(dim=0)
    edge, area_edge = knife_edges(tv, scene, wave_log, bad, pixels, lights)
    rows = []
    for j, i in enumerate(bad.tolist()):
        r = {"pixel": int(pixel_ids[i]), "sample": sample,
             "kernel_vs_plain": float(diff(kernel, plain)[i]),
             "kernel_vs_wavefront": float(diff(kernel, wave)[i]),
             "wavefront_vs_plain": float(diff(wave, plain)[i]),
             **{k: (float(v[i]) if k == "miss_dir_diff" else bool(v[i])) for k, v in paths.items()},
             "area_shadow": bool(area_shadow[i]), "knife_edge": bool(edge[j]),
             "knife_edge_area_shadow": bool(area_edge[j]),
             **{k: float(v[i]) for k, v in (extra or {}).items()}}
        causes = (("primary triangle", r["primary_tri"]),
                  ("bounce hit or triangle", r["bounce_hit"] or r["bounce_tri"]),
                  ("area-light shadow ray", r["area_shadow"]),
                  ("other shadow ray", r["shadow"]),
                  ("miss direction", r["miss_dir_diff"] > DIR_PART),
                  ("cube face tie", r["near_face_tie"]),
                  ("knife edge, area-light shadow ray", r["knife_edge_area_shadow"]),
                  ("knife edge", r["knife_edge"]))
        r["cause"] = next((c for c, hit in causes if hit), "none")
        rows.append(r)
    return rows


def census_verdict(label: str, rows: list) -> dict:
    """Print the census rows and their counts by cause; raise where a
    pixel's path agrees (cause "none") but the kernel parts from the
    wavefront route on the same rays by more than BAD_TOL (the kernel's
    fault; where it agrees with that route, what is left is the route's
    float arithmetic against the plain version's on the same path)."""
    by_cause = {}
    for r in rows:
        print(f"{label} bad pixel: {json.dumps(r)}", flush=True)
        by_cause[r["cause"]] = by_cause.get(r["cause"], 0) + 1
    unexplained = [(r["pixel"], r["sample"]) for r in rows
                   if r["cause"] == "none" and r["kernel_vs_wavefront"] > BAD_TOL]
    census = {"bad_pixel_samples": len(rows), "by_cause": by_cause,
              "kernel_matches_wavefront": sum(r["kernel_vs_wavefront"] <= BAD_TOL for r in rows),
              "unexplained": len(unexplained)}
    print(f"{label} bad pixels, by cause: {json.dumps(census)} (a pixel-sample whose kernel value "
          f"and plain value differ by > {BAD_TOL}; causes in order: where the wavefront route's "
          f"path and the plain version's part, then a knife edge: a trace that a perturbation of "
          f"{PROBE_EPS} of its direction and {PROBE_ORIGIN} x max(1, |o|) of its origin flips)",
          flush=True)
    if unexplained:
        raise RuntimeError(f"{label}: the kernel parts from the wavefront route where the paths "
                           f"agree and no trace lies on a knife edge, (pixel, sample) {unexplained}")
    return census


class TexHits:
    """Counts the closest hits on textured materials of the BVH route's
    traces made while it is active (trace.integrator._interpolate_hit), each
    a four-texel lookup in the fused-traversal kernel."""

    def __init__(self, integrator):
        self.mod, self.hits = integrator, 0

    def __enter__(self):
        self.fn = self.mod._interpolate_hit

        def wrapped(scene, hits, origins, directions):
            if "textures" in scene:
                tri = hits["tri"].clamp(min=0)
                width = scene["textures"]["meta"][scene["mat_id"][tri], 1]
                self.hits += int((hits["hit"] & (width > 0)).sum())
            return self.fn(scene, hits, origins, directions)

        self.mod._interpolate_hit = wrapped
        return self

    def __exit__(self, *exc):
        self.mod._interpolate_hit = self.fn


# ---- mesh files: phase 42 writes every file it loads (none is in the repo) ----
# Writers of the formats scene.mesh.load_mesh reads, each from a scene.mesh.Mesh;
# tests/test_torch_mesh_io.py holds them to the port's and the JAX package's
# loaders on the CPU.


def first_use_order(mesh):
    """The mesh with its materials renumbered in order of first use over its
    faces, as an OBJ's usemtl lines number them on load."""
    import numpy as np

    from dxrexperiments_torch.scene.mesh import Mesh

    ids = np.asarray(mesh.material_ids)
    first = list(dict.fromkeys(ids.tolist()))
    remap = np.zeros(max(first) + 1, np.int32)
    remap[first] = np.arange(len(first), dtype=np.int32)
    return Mesh(mesh.positions, mesh.normals, mesh.indices, material_ids=remap[ids],
                materials=[mesh.materials[k] for k in first], name=mesh.name)


def tensor_items(tree, path=""):
    """(path, tensor) of every tensor of a nested dict."""
    import torch

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tensor_items(v, f"{path}/{k}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def traced_frame_kernels(app, log_dir):
    """The device items (kernels and copies with device time) of one frame
    of a viewer app under utils.profiling.device_trace, after one frame
    untraced."""
    from dxrexperiments_torch.core.camera_controller import InputState
    from dxrexperiments_torch.utils.profiling import device_trace

    app.step(InputState())
    with device_trace(log_dir) as prof:
        app.step(InputState())
    return sorted({e.key for e in prof.key_averages()
                   if getattr(e, "self_device_time_total", 0.0) > 0})


def b1_b2_traced(names):
    """(B1's realtime kernel traced, both B2 passes traced)."""
    return (any("fused_realtime_kernel" in k for k in names),
            sum("bilateral_tile_kernel" in k for k in names) == 2)


def unit_normals(normals):
    """Normals that the loaders' float64 renormalisation (glTF, FBX) maps to
    themselves: each row renormalised until it stops changing."""
    import numpy as np

    n = np.asarray(normals, np.float32)
    for _ in range(8):
        v = n.astype(np.float64)
        ln = np.linalg.norm(v, axis=-1, keepdims=True)
        nxt = (v / np.where(ln > 1e-12, ln, 1.0)).astype(np.float32)
        if np.array_equal(nxt, n):
            return n
        n = nxt
    raise RuntimeError("normals did not reach a fixed point of renormalisation")


def _runs(ids):
    """(start, end, id) of each run of equal material ids, in face order."""
    import numpy as np

    if len(ids) == 0:
        return []
    cut = np.flatnonzero(np.diff(ids)) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [len(ids)]])
    return [(int(s), int(e), int(ids[s])) for s, e in zip(starts, ends)]


def write_obj(path: str, mesh, normals: bool = True) -> None:
    """OBJ (+ an MTL of each material's Kd when the mesh has materials): v, vn and
    'f a//a b//b c//c' lines, usemtl at each change of material id in face
    order (ids must appear in order of first use), 9 significant digits (a
    float32 round trip)."""
    import numpy as np

    stem = os.path.splitext(path)[0]
    with open(path, "w") as f:
        if mesh.materials:
            mtl = stem + ".mtl"
            with open(mtl, "w") as m:
                for k, mat in enumerate(mesh.materials):
                    m.write(f"newmtl m{k}\nKd {mat.albedo[0]:.9g} {mat.albedo[1]:.9g} "
                            f"{mat.albedo[2]:.9g}\n")
            f.write(f"mtllib {os.path.basename(mtl)}\n")
        np.savetxt(f, mesh.positions, fmt="v %.9g %.9g %.9g")
        if normals:
            np.savetxt(f, mesh.normals, fmt="vn %.9g %.9g %.9g")
        one = mesh.indices.astype(np.int64) + 1
        fmt = "f %d//%d %d//%d %d//%d" if normals else "f %d %d %d"
        rows = np.repeat(one, 2, axis=1) if normals else one
        runs = _runs(mesh.material_ids) if mesh.materials else [(0, len(one), -1)]
        for s, e, mid in runs:
            if mid >= 0:
                f.write(f"usemtl m{mid}\n")
            np.savetxt(f, rows[s:e], fmt=fmt)


def write_ply(path: str, mesh) -> None:
    """Binary little-endian PLY: float x y z nx ny nz, uchar/int faces."""
    import numpy as np

    v = np.zeros(len(mesh.positions), [(c, "<f4") for c in ("x", "y", "z", "nx", "ny", "nz")])
    for k, c in enumerate("xyz"):
        v[c] = mesh.positions[:, k]
        v["n" + c] = mesh.normals[:, k]
    faces = np.zeros(len(mesh.indices), [("n", "u1"), ("i", "<i4", (3,))])
    faces["n"] = 3
    faces["i"] = mesh.indices
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(v)}\n"
              + "".join(f"property float {c}\n" for c in ("x", "y", "z", "nx", "ny", "nz"))
              + f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii") + v.tobytes() + faces.tobytes())


def _gltf_doc(mesh):
    import numpy as np

    pos = np.ascontiguousarray(mesh.positions, "<f4")
    nrm = np.ascontiguousarray(mesh.normals, "<f4")
    idx = np.ascontiguousarray(mesh.indices.reshape(-1), "<u4")
    blob = pos.tobytes() + nrm.tobytes() + idx.tobytes()
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1},
                                    "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [0.73, 0.73, 0.73, 1.0],
                                                "metallicFactor": 0.0,
                                                "roughnessFactor": 1.0}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(pos), "type": "VEC3",
             "min": lo.tolist(), "max": hi.tolist()},
            {"bufferView": 1, "componentType": 5126, "count": len(nrm), "type": "VEC3"},
            {"bufferView": 2, "componentType": 5125, "count": len(idx), "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
            {"buffer": 0, "byteOffset": pos.nbytes, "byteLength": nrm.nbytes},
            {"buffer": 0, "byteOffset": pos.nbytes + nrm.nbytes, "byteLength": idx.nbytes},
        ],
        "buffers": [{"byteLength": len(blob)}],
    }
    return doc, blob


def write_glb(path: str, mesh) -> None:
    """Binary glTF: one node, one triangle primitive (POSITION, NORMAL,
    u32 indices), one diffuse material."""
    doc, blob = _gltf_doc(mesh)
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\x00" * (-len(blob) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, 28 + len(js) + len(blob)))
        f.write(struct.pack("<I4s", len(js), b"JSON") + js)
        f.write(struct.pack("<I4s", len(blob), b"BIN\x00") + blob)


def write_gltf(path: str, mesh) -> None:
    """JSON glTF with its buffer as a base64 data URI."""
    doc, blob = _gltf_doc(mesh)
    doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                + base64.b64encode(blob).decode())
    with open(path, "w") as f:
        json.dump(doc, f)


def _fbx_prop(v):
    import numpy as np

    if isinstance(v, int):
        return b"L" + struct.pack("<q", v)
    if isinstance(v, float):
        return b"D" + struct.pack("<d", v)
    if isinstance(v, str):
        b = v.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    code = {np.dtype("f8"): b"d", np.dtype("i4"): b"i"}[v.dtype]
    raw = zlib.compress(v.tobytes())
    return code + struct.pack("<III", len(v), 1, len(raw)) + raw


def _fbx_node(name, props=(), children=(), base=0):
    """A node record of FBX 7500 (64-bit offsets) at file offset ``base``;
    children are (name, props, children) triples."""
    name_b = name.encode()
    body = b"".join(_fbx_prop(p) for p in props)
    pos = base + 25 + len(name_b) + len(body)
    kids = b""
    for kname, kprops, kchildren in children:
        kb = _fbx_node(kname, kprops, kchildren, pos)
        kids += kb
        pos += len(kb)
    if children:
        kids += b"\x00" * 25
        pos += 25
    return struct.pack("<QQQB", pos, len(props), len(body), len(name_b)) + name_b + body + kids


def write_fbx(path: str, mesh) -> None:
    """Binary FBX 7500: one Geometry (Vertices, PolygonVertexIndex, normals
    ByVertice) under one Model with a diffuse Material."""
    import numpy as np

    poly = mesh.indices.astype(np.int32).copy()
    poly[:, 2] = ~poly[:, 2]
    geo = [
        ("Vertices", [mesh.positions.astype(np.float64).reshape(-1)], []),
        ("PolygonVertexIndex", [poly.reshape(-1)], []),
        ("LayerElementNormal", [0], [
            ("MappingInformationType", ["ByVertice"], []),
            ("Normals", [mesh.normals.astype(np.float64).reshape(-1)], []),
        ]),
    ]
    objects = ("Objects", [], [
        ("Geometry", [1001, "Geometry::geo", "Mesh"], geo),
        ("Model", [2001, "Model::mesh", "Mesh"], []),
        ("Material", [3001, "Material::white", ""], [("Properties70", [], [
            ("P", ["DiffuseColor", "Color", "", "A", 0.73, 0.73, 0.73], [])])]),
    ])
    conns = ("Connections", [], [("C", ["OO", 1001, 2001], []), ("C", ["OO", 2001, 0], []),
                                 ("C", ["OO", 3001, 2001], [])])
    out = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7500)
    for name, props, children in (objects, conns):
        out += _fbx_node(name, props, children, len(out))
    with open(path, "wb") as f:
        f.write(out + b"\x00" * 25)


def write_dae(path: str, mesh) -> None:
    """COLLADA 1.4: one geometry (positions, <triangles>), one node
    instancing it with a Phong material."""
    pos = " ".join(f"{x:.9g}" for x in mesh.positions.reshape(-1))
    idx = " ".join(str(int(i)) for i in mesh.indices.reshape(-1))
    n_v, n_t = len(mesh.positions), len(mesh.indices)
    text = f"""<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
 <library_effects><effect id="e1"><profile_COMMON><technique sid="t"><phong>
  <diffuse><color>0.73 0.73 0.73 1</color></diffuse>
 </phong></technique></profile_COMMON></effect></library_effects>
 <library_materials><material id="m1"><instance_effect url="#e1"/></material></library_materials>
 <library_geometries><geometry id="g1"><mesh>
  <source id="s1"><float_array id="a1" count="{3 * n_v}">{pos}</float_array>
   <technique_common><accessor source="#a1" count="{n_v}" stride="3"/></technique_common>
  </source>
  <vertices id="v1"><input semantic="POSITION" source="#s1"/></vertices>
  <triangles material="sym" count="{n_t}">
   <input semantic="VERTEX" source="#v1" offset="0"/>
   <p>{idx}</p>
  </triangles>
 </mesh></geometry></library_geometries>
 <library_visual_scenes><visual_scene id="scene"><node>
  <instance_geometry url="#g1"><bind_material><technique_common>
   <instance_material symbol="sym" target="#m1"/>
  </technique_common></bind_material></instance_geometry>
 </node></visual_scene></library_visual_scenes>
</COLLADA>
"""
    with open(path, "w") as f:
        f.write(text)


def config2_stand_in(env):
    """BASELINE config 2's shape without its files (susanne.obj, ground.fbx
    and CathedralRadiance.dds are not in the repository): a 960-triangle UV
    sphere in susanne's place (968 triangles), scaled x4 and lifted to
    y = 4.2 as the JAX config2 scene places susanne, with
    Material.reference_default(); a ground grid of 20 x 20 quads (800
    triangles) at y = 0 spanning +-40 with planar UVs (scale 40) and the
    checker-textured floor material; 1 directional + 1 area light; `env` in
    the cubemap's place; the camera (8, 7, 16) -> (0, 4, 0). 1,760
    triangles, against the JAX run's 1,768."""
    import numpy as np

    from dxrexperiments_torch.core.camera import Camera
    from dxrexperiments_torch.scene import Material, Mesh, Scene
    from dxrexperiments_torch.scene.lights import area_light, directional_light
    from dxrexperiments_torch.scene.procedural import sphere_mesh
    from dxrexperiments_torch.scene.textures import checker_texture, planar_uvs

    n = 20
    xs = np.linspace(-40.0, 40.0, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    pos = np.stack([gx, np.zeros_like(gx), gz], axis=-1).reshape(-1, 3)
    a = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]).reshape(-1)
    b, c = a + 1, a + n + 1
    idx = np.stack([np.stack([a, b, c + 1], -1), np.stack([a, c + 1, c], -1)], 1).reshape(-1, 3)
    ground = Mesh(pos, None, idx.astype(np.int32), name="ground")  # faces +y
    planar_uvs(ground, scale=40.0)
    sc = Scene()
    glossy = sc.add_material(Material.reference_default())
    floor = sc.add_material(Material(
        albedo=(0.85, 0.85, 0.85, 1.0), roughness=0.9,
        albedo_texture=checker_texture(16, (1.0, 1.0, 1.0), (0.45, 0.42, 0.38), size=128)))
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] *= 4.0
    t[1, 3] = 4.2
    sc.add_model(sphere_mesh((0.0, 0.0, 0.0), 1.0, lat=16, lon=32), transform=t, material=glossy)
    sc.add_model(ground, material=floor)
    sc.lights = {
        "dir": [directional_light((0.3, -0.75, -0.6), (1.0, 0.96, 0.9, 1.2))],
        "point": [],
        "area": [area_light((-6.0, 14.0, 6.0), (4.0, 0, 0), (0, 0, -4.0), (1.0, 0.95, 0.85, 3.0))],
    }
    sc.environment = env
    cam = Camera()
    cam.set_eye_at_up((8.0, 7.0, 16.0), (0.0, 4.0, 0.0), (0.0, 1.0, 0.0))
    return sc, cam


class PairCount:
    """Counts the pair tests of the brute-force megakernel on its plain run:
    rays with a non-empty window (and, for occlusion, a direction) times the
    scene's triangle count (num_tris; the padding rows after it never hit,
    and the kernel's sweeps stop before them); and the env
    lookups, the closest-hit rays with a non-empty window that miss (the
    primary and bounce misses, where the kernel samples the environment)."""

    def __init__(self, intersect, torch):
        self.mod, self.torch, self.pairs, self.env_lookups = intersect, torch, 0, 0

    def _live(self, scene, directions, t_min, t_max, occlusion):
        t = self.torch
        tmax = t.as_tensor(t_max, device=directions.device).expand(directions.shape[0])
        live = tmax > t_min
        if occlusion:
            live = live & (directions.abs().sum(dim=1) > 0)
        self.pairs += int(live.sum()) * int(scene["num_tris"])
        return live

    def __enter__(self):
        self.closest, self.any = self.mod.intersect_closest, self.mod.intersect_any

        def closest(scene, o, d, t_min=1e-4, t_max=1e38, **kw):
            live = self._live(scene, d, t_min, t_max, False)
            hits = self.closest(scene, o, d, t_min, t_max, **kw)
            self.env_lookups += int((live & ~hits["hit"]).sum())
            return hits

        def any_(scene, o, d, t_min=1e-4, t_max=1e38, **kw):
            self._live(scene, d, t_min, t_max, True)
            return self.any(scene, o, d, t_min, t_max, **kw)

        self.mod.intersect_closest, self.mod.intersect_any = closest, any_
        return self

    def __exit__(self, *exc):
        self.mod.intersect_closest, self.mod.intersect_any = self.closest, self.any


class TraceHook:
    """Calls on_trace(o, d, t_min, t_max, cull=..., occlusion=...) before
    every B4a trace (module ops.traverse; B4b's with names=BINARY) or B6a
    trace (names=TWO_LEVEL, module ops.traverse2; B6b's with
    names=TWO_LEVEL_BINARY) made while it is active; the traces still run."""

    B4A = ("traverse_fat_closest", "traverse_fat_any")
    BINARY = ("traverse_closest", "traverse_any")  # B4b, module ops.traverse
    TWO_LEVEL = ("traverse2_fat_closest", "traverse2_fat_any")
    TWO_LEVEL_BINARY = ("traverse2_closest", "traverse2_any")  # B6b
    BRUTE = ("trace_closest", "trace_any")  # B3, module ops.intersect_kernel

    def __init__(self, tv, on_trace, names=B4A):
        self.tv, self.on_trace, self.names = tv, on_trace, names

    def __enter__(self):
        tv, on_trace = self.tv, self.on_trace
        self.closest, self.any = (getattr(tv, n) for n in self.names)

        def closest(scene, o, d, t_min=1e-4, t_max=3.0e37, cull_backface=False):
            on_trace(o, d, t_min, t_max, cull=cull_backface, occlusion=False)
            return self.closest(scene, o, d, t_min, t_max, cull_backface)

        def any_(scene, o, d, t_min=1e-4, t_max=3.0e37):
            on_trace(o, d, t_min, t_max, cull=False, occlusion=True)
            return self.any(scene, o, d, t_min, t_max)

        setattr(tv, self.names[0], closest)
        setattr(tv, self.names[1], any_)
        return self

    def __exit__(self, *exc):
        setattr(self.tv, self.names[0], self.closest)
        setattr(self.tv, self.names[1], self.any)


class WalkCount:
    """Counts the slab and pair tests of the walks it is given, with the
    host model of the kernels' walk (ops/traverse.fat_walk_numpy)."""

    def __init__(self, tv, bvh_np):
        self.tv, self.bvh = tv, bvh_np
        self.c = {"rays": 0, "visits": 0, "slab_tests": 0, "pair_tests": 0}
        self.nodes, self.slots = [], []

    def add(self, o, d, t_min, t_max, cull=False, occlusion=False):
        _, c = self.tv.fat_walk_numpy(self.bvh, host_array(o), host_array(d), host_array(t_min),
                                      host_array(t_max), cull=cull, occlusion=occlusion)
        self.c["rays"] += len(o)
        for k in ("visits", "slab_tests", "pair_tests"):
            self.c[k] += c[k]
        self.nodes.append(c["node_ids"])
        self.slots.append(c["slot_ids"])

    def distinct(self):
        import numpy as np

        return (len(np.unique(np.concatenate(self.nodes))),
                len(np.unique(np.concatenate(self.slots))))


def walk_work(wc, scale, bvh, io_bytes_per_ray, attr_lanes=0):
    """(operations, bytes) of walks counted on a sample, scaled by `scale`
    (batch rays / sampled rays): slab and pair operations; the distinct
    nodes (64 bytes) and slots (19 coefficients + attr_lanes) touched,
    scaled but at most the whole arrays, plus each ray's own input and
    output."""
    nodes, slots = wc.distinct()
    n_nodes = min(nodes * scale, int(bvh["bvhf_rows"].shape[0]))
    n_slots = min(slots * scale, int((bvh["slot_tri"] >= 0).sum()))
    ops = (wc.c["slab_tests"] * OPS_SLAB + wc.c["pair_tests"] * OPS_PAIR) * scale
    nbytes = (n_nodes * 64 + n_slots * (19 + attr_lanes) * 4
              + wc.c["rays"] * scale * io_bytes_per_ray)
    return ops, nbytes


def host_array(x):
    """A tensor as a host numpy array, a scalar window as a float32."""
    import numpy as np

    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.float32(x)


NODE_BYTES = {"fat": 64, "binary": 32, "wide": 256, "grouped": 64}  # one node of each tree


def walk1_work(tv, kind, bvh_np, o, d, t_min, t_max, cull, occlusion, scale, io_bytes_per_ray,
               packet=()):
    """(operations, bytes, counts) of the walks of rays o, d (a sample of a
    launch) by B4a, B4b, B4d or B4c (kind "fat", "binary", "wide", "grouped"
    with packet = (tile, group, common_origin); its sample whole packets),
    counted by their host model (ops/traverse.fat_walk_numpy,
    binary_walk_numpy, wide_walk_numpy, fat_packet_walk_numpy with the JAX
    kernel's packets of `tile` rays, without its lag) and scaled by `scale`
    (launch rays / sampled rays): slab and pair operations; the distinct
    nodes (NODE_BYTES each) and slots (19 coefficients) touched, scaled but
    at most the whole arrays, plus each ray's own input and output."""
    if kind == "grouped":
        tile, group, common_origin = packet
        model = lambda *a, **k: tv.fat_packet_walk_numpy(  # noqa: E731
            *a, tile=tile, group=group, common_origin=common_origin, **k)
    else:
        model = {"fat": tv.fat_walk_numpy, "binary": tv.binary_walk_numpy,
                 "wide": tv.wide_walk_numpy}[kind]
    _, c = model(bvh_np, host_array(o), host_array(d), host_array(t_min), host_array(t_max),
                 cull=cull, occlusion=occlusion)
    rows = bvh_np[tv.WALKS[kind][1]]
    n_nodes = min(len(c["node_ids"]) * scale, len(rows) // 8 if kind == "wide" else len(rows))
    n_slots = min(len(c["slot_ids"]) * scale, int((bvh_np["slot_tri"] >= 0).sum()))
    ops = (c["slab_tests"] * OPS_SLAB + c["pair_tests"] * OPS_PAIR) * scale
    nbytes = n_nodes * NODE_BYTES[kind] + n_slots * 19 * 4 + len(o) * scale * io_bytes_per_ray
    return ops, nbytes, c


def walk2_work(tv2, tl_np, o, d, t_min, t_max, cull, occlusion, scale, io_bytes_per_ray,
               kind="fat"):
    """(operations, bytes, counts) of B6a's (kind "fat") or B6b's ("binary")
    walks of rays o, d (a sample of a launch), counted by the host model
    (ops/traverse2.fat_walk2_numpy, binary_walk2_numpy) and scaled by
    `scale` (launch rays / sampled rays): slab, pair and instance-transform
    operations; the distinct TLAS nodes and BLAS nodes (NODE_BYTES each),
    instance rows (64 bytes) and slots (19 coefficients) touched, scaled but
    at most the whole arrays, plus each ray's own input and output."""
    model = tv2.fat_walk2_numpy if kind == "fat" else tv2.binary_walk2_numpy
    tname, _, bname = list(tv2.WALKS[kind][1])[:3]
    _, c = model(tl_np, host_array(o), host_array(d), host_array(t_min), host_array(t_max),
                 cull=cull, occlusion=occlusion)
    ops = (c["slab_tests"] * OPS_SLAB + c["pair_tests"] * OPS_PAIR
           + c["instance_entries"] * OPS_INST) * scale
    caps = {"tlas_node_ids": len(tl_np[tname]), "inst_ids": len(tl_np["inst_rows_t"]),
            "blas_node_ids": len(tl_np[bname]),
            "slot_ids": int((tl_np["slot_tri"] >= 0).sum())}
    touched = {k: min(len(c[k]) * scale, cap) for k, cap in caps.items()}
    nbytes = ((touched["tlas_node_ids"] + touched["blas_node_ids"]) * NODE_BYTES[kind]
              + touched["inst_ids"] * 64 + touched["slot_ids"] * 19 * 4
              + len(o) * scale * io_bytes_per_ray)
    return ops, nbytes, c


def sampled_warps(n: int, rng, device):
    """COUNT_PIXELS ray indices of a launch of n rays, as whole warps: spans
    of WARP_SPAN consecutive rays (WARP_SPAN / WARP warps each, so that a
    queue of the span's live rays packs neighbours as the card's does),
    drawn without replacement."""
    import numpy as np
    import torch

    starts = rng.choice(n // WARP_SPAN, COUNT_PIXELS // WARP_SPAN, replace=False) * WARP_SPAN
    return torch.as_tensor((starts[:, None] + np.arange(WARP_SPAN)).reshape(-1), device=device)


def walk2_figures(tv2, counts, d, t_min, t_max, occlusion: bool) -> dict:
    """B6a's warp figures on sampled warps (rays d, t_min, t_max of the
    sample, the host model's counts of their walks; ops/traverse2.
    warp_costs): the nested walk's and the single loop's costs in node
    visits, summed over the warps, and their ratio; the single loop over a
    queue of the live rays ("queued": for occlusion the kernel's rule, a
    non-zero direction; for closest hits, which take no queue, also a
    non-empty window); the dead rays' share; the idle lane share of each
    design (visits not made over WARP x its cost)."""
    import numpy as np

    d_np = host_array(d)
    live = np.abs(d_np).sum(1) >= 1e-30
    if not occlusion:
        live &= np.broadcast_to(host_array(t_max), len(d_np)) > host_array(t_min)
    w = tv2.warp_costs(counts["per_ray"], live)
    nested, single = int(w["nested"].sum()), int(w["single"].sum())
    queued = int(w["single_queued"].sum())
    lane = int(w["lane_visits"].sum())
    return {"warps": len(w["nested"]), "nested": nested, "single": single, "queued": queued,
            "single_over_nested": single / nested, "queued_over_nested": queued / nested,
            "dead_share": w["dead_share"], "idle_nested": 1.0 - lane / (WARP * nested),
            "idle_single": 1.0 - lane / (WARP * single)}


def figures_line(fig: dict) -> str:
    """A figures dict as "key value, ..." with floats to 4 places."""
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in fig.items())


def plain_sliced(fn, n: int, device):
    """fn(idx) on the rays idx of each slice of PLAIN_SLICE of n rays, the
    results (tensors, or dicts of them) concatenated in ray order."""
    import torch

    parts = [fn(torch.arange(i, min(i + PLAIN_SLICE, n), device=device))
             for i in range(0, n, PLAIN_SLICE)]
    if isinstance(parts[0], dict):
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return torch.cat(parts)


def rows_of(x, idx):
    """x[idx] for a per-ray tensor, x itself for a scalar window."""
    return x[idx] if hasattr(x, "dim") and x.dim() else x


def kernel_ms(prepared, reps: int, torch) -> float:
    """CUDA-event ms of a kernel alone: the launch of a wrapper's
    prepare_launch, without its packing, allocation and error-flag read
    (the flag, where the kernel has one, is read once after the runs)."""
    from dxrexperiments_torch.ops.kernel import raise_on_error

    launch, _, err = prepared
    rc = launch()
    if rc != 0:
        raise RuntimeError(f"kernel launch failed: cudaError {rc}")
    ms = time_ms(launch, reps, torch)
    if err is not None:
        raise_on_error(err, "timed kernel")
    return ms


def device_busy(fn, torch) -> tuple[float, list]:
    """The card's busy ms while fn runs (torch.profiler: the sum of the
    device time of every kernel and copy, idle gaps excluded), and the five
    largest items as (name, ms, calls). (0.0, []) where the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:5]


def time_ms(fn, reps: int, torch) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    t_start = time.perf_counter()  # the phases print their start on this clock
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from dxrexperiments_torch import entry as entry_mod
    from dxrexperiments_torch.app import viewer as viewer_mod
    from dxrexperiments_torch.app.headless import build_scene, mesh_scene, parse_env, yaw_matrix
    from dxrexperiments_torch.app.headless import main as headless_main
    from dxrexperiments_torch.core.camera_controller import InputState
    from dxrexperiments_torch.core import rng as trng
    from dxrexperiments_torch.accel import bvh as tbvh
    from dxrexperiments_torch.core.camera import (
        Camera,
        camera_params,
        primary_ray_grid,
        stack_cameras,
    )
    from dxrexperiments_torch.core.device import setup_device
    from dxrexperiments_torch.models.base import select_route
    from dxrexperiments_torch.models.denoise import (
        DenoiseCompositor,
        denoise_composite,
        denoise_composite_frames,
    )
    from dxrexperiments_torch.models.progressive import (
        ProgressiveRaytracingPipeline,
        make_progressive_step,
    )
    from dxrexperiments_torch.models.realtime import (
        RealtimeRaytracingPipeline,
        make_realtime_denoise_frames_step,
        realtime_frames,
    )
    from dxrexperiments_torch.ops import bilateral as bl
    from dxrexperiments_torch.ops import fused_sample as fs
    from dxrexperiments_torch.ops import fused_traverse as ft
    from dxrexperiments_torch.ops import intersect
    from dxrexperiments_torch.ops import intersect_kernel as ik
    from dxrexperiments_torch.ops import roofline as rf
    from dxrexperiments_torch.ops import traverse as tv
    from dxrexperiments_torch.ops import traverse2 as tv2
    from dxrexperiments_torch.ops import kernel as seam
    from dxrexperiments_torch.ops.kernel import check_errors, raise_on_error
    from dxrexperiments_torch.parallel import launch as par_launch
    from dxrexperiments_torch.parallel import render as par
    from dxrexperiments_torch.scene import Scene, cornell_box, envmap
    from dxrexperiments_torch.scene.dynamic import (
        bake_instances,
        prepare_base,
        refit_scene_instances,
    )
    from dxrexperiments_torch.scene.lights import area_light, default_lights, directional_light
    from dxrexperiments_torch.scene.materials import Material
    from dxrexperiments_torch.scene.mesh import Mesh, load_mesh
    from dxrexperiments_torch.scene.procedural import box_mesh, sphere_mesh
    from dxrexperiments_torch.scene.scene import rebake_material
    from dxrexperiments_torch.trace import integrator as tint
    from dxrexperiments_torch.trace.integrator import (
        RAY_EPSILON,
        RAY_MAX_T,
        default_options,
        render_sample,
        trace_rays,
    )
    from dxrexperiments_torch.utils import cuda_build, native
    from dxrexperiments_torch.utils.dds import write_dds
    from dxrexperiments_torch.utils.image import write_hdr
    from dxrexperiments_torch.utils.profiling import device_trace

    reset_counts = par_launch.reset_launch_counts

    def launches(*names):
        """The launch counts of the kernels ``names`` (one name: its count)."""
        got = par_launch.launch_counts()
        return got[names[0]] if len(names) == 1 else tuple(got[k] for k in names)

    def expect_counts(label, want):
        """Every kernel's launches since the last reset_counts: `want` (name
        -> count) for the kernels it names, 0 for every other. Raises."""
        got = par_launch.launch_counts()
        off = {k: v for k, v in got.items() if v != want.get(k, 0)}
        print(f"launches {label}: {', '.join(f'{k} {v}' for k, v in got.items() if v)}; "
              f"expected {want}, every other 0 -> {'FAIL' if off else 'ok'}", flush=True)
        if off:
            raise RuntimeError(f"unexpected launch counts for {label}: {off}")
        return got

    # tests/test_fused_traverse.py's area rig for the Cornell box, and an area
    # light over the middle of the instanced grids
    cornell_area_rig = {
        "dir": [directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.3))],
        "point": [],
        "area": [area_light((-0.4, 1.96, -0.4), (0.8, 0, 0), (0, 0, 0.8), (1.0, 0.9, 0.7, 4.0))],
    }
    instanced_area = area_light((-2.0, 8.0, -2.0), (4.0, 0, 0), (0, 0, 4.0), (1.0, 0.95, 0.85, 10.0))

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 1", flush=True)
    # ---- 1. the card --------------------------------------------------------
    dev = setup_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device: {kind}", flush=True)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 2", flush=True)
    # ---- 2. build: one nvcc per source and g++ for the SAH builder, together -----
    t0 = time.perf_counter()
    builds = (*(k.library for k in seam.kernels().values()), native.get_lib, native.get_mesh_lib)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futs = [pool.submit(f) for f in builds]
        sah_lib, mesh_lib = [f.result() for f in futs][-2:]
    load_s = time.perf_counter() - t0
    print(f"build csrc/sah_bvh.cpp with g++: "
          f"{'built' if sah_lib is not None else 'no g++: the Morton build serves'}", flush=True)
    print(f"build csrc/mesh_io.cpp (the native OBJ parser) with g++: "
          f"{'built' if mesh_lib is not None else 'FAILED (phase 42 fails)'}", flush=True)
    for name in ("fused_sample", "bilateral", "traverse_fat", "traverse_binary", "traverse8",
                 "fused_traverse", "traverse2_fat", "traverse2_binary", "intersect_brute",
                 "traverse_fat_grouped", "roofline"):
        info = cuda_build.BUILD_INFO[name]
        print(f"build {name}.cu: nvcc {info['seconds']:.2f}s (all builds together "
              f"{load_s:.2f}s) -> {os.path.relpath(info['path'], ROOT)}", flush=True)
        for line in info["log"].splitlines():
            if any(s in line for s in ("entry function", "registers", "spill", "smem")):
                print(f"  ptxas: {line.strip()}", flush=True)

    rng = np.random.default_rng(0)

    def cameras(cam, width, height, s_count, frame0):
        return stack_cameras([
            camera_params(cam, jitter=((rng.random() - 0.5) / width,
                                       (rng.random() - 0.5) / height),
                          frame_count=frame0 + k)
            for k in range(s_count)
        ])

    def parity_scene(env):
        sc, cam = build_scene("cornell-glossy")
        sc.environment = (envmap.gradient_env() if env == "gradient"
                          else envmap.constant_env((0.05, 0.1, 0.2), strength=1.5))
        if env == "emissive":
            sc.materials = [dataclasses.replace(m, emissive=(0.2, 0.3, 0.4, 2.0))
                            for m in sc.materials]
        cam.set_aspect(PARITY_SIZE, PARITY_SIZE)
        return sc.build(dev), cam

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 3a", flush=True)
    # ---- 3a. progressive kernel vs plain parity ----------------------------------
    for name, opts, env in OPTION_CASES:
        scene, cam = parity_scene(env)
        options = default_options(**opts)
        cams = cameras(cam, PARITY_SIZE, PARITY_SIZE, PARITY_S, 11)
        ek = scene["env"]["kind"]
        got = fs.fused_progressive_sum(scene, options, cams, PARITY_SIZE, PARITY_SIZE, ek)
        want = fs.fused_progressive_sum_reference(scene, options, cams, PARITY_SIZE, PARITY_SIZE, ek)
        torch.cuda.synchronize()
        image_gate(f"{name} {PARITY_SIZE}^2 S={PARITY_S}", got, want, PARITY_S)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 3b", flush=True)
    # ---- 3b. realtime kernel vs plain parity -------------------------------------
    for name, opts, env in REALTIME_CASES:
        scene, cam = parity_scene(env)
        options = default_options(**opts)
        cams = cameras(cam, PARITY_SIZE, PARITY_SIZE, 1, 2**31 + 5)
        ek = scene["env"]["kind"]
        got = fs.fused_realtime_outputs(scene, options, {k: v[0] for k, v in cams.items()},
                                        PARITY_SIZE, PARITY_SIZE, ek)
        want = fs.fused_realtime_outputs_reference(scene, options, cams, PARITY_SIZE,
                                                   PARITY_SIZE, ek)
        torch.cuda.synchronize()
        aov_gate(f"realtime {name} {PARITY_SIZE}^2", got, {k: v[0] for k, v in want.items()})
    scene, cam = parity_scene("gradient")
    options = default_options(debug=2)
    cams = cameras(cam, PARITY_SIZE, PARITY_SIZE, 2, 40)
    batch = fs.fused_realtime_outputs_batch(scene, options, cams, PARITY_SIZE, PARITY_SIZE, 1)
    batch_err = 0.0
    for f in range(2):
        single = fs.fused_realtime_outputs(scene, options, {k: v[f] for k, v in cams.items()},
                                           PARITY_SIZE, PARITY_SIZE, 1)
        for k in AOVS:
            batch_err = max(batch_err, float((batch[k][f] - single[k]).abs().max()))
    torch.cuda.synchronize()
    print(f"parity realtime S=2 batch vs 2 single launches: max |d| {batch_err:.3e} (<= 1e-6)",
          flush=True)
    if not batch_err <= 1e-6:
        raise RuntimeError("realtime S=2 batch differs from single-frame launches")

    # ---- 3c. bilateral kernel vs plain parity --------------------------------------
    bl_err = 0.0
    for h, w in ((RT_H, RT_W), (37, 53)):
        inp = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        guide = np.zeros((h, w, 3), np.float32)
        guide[:, w // 2:] = 0.8
        guide += rng.uniform(0, 0.05, (h, w, 3)).astype(np.float32)
        inp_t, guide_t = torch.from_numpy(inp).to(dev), torch.from_numpy(guide).to(dev)
        for axis in (1, 0):
            for radius in BILATERAL_RADII:
                got = bl.bilateral_pass(inp_t, guide_t, float(radius), axis)
                want = bl._bilateral_pass(inp_t, guide_t, float(radius), axis)
                torch.cuda.synchronize()
                bl_err = max(bl_err, bilateral_gate(
                    f"bilateral {h}x{w} axis {axis} radius {radius}", got, want))

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 4", flush=True)
    # ---- 4. the progressive main path ----------------------------------------------
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(MAIN_SIZE, MAIN_SIZE)
    pipe = ProgressiveRaytracingPipeline(MAIN_SIZE, MAIN_SIZE, seed=0, samples_per_frame=MAIN_S,
                                         device=dev)
    pipe.max_iterations = MAIN_S * MAIN_FRAMES
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    first_cams = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(MAIN_FRAMES):
        pipe.update(elapsed_time=f / 60.0, elapsed_frames=f)
        if first_cams is None:
            first_cams = pipe._camera_params
        pipe.render()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    b1_launches = launches("B1")
    img = pipe.get_output()
    finite = bool(img.isfinite().all())
    mean = float(img.mean())
    print(f"main path: {MAIN_FRAMES} frames x {MAIN_S} samples at {MAIN_SIZE}^2 "
          f"({pipe.accum_count} spp) in {main_s:.3f}s host clock, kernel launches {b1_launches}, "
          f"image finite {finite}, mean {mean:.5f}", flush=True)
    if b1_launches != MAIN_FRAMES:
        raise RuntimeError(f"expected {MAIN_FRAMES} kernel launches on the main path, got "
                           f"{b1_launches}")
    if not finite or not mean > 0.0:
        raise RuntimeError("main path image is not finite with a positive mean")
    if pipe.accum_count != MAIN_S * MAIN_FRAMES:
        raise RuntimeError(f"accumulated {pipe.accum_count} samples")

    scene = pipe.scene_data
    options = pipe.options
    scene1, options1 = scene, options  # config 1's, timed again in phase 38
    got = fs.fused_progressive_sum(scene, options, first_cams, MAIN_SIZE, MAIN_SIZE, 0)
    with PairCount(intersect, torch) as b1_count:
        want = fs.fused_progressive_sum_reference(scene, options, first_cams, MAIN_SIZE,
                                                  MAIN_SIZE, 0)
    torch.cuda.synchronize()
    main_gate = image_gate(f"main-path frame 0 {MAIN_SIZE}^2 S={MAIN_S}", got, want, MAIN_S)
    c_tris = int(scene["mt_pack"].shape[1])
    # B1's inputs: a record (tv.REC_WORDS words) and 24 attribute words of
    # each of the num_tris triangles, read once
    b1_tri_bytes = int(scene["num_tris"]) * (tv.REC_WORDS + 24) * 4
    b1_bound = bound(b1_count.pairs * OPS_PAIR, b1_tri_bytes + MAIN_SIZE * MAIN_SIZE * 12)

    def headless(args, label):
        with tempfile.TemporaryDirectory() as tmp:
            png = os.path.join(tmp, "headless.png")
            cmd = [sys.executable, "-m", "dxrexperiments_torch.app.headless", *args,
                   "--device", "cuda", "-o", png]
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                                  check=False)
            for line in (proc.stdout + proc.stderr).strip().splitlines()[-4:]:
                print(f"  headless: {line}", flush=True)
            if proc.returncode != 0 or not os.path.exists(png):
                raise RuntimeError(f"headless {label} failed with exit code {proc.returncode}")
            print(f"headless {label} --device cuda: exit 0", flush=True)

    headless(["--scene", "cornell-glossy", "--size", f"{MAIN_SIZE}x{MAIN_SIZE}", "--spp", "32"],
             f"cornell-glossy {MAIN_SIZE}^2 32 spp")

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 5", flush=True)
    # ---- 5. the realtime + denoise main path (config 4) ----------------------------
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(RT_W, RT_H)
    rt = RealtimeRaytracingPipeline(RT_W, RT_H, seed=0, device=dev)
    rt.set_camera(cam)
    rt.set_scene(sc)
    denoiser = DenoiseCompositor(device=dev)
    frame0 = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(RT_FRAMES):
        rt.update(elapsed_time=f / 60.0, elapsed_frames=f)
        direct, spec = rt.render()
        display = denoiser.dispatch(direct, spec)
        if frame0 is None:
            frame0 = (rt._camera_params, direct, spec, display)
    torch.cuda.synchronize()
    rt_s = time.perf_counter() - t0
    rt_launches, bl_launches = launches("B1 realtime", "B2")
    finite = bool(display.isfinite().all())
    mean = float(display.mean())
    print(f"realtime main path: {RT_FRAMES} frames at {RT_W}x{RT_H} (render + denoise) in "
          f"{rt_s:.3f}s host clock, realtime launches {rt_launches}, bilateral launches "
          f"{bl_launches}, display finite {finite}, mean {mean:.5f}", flush=True)
    if rt_launches != RT_FRAMES or bl_launches != 2 * RT_FRAMES:
        raise RuntimeError(f"expected {RT_FRAMES} realtime and {2 * RT_FRAMES} bilateral launches,"
                           f" got {rt_launches} and {bl_launches}")
    if not finite or not mean > 0.0:
        raise RuntimeError("realtime main path display is not finite with a positive mean")

    rt_scene, rt_options = rt.scene_data, rt.options
    cam0, direct0, spec0, display0 = frame0
    cams0 = {k: v[None] for k, v in cam0.items()}
    with PairCount(intersect, torch) as b1_rt_count:
        want = fs.fused_realtime_outputs_reference(rt_scene, rt_options, cams0, RT_W, RT_H, 0)
    b1_rt_bound = bound(b1_rt_count.pairs * OPS_PAIR, b1_tri_bytes + RT_W * RT_H * 40)
    got = {"direct": direct0, "indirect_specular": spec0}
    got.update({k: v[0] for k, v in fs.fused_realtime_outputs_batch(
        rt_scene, rt_options, cams0, RT_W, RT_H, 0).items() if k not in got})
    torch.cuda.synchronize()
    rt_err = aov_gate(f"realtime main-path frame 0 {RT_W}x{RT_H}", got,
                      {k: v[0] for k, v in want.items()})
    plain_display = denoise_composite(direct0, spec0, denoiser.params, impl="torch")
    torch.cuda.synchronize()
    disp_err = bilateral_gate("realtime main-path frame 0 display vs plain denoiser",
                              display0, plain_display)
    bl_err = max(bl_err, disp_err)

    headless(["--pipeline", "realtime", "--denoise", "--scene", "cornell-glossy", "--size",
              f"{RT_W}x{RT_H}"], f"realtime+denoise cornell-glossy {RT_W}x{RT_H}")

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 6", flush=True)
    # ---- 6. times -------------------------------------------------------------------
    rays = MAIN_SIZE * MAIN_SIZE * MAIN_S
    kern_ms = time_ms(lambda: fs.fused_progressive_sum(
        scene, options, first_cams, MAIN_SIZE, MAIN_SIZE, 0), 20, torch)
    plain_ms = time_ms(lambda: fs.fused_progressive_sum_reference(
        scene, options, first_cams, MAIN_SIZE, MAIN_SIZE, 0), 3, torch)
    for label, ms in (("kernel", kern_ms), ("plain", plain_ms)):
        print(f"time {label}: {ms:.3f} ms per {MAIN_S}-sample dispatch at {MAIN_SIZE}^2, "
              f"{rays / ms / 1e3:.2f} primary Mrays/s [{card}]", flush=True)

    rt_kern_ms = time_ms(lambda: fs.fused_realtime_outputs(
        rt_scene, rt_options, cam0, RT_W, RT_H, 0), 20, torch)
    rt_plain_ms = time_ms(lambda: fs.fused_realtime_outputs_reference(
        rt_scene, rt_options, cams0, RT_W, RT_H, 0), 3, torch)
    for label, ms in (("kernel", rt_kern_ms), ("plain", rt_plain_ms)):
        print(f"time realtime {label}: {ms:.3f} ms per {RT_W}x{RT_H} frame, "
              f"{RT_W * RT_H / ms / 1e3:.2f} primary Mrays/s [{card}]", flush=True)

    radius = float(denoiser.params["max_kernel_size"])
    bl_ms, bl_plain_ms = {}, {}
    for axis in (1, 0):
        bl_ms[axis] = time_ms(lambda: bl.bilateral_pass(spec0, direct0, radius, axis), 50, torch)
        bl_plain_ms[axis] = time_ms(lambda: bl._bilateral_pass(spec0, direct0, radius, axis), 3,
                                    torch)
        print(f"time bilateral axis {axis}: kernel {bl_ms[axis]:.4f} ms, plain "
              f"{bl_plain_ms[axis]:.3f} ms per {RT_W}x{RT_H} pass, radius {radius:g} [{card}]",
              flush=True)

    b2_bound = bound(RT_W * RT_H * (2 * radius + 1) * OPS_TAP, RT_W * RT_H * 12 * 3)
    host_s = {"update": 0.0, "render": 0.0, "dispatch": 0.0}

    def frame():
        t_a = time.perf_counter()
        rt.update(elapsed_time=0.0, elapsed_frames=frame.count)
        t_b = time.perf_counter()
        aovs = rt.render()
        t_c = time.perf_counter()
        display = denoiser.dispatch(*aovs)
        t_d = time.perf_counter()
        host_s["update"] += t_b - t_a
        host_s["render"] += t_c - t_b
        host_s["dispatch"] += t_d - t_c
        frame.count += 1
        return display

    frame.count = RT_FRAMES
    frame()  # warm-up
    torch.cuda.synchronize()
    host_s.update(update=0.0, render=0.0, dispatch=0.0)
    n_frames = 50
    t0 = time.perf_counter()
    for _ in range(n_frames):
        frame()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / n_frames * 1e3
    print(f"time realtime+denoise end to end (update + render + dispatch, host clock, "
          f"synchronised, {n_frames} frames): {frame_ms:.3f} ms per {RT_W}x{RT_H} frame = "
          f"{1e3 / frame_ms:.1f} fps [{card}]", flush=True)
    print("time realtime+denoise host enqueue per frame (host clock, same frames): "
          + ", ".join(f"{k} {v / n_frames * 1e3:.3f} ms" for k, v in host_s.items())
          + f", total {sum(host_s.values()) / n_frames * 1e3:.3f} ms [{card}]", flush=True)

    # the host's share of render: the two packs, as _launch builds them each frame
    n_packs = 200
    t0 = time.perf_counter()
    for _ in range(n_packs):
        fs.pack_cameras(cams0, True)
    cam_us = (time.perf_counter() - t0) / n_packs * 1e6
    t0 = time.perf_counter()
    for _ in range(n_packs):
        fs.pack_consts(rt_scene, rt_options, 0)
    cst_us = (time.perf_counter() - t0) / n_packs * 1e6
    print(f"time host packs per realtime frame (host clock, {n_packs} calls each): "
          f"pack_cameras {cam_us:.1f} us, pack_consts {cst_us:.1f} us [{card}]", flush=True)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 36", flush=True)
    # ---- 36. B1's opt-ins: cluster-gated shadow sweeps, the blocked pixel order ---
    # the main path with each knob set in the environment, as a user sets it:
    # 2 dispatches of config 1 per setting, the images equal bit for bit; then
    # the CLUSTERED and BLOCKED instantiations against the base one on phase
    # 3's option sets at 128^2, config 1's first 512^2 dispatch and the 1080p
    # realtime frame 0 (every AOV), all bit-equal; then the times, in turns.
    opt_dispatches = 2
    sc36, cam36 = build_scene("cornell-glossy")
    cam36.set_aspect(MAIN_SIZE, MAIN_SIZE)
    opt_imgs = {}
    reset_counts()
    for knob, value in ((None, None), ("FUSED_CLUSTERS", "16"), ("FUSED_BLOCK_W", "16")):
        if knob:
            os.environ[knob] = value
        try:
            pipe36 = ProgressiveRaytracingPipeline(MAIN_SIZE, MAIN_SIZE, seed=0,
                                                   samples_per_frame=MAIN_S, device=dev)
            pipe36.max_iterations = MAIN_S * opt_dispatches
            pipe36.set_camera(cam36)
            pipe36.set_scene(sc36)
            for f in range(opt_dispatches):
                pipe36.update(elapsed_time=f / 60.0, elapsed_frames=f)
                pipe36.render()
            opt_imgs[knob] = pipe36.get_output()
        finally:
            if knob:
                del os.environ[knob]
    torch.cuda.synchronize()
    opt_counts = expect_counts(
        f"B1 opt-ins main path ({opt_dispatches} dispatches x {MAIN_S} samples at "
        f"{MAIN_SIZE}^2 each: the base, FUSED_CLUSTERS=16, FUSED_BLOCK_W=16)",
        {"B1": 3 * opt_dispatches, "B1 clustered": opt_dispatches,
         "B1 blocked": opt_dispatches})
    for knob in ("FUSED_CLUSTERS", "FUSED_BLOCK_W"):
        same = torch.equal(opt_imgs[knob], opt_imgs[None])
        print(f"B1 opt-ins main path {knob}=16 vs the base pipeline: images equal {same}",
              flush=True)
        if not same:
            raise RuntimeError(f"the pipeline's image with {knob}=16 differs from the base's")
    del pipe36, opt_imgs

    OPT_SETTINGS = ((8, 0), (16, 0), (24, 0), (0, 8), (0, 16), (0, 32))  # (rows, block_w)
    opt_cases = 0
    for name, opts, env in OPTION_CASES:
        scene_p, cam_p = parity_scene(env)
        options_p = default_options(**opts)
        cams_p = cameras(cam_p, PARITY_SIZE, PARITY_SIZE, PARITY_S, 11)
        ek = scene_p["env"]["kind"]
        base_p = fs.fused_progressive_sum(scene_p, options_p, cams_p, PARITY_SIZE, PARITY_SIZE,
                                          ek, cluster_rows=0, block_w=0)
        for rows, bw in OPT_SETTINGS:
            got = fs.fused_progressive_sum(scene_p, options_p, cams_p, PARITY_SIZE, PARITY_SIZE,
                                           ek, cluster_rows=rows, block_w=bw)
            if not torch.equal(got, base_p):
                raise RuntimeError(f"B1 {name} with cluster_rows {rows}, block_w {bw} differs "
                                   f"from the base kernel")
            opt_cases += 1
    base_1 = fs.fused_progressive_sum(scene, options, first_cams, MAIN_SIZE, MAIN_SIZE, 0,
                                      cluster_rows=0, block_w=0)
    base_rt = fs.realtime_aovs(rt_scene, rt_options, cams0, RT_W, RT_H, 0, cluster_rows=0,
                               block_w=0)
    opt_first = {}
    for rows, bw in OPT_SETTINGS:
        got = fs.fused_progressive_sum(scene, options, first_cams, MAIN_SIZE, MAIN_SIZE, 0,
                                       cluster_rows=rows, block_w=bw)
        got_rt = fs.realtime_aovs(rt_scene, rt_options, cams0, RT_W, RT_H, 0, cluster_rows=rows,
                                  block_w=bw)
        torch.cuda.synchronize()
        opt_first[rows, bw] = got
        if not torch.equal(got, base_1) or not all(torch.equal(got_rt[k], base_rt[k])
                                                   for k in fs.AOV_KEYS):
            raise RuntimeError(f"B1 with cluster_rows {rows}, block_w {bw} differs from the "
                               f"base kernel on config 1's first dispatch or the 1080p frame")
        opt_cases += 2
    print(f"parity B1 opt-ins: cluster_rows 8, 16, 24 (C = {c_tris}) and block_w 8, 16, 32 "
          f"bit-equal (max |d| 0) to the base kernel in all {opt_cases} cases ({len(OPTION_CASES)}"
          f" option sets at {PARITY_SIZE}^2 S={PARITY_S}, config 1's first {MAIN_SIZE}^2 "
          f"dispatch, the {RT_W}x{RT_H} realtime frame 0 on every AOV)", flush=True)
    plain_1 = fs.fused_progressive_sum_reference(scene, options, first_cams, MAIN_SIZE,
                                                 MAIN_SIZE, 0)
    torch.cuda.synchronize()
    opt_gate = image_gate(f"B1 opt-ins config 1 first dispatch {MAIN_SIZE}^2 S={MAIN_S} vs "
                          f"plain", opt_first[16, 0], plain_1, MAIN_S)
    del plain_1, base_rt

    order = [(0, 0), *OPT_SETTINGS, *OPT_SETTINGS[::-1], (0, 0)]
    opt_ms = {}
    for rows, bw in order:
        opt_ms.setdefault((rows, bw), []).append(time_ms(
            lambda: fs.fused_progressive_sum(scene, options, first_cams, MAIN_SIZE, MAIN_SIZE, 0,
                                             cluster_rows=rows, block_w=bw), 20, torch))
    opt_ms = {k: sum(v) / len(v) for k, v in opt_ms.items()}
    labels = {k: "base" if k == (0, 0) else f"clusters {k[0]}" if k[0] else f"block_w {k[1]}"
              for k in opt_ms}
    print(f"time B1 opt-ins per {MAIN_S}-sample {MAIN_SIZE}^2 config-1 dispatch, in turns "
          f"(base, settings, settings reversed, base): "
          + ", ".join(f"{labels[k]} {v:.3f} ms" for k, v in opt_ms.items()) + f" [{card}]",
          flush=True)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 7", flush=True)
    # ---- 7. BVH kernels vs plain at instanced:4 ------------------------------------
    P = BVH_PARITY_SIZE
    bvh_scenes = {}

    def bvh_parity_scene(env):
        if env not in bvh_scenes:
            sc, cam = build_scene(BVH_PARITY_SCENE)  # its default env: the gradient
            if env == "const":
                sc.environment = envmap.constant_env((0.05, 0.1, 0.2), strength=1.5)
            if env == "emissive":
                sc.materials = [dataclasses.replace(m, emissive=(0.2, 0.3, 0.4, 2.0))
                                for m in sc.materials]
            cam.set_aspect(P, P)
            bvh_scenes[env] = (sc.build(dev), cam)
        return bvh_scenes[env]

    def shadow_rays(o, d, hits, light=SHADOW_LIGHT):
        """Shadow rays from the hit points toward a point light at `light`
        (zero directions on misses, as the integrator sends them). The scenes'
        own point light sits in the floor's plane, where every floor point's
        shadow ray grazes the floor: its visibility is a knife edge there (and
        its cosine 0, so no image shows it)."""
        pos = o + hits["t"].clamp(min=0.0)[:, None] * d
        path = torch.tensor(light, device=dev) - pos
        sd = torch.where(hits["hit"][:, None], torch.nn.functional.normalize(path, dim=1), 0.0)
        return pos, sd, (path.norm(dim=1) - RAY_EPSILON).clamp(min=RAY_EPSILON)

    scene4, cam4 = bvh_parity_scene("gradient")
    cams4 = cameras(cam4, P, P, PARITY_S, 21)
    o4, d4 = (x.reshape(-1, 3).to(dev) for x in
              primary_ray_grid({k: v[0] for k, v in cams4.items()}, P, P, fs.JITTER_SCALE))
    got = tv.traverse_fat_closest(scene4, o4, d4, 0.0, RAY_MAX_T, cull_backface=True)
    want = tv.traverse_fat_closest_reference(scene4, o4, d4, 0.0, RAY_MAX_T, cull_backface=True)
    torch.cuda.synchronize()
    hit_gate(f"B4a closest {BVH_PARITY_SCENE} {P}^2 primary rays", got, want, torch)
    pos4, sd4, tmax4 = shadow_rays(o4, d4, want)
    occ_got = tv.traverse_fat_any(scene4, pos4, sd4, RAY_EPSILON, tmax4)
    occ_want = tv.traverse_fat_any_reference(scene4, pos4, sd4, RAY_EPSILON, tmax4)
    torch.cuda.synchronize()
    occlusion_gate(f"B4a any {BVH_PARITY_SCENE} {P}^2 shadow rays", occ_got, occ_want)

    for name, opts, env in OPTION_CASES:
        scene, cam = bvh_parity_scene(env)
        options = default_options(**opts)
        cams = cameras(cam, P, P, PARITY_S, 11)
        ek = scene["env"]["kind"]
        got = ft.fused_traverse_progressive_sum(scene, options, cams, P, P, ek)
        want = ft.fused_traverse_progressive_sum_reference(scene, options, cams, P, P, ek)
        torch.cuda.synchronize()
        image_gate(f"B5 {name} {BVH_PARITY_SCENE} {P}^2 S={PARITY_S}", got, want, PARITY_S)
    b5_rt_err = 0.0
    for name, opts, env in REALTIME_CASES:
        scene, cam = bvh_parity_scene(env)
        options = default_options(**opts)
        cams = cameras(cam, P, P, 1, 2**31 + 5)
        ek = scene["env"]["kind"]
        got = ft.fused_traverse_realtime_outputs(scene, options, {k: v[0] for k, v in cams.items()},
                                                 P, P, ek)
        want = ft.fused_traverse_realtime_outputs_reference(scene, options, cams, P, P, ek)
        torch.cuda.synchronize()
        b5_rt_err = max(b5_rt_err, aov_gate(f"B5 realtime {name} {BVH_PARITY_SCENE} {P}^2", got,
                                            {k: v[0] for k, v in want.items()}))
    scene, cam = bvh_parity_scene("gradient")
    options = default_options(debug=2)
    cams = cameras(cam, P, P, 2, 40)
    batch = ft.realtime_aovs(scene, options, cams, P, P, 1)
    batch_err = 0.0
    for f in range(2):
        single = ft.realtime_aovs(scene, options, {k: v[f:f + 1] for k, v in cams.items()}, P, P, 1)
        for k in fs.AOV_KEYS:
            batch_err = max(batch_err, float((batch[k][f] - single[k][0]).abs().max()))
    torch.cuda.synchronize()
    print(f"parity B5 realtime S=2 batch vs 2 single launches: max |d| {batch_err:.3e} (<= 1e-6)",
          flush=True)
    if not batch_err <= 1e-6:
        raise RuntimeError("B5 realtime S=2 batch differs from single-frame launches")

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 8", flush=True)
    # ---- 8. the BVH main path at full width: instanced:32, 512^2 ----------------
    M = MAIN_SIZE
    sc32, cam32 = build_scene(BVH_MAIN_SCENE)
    cam32.set_aspect(M, M)
    pipe = ProgressiveRaytracingPipeline(M, M, seed=0, samples_per_frame=BVH_S, device=dev)
    pipe.max_iterations = BVH_S * BVH_DISPATCHES
    pipe.set_camera(cam32)
    collapse_s = []  # pack_for_traversal's 8-wide collapse, a Python loop, timed alone
    real_collapse = tv.collapse_wide

    def timed_collapse(*args, **kwargs):
        t1 = time.perf_counter()
        out = real_collapse(*args, **kwargs)
        collapse_s.append(time.perf_counter() - t1)
        return out

    tv.collapse_wide = timed_collapse
    try:
        t0 = time.perf_counter()
        pipe.set_scene(sc32)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        tv.collapse_wide = real_collapse
    scene32 = pipe.scene_data
    bvh32 = scene32["bvh"]
    print(f"build {BVH_MAIN_SCENE}: {scene32['num_tris']} triangles, {build_s:.2f}s host clock "
          f"(flatten, {bvh32['builder'].upper()} BVH build, packs, upload), builder "
          f"{bvh32['builder']}; mt_rows {tuple(bvh32['mt_rows'].shape)} "
          f"({bvh32['mt_rows'].numel() * 4 / 2**20:.0f} MiB), bvhf_nodes "
          f"{tuple(bvh32['bvhf_nodes'].shape)}, bvh_nodes {tuple(bvh32['bvh_nodes'].shape)}, "
          f"bvh8_nodes {tuple(bvh32['bvh8_nodes'].shape)}; collapse_wide (the 8-wide collapse, "
          f"a Python loop) {sum(collapse_s):.3f}s of the build", flush=True)
    first32 = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(BVH_DISPATCHES):
        pipe.update(elapsed_time=f / 60.0, elapsed_frames=f)
        if first32 is None:
            first32 = pipe._camera_params
        pipe.render()
    torch.cuda.synchronize()
    bvh_prog_s = time.perf_counter() - t0
    b5_launches, b1_in_bvh = launches("B5", "B1")
    img = pipe.get_output()
    finite, mean = bool(img.isfinite().all()), float(img.mean())
    print(f"BVH main path: {BVH_DISPATCHES} dispatches x {BVH_S} samples at {M}^2 on "
          f"{BVH_MAIN_SCENE} ({pipe.accum_count} spp) in {bvh_prog_s:.3f}s host clock, B5 launches "
          f"{b5_launches}, B1 launches {b1_in_bvh}, image finite {finite}, mean {mean:.5f}",
          flush=True)
    if b5_launches != BVH_DISPATCHES or b1_in_bvh != 0:
        raise RuntimeError(f"expected {BVH_DISPATCHES} B5 and 0 B1 launches, got {b5_launches} "
                           f"and {b1_in_bvh}")
    if not finite or not mean > 0.0:
        raise RuntimeError("BVH main path image is not finite with a positive mean")

    opts32, ek32 = pipe.options, scene32["env"]["kind"]
    cam1 = {k: v[0] for k, v in first32.items()}
    traces = []  # the inputs of the wavefront frame's B4a launches, in order

    def record(o, d, t_min, t_max, cull, occlusion):
        traces.append((o, d, t_min, t_max, cull, occlusion))

    reset_counts()
    with TraceHook(tv, record):
        wave = render_sample(scene32, opts32, cam1, M, M, impl="cuda")["color"]
    torch.cuda.synchronize()
    wf_closest, wf_any = launches("B4a closest", "B4a any")
    check_errors()
    print(f"wavefront route on {BVH_MAIN_SCENE} at {M}^2, 1 sample: B4a closest launches "
          f"{wf_closest}, any launches {wf_any}", flush=True)
    if (wf_closest, wf_any) != (2, 2) or [t[5] for t in traces] != [False, True, False, True]:
        raise RuntimeError(f"expected 2 closest and 2 any B4a launches, got {wf_closest} and "
                           f"{wf_any}")
    batches = ("primary closest", "depth-0 shadow any", "bounce closest", "depth-1 shadow any")
    b5_one = ft.fused_traverse_progressive_sum(scene32, opts32,
                                               {k: v[None] for k, v in cam1.items()}, M, M, ek32)
    torch.cuda.synchronize()
    b5_gate = image_gate(f"B5 vs the B4a wavefront route {BVH_MAIN_SCENE} {M}^2 1 sample",
                         b5_one, wave, 1)

    # both kernels against the plain version on the same sampled pixels
    o32, d32 = (x.reshape(-1, 3).to(dev) for x in primary_ray_grid(cam1, M, M, fs.JITTER_SCALE))
    pick = torch.as_tensor(rng.choice(M * M, COUNT_PIXELS, replace=False), device=dev)
    seeds = trng.pixel_seeds(M, M, cam1["frame_count"], device=dev).reshape(-1)
    plain_pick = trace_rays(scene32, opts32, o32[pick], d32[pick], seeds[pick],
                            impl="torch")["color"][None]
    torch.cuda.synchronize()
    b5_plain_gate = image_gate(f"B5 vs plain {BVH_MAIN_SCENE} {COUNT_PIXELS} sampled pixels of "
                               f"{M}^2, 1 sample", b5_one.reshape(-1, 3)[pick][None], plain_pick, 1)
    image_gate(f"the B4a wavefront route vs plain {BVH_MAIN_SCENE} {COUNT_PIXELS} sampled pixels "
               f"of {M}^2, 1 sample", wave.reshape(-1, 3)[pick][None], plain_pick, 1)

    # B4a against the brute-force sweep on sampled rays of each closest launch
    # of the frame, and on shadow rays toward SHADOW_LIGHT
    b4a_max_t = 0.0
    for batch, (o, d, t_min, t_max, cull, occlusion) in zip(batches, traces):
        if occlusion:
            continue
        sub = torch.as_tensor(rng.choice(len(o), COUNT_PIXELS, replace=False), device=dev)
        args = (scene32, o[sub], d[sub], t_min, rows_of(t_max, sub))
        got = tv.traverse_fat_closest(*args, cull_backface=cull)
        want = tv.traverse_fat_closest_reference(*args, cull_backface=cull)
        torch.cuda.synchronize()
        b4a_max_t = max(b4a_max_t, hit_gate(
            f"B4a {batch} {BVH_MAIN_SCENE} {COUNT_PIXELS} sampled rays of {len(o)}", got, want,
            torch)["max_abs_t"])
    pos32, sd32, tmax32 = shadow_rays(o32[pick], d32[pick], tv.traverse_fat_closest(
        scene32, o32[pick], d32[pick], 0.0, RAY_MAX_T, cull_backface=True))
    occ_got = tv.traverse_fat_any(scene32, pos32, sd32, RAY_EPSILON, tmax32)
    occ_want = tv.traverse_fat_any_reference(scene32, pos32, sd32, RAY_EPSILON, tmax32)
    torch.cuda.synchronize()
    b4a_any_err = occlusion_gate(f"B4a any {BVH_MAIN_SCENE} {COUNT_PIXELS} sampled shadow rays",
                                 occ_got, occ_want)
    check_errors()

    headless(["--scene", BVH_MAIN_SCENE, "--size", f"{M}x{M}", "--spp", "8"],
             f"{BVH_MAIN_SCENE} {M}^2 8 spp")

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 10a", flush=True)
    # ---- 10a. BVH times at 512^2 (before the realtime pipeline takes the card) ----
    # B4a: each launch of the wavefront frame on its own inputs, with its
    # bound from the host model's counts on COUNT_PIXELS sampled rays
    bvh_np = {k: bvh32[k].cpu().numpy() for k in ("bvhf_rows", "mt_rows")}
    b4a = {False: {"ms": 0.0, "wrapper_ms": 0.0, "ops": 0.0, "bytes": 0.0, "per_launch": []},
           True: {"ms": 0.0, "wrapper_ms": 0.0, "ops": 0.0, "bytes": 0.0, "per_launch": []}}
    b4a_bound_of = {}
    for batch, (o, d, t_min, t_max, cull, occlusion) in zip(batches, traces):
        ms = kernel_ms(tv.prepare_launch(scene32, o, d, t_min, t_max, cull, occlusion), 10, torch)
        if occlusion:
            wrap = time_ms(lambda: tv.traverse_fat_any(scene32, o, d, t_min, t_max), 10, torch)
        else:
            wrap = time_ms(lambda: tv.traverse_fat_closest(scene32, o, d, t_min, t_max,
                                                           cull_backface=cull), 10, torch)
        sub = torch.as_tensor(rng.choice(len(o), COUNT_PIXELS, replace=False), device=dev)
        wc = WalkCount(tv, bvh_np)
        wc.add(o[sub], d[sub], t_min, rows_of(t_max, sub), cull=cull, occlusion=occlusion)
        ops, nbytes = walk_work(wc, len(o) / COUNT_PIXELS, bvh32, 32 + (1 if occlusion else 16))
        bnd = bound(ops, nbytes)
        acc = b4a[occlusion]
        acc["ms"] += ms
        acc["wrapper_ms"] += wrap
        acc["ops"] += ops
        acc["bytes"] += nbytes
        acc["per_launch"].append({"batch": batch, "rays": len(o), "ms": ms, "wrapper_ms": wrap,
                                  "bound_ms": bnd[0], "bound_by": bnd[1]})
        b4a_bound_of[batch] = bnd  # B4c's too (phase 35): the same function of the same rays
        print(f"time B4a {batch} on {BVH_MAIN_SCENE} {M}^2 wavefront sample: {len(o)} rays, "
              f"kernel {ms:.4f} ms, wrapper {wrap:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); "
              f"walk per ray {wc.c['visits'] / COUNT_PIXELS:.2f} visits, "
              f"{wc.c['pair_tests'] / COUNT_PIXELS:.2f} pair tests [{card}]", flush=True)
    b4a_c_bound = bound(b4a[False]["ops"], b4a[False]["bytes"])
    b4a_a_bound = bound(b4a[True]["ops"], b4a[True]["bytes"])

    wc_b5 = WalkCount(tv, bvh_np)
    with TraceHook(tv, wc_b5.add):
        trace_rays(scene32, opts32, o32[pick], d32[pick], seeds[pick], impl="cuda")
    b5_bound = bound(*walk_work(wc_b5, M * M / COUNT_PIXELS, bvh32,
                                12 / max(wc_b5.c["rays"] / COUNT_PIXELS, 1), 10))
    print(f"walk counts per sampled pixel ({COUNT_PIXELS} pixels): B5 sample "
          f"{wc_b5.c['visits'] / COUNT_PIXELS:.1f} visits, "
          f"{wc_b5.c['pair_tests'] / COUNT_PIXELS:.1f} pair tests over {wc_b5.c['rays']} rays",
          flush=True)

    b5_ms = kernel_ms(ft.prepare_launch(scene32, opts32, first32, M, M, ek32, False), 5,
                      torch) / BVH_S
    b5_wrap_ms = time_ms(lambda: ft.fused_traverse_progressive_sum(
        scene32, opts32, first32, M, M, ek32), 5, torch) / BVH_S
    check_errors()
    host_prog_ms = bvh_prog_s / BVH_DISPATCHES * 1e3
    print(f"time B5 progressive: kernel {b5_ms:.3f} ms per sample at {M}^2 on {BVH_MAIN_SCENE} "
          f"({M * M / b5_ms / 1e3:.2f} primary Mrays/s), wrapper {b5_wrap_ms:.3f} ms; pipeline "
          f"{host_prog_ms:.3f} ms per {BVH_S}-sample dispatch on the host clock, synchronised, "
          f"first dispatches included [{card}]", flush=True)
    print(f"[{time.perf_counter() - t_start:.1f}s] phase 32", flush=True)
    # ---- 32. the flattened route without fat nodes: instanced:32, 512^2 ----------
    # phase 8's scene with bvhf_nodes and bvhf_rows dropped from a shallow copy
    # of its bvh: both gates send it to the wavefront route, whose traces take
    # the binary walk (B4b); B4b and B4d on phase 8's four launch inputs
    bin32 = dict(scene32, bvh={k: v for k, v in bvh32.items() if k not in FAT_BVH})
    for mode in ("progressive", "realtime"):
        if select_route(bin32, mode) != "wavefront":
            raise RuntimeError(f"a BVH without fat nodes must take the wavefront route ({mode})")
    pipe_b = ProgressiveRaytracingPipeline(M, M, seed=0, samples_per_frame=BVH_S, device=dev)
    pipe_b.max_iterations = BVH_S * BVH_DISPATCHES
    pipe_b.set_camera(cam32)
    pipe_b.set_scene_data(bin32)
    first_b = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(BVH_DISPATCHES):
        pipe_b.update(elapsed_time=f / 60.0, elapsed_frames=f)
        if first_b is None:
            first_b = pipe_b._camera_params
        pipe_b.render()
    torch.cuda.synchronize()
    bin_prog_s = time.perf_counter() - t0
    want_n = BVH_DISPATCHES * BVH_S * 2
    b4b_counts = expect_counts(f"B4b main path ({BVH_DISPATCHES} dispatches x {BVH_S} samples, "
                               f"{BVH_MAIN_SCENE} without fat nodes)",
                               {"B4b closest": want_n, "B4b any": want_n})
    b4b_counts = {False: b4b_counts["B4b closest"], True: b4b_counts["B4b any"]}
    img = pipe_b.get_output()
    finite, mean = bool(img.isfinite().all()), float(img.mean())
    print(f"B4b main path: {BVH_DISPATCHES} dispatches x {BVH_S} samples at {M}^2 on "
          f"{BVH_MAIN_SCENE} without fat nodes ({pipe_b.accum_count} spp) in {bin_prog_s:.3f}s "
          f"host clock, image finite {finite}, mean {mean:.5f}", flush=True)
    if not finite or not mean > 0.0:
        raise RuntimeError("B4b main path image is not finite with a positive mean")
    if any(not torch.equal(first_b[k], first32[k]) for k in ("eye", "jitter", "frame_count")):
        raise RuntimeError("the B4b pipeline's first cameras differ from phase 8's")

    # its first sample against phase 8's B4a wavefront frame (same camera and
    # seeds) and against the plain version on phase 8's sampled pixels
    wave_b = render_sample(bin32, pipe_b.options, cam1, M, M, impl="cuda")["color"]
    torch.cuda.synchronize()
    check_errors()
    b4b_wave_gate = image_gate(f"the B4b route vs phase 8's B4a route {BVH_MAIN_SCENE} {M}^2 1 "
                               f"sample", wave_b, wave, 1)
    b4b_plain_gate = image_gate(f"the B4b route vs plain {BVH_MAIN_SCENE} {COUNT_PIXELS} sampled "
                                f"pixels of {M}^2, 1 sample", wave_b.reshape(-1, 3)[pick][None],
                                plain_pick, 1)

    # B4b and B4d on each of phase 8's four launch inputs: against B4a on all
    # rays, against the plain version on COUNT_PIXELS sampled rays
    walks = {"binary": ("B4b", tv.traverse_closest, tv.traverse_any),
             "wide": ("B4d", tv.traverse8_closest, tv.traverse8_any)}
    walk_err = {(w, occl): 0.0 for w in walks for occl in (False, True)}
    reset_counts()
    for batch, (o, d, t_min, t_max, cull, occlusion) in zip(batches, traces):
        sub = torch.as_tensor(rng.choice(len(o), COUNT_PIXELS, replace=False), device=dev)
        args, sub_args = (o, d, t_min, t_max), (o[sub], d[sub], t_min, rows_of(t_max, sub))
        if occlusion:
            fat = tv.traverse_fat_any(scene32, *args)
            plain = tv.traverse_fat_any_reference(scene32, *sub_args)
        else:
            fat = tv.traverse_fat_closest(scene32, *args, cull_backface=cull)
            plain = tv.traverse_fat_closest_reference(scene32, *sub_args, cull_backface=cull)
        for walk, (label, closest_fn, any_fn) in walks.items():
            name = f"{label} {batch} {BVH_MAIN_SCENE}"
            if occlusion:
                got = any_fn(bin32, *args)
                torch.cuda.synchronize()
                occlusion_gate(f"{name} vs B4a, all {len(o)} rays", got, fat)
                err = occlusion_gate(f"{name} vs plain, {COUNT_PIXELS} sampled rays", got[sub],
                                     plain)
            else:
                got = closest_fn(bin32, *args, cull_backface=cull)
                torch.cuda.synchronize()
                hit_gate(f"{name} vs B4a, all {len(o)} rays", got, fat, torch)
                err = hit_gate(f"{name} vs plain, {COUNT_PIXELS} sampled rays",
                               {k: v[sub] for k, v in got.items()}, plain, torch)["max_abs_t"]
            walk_err[walk, occlusion] = max(walk_err[walk, occlusion], err)
    check_errors()
    b4d_counts = expect_counts(f"B4b and B4d on phase 8's {len(traces)} launch inputs (B4a beside "
                               f"them)", {"B4a closest": 2, "B4a any": 2, "B4b closest": 2,
                                          "B4b any": 2, "B4d closest": 2, "B4d any": 2})
    b4d_counts = {False: b4d_counts["B4d closest"], True: b4d_counts["B4d any"]}

    # times: each launch alone on its own inputs, B4a, B4b and B4d in turns,
    # with each walk's bound from its host model's counts on sampled rays
    bin_np = {k: bvh32[k].cpu().numpy() for k in ("bvhf_rows", "bvh_rows", "bvh8_rows",
                                                  "mt_rows", "slot_tri")}
    wtime = {(w, occl): {"ms": 0.0, "fat_ms": 0.0, "ops": 0.0, "bytes": 0.0, "per_launch": []}
             for w in walks for occl in (False, True)}
    deepest = {"fat": 0, "binary": 0, "wide": 0}
    for batch, (o, d, t_min, t_max, cull, occlusion) in zip(batches, traces):
        ms = {}
        for walk in ("fat", "binary", "wide", "wide", "binary", "fat"):
            scene_w = scene32 if walk == "fat" else bin32
            ms.setdefault(walk, []).append(kernel_ms(
                tv.prepare_launch(scene_w, o, d, t_min, t_max, cull, occlusion, walk), 10, torch))
        sub = torch.as_tensor(rng.choice(len(o), COUNT_PIXELS, replace=False), device=dev)
        # COUNT_PIXELS / 32 sampled warps (32 consecutive rays each, as the
        # kernel's threads take them): how far each warp's slowest lane sets
        # its steps (SIMT lanes wait for it)
        warps = rng.choice(len(o) // 32, COUNT_PIXELS // 32, replace=False)
        blk = torch.as_tensor((warps[:, None] * 32 + np.arange(32)).reshape(-1), device=dev)
        line = []
        for walk in ("fat", "binary", "wide"):
            ops, nbytes, c = walk1_work(tv, walk, bin_np, o[sub], d[sub], t_min,
                                        rows_of(t_max, sub), cull, occlusion,
                                        len(o) / COUNT_PIXELS, 32 + (1 if occlusion else 16))
            cw = walk1_work(tv, walk, bin_np, o[blk], d[blk], t_min, rows_of(t_max, blk), cull,
                            occlusion, 1.0, 0)[2]
            warp = {k: (float(cw[k].mean()), float(cw[k].reshape(-1, 32).max(1).mean()))
                    for k in ("ray_visits", "ray_leaves")}
            # leaf-weighted: a warp's loop turns and the largest pair tests of
            # each; B4b's and B4d's of their kernels' walks (leaves postponed;
            # B4b's children tested at the parent), not of the JAX order their
            # bounds count
            if walk != "fat":
                kernel_walk = {"binary": tv.parent_walk_numpy, "wide": tv.wide_walk_numpy}[walk]
                cw = kernel_walk(bin_np, host_array(o[blk]), host_array(d[blk]),
                                 host_array(t_min), host_array(rows_of(t_max, blk)), cull=cull,
                                 occlusion=occlusion, postpone=True)[1]
            wt = tv2.turn_costs(cw["turns"], len(blk))
            warp_turns = {k: int(v.sum()) for k, v in wt.items() if k.endswith(("turns", "slots"))}
            deepest[walk] = max(deepest[walk], c["max_stack"])
            k_ms = sum(ms[walk]) / 2
            bnd = bound(ops, nbytes)
            line.append(f"{walk} {k_ms:.4f} ms ({', '.join(f'{x:.4f}' for x in ms[walk])}; bound "
                        f"{bnd[0]:.4f} {bnd[1]}; {c['visits'] / COUNT_PIXELS:.2f} visits, "
                        f"{c['pair_tests'] / COUNT_PIXELS:.2f} pair tests per ray; sampled "
                        f"warps: visits per ray {warp['ray_visits'][0]:.2f}, per warp's slowest "
                        f"lane {warp['ray_visits'][1]:.2f}; leaf tests {warp['ray_leaves'][0]:.2f},"
                        f" {warp['ray_leaves'][1]:.2f}; warp turns and pair slots"
                        f"{' of the kernel walk' if walk != 'fat' else ''} "
                        + ", ".join(f"{k} {v}" for k, v in warp_turns.items()) + ")")
            if walk == "fat":
                continue
            acc = wtime[walk, occlusion]
            acc["ms"] += k_ms
            acc["fat_ms"] += sum(ms["fat"]) / 2
            acc["ops"] += ops
            acc["bytes"] += nbytes
            acc["per_launch"].append({"batch": batch, "rays": len(o), "ms": k_ms,
                                      "fat_ms": sum(ms["fat"]) / 2, "bound_ms": bnd[0],
                                      "bound_by": bnd[1],
                                      "visits_per_ray": c["visits"] / COUNT_PIXELS,
                                      "pair_tests_per_ray": c["pair_tests"] / COUNT_PIXELS,
                                      "warp_max_visits": warp["ray_visits"][1],
                                      "warp_max_leaf_tests": warp["ray_leaves"][1],
                                      "warp_turns_and_slots": warp_turns})
        print(f"time {batch} on {BVH_MAIN_SCENE} {M}^2 ({len(o)} rays), each kernel alone, in "
              f"turns fat, binary, wide, wide, binary, fat: {'; '.join(line)} [{card}]",
              flush=True)
    wbound = {key: bound(acc["ops"], acc["bytes"]) for key, acc in wtime.items()}
    print(f"deepest stack on {COUNT_PIXELS} sampled rays of each launch (host models): fat "
          f"{deepest['fat']}, binary {deepest['binary']}, 8-wide {deepest['wide']} of "
          f"{tv.MAX_STACK}", flush=True)

    # the host's share of the B4b route: dispatches enqueued and synchronised
    n_disp_b = 5
    pipe_b.max_iterations = 2**30  # every timed dispatch renders
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(n_disp_b):
        pipe_b.update(elapsed_time=0.0, elapsed_frames=100 + f)
        pipe_b.render()
    bin_enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    bin_dispatch_s = time.perf_counter() - t0
    pipe_b.get_output()
    print(f"time B4b route host ({n_disp_b} dispatches of {BVH_S} samples, host clock): "
          f"{bin_enqueue_s / n_disp_b * 1e3:.3f} ms enqueued, {bin_dispatch_s / n_disp_b * 1e3:.3f}"
          f" ms synchronised at the end, per dispatch; the main path's "
          f"{bin_prog_s / BVH_DISPATCHES * 1e3:.3f} ms with the first [{card}]", flush=True)
    del pipe_b

    # realtime + denoise at 1080p on the same scene: the wavefront route, B4b
    cam32.set_aspect(RT_W, RT_H)
    rt_b = RealtimeRaytracingPipeline(RT_W, RT_H, seed=0, device=dev)
    rt_b.set_camera(cam32)
    rt_b.set_scene_data(bin32)
    denoiser_b = DenoiseCompositor(device=dev)
    frame0 = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(BIN_RT_FRAMES):
        rt_b.update(elapsed_time=f / 60.0, elapsed_frames=f)
        direct, spec = rt_b.render()
        display = denoiser_b.dispatch(direct, spec)
        if frame0 is None:
            frame0 = (rt_b._camera_params, direct, spec)
    torch.cuda.synchronize()
    bin_rt_s = time.perf_counter() - t0
    n = 2 * BIN_RT_FRAMES
    expect_counts(f"B4b realtime + denoise ({BIN_RT_FRAMES} frames at {RT_W}x{RT_H})",
                  {"B4b closest": n, "B4b any": n, "B2": n})
    finite = all(bool(x.isfinite().all()) for x in (direct, spec, display))
    print(f"B4b realtime + denoise: {BIN_RT_FRAMES} frames at {RT_W}x{RT_H} in {bin_rt_s:.3f}s "
          f"host clock, AOVs and display finite {finite}, display mean {float(display.mean()):.5f} "
          f"[{card}]", flush=True)
    if not finite or not float(display.mean()) > 0.0:
        raise RuntimeError("the B4b realtime + denoise frames failed")
    cam_r, direct0, spec0 = frame0
    o_r, d_r = (x.reshape(-1, 3).to(dev) for x in
                primary_ray_grid(cam_r, RT_W, RT_H, fs.REALTIME_JITTER_SCALE))
    pick_r = torch.as_tensor(rng.choice(RT_W * RT_H, COUNT_PIXELS, replace=False), device=dev)
    seeds_r = trng.pixel_seeds(RT_W, RT_H, cam_r["frame_count"], device=dev).reshape(-1)
    plain_r = trace_rays(bin32, rt_b.options, o_r[pick_r], d_r[pick_r], seeds_r[pick_r],
                         mode="realtime", impl="torch")
    torch.cuda.synchronize()
    b4b_rt_err = max(
        image_gate(f"B4b realtime frame 0 vs plain {BVH_MAIN_SCENE} {COUNT_PIXELS} sampled pixels "
                   f"of {RT_W}x{RT_H} {k}", g.reshape(-1, 3)[pick_r][None],
                   plain_r[k].reshape(COUNT_PIXELS, -1)[None], 1)["max_abs_diff"]
        for k, g in (("direct", direct0), ("indirect_specular", spec0)))
    rt_b.get_output()
    del rt_b, denoiser_b, direct, spec, display, frame0, direct0, spec0, plain_r, o_r, d_r, bin_np
    cam32.set_aspect(M, M)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 35", flush=True)
    # ---- 35. the grouped packet walk (B4c) on phase 8's four launch inputs --------
    # B4a on each input first (the yardstick), then B4c at every packet layout
    # of GROUPINGS (primary closest with common_origin): exactly one B4c launch
    # per input and layout, no other kernel's; against B4a on all rays;
    # against the plain version on GROUPED_PLAIN_RAYS random rays of each
    # launch (B4a on the same rays beside it), and on whole sampled packets,
    # B4c and B4a alike (occlusion knife-edge-aware, as a packet of floor
    # pixels holds many knife edges); against the host model
    # of the card's walk (fat_packet_walk_numpy with packet=32: each warp a
    # packet) on those packets; each launch alone, B4a and B4c in turns, with
    # the bound from B4a's counts on the same rays (the function's need) and
    # the warp and tile packet models' counts beside it; then B4c against the plain
    # version on instanced:4 at 128^2 (phase 7's rays). The phase draws from
    # its own generator, so the phases after it sample what they sampled
    # before it existed.
    rng35 = np.random.default_rng(35)
    fat_ref, plain_ref = [], []
    for batch, (o, d, t_min, t_max, cull, occlusion) in zip(batches, traces):
        fat_ref.append(tv.traverse_fat_any(scene32, o, d, t_min, t_max) if occlusion else
                       tv.traverse_fat_closest(scene32, o, d, t_min, t_max, cull_backface=cull))
        # the plain version on GROUPED_PLAIN_RAYS rays drawn across the launch,
        # one draw for every layout
        pick_r = torch.as_tensor(rng35.choice(len(o), GROUPED_PLAIN_RAYS, replace=False),
                                 device=dev)
        pick_args = (o[pick_r], d[pick_r], t_min, rows_of(t_max, pick_r))
        plain = (tv.traverse_fat_any_reference(scene32, *pick_args) if occlusion else
                 tv.traverse_fat_closest_reference(scene32, *pick_args, cull_backface=cull))
        plain_ref.append((pick_r, plain))
        name = f"B4a {batch} {BVH_MAIN_SCENE} (the yardstick) vs plain, {len(pick_r)} random rays"
        if occlusion:
            occlusion_gate(name, fat_ref[-1][pick_r], plain)
        else:
            fat_pick = {k: v[pick_r] for k, v in fat_ref[-1].items()}
            hit_gate(name, fat_pick, plain, torch)
            tail_census(name, fat_pick, plain, scene32, pick_args[0], pick_args[1])
    shared_origin = bool((traces[0][0] == traces[0][0][0]).all())
    if not shared_origin:
        raise RuntimeError("the primary launch's rays do not share one origin")
    grp_out = {}
    torch.cuda.synchronize()
    reset_counts()
    for tile, group in GROUPINGS:
        for batch, (o, d, t_min, t_max, cull, occlusion) in zip(batches, traces):
            grp_out[tile, group, batch] = (
                tv.traverse_fat_any(scene32, o, d, t_min, t_max, tile=tile, group=group)
                if occlusion else
                tv.traverse_fat_closest(scene32, o, d, t_min, t_max, cull_backface=cull,
                                        tile=tile, group=group,
                                        common_origin=batch == batches[0]))
    torch.cuda.synchronize()
    check_errors()
    b4c_counts = expect_counts(
        f"B4c on phase 8's {len(traces)} launch inputs at {len(GROUPINGS)} packet layouts",
        {"B4c closest": 2 * len(GROUPINGS), "B4c any": 2 * len(GROUPINGS)})
    b4c_counts = {False: b4c_counts["B4c closest"], True: b4c_counts["B4c any"]}
    grp_np = {k: bvh32[k].cpu().numpy() for k in ("bvhf_rows", "mt_rows", "slot_tri")}
    b4c_err = {False: 0.0, True: 0.0}
    b4c = {(tile, group): {occl: {"ms": 0.0, "fat_ms": 0.0, "per_launch": []}
                           for occl in (False, True)} for tile, group in GROUPINGS}
    b4c_bound = {False: b4a_c_bound, True: b4a_a_bound}  # the same function's need as B4a's
    b4c_deepest, model_s = 0, 0.0
    for tile, group in GROUPINGS:
        for batch, (o, d, t_min, t_max, cull, occlusion), fat, (pick_r, plain) in zip(
                batches, traces, fat_ref, plain_ref):
            got = grp_out[tile, group, batch]
            name = f"B4c tile {tile} group {group} {batch} {BVH_MAIN_SCENE}"
            co = batch == batches[0]
            if occlusion:
                agree = occlusion_gate(f"{name} vs B4a, all {len(o)} rays", got, fat)
                t_equal = 1.0 - agree
            else:
                hit_gate(f"{name} vs B4a, all {len(o)} rays", got, fat, torch)
                t_equal = float((got["t"] == fat["t"]).float().mean())
            # whole sampled packets, as the kernel forms them
            n_pk = max(1, GROUPED_MODEL_RAYS // tile)
            packets = rng35.choice(len(o) // tile, n_pk, replace=False)
            sub = torch.as_tensor((packets[:, None] * tile + np.arange(tile)).reshape(-1),
                                  device=dev)
            sub_args = (o[sub], d[sub], t_min, rows_of(t_max, sub))
            t1 = time.perf_counter()
            # the JAX kernel's tile packets: their counts and redundant-work
            # bound; the card's warp packets: the model the kernel is held to
            ops, nbytes, c = walk1_work(tv, "grouped", grp_np, *sub_args, cull, occlusion,
                                        len(o) / len(sub), 32 + (1 if occlusion else 16),
                                        packet=(tile, group, co))
            model, cw = tv.fat_packet_walk_numpy(
                grp_np, *(host_array(x) for x in sub_args), tile, group, cull=cull,
                occlusion=occlusion, common_origin=co, packet=tv.WARP)
            launch_model_s = time.perf_counter() - t1
            model_s += launch_model_s
            b4c_deepest = max(b4c_deepest, c["max_stack"])
            if occlusion:
                err = occlusion_gate(f"{name} vs plain, {len(pick_r)} random rays",
                                     got[pick_r], plain)
                # whole packets, B4c and B4a alike, knife-edge-aware (one probe
                # of every ray that any of the three comparisons finds off)
                want_sub = tv.traverse_fat_any_reference(scene32, *sub_args)
                model_occ = torch.as_tensor(model["occluded"], device=dev)
                probe = ((got[sub] != want_sub) | (fat[sub] != want_sub)
                         | (got[sub] != model_occ)).nonzero()[:, 0]
                edges = torch.zeros_like(want_sub)
                if len(probe):
                    edges[probe] = ray_knife_edges(tv, scene32, sub_args[0][probe],
                                                   sub_args[1][probe], t_min,
                                                   rows_of(sub_args[3], probe))
                knife_of = lambda idx: edges[idx]  # noqa: E731
                for who, res in (("B4c", got[sub]), ("B4a", fat[sub])):
                    knife_occlusion_gate(f"{name}: {who} vs plain, {len(sub)} rays of sampled "
                                         f"packets", res, want_sub, knife_of)
                knife_occlusion_gate(
                    f"{name} vs the host model, {len(sub)} rays of sampled packets", got[sub],
                    model_occ, knife_of)
            else:
                err = hit_gate(f"{name} vs plain, {len(pick_r)} random rays",
                               {k: v[pick_r] for k, v in got.items()}, plain,
                               torch)["max_abs_t"]
                model_hit_gate(f"{name} vs the host model, {len(sub)} rays of sampled packets",
                               {k: v[sub] for k, v in got.items()}, model, torch,
                               lambda idx: ray_t_unstable(
                                   tv, scene32, sub_args[0][idx], sub_args[1][idx], t_min,
                                   rows_of(sub_args[3], idx), cull))
            b4c_err[occlusion] = max(b4c_err[occlusion], err)
            ms = {}
            for walk in ("fat", "grouped", "grouped", "fat"):
                ms.setdefault(walk, []).append(kernel_ms(tv.prepare_launch(
                    scene32, o, d, t_min, t_max, cull, occlusion, walk,
                    (tile, group, co) if walk == "grouped" else ()), 10, torch))
            k_ms, f_ms = sum(ms["grouped"]) / 2, sum(ms["fat"]) / 2
            # the bound is the function's need, B4a's walks of the launch (phase
            # 10a); the packet model's redundant work beside it
            bnd, bnd_pk = b4a_bound_of[batch], bound(ops, nbytes)
            acc = b4c[tile, group][occlusion]
            acc["ms"] += k_ms
            acc["fat_ms"] += f_ms
            acc["per_launch"].append({
                "batch": batch, "rays": len(o), "ms": k_ms, "fat_ms": f_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "t_bit_equal_to_b4a" if not occlusion else
                "occlusion_agrees_with_b4a": t_equal,
                "packet_model_bound_ms": bnd_pk[0],
                "packet_steps": c["visits"] / n_pk,
                "pair_tests_per_ray": c["pair_tests"] / len(sub),
                "warp_model_steps": cw["visits"] / (len(sub) // tv.WARP),
                "warp_model_pair_tests_per_ray": cw["pair_tests"] / len(sub),
                "deepest_stack": c["max_stack"]})
            print(f"time {name} ({len(o)} rays), each kernel alone, in turns fat, grouped, grouped,"
                  f" fat: B4c {k_ms:.4f} ms ({', '.join(f'{x:.4f}' for x in ms['grouped'])}), "
                  f"B4a {f_ms:.4f} ms; bound {bnd[0]:.4f} {bnd[1]} (B4a's walks, phase 10a); "
                  f"warp packet model on {len(sub) // tv.WARP} warps: "
                  f"{cw['visits'] / (len(sub) // tv.WARP):.1f} steps per warp, "
                  f"{cw['pair_tests'] / len(sub):.1f} pair tests per ray; tile packet model on "
                  f"{n_pk} packets: bound {bnd_pk[0]:.4f}, {c['visits'] / n_pk:.1f} steps per "
                  f"packet, {c['pair_tests'] / len(sub):.1f} pair tests per ray, deepest stack "
                  f"{c['max_stack']}; models {launch_model_s:.1f}s; "
                  f"{'occlusion agreeing with B4a' if occlusion else 't bit-equal to B4a on'} "
                  f"{t_equal:.4f} of rays [{card}]", flush=True)
    print(f"B4c: deepest stack {b4c_deepest} of {tv.MAX_STACK} (tile packet model on sampled "
          f"packets); host models {model_s:.1f}s for all layouts and launches", flush=True)

    # at 128^2 on instanced:4 (phase 7's rays) against the plain version
    b4c_small = {}
    want4 = tv.traverse_fat_closest_reference(scene4, o4, d4, 0.0, RAY_MAX_T, cull_backface=True)
    occ_want4 = tv.traverse_fat_any_reference(scene4, pos4, sd4, RAY_EPSILON, tmax4)
    for tile, group in GROUPINGS:
        got = tv.traverse_fat_closest(scene4, o4, d4, 0.0, RAY_MAX_T, cull_backface=True,
                                      tile=tile, group=group, common_origin=True)
        occ = tv.traverse_fat_any(scene4, pos4, sd4, RAY_EPSILON, tmax4, tile=tile, group=group)
        torch.cuda.synchronize()
        label = f"B4c tile {tile} group {group} {BVH_PARITY_SCENE} {P}^2"
        b4c_small[tile, group] = (
            hit_gate(f"{label} primary closest vs plain", got, want4, torch)["max_abs_t"],
            occlusion_gate(f"{label} shadow any vs plain", occ, occ_want4),
            kernel_ms(tv.prepare_launch(scene4, o4, d4, 0.0, RAY_MAX_T, True, False, "grouped",
                                        (tile, group, True)), 10, torch),
            kernel_ms(tv.prepare_launch(scene4, pos4, sd4, RAY_EPSILON, tmax4, False, True,
                                        "grouped", (tile, group, False)), 10, torch))
    check_errors()
    del fat_ref, plain_ref, grp_out, grp_np

    del pipe, traces, pos32, sd32, tmax32, o32, d32, wave, bvh_np, bin32, wave_b  # phase 23 reuses scene32
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 9", flush=True)
    # ---- 9. realtime + denoise on instanced:32 at 1080p --------------------------
    cam32.set_aspect(RT_W, RT_H)
    rt = RealtimeRaytracingPipeline(RT_W, RT_H, seed=0, device=dev)
    rt.set_camera(cam32)
    rt.set_scene(sc32)
    denoiser = DenoiseCompositor(device=dev)
    frame0 = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(BVH_RT_FRAMES):
        rt.update(elapsed_time=f / 60.0, elapsed_frames=f)
        direct, spec = rt.render()
        display = denoiser.dispatch(direct, spec)
        if frame0 is None:
            frame0 = (rt._camera_params, direct, spec)
    torch.cuda.synchronize()
    bvh_rt_s = time.perf_counter() - t0
    b5_rt_launches, bvh_bl_launches = launches("B5 realtime", "B2")
    finite, mean = bool(display.isfinite().all()), float(display.mean())
    print(f"BVH realtime main path: {BVH_RT_FRAMES} frames at {RT_W}x{RT_H} on {BVH_MAIN_SCENE} "
          f"(render + denoise) in {bvh_rt_s:.3f}s host clock, B5 realtime launches "
          f"{b5_rt_launches}, B1 realtime launches {launches('B1 realtime')}, bilateral launches "
          f"{bvh_bl_launches}, display finite {finite}, mean {mean:.5f}", flush=True)
    if (b5_rt_launches, launches("B1 realtime"), bvh_bl_launches) != (BVH_RT_FRAMES, 0,
                                                                     2 * BVH_RT_FRAMES):
        raise RuntimeError(f"expected {BVH_RT_FRAMES} B5 realtime, 0 B1 and {2 * BVH_RT_FRAMES} "
                           f"bilateral launches")
    if not finite or not mean > 0.0:
        raise RuntimeError("BVH realtime display is not finite with a positive mean")
    rt32, rt_opts32 = rt.scene_data, rt.options
    cam0_32, direct0, spec0 = frame0
    want = render_sample(rt32, rt_opts32, cam0_32, RT_W, RT_H, mode="realtime",
                         jitter_scale=fs.REALTIME_JITTER_SCALE, impl="cuda")
    torch.cuda.synchronize()
    b5_rt_wave_err = max(
        image_gate(f"B5 realtime vs the B4a wavefront route {BVH_MAIN_SCENE} {RT_W}x{RT_H} {k}",
                   g, want[k], 1)["max_abs_diff"]
        for k, g in (("direct", direct0), ("indirect_specular", spec0)))

    check_errors()

    # B5 realtime against the plain version on the same sampled pixels, every AOV
    o_rt, d_rt = (x.reshape(-1, 3).to(dev) for x in
                  primary_ray_grid(cam0_32, RT_W, RT_H, fs.REALTIME_JITTER_SCALE))
    pick_rt = torch.as_tensor(rng.choice(RT_W * RT_H, COUNT_PIXELS, replace=False), device=dev)
    seeds_rt = trng.pixel_seeds(RT_W, RT_H, cam0_32["frame_count"], device=dev).reshape(-1)
    cams0_32 = {k: v[None] for k, v in cam0_32.items()}
    aovs0 = ft.realtime_aovs(rt32, rt_opts32, cams0_32, RT_W, RT_H, ek32)
    got = {k: v[0].reshape(RT_W * RT_H, -1)[pick_rt][None] for k, v in aovs0.items()}
    got["color"] = got["direct"] + got["indirect_specular"]
    plain_rt = trace_rays(rt32, rt_opts32, o_rt[pick_rt], d_rt[pick_rt], seeds_rt[pick_rt],
                          mode="realtime", impl="torch")
    torch.cuda.synchronize()
    check_errors()
    b5_rt_plain_err = aov_gate(
        f"B5 realtime vs plain {BVH_MAIN_SCENE} {COUNT_PIXELS} sampled pixels of {RT_W}x{RT_H}",
        got, {k: v.reshape(COUNT_PIXELS, -1)[None] for k, v in plain_rt.items()})
    del aovs0, got, plain_rt

    headless(["--pipeline", "realtime", "--denoise", "--scene", BVH_MAIN_SCENE, "--size",
              f"{RT_W}x{RT_H}"], f"realtime+denoise {BVH_MAIN_SCENE} {RT_W}x{RT_H}")

    bvh_np = {k: rt32["bvh"][k].cpu().numpy() for k in ("bvhf_rows", "mt_rows")}
    wc_rt = WalkCount(tv, bvh_np)
    with TraceHook(tv, wc_rt.add):
        trace_rays(rt32, rt_opts32, o_rt[pick_rt], d_rt[pick_rt], seeds_rt[pick_rt],
                   mode="realtime", impl="cuda")
    b5_rt_bound = bound(*walk_work(wc_rt, RT_W * RT_H / COUNT_PIXELS, rt32["bvh"],
                                   40 / max(wc_rt.c["rays"] / COUNT_PIXELS, 1), 10))
    del bvh_np

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 10b", flush=True)
    # ---- 10b. BVH times: realtime, host, and at the plain version's shape --------
    b5_rt_ms = kernel_ms(ft.prepare_launch(rt32, rt_opts32, cams0_32, RT_W, RT_H, ek32, True), 10,
                         torch)
    b5_rt_wrap_ms = time_ms(lambda: ft.realtime_aovs(rt32, rt_opts32, cams0_32, RT_W, RT_H, ek32),
                            10, torch)

    frame_cams = []  # each timed frame's camera

    def bvh_frame(read_flag: bool, denoise: bool = True):
        """One realtime frame, denoised unless denoise is False. read_flag:
        wait for B5 and read its error flag before the denoiser is queued,
        as a read per launch does."""
        rt.update(elapsed_time=0.0, elapsed_frames=bvh_frame.count)
        frame_cams.append({k: v[None] for k, v in rt._camera_params.items()})
        bvh_frame.count += 1
        aovs = rt.render()
        if read_flag:
            check_errors()
        return denoiser.dispatch(*aovs) if denoise else aovs

    def frames_ms(read_flag: bool, denoise: bool = True, n: int = 10) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            bvh_frame(read_flag, denoise)
        torch.cuda.synchronize()
        check_errors()
        return (time.perf_counter() - t0) / n * 1e3

    bvh_frame.count = BVH_RT_FRAMES
    bvh_frame(False)  # warm-up
    # deferred flag reads, a read after each launch, the read again, deferred
    # again; then update + render alone, without the denoiser
    runs = [frames_ms(flag) for flag in (False, True, True, False)]
    bvh_frame_ms = (runs[0] + runs[3]) / 2
    bvh_frame_read_ms = (runs[1] + runs[2]) / 2
    render_only_ms = frames_ms(False, denoise=False)
    # B5 alone on the last ten frames' cameras, one launch each in turn
    # (kernel_ms repeats one camera's launch)
    prepared = [ft.prepare_launch(rt32, rt_opts32, c, RT_W, RT_H, ek32, True)
                for c in frame_cams[-10:]]
    b5_rt_cams_ms = time_ms(lambda: [p[0]() for p in prepared], 3, torch) / len(prepared)
    for _, _, err in prepared:
        raise_on_error(err, "timed kernel")
    del prepared
    print(f"time B5 realtime: kernel {b5_rt_ms:.3f} ms per {RT_W}x{RT_H} frame on "
          f"{BVH_MAIN_SCENE}, wrapper {b5_rt_wrap_ms:.3f} ms; realtime+denoise end to end "
          f"(host clock, synchronised, 10 frames per run): {bvh_frame_ms:.3f} ms per frame with "
          f"the error flag read later, {bvh_frame_read_ms:.3f} ms with it read right after the "
          f"B5 launch (runs in order deferred, read, read, deferred: "
          f"{', '.join(f'{r:.3f}' for r in runs)} ms); update + render without the denoiser "
          f"{render_only_ms:.3f} ms per frame; B5 alone on those frames' ten cameras in turn "
          f"{b5_rt_cams_ms:.3f} ms per launch [{card}]", flush=True)
    del rt, rt32, o_rt, d_rt
    torch.cuda.empty_cache()

    scene4, cam4 = bvh_parity_scene("gradient")
    opts4 = default_options()
    cams4 = cameras(cam4, P, P, BVH_S, 60)
    pos4, sd4, tmax4 = shadow_rays(o4, d4, tv.traverse_fat_closest(
        scene4, o4, d4, 0.0, RAY_MAX_T, cull_backface=True))
    small = {
        "b5": (ft.prepare_launch(scene4, opts4, cams4, P, P, 1, False),
               lambda: ft.fused_traverse_progressive_sum_reference(scene4, opts4, cams4, P, P, 1),
               BVH_S),
        "b5_rt": (ft.prepare_launch(scene4, opts4, cams4, P, P, 1, True),
                  lambda: ft.fused_traverse_realtime_outputs_reference(scene4, opts4, cams4, P, P,
                                                                       1),
                  BVH_S),
        "b4a_c": (tv.prepare_launch(scene4, o4, d4, 0.0, RAY_MAX_T, True, False),
                  lambda: tv.traverse_fat_closest_reference(scene4, o4, d4, 0.0, RAY_MAX_T, True),
                  1),
        "b4a_a": (tv.prepare_launch(scene4, pos4, sd4, RAY_EPSILON, tmax4, False, True),
                  lambda: tv.traverse_fat_any_reference(scene4, pos4, sd4, RAY_EPSILON, tmax4), 1),
    }
    small_ms = {}
    for key, (prepared, plain, per) in small.items():
        small_ms[key] = (kernel_ms(prepared, 10, torch) / per, time_ms(plain, 2, torch) / per)
        print(f"time {key} at {BVH_PARITY_SCENE} {P}^2: kernel {small_ms[key][0]:.4f} ms, plain "
              f"{small_ms[key][1]:.3f} ms (per sample, frame or trace) [{card}]", flush=True)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 11", flush=True)
    # ---- 11. B6a vs plain at 128^2: the card tests' two-level cases -------------
    def five_scene():
        from dxrexperiments_torch.scene import Material, Scene
        from dxrexperiments_torch.scene.procedural import box_mesh, sphere_mesh

        sc = Scene()
        white = sc.add_material(Material(albedo=(0.73, 0.73, 0.73, 1.0)))
        red = sc.add_material(Material(albedo=(0.9, 0.1, 0.1, 1.0)))
        box, sph = box_mesh((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), sphere_mesh((0.0, 0.0, 0.0), 0.6,
                                                                          lat=6, lon=8)
        for mesh, t, mat in zip((box, box, sph, sph, box), FIVE_TRANSFORMS,
                                (white, red, white, red, white)):
            sc.add_model(mesh, transform=transform(*t), material=mat)
        return sc

    def two_level_case(case):
        """(two-level scene on the card, P^2 probe rays' origins and directions)."""
        if case == "five":
            return five_scene().build_two_level(dev), *probe_rays(P * P, 0, 8.0, 1.8, dev)
        if case == "single":
            from dxrexperiments_torch.scene import Scene
            from dxrexperiments_torch.scene.procedural import sphere_mesh

            sc = Scene()
            sc.add_model(sphere_mesh((0.0, 0.0, 0.0), 1.0), transform=transform((0.3, 0, 0), 0.4,
                                                                                1.2))
            return sc.build_two_level(dev), *probe_rays(P * P, 2, 8.0, 0.8, dev)
        return build_scene(case)[0].build_two_level(dev), *probe_rays(P * P, 1, 12.0, 3.0, dev)

    b6a_parity = {False: 0.0, True: 0.0}
    for case in (*TWO_LEVEL_PARITY, "single"):
        scene_t, o_t, d_t = two_level_case(case)
        got = tv2.traverse2_fat_closest(scene_t, o_t, d_t, 1e-4, 3.0e37)
        want = tv2.two_level_closest_reference(scene_t, o_t, d_t, 1e-4, 3.0e37)
        torch.cuda.synchronize()
        g = hit_gate(f"B6a closest {case} two-level {P * P} probe rays", got, want, torch)
        inst_gate(f"B6a closest {case}", got, want)
        b6a_parity[False] = max(b6a_parity[False], g["max_abs_t"])
        pos_t, sd_t, tmax_t = shadow_rays(o_t, d_t, want)
        if case == "five":
            sd_t[::3] = 0.0  # zero directions: never occluded
        occ_got = tv2.traverse2_fat_any(scene_t, pos_t, sd_t, RAY_EPSILON, tmax_t)
        occ_want = tv2.two_level_any_reference(scene_t, pos_t, sd_t, RAY_EPSILON, tmax_t)
        torch.cuda.synchronize()
        b6a_parity[True] = max(b6a_parity[True], occlusion_gate(
            f"B6a any {case} two-level {P * P} shadow rays", occ_got, occ_want))
        if case == "five" and bool(occ_got[::3].any()):
            raise RuntimeError("B6a occluded a zero-direction shadow ray")
    check_errors()
    del scene_t

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 33", flush=True)
    # ---- 33. B4b, B4d and B6b vs plain at 128^2 -----------------------------------
    # instanced:4 flattened (phase 7's primary rays, culled and not) and the
    # two-level cases of phase 11, every pack without its fat nodes; shadow
    # rays toward SHADOW_LIGHT, a third at zero direction, per-ray t_max
    flat4 = dict(scene4, bvh={k: v for k, v in scene4["bvh"].items() if k not in FAT_BVH})
    bin_parity = {(w, occl): 0.0 for w in ("binary", "wide", "two_level") for occl in (False, True)}
    for cull in (True, False):
        want = tv.traverse_fat_closest_reference(scene4, o4, d4, 0.0, RAY_MAX_T, cull_backface=cull)
        pos_p, sd_p, tmax_p = shadow_rays(o4, d4, want)
        sd_p[::3] = 0.0  # zero directions: never occluded
        occ_want = tv.traverse_fat_any_reference(scene4, pos_p, sd_p, RAY_EPSILON, tmax_p)
        for walk, label, closest_fn, any_fn in (
                ("binary", "B4b", tv.traverse_closest, tv.traverse_any),
                ("wide", "B4d", tv.traverse8_closest, tv.traverse8_any)):
            got = closest_fn(flat4, o4, d4, 0.0, RAY_MAX_T, cull_backface=cull)
            occ = any_fn(flat4, pos_p, sd_p, RAY_EPSILON, tmax_p)
            torch.cuda.synchronize()
            name = f"{label} {BVH_PARITY_SCENE} {P}^2 {'culled ' if cull else ''}primary rays"
            g = hit_gate(f"{name} closest", got, want, torch)
            bin_parity[walk, False] = max(bin_parity[walk, False], g["max_abs_t"])
            bin_parity[walk, True] = max(bin_parity[walk, True], occlusion_gate(
                f"{label} any {BVH_PARITY_SCENE} {P}^2 shadow rays", occ, occ_want))
            if bool(occ[::3].any()):
                raise RuntimeError(f"{label} occluded a zero-direction shadow ray")
    for case in (*TWO_LEVEL_PARITY, "single"):
        scene_t, o_t, d_t = two_level_case(case)
        scene_t = dict(scene_t, tlas={k: v for k, v in scene_t["tlas"].items()
                                      if k not in FAT_TLAS})
        for cull in (False, True):
            got = tv2.traverse2_closest(scene_t, o_t, d_t, 1e-4, 3.0e37, cull_backface=cull)
            want = tv2.two_level_closest_reference(scene_t, o_t, d_t, 1e-4, 3.0e37,
                                                   cull_backface=cull)
            torch.cuda.synchronize()
            name = f"B6b closest {case} two-level {P * P} probe rays{' culled' if cull else ''}"
            g = hit_gate(name, got, want, torch)
            inst_gate(name, got, want)
            bin_parity["two_level", False] = max(bin_parity["two_level", False], g["max_abs_t"])
        pos_t, sd_t, tmax_t = shadow_rays(o_t, d_t, want)
        sd_t[::3] = 0.0  # zero directions: never occluded
        occ = tv2.traverse2_any(scene_t, pos_t, sd_t, RAY_EPSILON, tmax_t)
        occ_want = tv2.two_level_any_reference(scene_t, pos_t, sd_t, RAY_EPSILON, tmax_t)
        torch.cuda.synchronize()
        bin_parity["two_level", True] = max(bin_parity["two_level", True], occlusion_gate(
            f"B6b any {case} two-level {P * P} shadow rays", occ, occ_want))
        if bool(occ[::3].any()):
            raise RuntimeError("B6b occluded a zero-direction shadow ray")
    check_errors()

    # the kernels at the plain version's shape (phase 10b's instanced:4 rays);
    # the plain versions are B4a's there (phase 10b), the same function
    small_bin = {}
    for walk, label in (("binary", "B4b"), ("wide", "B4d")):
        for occl, args in ((False, (o4, d4, 0.0, RAY_MAX_T, True)),
                           (True, (pos4, sd4, RAY_EPSILON, tmax4, False))):
            small_bin[walk, occl] = kernel_ms(tv.prepare_launch(flat4, *args, occl, walk), 10,
                                              torch)
            print(f"time {label} {'any' if occl else 'closest'} at {BVH_PARITY_SCENE} {P}^2: kernel "
                  f"{small_bin[walk, occl]:.4f} ms, B4a {small_ms['b4a_a' if occl else 'b4a_c'][0]:.4f}"
                  f" ms, plain {small_ms['b4a_a' if occl else 'b4a_c'][1]:.3f} ms per trace "
                  f"[{card}]", flush=True)
    del scene_t, flat4

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 12", flush=True)
    # ---- 12. the two-level main path: instanced:32 two-level at 512^2 ------------
    cam32.set_aspect(M, M)
    pipe = ProgressiveRaytracingPipeline(M, M, seed=0, samples_per_frame=BVH_S, device=dev)
    pipe.max_iterations = BVH_S * BVH_DISPATCHES
    pipe.set_camera(cam32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene2 = sc32.build_two_level(dev)
    torch.cuda.synchronize()
    build2_s = time.perf_counter() - t0
    tl2 = scene2["tlas"]
    card_bytes = sum(t.numel() * t.element_size()
                     for t in {id(t): t for t in tensors_of(scene2)}.values() if t.is_cuda)
    tlas_bytes = sum(tl2[k].numel() * 4 for k in ("blas_test", "tlasf_rows", "inst_rows_t",
                                                   "blasf_rows"))
    coef_lanes = list(tv.COEF_LANES)
    if not (torch.equal(tl2["blas_test"][:, :19], tl2["mt_rows"][:, coef_lanes])
            and not bool(tl2["blas_test"][:, 19:].any())):
        raise RuntimeError("B6a's BLAS records differ from the two-level build's mt_rows")
    print(f"build {BVH_MAIN_SCENE} two-level: {scene2['num_tris']} triangles over "
          f"{scene2['tlas_meta']['num_instances']} instances of "
          f"{len(scene2['tlas_meta']['mesh_tri_ranges'])} meshes, {build2_s:.3f}s host clock "
          f"(BLAS builds, packs, refit, upload); {card_bytes / 2**20:.3f} MiB on the card, of "
          f"which B6a reads {tlas_bytes / 2**20:.3f} MiB (blas_test "
          f"{tuple(tl2['blas_test'].shape)}, equal to mt_rows' coefficient lanes, "
          f"tlasf_rows {tuple(tl2['tlasf_rows'].shape)}, inst_rows_t "
          f"{tuple(tl2['inst_rows_t'].shape)}, blasf_rows {tuple(tl2['blasf_rows'].shape)}) "
          f"[{card}]", flush=True)
    pipe.set_scene_data(scene2)
    first2 = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(BVH_DISPATCHES):
        pipe.update(elapsed_time=f / 60.0, elapsed_frames=f)
        if first2 is None:
            first2 = pipe._camera_params
        pipe.render()
    torch.cuda.synchronize()
    two_prog_s = time.perf_counter() - t0
    two_counts = {False: launches("B6a closest"), True: launches("B6a any")}
    others = launches("B1", "B4a closest", "B4a any", "B5")
    img = pipe.get_output()
    finite, mean = bool(img.isfinite().all()), float(img.mean())
    want_n = BVH_DISPATCHES * BVH_S * 2
    print(f"two-level main path: {BVH_DISPATCHES} dispatches x {BVH_S} samples at {M}^2 on "
          f"{BVH_MAIN_SCENE} two-level ({pipe.accum_count} spp) in {two_prog_s:.3f}s host clock, "
          f"B6a closest launches {two_counts[False]}, any launches {two_counts[True]}, B1 / B4a "
          f"closest / B4a any / B5 launches {others}, image finite {finite}, mean {mean:.5f}",
          flush=True)
    if (two_counts[False], two_counts[True]) != (want_n, want_n) or others != (0, 0, 0, 0):
        raise RuntimeError(f"expected {want_n} closest and {want_n} any B6a launches and no "
                           f"other kernel's, got {two_counts} and {others}")
    if not finite or not mean > 0.0:
        raise RuntimeError("two-level main path image is not finite with a positive mean")
    if any(not torch.equal(first2[k], first32[k]) for k in ("eye", "jitter", "frame_count")):
        raise RuntimeError("the two-level pipeline's first cameras differ from phase 8's")

    # the first dispatch's first sample through the wavefront route, against
    # B5's image of the flattened scene (phase 8) on the same camera and seeds
    opts2 = pipe.options
    traces2 = []

    def record2(o, d, t_min, t_max, cull, occlusion):
        traces2.append((o, d, t_min, t_max, cull, occlusion))

    with TraceHook(tv2, record2, TraceHook.TWO_LEVEL):
        wave2 = render_sample(scene2, opts2, cam1, M, M, impl="cuda")["color"]
    torch.cuda.synchronize()
    if [t[5] for t in traces2] != [False, True, False, True]:
        raise RuntimeError(f"expected a closest, an any, a closest and an any B6a trace, got "
                           f"{[t[5] for t in traces2]}")
    two_b5_gate = image_gate(f"two-level (B6a) vs flattened B5 {BVH_MAIN_SCENE} {M}^2 1 sample",
                             wave2, b5_one, 1)

    # B6a against the plain versions on sampled rays of each of the frame's launches
    b6a_err = dict(b6a_parity)
    for batch, (o, d, t_min, t_max, cull, occlusion) in zip(batches, traces2):
        sub = torch.as_tensor(rng.choice(len(o), COUNT_PIXELS, replace=False), device=dev)
        args = (scene2, o[sub], d[sub], t_min, rows_of(t_max, sub))
        label = f"B6a {batch} {BVH_MAIN_SCENE} two-level {COUNT_PIXELS} sampled rays of {len(o)}"
        if occlusion:
            got, want = tv2.traverse2_fat_any(*args), tv2.two_level_any_reference(*args)
            torch.cuda.synchronize()
            b6a_err[True] = max(b6a_err[True], occlusion_gate(label, got, want))
        else:
            got = tv2.traverse2_fat_closest(*args, cull_backface=cull)
            want = tv2.two_level_closest_reference(*args, cull_backface=cull)
            torch.cuda.synchronize()
            b6a_err[False] = max(b6a_err[False], hit_gate(label, got, want, torch)["max_abs_t"])
            inst_gate(label, got, want)
    check_errors()

    # animated frames (the CLI's yaw), then B6a against a brute-force sweep of
    # the flattened scene built at the last frame's transforms
    base_tf = np.stack([inst.transform for inst in sc32.instances])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(TWO_LEVEL_FRAMES):
        moved = np.einsum("ij,njk->nik", yaw_matrix(0.05 * f), base_tf)
        pipe.set_instance_transforms(moved)
        pipe.update(elapsed_time=f / 60.0, elapsed_frames=BVH_DISPATCHES + f)
        pipe.render()
    torch.cuda.synchronize()
    anim_s = time.perf_counter() - t0
    anim_counts = launches("B6a closest", "B6a any")
    img = pipe.get_output()
    print(f"two-level animated: {TWO_LEVEL_FRAMES} frames (refit + {BVH_S} samples each) in "
          f"{anim_s:.3f}s host clock, B6a launches {anim_counts}, accumulated {pipe.accum_count}, "
          f"image finite {bool(img.isfinite().all())}", flush=True)
    want_n = TWO_LEVEL_FRAMES * BVH_S * 2
    if anim_counts != (want_n, want_n) or pipe.accum_count != BVH_S:
        raise RuntimeError("the animated frames did not refit, restart and render as expected")
    if not bool(img.isfinite().all()):
        raise RuntimeError("the animated two-level image is not finite")
    cam_a = {k: v[0] for k, v in pipe._camera_params.items()}
    o_a, d_a = (x.reshape(-1, 3).to(dev) for x in primary_ray_grid(cam_a, M, M, fs.JITTER_SCALE))
    pick_a = torch.as_tensor(rng.choice(M * M, COUNT_PIXELS, replace=False), device=dev)
    got = tv2.traverse2_fat_closest(pipe.scene_data, o_a[pick_a], d_a[pick_a], 0.0, RAY_MAX_T,
                                    cull_backface=True)
    saved = [inst.transform for inst in sc32.instances]
    for inst, t in zip(sc32.instances, moved):
        inst.transform = t
    flat = sc32.build(dev, accel="none")
    for inst, t in zip(sc32.instances, saved):
        inst.transform = t
    want = intersect.intersect_closest(flat, o_a[pick_a], d_a[pick_a], 0.0, RAY_MAX_T,
                                       cull_backface=True)
    torch.cuda.synchronize()
    check_errors()
    anim_gate = flat_gate(f"B6a after {TWO_LEVEL_FRAMES} animated frames vs the brute-force "
                          f"sweep of the flattened scene at the same transforms, {COUNT_PIXELS} "
                          f"sampled primary rays", got, want, torch)
    del flat

    headless(["--scene", BVH_MAIN_SCENE, "--accel", "two-level", "--animate-instances", "--size",
              f"{M}x{M}", "--spp", "8"], f"{BVH_MAIN_SCENE} two-level animated {M}^2 8 spp")

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 13", flush=True)
    # ---- 13. realtime + denoise at 1080p on the two-level scene -------------------
    cam32.set_aspect(RT_W, RT_H)
    rt = RealtimeRaytracingPipeline(RT_W, RT_H, seed=0, device=dev)
    rt.set_camera(cam32)
    rt.set_scene_data(scene2)
    denoiser = DenoiseCompositor(device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(TWO_LEVEL_RT_FRAMES):
        rt.update(elapsed_time=f / 60.0, elapsed_frames=f)
        direct, spec = rt.render()
        display = denoiser.dispatch(direct, spec)
    torch.cuda.synchronize()
    two_rt_s = time.perf_counter() - t0
    rt_counts = launches("B6a closest", "B6a any", "B2", "B1 realtime", "B5 realtime")
    finite = all(bool(x.isfinite().all()) for x in (direct, spec, display))
    mean = float(display.mean())
    print(f"two-level realtime + denoise: {TWO_LEVEL_RT_FRAMES} frames at {RT_W}x{RT_H} in "
          f"{two_rt_s:.3f}s host clock, B6a closest / any / bilateral / B1 realtime / B5 "
          f"realtime launches {rt_counts}, AOVs and display finite {finite}, display mean "
          f"{mean:.5f} [{card}]", flush=True)
    n = TWO_LEVEL_RT_FRAMES * 2
    if rt_counts != (n, n, n, 0, 0) or not finite or not mean > 0.0:
        raise RuntimeError("the two-level realtime + denoise frames failed")
    rt.get_output()
    del rt, direct, spec, display
    cam32.set_aspect(M, M)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 14", flush=True)
    # ---- 14. two-level times ----------------------------------------------------
    # B6a: each launch of the wavefront frame on its own inputs, with its bound
    # and the warp figures (walk2_figures) from the host model's counts on
    # COUNT_PIXELS rays of sampled whole warps
    tl_np = {k: tl2[k].cpu().numpy() for k in ("tlasf_rows", "inst_rows_t", "blasf_rows",
                                                "mt_rows", "slot_tri")}
    b6a = {False: {"ms": 0.0, "wrapper_ms": 0.0, "ops": 0.0, "bytes": 0.0, "per_launch": []},
           True: {"ms": 0.0, "wrapper_ms": 0.0, "ops": 0.0, "bytes": 0.0, "per_launch": []}}
    for batch, (o, d, t_min, t_max, cull, occlusion) in zip(batches, traces2):
        ms = kernel_ms(tv2.prepare_launch(tl2, o, d, t_min, t_max, cull, occlusion), 10, torch)
        if occlusion:
            wrap = time_ms(lambda: tv2.traverse2_fat_any(scene2, o, d, t_min, t_max), 10, torch)
        else:
            wrap = time_ms(lambda: tv2.traverse2_fat_closest(scene2, o, d, t_min, t_max,
                                                             cull_backface=cull), 10, torch)
        sub = sampled_warps(len(o), rng, dev)
        ops, nbytes, c = walk2_work(tv2, tl_np, o[sub], d[sub], t_min, rows_of(t_max, sub), cull,
                                    occlusion, len(o) / COUNT_PIXELS,
                                    32 + (1 if occlusion else 20))
        bnd = bound(ops, nbytes)
        fig = walk2_figures(tv2, c, d[sub], t_min, rows_of(t_max, sub), occlusion)
        acc = b6a[occlusion]
        acc["ms"] += ms
        acc["wrapper_ms"] += wrap
        acc["ops"] += ops
        acc["bytes"] += nbytes
        per_ray = {k: c[k] / COUNT_PIXELS for k in ("tlas_visits", "instance_entries",
                                                     "blas_visits", "pair_tests")}
        acc["per_launch"].append({"batch": batch, "rays": len(o), "ms": ms, "wrapper_ms": wrap,
                                  "bound_ms": bnd[0], "bound_by": bnd[1], "per_ray": per_ray,
                                  "figures": fig})
        print(f"time B6a {batch} on {BVH_MAIN_SCENE} two-level {M}^2 wavefront sample: {len(o)} "
              f"rays, live share {1.0 - fig['dead_share']:.4f}, kernel {ms:.4f} ms, wrapper "
              f"{wrap:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), {ms / bnd[0]:.1f}x the bound; "
              f"walk per ray {per_ray['tlas_visits']:.2f} TLAS visits, "
              f"{per_ray['instance_entries']:.2f} instance entries, {per_ray['blas_visits']:.2f} "
              f"BLAS visits, {per_ray['pair_tests']:.2f} pair tests [{card}]", flush=True)
        print(f"figures B6a {batch}: {figures_line(fig)}", flush=True)
    b6a_bound = {k: bound(b6a[k]["ops"], b6a[k]["bytes"]) for k in (False, True)}

    # the host's share: a refit's enqueue and the whole refit, and a dispatch
    n_refit = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(n_refit):
        refit_scene_instances(scene2, np.einsum("ij,njk->nik", yaw_matrix(0.01 * f), base_tf))
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    pipe.max_iterations = 2**30  # every timed dispatch renders
    t0 = time.perf_counter()
    for f in range(n_refit):
        pipe.update(elapsed_time=0.0, elapsed_frames=100 + f)
        pipe.render()
    dispatch_enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    dispatch_s = time.perf_counter() - t0
    pipe.get_output()
    print(f"time two-level host (host clock, {n_refit} calls each): refit "
          f"{enqueue_s / n_refit * 1e3:.3f} ms enqueue, {refit_s / n_refit * 1e3:.3f} ms "
          f"synchronised at the end; progressive dispatch ({BVH_S} samples, wavefront route) "
          f"{dispatch_enqueue_s / n_refit * 1e3:.3f} ms enqueue, "
          f"{dispatch_s / n_refit * 1e3:.3f} ms synchronised at the end; the main path's "
          f"{two_prog_s / BVH_DISPATCHES * 1e3:.3f} ms per dispatch with the first, the "
          f"animated {anim_s / TWO_LEVEL_FRAMES * 1e3:.3f} ms per frame with its refit "
          f"[{card}]", flush=True)

    # B6a beside its plain versions at the parity shape (instanced:4, 128^2)
    scene4_2 = build_scene(BVH_PARITY_SCENE)[0].build_two_level(dev)
    small2 = {}
    for occl, prepared, plain in (
            (False, tv2.prepare_launch(scene4_2["tlas"], o4, d4, 0.0, RAY_MAX_T, True, False),
             lambda: tv2.two_level_closest_reference(scene4_2, o4, d4, 0.0, RAY_MAX_T, True)),
            (True, tv2.prepare_launch(scene4_2["tlas"], pos4, sd4, RAY_EPSILON, tmax4, False,
                                      True),
             lambda: tv2.two_level_any_reference(scene4_2, pos4, sd4, RAY_EPSILON, tmax4))):
        small2[occl] = (kernel_ms(prepared, 10, torch), time_ms(plain, 2, torch))
        print(f"time B6a {'any' if occl else 'closest'} at {BVH_PARITY_SCENE} two-level {P}^2: "
              f"kernel {small2[occl][0]:.4f} ms, plain {small2[occl][1]:.3f} ms per trace "
              f"[{card}]", flush=True)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 34", flush=True)
    # ---- 34. the two-level route without fat nodes: instanced:32, 512^2 ----------
    # phase 12's two-level scene with tlasf_nodes and tlasf_rows dropped: the
    # wavefront route's traces take the binary two-level walk (B6b)
    bin2 = dict(scene2, tlas={k: v for k, v in tl2.items() if k not in FAT_TLAS})
    cam32.set_aspect(M, M)
    pipe_c = ProgressiveRaytracingPipeline(M, M, seed=0, samples_per_frame=BVH_S, device=dev)
    pipe_c.max_iterations = BVH_S * BVH_DISPATCHES
    pipe_c.set_camera(cam32)
    pipe_c.set_scene_data(bin2)
    first_c = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(BVH_DISPATCHES):
        pipe_c.update(elapsed_time=f / 60.0, elapsed_frames=f)
        if first_c is None:
            first_c = pipe_c._camera_params
        pipe_c.render()
    torch.cuda.synchronize()
    bin2_prog_s = time.perf_counter() - t0
    want_n = BVH_DISPATCHES * BVH_S * 2
    b6b_counts = expect_counts(f"B6b main path ({BVH_DISPATCHES} dispatches x {BVH_S} samples, "
                               f"{BVH_MAIN_SCENE} two-level without fat nodes)",
                               {"B6b closest": want_n, "B6b any": want_n})
    b6b_counts = {False: b6b_counts["B6b closest"], True: b6b_counts["B6b any"]}
    img = pipe_c.get_output()
    finite, mean = bool(img.isfinite().all()), float(img.mean())
    print(f"B6b main path: {BVH_DISPATCHES} dispatches x {BVH_S} samples at {M}^2 on "
          f"{BVH_MAIN_SCENE} two-level without fat nodes ({pipe_c.accum_count} spp) in "
          f"{bin2_prog_s:.3f}s host clock, image finite {finite}, mean {mean:.5f}", flush=True)
    if not finite or not mean > 0.0:
        raise RuntimeError("B6b main path image is not finite with a positive mean")
    if any(not torch.equal(first_c[k], first32[k]) for k in ("eye", "jitter", "frame_count")):
        raise RuntimeError("the B6b pipeline's first cameras differ from phase 8's")

    # its first sample against phase 12's B6a frame (same camera and seeds)
    wave_c = render_sample(bin2, pipe_c.options, cam1, M, M, impl="cuda")["color"]
    torch.cuda.synchronize()
    check_errors()
    b6b_wave_gate = image_gate(f"the B6b route vs phase 12's B6a route {BVH_MAIN_SCENE} "
                               f"two-level {M}^2 1 sample", wave_c, wave2, 1)

    # B6b on each of phase 12's four launch inputs: against B6a on all rays,
    # against the plain versions on COUNT_PIXELS sampled rays
    b6b_err = {False: 0.0, True: 0.0}
    for batch, (o, d, t_min, t_max, cull, occlusion) in zip(batches, traces2):
        sub = torch.as_tensor(rng.choice(len(o), COUNT_PIXELS, replace=False), device=dev)
        args, sub_args = (o, d, t_min, t_max), (o[sub], d[sub], t_min, rows_of(t_max, sub))
        name = f"B6b {batch} {BVH_MAIN_SCENE} two-level"
        if occlusion:
            got, fat = tv2.traverse2_any(bin2, *args), tv2.traverse2_fat_any(scene2, *args)
            plain = tv2.two_level_any_reference(scene2, *sub_args)
            torch.cuda.synchronize()
            occlusion_gate(f"{name} vs B6a, all {len(o)} rays", got, fat)
            b6b_err[True] = max(b6b_err[True], occlusion_gate(
                f"{name} vs plain, {COUNT_PIXELS} sampled rays", got[sub], plain))
        else:
            got = tv2.traverse2_closest(bin2, *args, cull_backface=cull)
            fat = tv2.traverse2_fat_closest(scene2, *args, cull_backface=cull)
            plain = tv2.two_level_closest_reference(scene2, *sub_args, cull_backface=cull)
            torch.cuda.synchronize()
            hit_gate(f"{name} vs B6a, all {len(o)} rays", got, fat, torch)
            inst_gate(f"{name} vs B6a", got, fat)
            got_sub = {k: v[sub] for k, v in got.items()}
            b6b_err[False] = max(b6b_err[False], hit_gate(
                f"{name} vs plain, {COUNT_PIXELS} sampled rays", got_sub, plain,
                torch)["max_abs_t"])
            inst_gate(f"{name} vs plain", got_sub, plain)
    check_errors()

    # animated frames (the CLI's yaw): the refit keeps the TLAS without fat
    # nodes; then B6b against B6a on sampled primary rays at the last refit
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(TWO_LEVEL_FRAMES):
        moved = np.einsum("ij,njk->nik", yaw_matrix(0.05 * f), base_tf)
        pipe_c.set_instance_transforms(moved)
        pipe_c.update(elapsed_time=f / 60.0, elapsed_frames=BVH_DISPATCHES + f)
        pipe_c.render()
    torch.cuda.synchronize()
    anim_c_s = time.perf_counter() - t0
    n = TWO_LEVEL_FRAMES * BVH_S * 2
    expect_counts(f"B6b animated ({TWO_LEVEL_FRAMES} refits + {BVH_S} samples each)",
                  {"B6b closest": n, "B6b any": n})
    img = pipe_c.get_output()
    if (FAT_TLAS[0] in pipe_c.scene_data["tlas"] or pipe_c.accum_count != BVH_S
            or not bool(img.isfinite().all())):
        raise RuntimeError("the animated B6b frames did not refit, restart and render as expected")
    cam_c = {k: v[0] for k, v in pipe_c._camera_params.items()}
    o_c, d_c = (x.reshape(-1, 3).to(dev) for x in primary_ray_grid(cam_c, M, M, fs.JITTER_SCALE))
    pick_c = torch.as_tensor(rng.choice(M * M, COUNT_PIXELS, replace=False), device=dev)
    fat_moved = refit_scene_instances(scene2, moved)
    got = tv2.traverse2_closest(pipe_c.scene_data, o_c[pick_c], d_c[pick_c], 0.0, RAY_MAX_T,
                                cull_backface=True)
    want = tv2.traverse2_fat_closest(fat_moved, o_c[pick_c], d_c[pick_c], 0.0, RAY_MAX_T,
                                     cull_backface=True)
    torch.cuda.synchronize()
    check_errors()
    b6b_anim_gate = hit_gate(f"B6b after {TWO_LEVEL_FRAMES} animated frames vs B6a at the same "
                             f"refit, {COUNT_PIXELS} sampled primary rays", got, want, torch)
    inst_gate("B6b after the animated frames vs B6a", got, want)
    print(f"B6b animated: {TWO_LEVEL_FRAMES} frames (refit + {BVH_S} samples each) in "
          f"{anim_c_s:.3f}s host clock", flush=True)

    # times: each launch of phase 12's frame alone, B6a and B6b in turns, with
    # B6b's bound from its host model's counts on sampled rays
    tlb_np = {k: tl2[k].cpu().numpy() for k in ("tlas_rows", "inst_rows_t", "blas_rows",
                                                 "mt_rows", "slot_tri")}
    b6b = {False: {"ms": 0.0, "fat_ms": 0.0, "ops": 0.0, "bytes": 0.0, "per_launch": []},
           True: {"ms": 0.0, "fat_ms": 0.0, "ops": 0.0, "bytes": 0.0, "per_launch": []}}
    for batch, (o, d, t_min, t_max, cull, occlusion) in zip(batches, traces2):
        ms = {}
        for walk in ("fat", "binary", "binary", "fat"):
            ms.setdefault(walk, []).append(kernel_ms(tv2.prepare_launch(
                tl2, o, d, t_min, t_max, cull, occlusion, walk), 10, torch))
        sub = torch.as_tensor(rng.choice(len(o), COUNT_PIXELS, replace=False), device=dev)
        ops, nbytes, c = walk2_work(tv2, tlb_np, o[sub], d[sub], t_min, rows_of(t_max, sub),
                                    cull, occlusion, len(o) / COUNT_PIXELS,
                                    32 + (1 if occlusion else 20), kind="binary")
        bnd = bound(ops, nbytes)
        k_ms, f_ms = sum(ms["binary"]) / 2, sum(ms["fat"]) / 2
        acc = b6b[occlusion]
        acc["ms"] += k_ms
        acc["fat_ms"] += f_ms
        acc["ops"] += ops
        acc["bytes"] += nbytes
        per_ray = {k: c[k] / COUNT_PIXELS for k in ("tlas_visits", "instance_entries",
                                                     "blas_visits", "pair_tests")}
        acc["per_launch"].append({"batch": batch, "rays": len(o), "ms": k_ms, "fat_ms": f_ms,
                                  "bound_ms": bnd[0], "bound_by": bnd[1], "per_ray": per_ray})
        print(f"time B6b {batch} on {BVH_MAIN_SCENE} two-level {M}^2 wavefront sample: {len(o)} "
              f"rays, kernel {k_ms:.4f} ms ({', '.join(f'{x:.4f}' for x in ms['binary'])}), B6a "
              f"{f_ms:.4f} ms ({', '.join(f'{x:.4f}' for x in ms['fat'])}), in turns B6a, B6b, "
              f"B6b, B6a; bound {bnd[0]:.4f} ms ({bnd[1]}); walk per ray "
              f"{per_ray['tlas_visits']:.2f} TLAS visits, {per_ray['instance_entries']:.2f} "
              f"instance entries, {per_ray['blas_visits']:.2f} BLAS visits, "
              f"{per_ray['pair_tests']:.2f} pair tests [{card}]", flush=True)
    b6b_bound = {k: bound(b6b[k]["ops"], b6b[k]["bytes"]) for k in (False, True)}
    small2_bin = {}
    for occl, args in ((False, (o4, d4, 0.0, RAY_MAX_T, True)),
                       (True, (pos4, sd4, RAY_EPSILON, tmax4, False))):
        small2_bin[occl] = kernel_ms(tv2.prepare_launch(scene4_2["tlas"], *args, occl, "binary"),
                                     10, torch)
        print(f"time B6b {'any' if occl else 'closest'} at {BVH_PARITY_SCENE} two-level {P}^2: "
              f"kernel {small2_bin[occl]:.4f} ms, B6a {small2[occl][0]:.4f} ms, plain "
              f"{small2[occl][1]:.3f} ms per trace [{card}]", flush=True)

    # the host's share of the B6b route: dispatches enqueued and synchronised
    n_disp_c = 5
    pipe_c.max_iterations = 2**30
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(n_disp_c):
        pipe_c.update(elapsed_time=0.0, elapsed_frames=100 + f)
        pipe_c.render()
    bin2_enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    bin2_dispatch_s = time.perf_counter() - t0
    pipe_c.get_output()
    print(f"time B6b route host ({n_disp_c} dispatches of {BVH_S} samples, host clock): "
          f"{bin2_enqueue_s / n_disp_c * 1e3:.3f} ms enqueued, "
          f"{bin2_dispatch_s / n_disp_c * 1e3:.3f} ms synchronised at the end, per dispatch; the "
          f"main path's {bin2_prog_s / BVH_DISPATCHES * 1e3:.3f} ms with the first [{card}]",
          flush=True)
    del pipe_c, fat_moved, o_c, d_c, tlb_np

    # realtime + denoise at 1080p on the two-level scene without fat nodes
    cam32.set_aspect(RT_W, RT_H)
    rt_c = RealtimeRaytracingPipeline(RT_W, RT_H, seed=0, device=dev)
    rt_c.set_camera(cam32)
    rt_c.set_scene_data(bin2)
    denoiser_c = DenoiseCompositor(device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(BIN_RT_FRAMES):
        rt_c.update(elapsed_time=f / 60.0, elapsed_frames=f)
        direct, spec = rt_c.render()
        display = denoiser_c.dispatch(direct, spec)
    torch.cuda.synchronize()
    bin2_rt_s = time.perf_counter() - t0
    n = 2 * BIN_RT_FRAMES
    expect_counts(f"B6b realtime + denoise ({BIN_RT_FRAMES} frames at {RT_W}x{RT_H})",
                  {"B6b closest": n, "B6b any": n, "B2": n})
    finite = all(bool(x.isfinite().all()) for x in (direct, spec, display))
    print(f"B6b realtime + denoise: {BIN_RT_FRAMES} frames at {RT_W}x{RT_H} in {bin2_rt_s:.3f}s "
          f"host clock, AOVs and display finite {finite}, display mean {float(display.mean()):.5f} "
          f"[{card}]", flush=True)
    if not finite or not float(display.mean()) > 0.0:
        raise RuntimeError("the B6b realtime + denoise frames failed")
    rt_c.get_output()
    del rt_c, denoiser_c, direct, spec, display, bin2, wave_c
    cam32.set_aspect(M, M)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 15", flush=True)
    # ---- 15. B3 vs plain at 128^2 on the brute-force parity scenes ---------------
    from dxrexperiments_torch.scene.lights import area_light, directional_light, point_light

    b3_err = {False: 0.0, True: 0.0}
    b3_attr = {"normal_max": 0.0, "position_max": 0.0}
    for name in BRUTE_PARITY:
        sc_b, cam_b = build_scene(name)
        cam_b.set_aspect(P, P)
        scene_b = sc_b.build(dev)
        if "bvh" in scene_b:
            raise RuntimeError(f"{name} built a BVH: B3 takes brute-force scenes")
        label = f"B3 {name} ({int(scene_b['mt_pack'].shape[1])} padded triangles) {P}^2"
        cam_p = {k: v[0] for k, v in cameras(cam_b, P, P, 1, 31).items()}
        o_p, d_p = (x.reshape(-1, 3).to(dev) for x in
                    primary_ray_grid(cam_p, P, P, fs.JITTER_SCALE))
        got = ik.trace_closest(scene_b, o_p, d_p, 0.0, RAY_MAX_T, cull_backface=True)
        want = ik.trace_closest_reference(scene_b, o_p, d_p, 0.0, RAY_MAX_T, cull_backface=True)
        torch.cuda.synchronize()
        b3_err[False] = max(b3_err[False], hit_gate(f"{label} primary closest (culled)", got,
                                                    want, torch)["max_abs_t"])
        a = attr_gate(f"{label} primary closest", got, want, torch)
        # bounce rays about the normal; a miss's window is empty, as the
        # integrator sends its inactive lanes
        wobble = torch.nn.functional.normalize(
            torch.as_tensor(rng.normal(size=(P * P, 3)).astype(np.float32), device=dev), dim=1)
        bd = torch.nn.functional.normalize(want["normal"] + wobble, dim=1)
        tmax_b = torch.where(want["hit"], RAY_MAX_T, 0.0)
        got_b = ik.trace_closest(scene_b, want["position"], bd, RAY_EPSILON, tmax_b)
        want_b = ik.trace_closest_reference(scene_b, want["position"], bd, RAY_EPSILON, tmax_b)
        torch.cuda.synchronize()
        if bool(got_b["hit"][~want["hit"]].any()):
            raise RuntimeError("B3 hit on a ray with an empty window")
        b3_err[False] = max(b3_err[False], hit_gate(f"{label} bounce closest", got_b, want_b,
                                                    torch)["max_abs_t"])
        a_b = attr_gate(f"{label} bounce closest", got_b, want_b, torch)
        for k in b3_attr:
            b3_attr[k] = max(b3_attr[k], a[k], a_b[k])
        light = (0.0, 1.8, 0.0) if name.startswith("cornell") else SHADOW_LIGHT
        pos_s, sd_s, tmax_s = shadow_rays(o_p, d_p, want, light)
        sd_s[::3] = 0.0  # zero directions: never occluded
        occ_got = ik.trace_any(scene_b, pos_s, sd_s, RAY_EPSILON, tmax_s)
        occ_want = ik.trace_any_reference(scene_b, pos_s, sd_s, RAY_EPSILON, tmax_s)
        torch.cuda.synchronize()
        b3_err[True] = max(b3_err[True], occlusion_gate(
            f"{label} any, shadow rays toward {light}", occ_got, occ_want))
        if bool(occ_got[::3].any()):
            raise RuntimeError("B3 occluded a zero-direction shadow ray")
    # the plain versions' shape for phase 17: instanced:2 at 128^2 (the last scene)
    b3_small_args = {False: (scene_b, o_p, d_p, 0.0, RAY_MAX_T, True),
                     True: (scene_b, pos_s, sd_s, RAY_EPSILON, tmax_s, False)}

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 16", flush=True)
    # ---- 16. the brute-force wavefront main path: instanced:2 at 512^2 ------------
    sc_br, cam_br = build_scene(BRUTE_MAIN_SCENE)
    cam_br.set_aspect(M, M)
    pipe_b = ProgressiveRaytracingPipeline(M, M, seed=0, samples_per_frame=BVH_S, device=dev)
    pipe_b.max_iterations = BVH_S * BVH_DISPATCHES
    pipe_b.set_camera(cam_br)
    pipe_b.set_scene(sc_br)
    scene_br = pipe_b.scene_data
    t_count = int(scene_br["num_tris"])
    if "bvh" in scene_br or t_count > 4096:
        raise RuntimeError(f"{BRUTE_MAIN_SCENE} did not build brute force")
    first_br = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(BVH_DISPATCHES):
        pipe_b.update(elapsed_time=f / 60.0, elapsed_frames=f)
        if first_br is None:
            first_br = pipe_b._camera_params
        pipe_b.render()
    torch.cuda.synchronize()
    brute_prog_s = time.perf_counter() - t0
    b3_counts = {False: launches("B3 closest"), True: launches("B3 any")}
    others = launches("B1", "B4a closest", "B4a any", "B5", "B6a closest", "B6a any")
    img = pipe_b.get_output()
    finite, mean = bool(img.isfinite().all()), float(img.mean())
    want_n = BVH_DISPATCHES * BVH_S * 2
    print(f"brute-force main path: {BVH_DISPATCHES} dispatches x {BVH_S} samples at {M}^2 on "
          f"{BRUTE_MAIN_SCENE} ({t_count} triangles, {int(scene_br['mt_pack'].shape[1])} padded; "
          f"{pipe_b.accum_count} spp) in {brute_prog_s:.3f}s host clock, B3 closest launches "
          f"{b3_counts[False]}, any launches {b3_counts[True]}, B1 / B4a closest / B4a any / B5 / "
          f"B6a closest / B6a any launches {others}, image finite {finite}, mean {mean:.5f} "
          f"[{card}]", flush=True)
    if (b3_counts[False], b3_counts[True]) != (want_n, want_n) or any(others):
        raise RuntimeError(f"expected {want_n} closest and {want_n} any B3 launches and no other "
                           f"kernel's, got {b3_counts} and {others}")
    if not finite or not mean > 0.0:
        raise RuntimeError("brute-force main path image is not finite with a positive mean")

    # the first dispatch's first sample through the wavefront route, its
    # launches' inputs kept
    opts_br = pipe_b.options
    cam1b = {k: v[0] for k, v in first_br.items()}
    traces_b = []

    def record_b(o, d, t_min, t_max, cull, occlusion):
        traces_b.append((o, d, t_min, t_max, cull, occlusion))

    with TraceHook(ik, record_b, TraceHook.BRUTE):
        wave_b = render_sample(scene_br, opts_br, cam1b, M, M, impl="cuda")["color"]
    torch.cuda.synchronize()
    if [t[5] for t in traces_b] != [False, True, False, True]:
        raise RuntimeError(f"expected a closest, an any, a closest and an any B3 trace, got "
                           f"{[t[5] for t in traces_b]}")
    o_b, d_b = (x.reshape(-1, 3).to(dev) for x in primary_ray_grid(cam1b, M, M, fs.JITTER_SCALE))
    pick_b = torch.as_tensor(rng.choice(M * M, COUNT_PIXELS, replace=False), device=dev)
    seeds_b = trng.pixel_seeds(M, M, cam1b["frame_count"], device=dev).reshape(-1)
    plain_b = trace_rays(scene_br, opts_br, o_b[pick_b], d_b[pick_b], seeds_b[pick_b],
                         impl="torch")["color"][None]
    torch.cuda.synchronize()
    b3_image = image_gate(f"the B3 wavefront route vs plain {BRUTE_MAIN_SCENE} {COUNT_PIXELS} "
                          f"sampled pixels of {M}^2, 1 sample", wave_b.reshape(-1, 3)[pick_b][None],
                          plain_b, 1)
    # B3 against the plain version on every ray of each launch (the plain
    # sweep in slices of PLAIN_SLICE rays), so that no draw decides a gate:
    # a draw of 4,096 rays holds some 850 bounce hits, whose p99.9 is their
    # largest error or next to it. A 4,096-ray draw is printed beside the
    # gates, not gated, with each tail's census.
    for batch, (o, d, t_min, t_max, cull, occlusion) in zip(batches, traces_b):
        sub = torch.as_tensor(rng.choice(len(o), COUNT_PIXELS, replace=False), device=dev)
        label = f"B3 {batch} {BRUTE_MAIN_SCENE} all {len(o)} rays"
        if occlusion:
            got = ik.trace_any(scene_br, o, d, t_min, t_max)
            want = plain_sliced(lambda i: ik.trace_any_reference(
                scene_br, o[i], d[i], t_min, rows_of(t_max, i)), len(o), dev)
            torch.cuda.synchronize()
            b3_err[True] = max(b3_err[True], occlusion_gate(label, got, want))
        else:
            got = ik.trace_closest(scene_br, o, d, t_min, t_max, cull_backface=cull)
            want = plain_sliced(lambda i: ik.trace_closest_reference(
                scene_br, o[i], d[i], t_min, rows_of(t_max, i), cull_backface=cull), len(o),
                dev)
            torch.cuda.synchronize()
            b3_err[False] = max(b3_err[False], hit_gate(label, got, want, torch)["max_abs_t"])
            a = attr_gate(label, got, want, torch)
            for k in b3_attr:
                b3_attr[k] = max(b3_attr[k], a[k])
            tail_census(label, got, want, scene_br, o, d)
            tail_census(label, got, want, scene_br, o, d, normal_tail=True)
            attr_gate(f"B3 {batch} {BRUTE_MAIN_SCENE} {COUNT_PIXELS} sampled rays of {len(o)} "
                      f"(census)", {k: v[sub] for k, v in got.items()},
                      {k: v[sub] for k, v in want.items()}, torch, gated=False)
        del got, want

    # realtime + denoise at 1080p on the brute-force scene
    cam_br.set_aspect(RT_W, RT_H)
    rt = RealtimeRaytracingPipeline(RT_W, RT_H, seed=0, device=dev)
    rt.set_camera(cam_br)
    rt.set_scene(sc_br)
    denoiser = DenoiseCompositor(device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(BRUTE_RT_FRAMES):
        rt.update(elapsed_time=f / 60.0, elapsed_frames=f)
        direct, spec = rt.render()
        display = denoiser.dispatch(direct, spec)
    torch.cuda.synchronize()
    brute_rt_s = time.perf_counter() - t0
    rt_counts = launches("B3 closest", "B3 any", "B2", "B1 realtime", "B5 realtime")
    finite = all(bool(x.isfinite().all()) for x in (direct, spec, display))
    mean = float(display.mean())
    print(f"brute-force realtime + denoise: {BRUTE_RT_FRAMES} frames at {RT_W}x{RT_H} on "
          f"{BRUTE_MAIN_SCENE} in {brute_rt_s:.3f}s host clock, B3 closest / any / bilateral / "
          f"B1 realtime / B5 realtime launches {rt_counts}, AOVs and display finite {finite}, "
          f"display mean {mean:.5f} [{card}]", flush=True)
    n = BRUTE_RT_FRAMES * 2
    if rt_counts != (n, n, n, 0, 0) or not finite or not mean > 0.0:
        raise RuntimeError("the brute-force realtime + denoise frames failed")
    del rt, direct, spec, display
    cam_br.set_aspect(M, M)

    # the AO view, the refraction bounce and a rig with an area light: one
    # 4-sample dispatch each, its first sample against the plain version
    rig = {"dir": [directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
                   directional_light((0.5, -0.7, 0.2), (0.3, 0.5, 0.9, 0.4))],
           "point": [point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
                     point_light((-0.6, 1.2, 0.5), (0.4, 0.9, 0.5, 3.0))],
           "area": [area_light((-0.3, 1.95, -0.3), (0.6, 0.0, 0.0), (0.0, 0.0, 0.6),
                               (1.0, 0.9, 0.8, 8.0))]}  # tests/test_torch_cuda.area_rig
    side = {}
    for label, name, size, kw, lights, want_counts in (
            ("ao_only", "cornell", M, {"ao_only": True}, None, (BVH_S, 4 * BVH_S)),
            ("refraction", "cornell-glass", M, {"refraction": True}, None, (2 * BVH_S, 2 * BVH_S)),
            ("2dir_2point_1area", "cornell", RIG_SIZE, {}, rig, (2 * BVH_S, 2 * BVH_S))):
        sc_c, cam_c = build_scene(name)
        if lights is not None:
            sc_c.lights = lights
        cam_c.set_aspect(size, size)
        pipe_c = ProgressiveRaytracingPipeline(size, size, seed=0, samples_per_frame=BVH_S,
                                               device=dev)
        pipe_c.ao_only = kw.get("ao_only", False)
        pipe_c.refraction = kw.get("refraction", False)
        pipe_c.set_camera(cam_c)
        pipe_c.set_scene(sc_c)
        traces_c = []

        def record_c(o, d, t_min, t_max, cull, occlusion):
            traces_c.append((len(o), occlusion))

        torch.cuda.synchronize()
        reset_counts()
        with TraceHook(ik, record_c, TraceHook.BRUTE):
            pipe_c.update(elapsed_time=0.0, elapsed_frames=0)
            pipe_c.render()
        torch.cuda.synchronize()
        counts = launches("B3 closest", "B3 any")
        others = launches("B1", "B4a closest", "B4a any", "B5")
        img = pipe_c.get_output()
        finite, mean = bool(img.isfinite().all()), float(img.mean())
        cam_c1 = {k: v[0] for k, v in pipe_c._camera_params.items()}
        o_c, d_c = (x.reshape(-1, 3).to(dev) for x in
                    primary_ray_grid(cam_c1, size, size, fs.JITTER_SCALE))
        pick_c = torch.as_tensor(rng.choice(size * size, COUNT_PIXELS, replace=False), device=dev)
        seeds_c = trng.pixel_seeds(size, size, cam_c1["frame_count"], device=dev).reshape(-1)
        got = render_sample(pipe_c.scene_data, pipe_c.options, cam_c1, size, size, impl="cuda",
                            **kw)["color"].reshape(-1, 3)[pick_c][None]
        plain = trace_rays(pipe_c.scene_data, pipe_c.options, o_c[pick_c], d_c[pick_c],
                           seeds_c[pick_c], impl="torch", **kw)["color"][None]
        torch.cuda.synchronize()
        print(f"brute-force {label} ({name}, {size}^2, {BVH_S} samples): B3 closest / any launches "
              f"{counts}, B1 / B4a / B5 launches {others}, traced batches {traces_c}, image finite "
              f"{finite}, mean {mean:.5f}", flush=True)
        if counts != want_counts or any(others) or not finite or not mean > 0.0:
            raise RuntimeError(f"the brute-force {label} dispatch failed: launches {counts}, "
                               f"expected {want_counts}")
        if label == "refraction" and traces_c[2] != (3 * size * size, False):
            raise RuntimeError(f"expected a {3 * size * size}-ray bounce launch, got {traces_c[2]}")
        side[label] = image_gate(f"B3 {label} {name} vs plain, {COUNT_PIXELS} sampled pixels of "
                                 f"{size}^2, 1 sample", got, plain, 1)
        del pipe_c

    headless(["--scene", BRUTE_MAIN_SCENE, "--size", f"{M}x{M}", "--spp", "4"],
             f"{BRUTE_MAIN_SCENE} {M}^2 4 spp")
    headless(["--ao-only", "--size", f"{M}x{M}", "--spp", "4"], f"cornell --ao-only {M}^2 4 spp")
    headless(["--scene", "cornell-glass", "--refraction", "--size", f"{M}x{M}", "--spp", "4"],
             f"cornell-glass --refraction {M}^2 4 spp")

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 17", flush=True)
    # ---- 17. B3 times --------------------------------------------------------------
    # each launch of the wavefront sample on its own inputs: its time, its
    # bound from the pair tests its rays need (every triangle for a live
    # closest ray, up to the first blocker in index order for occlusion),
    # and the host figures of where its lanes idle (ops/intersect_kernel.
    # sweep_figures, from the plain sweep's verdicts on every ray)
    b3 = {False: {"ms": 0.0, "wrapper_ms": 0.0, "ops": 0.0, "bytes": 0.0, "per_launch": []},
          True: {"ms": 0.0, "wrapper_ms": 0.0, "ops": 0.0, "bytes": 0.0, "per_launch": []}}
    for batch, (o, d, t_min, t_max, cull, occlusion) in zip(batches, traces_b):
        ms = kernel_ms(ik.prepare_launch(scene_br, o, d, t_min, t_max, cull, occlusion), 10, torch)
        if occlusion:
            wrap = time_ms(lambda: ik.trace_any(scene_br, o, d, t_min, t_max), 10, torch)
        else:
            wrap = time_ms(lambda: ik.trace_closest(scene_br, o, d, t_min, t_max,
                                                    cull_backface=cull), 10, torch)
        fig = ik.sweep_figures(ik.sweep_work(scene_br, o, d, t_min, t_max, occlusion, cull,
                                             PLAIN_SLICE), t_count)
        pairs = fig["pairs"]
        per_ray_window = 4 if hasattr(t_max, "dim") and t_max.dim() else 0
        nbytes = (len(o) * (24 + per_ray_window + (1 if occlusion else 22 * 4 + 3 * 8))
                  + t_count * (19 + (0 if occlusion else 24)) * 4)
        bnd = bound(pairs * OPS_PAIR, nbytes)
        acc = b3[occlusion]
        acc["ms"] += ms
        acc["wrapper_ms"] += wrap
        acc["ops"] += pairs * OPS_PAIR
        acc["bytes"] += nbytes
        acc["per_launch"].append({"batch": batch, "rays": len(o), "ms": ms, "wrapper_ms": wrap,
                                  "pair_tests": pairs, "bound_ms": bnd[0], "bound_by": bnd[1],
                                  "figures": fig})
        print(f"time B3 {batch} on {BRUTE_MAIN_SCENE} {M}^2 wavefront sample: {len(o)} rays, "
              f"live share {fig['live_share']:.4f}, kernel {ms:.4f} ms, wrapper {wrap:.4f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}), {ms / bnd[0]:.2f}x the bound; "
              f"{pairs / len(o):.1f} pair tests per ray, {pairs / ms / 1e6:.2f} G pair tests/s "
              f"[{card}]", flush=True)
        print(f"figures B3 {batch}: {figures_line(fig)}", flush=True)
    b3_bound = {k: bound(b3[k]["ops"], b3[k]["bytes"]) for k in (False, True)}
    b3_small = {}
    for occl, (sc_s, o_s, d_s, tmin_s, tmax_s2, cull_s) in b3_small_args.items():
        if occl:
            plain = lambda: ik.trace_any_reference(sc_s, o_s, d_s, tmin_s, tmax_s2)  # noqa: E731
        else:
            plain = lambda: ik.trace_closest_reference(sc_s, o_s, d_s, tmin_s, tmax_s2,  # noqa: E731
                                                       cull_s)
        b3_small[occl] = (kernel_ms(ik.prepare_launch(sc_s, o_s, d_s, tmin_s, tmax_s2, cull_s,
                                                      occl), 10, torch),
                          time_ms(plain, 2, torch))
        print(f"time B3 {'any' if occl else 'closest'} at {BRUTE_MAIN_SCENE} {P}^2: kernel "
              f"{b3_small[occl][0]:.4f} ms, plain {b3_small[occl][1]:.3f} ms per trace [{card}]",
              flush=True)

    # the host's share: a progressive dispatch enqueued, and synchronised
    n_disp = 10
    pipe_b.max_iterations = 2**30  # every timed dispatch renders
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(n_disp):
        pipe_b.update(elapsed_time=0.0, elapsed_frames=100 + f)
        pipe_b.render()
    b3_enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    b3_dispatch_s = time.perf_counter() - t0
    pipe_b.get_output()
    print(f"time brute-force host (host clock, {n_disp} dispatches of {BVH_S} samples, wavefront "
          f"route): {b3_enqueue_s / n_disp * 1e3:.3f} ms enqueue, "
          f"{b3_dispatch_s / n_disp * 1e3:.3f} ms synchronised at the end; B3 alone "
          f"{(b3[False]['ms'] + b3[True]['ms']) * BVH_S:.3f} ms per dispatch; the main path's "
          f"{brute_prog_s / BVH_DISPATCHES * 1e3:.3f} ms per dispatch with the first [{card}]",
          flush=True)
    del pipe_b, traces_b
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 18", flush=True)
    # ---- 18. texture envs: the inputs, written here from a seed ---------------------
    # The repository holds no HDR or DDS asset: a lat-long radiance of the
    # size config 3's reference run loads (an 8K JPG, read there through
    # PIL) and a cubemap of the reference probe's format are made here.
    tex_dir = tempfile.TemporaryDirectory()
    hdr_path = os.path.join(tex_dir.name, "sky.hdr")
    dds_path = os.path.join(tex_dir.name, "probe.dds")
    t0 = time.perf_counter()
    write_hdr(hdr_path, sky_image(HDR_W, HDR_H, 18))
    write_dds(dds_path, cube_faces(CUBE_S, 19), "rgba16f")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hdr_env, cube_env = parse_env(f"latlong:{hdr_path}"), parse_env(f"cubemap:{dds_path}")
    read_s = time.perf_counter() - t0
    print(f"texture envs: {HDR_W}x{HDR_H} RLE .hdr ({os.path.getsize(hdr_path) / 2**20:.2f} MiB) "
          f"and 6x{CUBE_S}x{CUBE_S} R16G16B16A16_FLOAT .dds ({os.path.getsize(dds_path) / 2**20:.2f} "
          f"MiB) written in {write_s:.2f}s, read through parse_env in {read_s:.2f}s (host clock); "
          f"lat-long max {float(hdr_env['latlong'].max()):.2f}, mean "
          f"{float(hdr_env['latlong'].mean()):.4f}; cube mean {float(cube_env['cube'].mean()):.4f}",
          flush=True)
    tex_envs = {"latlong": hdr_env, "cubemap": cube_env}

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 19", flush=True)
    # ---- 19. B1 with texture envs vs plain at 128^2 ----------------------------------
    def tex_cases(scene_of, fn, plain, rt_fn, rt_plain, label):
        """The progressive option sets of phase 3 and the realtime cases
        (every AOV; an S = 2 batch against two single launches) on each
        texture env; returns the largest max |d| of the progressive sums and
        of the AOVs."""
        errs = [0.0, 0.0]
        for env_name in tex_envs:
            scene, cam = scene_of(env_name, False)
            ek = scene["env"]["kind"]
            for name, opts, _ in OPTION_CASES:
                options = default_options(**opts)
                cams = cameras(cam, P, P, PARITY_S, 11)
                got = fn(scene, options, cams, P, P, ek)
                want = plain(scene, options, cams, P, P, ek)
                torch.cuda.synchronize()
                errs[0] = max(errs[0], image_gate(f"{label} {env_name} {name} {P}^2 S={PARITY_S}",
                                                  got, want, PARITY_S)["max_abs_diff"])
            for name, opts, env in REALTIME_CASES:
                scene_r, cam_r = scene_of(env_name, env == "emissive")
                options = default_options(**opts)
                cams = cameras(cam_r, P, P, 1, 2**31 + 5)
                got = rt_fn(scene_r, options, cams, P, P, ek)
                want = rt_plain(scene_r, options, cams, P, P, ek)
                torch.cuda.synchronize()
                got = {k: v[0] for k, v in got.items()}
                got.setdefault("color", got["direct"] + got["indirect_specular"])
                errs[1] = max(errs[1], aov_gate(f"{label} realtime {env_name} {name} {P}^2", got,
                                                {k: v[0] for k, v in want.items()}))
            cams = cameras(cam, P, P, 2, 40)
            options = default_options(debug=2)
            batch = rt_fn(scene, options, cams, P, P, ek)
            batch_err = max(float((batch[k][f] - rt_fn(scene, options, {c: v[f:f + 1] for c, v in
                                                                       cams.items()}, P, P, ek)[k][0]
                                   ).abs().max()) for k in fs.AOV_KEYS for f in range(2))
            torch.cuda.synchronize()
            print(f"parity {label} realtime {env_name} S=2 batch vs 2 single launches: max |d| "
                  f"{batch_err:.3e} (<= 1e-6)", flush=True)
            if not batch_err <= 1e-6:
                raise RuntimeError(f"{label} realtime S=2 batch differs from single launches")
        return errs

    tex_scenes = {}

    def tex_cornell(env_name, emissive):
        """Cornell-glossy with a texture env, seen past the box's open side."""
        if (env_name, emissive) not in tex_scenes:
            sc, cam = build_scene("cornell-glossy")
            sc.environment = tex_envs[env_name]
            if emissive:
                sc.materials = [dataclasses.replace(m, emissive=(0.2, 0.3, 0.4, 2.0))
                                for m in sc.materials]
            cam.set_eye_at_up(*TEX_PARITY_EYE, (0.0, 1.0, 0.0))
            cam.set_aspect(P, P)
            scene = sc.build(dev)
            if "tex_autoroute" not in scene["bvh"] or select_route(scene, "progressive") != "fused":
                raise RuntimeError("a Cornell scene with a texture env did not route to B1")
            tex_scenes[env_name, emissive] = (scene, cam)
        return tex_scenes[env_name, emissive]

    b1_tex_err = tex_cases(tex_cornell, fs.fused_progressive_sum,
                           fs.fused_progressive_sum_reference, fs.realtime_aovs,
                           fs.fused_realtime_outputs_reference, "B1 texture env cornell-glossy")

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 20", flush=True)
    # ---- 20. B5 with texture envs vs plain on instanced:4 at 128^2 -----------------
    def tex_instanced4(env_name, emissive):
        if (env_name, emissive, 4) not in tex_scenes:
            sc, cam = build_scene(BVH_PARITY_SCENE)
            sc.environment = tex_envs[env_name]
            if emissive:
                sc.materials = [dataclasses.replace(m, emissive=(0.2, 0.3, 0.4, 2.0))
                                for m in sc.materials]
            cam.set_aspect(P, P)
            scene = sc.build(dev)
            if select_route(scene, "progressive") != "fused_traverse":
                raise RuntimeError(f"{BVH_PARITY_SCENE} with a texture env did not route to B5")
            tex_scenes[env_name, emissive, 4] = (scene, cam)
        return tex_scenes[env_name, emissive, 4]

    b5_tex_err = tex_cases(tex_instanced4, ft.fused_traverse_progressive_sum,
                           ft.fused_traverse_progressive_sum_reference, ft.realtime_aovs,
                           ft.fused_traverse_realtime_outputs_reference,
                           f"B5 texture env {BVH_PARITY_SCENE}")
    check_errors()
    # the plain version's time at this shape, for the kernel line
    scene_c4, cam_c4 = tex_instanced4("cubemap", False)
    cams_c4 = cameras(cam_c4, P, P, BVH_S, 60)
    b5_tex_small = (kernel_ms(ft.prepare_launch(scene_c4, default_options(), cams_c4, P, P, 3,
                                                False), 10, torch) / BVH_S,
                    time_ms(lambda: ft.fused_traverse_progressive_sum_reference(
                        scene_c4, default_options(), cams_c4, P, P, 3), 2, torch) / BVH_S)
    del tex_scenes, scene_c4

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 21", flush=True)
    # ---- 21. BASELINE config 3: Cornell + the 8K HDR lat-long env, 1080p -----------
    sc3, cam3 = build_scene("cornell-glossy")
    sc3.environment = hdr_env  # phase 18's, read through parse_env
    cam3.set_aspect(C3_W, C3_H)
    pipe3 = ProgressiveRaytracingPipeline(C3_W, C3_H, seed=0, samples_per_frame=C3_S, device=dev)
    pipe3.max_iterations = C3_S * C3_DISPATCHES
    pipe3.set_camera(cam3)
    pipe3.set_scene(sc3)
    scene3, opts3 = pipe3.scene_data, pipe3.options
    if "tex_autoroute" not in scene3["bvh"] or select_route(scene3, "progressive") != "fused":
        raise RuntimeError("config 3's scene did not route to B1 through its routing BVH")
    first3 = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(C3_DISPATCHES):
        pipe3.update(elapsed_time=f / 60.0, elapsed_frames=f)
        if first3 is None:
            first3 = pipe3._camera_params
        pipe3.render()
    torch.cuda.synchronize()
    c3_s = time.perf_counter() - t0
    c3_launches = launches("B1")
    others = launches("B3 closest", "B3 any", "B4a closest", "B4a any", "B5", "B6a closest",
                      "B6a any")
    img = pipe3.get_output()
    finite, mean = bool(img.isfinite().all()), float(img.mean())
    print(f"config 3 main path: {C3_DISPATCHES} dispatches x {C3_S} samples at {C3_W}x{C3_H} "
          f"({pipe3.accum_count} spp) with the {HDR_W}x{HDR_H} lat-long env in {c3_s:.3f}s host "
          f"clock, B1 launches {c3_launches}, B3 closest / B3 any / B4a closest / B4a any / B5 / "
          f"B6a closest / B6a any launches {others}, image finite {finite}, mean {mean:.5f} "
          f"[{card}]", flush=True)
    if c3_launches != C3_DISPATCHES or any(others):
        raise RuntimeError(f"expected {C3_DISPATCHES} B1 launches and no other kernel's, got "
                           f"{c3_launches} and {others}")
    if not finite or not mean > 0.0 or pipe3.accum_count != C3_S * C3_DISPATCHES:
        raise RuntimeError("config 3's image is not finite with a positive mean at 1024 spp")
    got = fs.fused_progressive_sum(scene3, opts3, first3, C3_W, C3_H, 2)
    with PairCount(intersect, torch) as c3_count:
        want = fs.fused_progressive_sum_reference(scene3, opts3, first3, C3_W, C3_H, 2)
    torch.cuda.synchronize()
    c3_gate = image_gate(f"config 3 first dispatch {C3_W}x{C3_H} S={C3_S} vs plain", got, want,
                         C3_S)
    c3_tri_bytes = int(scene3["num_tris"]) * (tv.REC_WORDS + 24) * 4  # as b1_tri_bytes
    c3_tex = envmap.texture(scene3["env"], 2)
    c3_bound = bound(c3_count.pairs * OPS_PAIR, c3_tri_bytes + C3_W * C3_H * 12
                     + env_bytes(c3_count.env_lookups, c3_tex))
    print(f"config 3 work per dispatch (plain run): {c3_count.pairs / (C3_W * C3_H * C3_S):.1f} "
          f"pair tests and {c3_count.env_lookups / (C3_W * C3_H * C3_S):.3f} env lookups per "
          f"pixel-sample", flush=True)
    del got, want
    headless(["--scene", "cornell-glossy", "--env", f"latlong:{hdr_path}", "--size",
              f"{C3_W}x{C3_H}", "--spp", "16"], f"cornell-glossy --env latlong {C3_W}x{C3_H} 16 spp")

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 22", flush=True)
    # ---- 22. realtime + denoise with the HDR env at 1080p ------------------------------
    rt = RealtimeRaytracingPipeline(RT_W, RT_H, seed=0, device=dev)
    cam3.set_aspect(RT_W, RT_H)
    rt.set_camera(cam3)
    rt.set_scene(sc3)
    denoiser = DenoiseCompositor(device=dev)
    frame0 = None
    torch.cuda.synchronize()
    reset_counts()
    for f in range(C3_RT_FRAMES):
        rt.update(elapsed_time=f / 60.0, elapsed_frames=f)
        direct, spec = rt.render()
        display = denoiser.dispatch(direct, spec)
        if frame0 is None:
            frame0 = (rt._camera_params, direct, spec)
    torch.cuda.synchronize()
    c3_rt_counts = launches("B1 realtime", "B2", "B5 realtime", "B3 closest")
    finite, mean = bool(display.isfinite().all()), float(display.mean())
    print(f"config 3 realtime + denoise: {C3_RT_FRAMES} frames at {RT_W}x{RT_H} with the lat-long "
          f"env, B1 realtime / bilateral / B5 realtime / B3 closest launches {c3_rt_counts}, "
          f"display finite {finite}, mean {mean:.5f}", flush=True)
    if c3_rt_counts != (C3_RT_FRAMES, 2 * C3_RT_FRAMES, 0, 0) or not finite or not mean > 0.0:
        raise RuntimeError("the texture-env realtime + denoise frames failed")
    rt_scene3 = rt.scene_data
    cam0_3, direct0, spec0 = frame0
    cams0_3 = {k: v[None] for k, v in cam0_3.items()}
    with PairCount(intersect, torch) as c3_rt_count:
        want = fs.fused_realtime_outputs_reference(rt_scene3, rt.options, cams0_3, RT_W, RT_H, 2)
    got = {"direct": direct0, "indirect_specular": spec0}
    got.update({k: v[0] for k, v in fs.fused_realtime_outputs_batch(
        rt_scene3, rt.options, cams0_3, RT_W, RT_H, 2).items() if k not in got})
    torch.cuda.synchronize()
    c3_rt_err = aov_gate(f"config 3 realtime frame 0 {RT_W}x{RT_H}", got,
                         {k: v[0] for k, v in want.items()})
    c3_rt_bound = bound(c3_rt_count.pairs * OPS_PAIR, c3_tri_bytes + RT_W * RT_H * 40
                        + env_bytes(c3_rt_count.env_lookups, c3_tex))
    c3_rt_ms = time_ms(lambda: fs.fused_realtime_outputs(rt_scene3, rt.options, cam0_3, RT_W, RT_H,
                                                         2), 20, torch)
    c3_rt_plain_ms = time_ms(lambda: fs.fused_realtime_outputs_reference(
        rt_scene3, rt.options, cams0_3, RT_W, RT_H, 2), 3, torch)
    print(f"time B1 realtime texture env: kernel {c3_rt_ms:.3f} ms, plain {c3_rt_plain_ms:.3f} ms "
          f"per {RT_W}x{RT_H} frame, bound {c3_rt_bound[0]:.4f} ms ({c3_rt_bound[1]}) [{card}]",
          flush=True)
    del rt, got, want, direct, spec, display, frame0, direct0, spec0
    headless(["--pipeline", "realtime", "--denoise", "--scene", "cornell-glossy", "--env",
              f"latlong:{hdr_path}", "--size", f"{RT_W}x{RT_H}"],
             f"realtime+denoise cornell-glossy --env latlong {RT_W}x{RT_H}")

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 23", flush=True)
    # ---- 23. B5 with the cubemap at full width: phase 8's instanced:32, 512^2 ------
    tex32 = dict(scene32, env=envmap.place(cube_env, dev))
    pipe_t = ProgressiveRaytracingPipeline(M, M, seed=0, samples_per_frame=BVH_S, device=dev)
    pipe_t.max_iterations = BVH_S * C3_B5_DISPATCHES
    pipe_t.set_camera(cam32)
    pipe_t.set_scene_data(tex32)
    first_t = None
    torch.cuda.synchronize()
    reset_counts()
    for f in range(C3_B5_DISPATCHES):
        pipe_t.update(elapsed_time=f / 60.0, elapsed_frames=f)
        if first_t is None:
            first_t = pipe_t._camera_params
        pipe_t.render()
    torch.cuda.synchronize()
    b5_tex_launches = launches("B5")
    others = launches("B1", "B4a closest", "B4a any", "B6a closest", "B3 closest")
    img = pipe_t.get_output()
    finite, mean = bool(img.isfinite().all()), float(img.mean())
    print(f"B5 cubemap main path: {C3_B5_DISPATCHES} dispatches x {BVH_S} samples at {M}^2 on "
          f"{BVH_MAIN_SCENE} with the 6x{CUBE_S}^2 cubemap, B5 launches {b5_tex_launches}, "
          f"B1 / B4a closest / B4a any / B6a / B3 launches {others}, image finite {finite}, mean "
          f"{mean:.5f}", flush=True)
    if b5_tex_launches != C3_B5_DISPATCHES or any(others) or not finite or not mean > 0.0:
        raise RuntimeError("the cubemap env on instanced:32 did not run through B5 as expected")
    cam_t = {k: v[0] for k, v in first_t.items()}
    b5_tex_one = ft.fused_traverse_progressive_sum(tex32, pipe_t.options,
                                                   {k: v[None] for k, v in cam_t.items()}, M, M, 3)
    o_t, d_t = (x.reshape(-1, 3).to(dev) for x in primary_ray_grid(cam_t, M, M, fs.JITTER_SCALE))
    pick_t = torch.as_tensor(rng.choice(M * M, COUNT_PIXELS, replace=False), device=dev)
    seeds_t = trng.pixel_seeds(M, M, cam_t["frame_count"], device=dev).reshape(-1)
    with PairCount(intersect, torch) as b5_tex_count, TraceLog(tv, TraceLog.PLAIN) as plain_log:
        plain_t = trace_rays(tex32, pipe_t.options, o_t[pick_t], d_t[pick_t], seeds_t[pick_t],
                             impl="torch")["color"][None]
    torch.cuda.synchronize()
    check_errors()
    b5_tex_gate = image_gate(f"B5 cubemap vs plain {BVH_MAIN_SCENE} {COUNT_PIXELS} sampled pixels "
                             f"of {M}^2, 1 sample", b5_tex_one.reshape(-1, 3)[pick_t][None],
                             plain_t, 1)
    bvh_np = {k: scene32["bvh"][k].cpu().numpy() for k in ("bvhf_rows", "mt_rows")}
    wc_t = WalkCount(tv, bvh_np)
    with TraceHook(tv, wc_t.add), TraceLog(tv) as wave_log:
        wave_t = trace_rays(tex32, pipe_t.options, o_t[pick_t], d_t[pick_t], seeds_t[pick_t],
                            impl="cuda")["color"]
    t_ops, t_bytes = walk_work(wc_t, M * M / COUNT_PIXELS, scene32["bvh"],
                               12 / max(wc_t.c["rays"] / COUNT_PIXELS, 1), 10)
    # Where B5 and the plain version part with the cubemap: the same pixels
    # and camera with the gradient env (smooth, so it moves only where the
    # path itself moves, and only with d.y); the wavefront route on the
    # same rays (B4a's walk, the same as B5's, with the plain lookup); and
    # where the wavefront route's path and the plain one (a brute-force
    # sweep) part, from their traces. The lookup is continuous except
    # across cube faces (near a face tie).
    b5_grad_one = ft.fused_traverse_progressive_sum(scene32, pipe_t.options,
                                                    {k: v[None] for k, v in cam_t.items()}, M, M, 1)
    plain_g = trace_rays(scene32, pipe_t.options, o_t[pick_t], d_t[pick_t], seeds_t[pick_t],
                         impl="torch")["color"]
    torch.cuda.synchronize()
    check_errors()
    b5_grad_one = b5_grad_one.reshape(-1, 3)[pick_t]
    b5_grad_gate = image_gate(f"B5 gradient env vs plain, the same {COUNT_PIXELS} pixels and "
                              f"camera", b5_grad_one[None], plain_g[None], 1)
    b5_c = b5_tex_one.reshape(-1, 3)[pick_t]
    grad_diff = (b5_grad_one - plain_g).abs().max(dim=-1).values
    census = census_verdict("B5 cubemap", bad_pixel_census(
        tv, tex32, light_counts(tex32), b5_c, wave_t, plain_t[0], wave_log, plain_log,
        pick_t.tolist(), extra={"gradient_env_b5_vs_plain": grad_diff}))
    b5_tex_bound = bound(t_ops, t_bytes + env_bytes(b5_tex_count.env_lookups * M * M
                                                    / COUNT_PIXELS, tex32["env"]["cube"]))
    # B5 alone on the same cameras: the cubemap, the gradient env, in turns
    tex_prep = ft.prepare_launch(tex32, pipe_t.options, first_t, M, M, 3, False)
    grad_prep = ft.prepare_launch(scene32, pipe_t.options, first_t, M, M, 1, False)
    turns = [kernel_ms(p, 5, torch) / BVH_S for p in (tex_prep, grad_prep, grad_prep, tex_prep)]
    b5_tex_ms, b5_grad_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    check_errors()
    print(f"time B5 texture env: kernel {b5_tex_ms:.3f} ms per {M}^2 sample with the cubemap, "
          f"{b5_grad_ms:.3f} ms with the gradient env on the same cameras (turns "
          f"{', '.join(f'{t:.3f}' for t in turns)}); bound {b5_tex_bound[0]:.4f} ms "
          f"({b5_tex_bound[1]}); {b5_tex_count.env_lookups / COUNT_PIXELS:.3f} env lookups per "
          f"pixel-sample [{card}]", flush=True)
    del pipe_t, tex32, tex_prep, grad_prep, bvh_np, b5_tex_one, o_t, d_t  # phase 29 reuses scene32
    del plain_log, wave_log
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 24", flush=True)
    # ---- 24. the wavefront routes with a texture env at 128^2 ----------------------
    wave_tex = {}
    for label, scene_w, cam_w, names, want_counts in (
            ("B3 cornell 2dir_2point_1area", "cornell", "brute", TraceHook.BRUTE, (2, 2)),
            (f"B6a {BVH_PARITY_SCENE} two-level", BVH_PARITY_SCENE, "two_level",
             TraceHook.TWO_LEVEL, (2, 2))):
        sc_w, c_w = build_scene(scene_w)
        sc_w.environment = hdr_env
        if cam_w == "brute":
            sc_w.lights = rig
            c_w.set_eye_at_up(*TEX_PARITY_EYE, (0.0, 1.0, 0.0))
            built = sc_w.build(dev)
            ident = "B3"
        else:
            built = sc_w.build_two_level(dev)
            ident = "B6a"
        c_w.set_aspect(P, P)
        if select_route(built, "progressive") != "wavefront" or "bvh" in built:
            raise RuntimeError(f"{label} with the lat-long env did not take the wavefront route")
        cam_1 = {k: v[0] for k, v in cameras(c_w, P, P, 1, 77).items()}
        opts_w = default_options()
        reset_counts()
        got = render_sample(built, opts_w, cam_1, P, P, impl="cuda")["color"]
        torch.cuda.synchronize()
        counts = launches(f"{ident} closest", f"{ident} any")
        want = render_sample(built, opts_w, cam_1, P, P, impl="torch")["color"]
        torch.cuda.synchronize()
        if counts != want_counts:
            raise RuntimeError(f"{label}: expected {want_counts} launches, got {counts}")
        wave_tex[label] = image_gate(f"{label} with the lat-long env {P}^2, 1 sample, vs plain",
                                     got, want, 1)
    check_errors()

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 25", flush=True)
    # ---- 25. config 3 times ---------------------------------------------------------
    black3 = dict(scene3, env=envmap.place(envmap.constant_env(), dev))
    c3_turns = [time_ms(lambda: fs.fused_progressive_sum(s3, opts3, first3, C3_W, C3_H, k3), 10,
                        torch) for s3, k3 in ((scene3, 2), (black3, 0), (black3, 0), (scene3, 2))]
    c3_ms, c3_black_ms = (c3_turns[0] + c3_turns[3]) / 2, (c3_turns[1] + c3_turns[2]) / 2
    c3_plain_ms = time_ms(lambda: fs.fused_progressive_sum_reference(
        scene3, opts3, first3, C3_W, C3_H, 2), 1, torch)
    n_disp = 20
    pipe3.max_iterations = 2**30  # every timed dispatch renders
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(n_disp):
        pipe3.update(elapsed_time=0.0, elapsed_frames=C3_DISPATCHES + f)
        pipe3.render()
    c3_enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    c3_dispatch_s = time.perf_counter() - t0
    pipe3.get_output()
    print(f"time config 3: B1 {c3_ms:.3f} ms per {C3_S}-sample {C3_W}x{C3_H} dispatch with the "
          f"lat-long env, {c3_black_ms:.3f} ms with the black constant env on the same scene and "
          f"cameras (turns {', '.join(f'{t:.3f}' for t in c3_turns)}), "
          f"{C3_W * C3_H * C3_S / c3_ms / 1e3:.2f} primary Mrays/s; plain {c3_plain_ms:.1f} ms; "
          f"bound {c3_bound[0]:.4f} ms ({c3_bound[1]}); host per dispatch "
          f"{c3_enqueue_s / n_disp * 1e3:.3f} ms enqueued, {c3_dispatch_s / n_disp * 1e3:.3f} ms "
          f"synchronised ({n_disp} dispatches); {c3_s:.3f} s to {C3_S * C3_DISPATCHES} spp "
          f"[{card}]", flush=True)
    # phase 38's config-3 launch alone, before the scene goes
    c3_launch_ms = kernel_ms(fs.prepare_launch(scene3, opts3, first3, C3_W, C3_H, 2, False, 0,
                                               0), 10, torch)
    c3_packs = {k: scene3[k] for k in ("mt_pack", "tri_records", "num_tris")}
    del pipe3, scene3, black3
    tex_dir.cleanup()
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 26", flush=True)
    # ---- 26. B5's area mode vs plain at 128^2 -----------------------------------------
    def with_area(sc, area):
        """sc's rig become 1 directional (its own, or the default sun) + 1 area light."""
        d = sc.lights["dir"] if sc.lights is not None else default_lights()["dir"]
        sc.lights = {"dir": d if isinstance(d, list) else [d], "point": [], "area": [area]}
        return sc

    area_scenes = {}

    def area_cornell(env, textured=False):
        """tests/test_fused_traverse.py's area Cornell: the glossy tall box,
        1 directional + 1 area light, with a BVH of its own; the env of
        phase 3's case (or phase 18's seeded cubemap); the floor textured or not."""
        key = (env, textured)
        if key not in area_scenes:
            mesh, mats = cornell_box(glossy_tall_box=True, textured_floor=textured)
            sc = Scene()
            for m in mats:
                sc.add_material(m)
            sc.add_model(mesh)
            sc.lights = cornell_area_rig
            sc.environment = {"gradient": envmap.gradient_env(), "cubemap": cube_env}.get(
                env, envmap.constant_env((0.05, 0.1, 0.2), strength=1.5))
            if env == "emissive":
                sc.materials = [dataclasses.replace(m, emissive=(0.2, 0.3, 0.4, 2.0))
                                for m in sc.materials]
            cam = build_scene("cornell")[1]
            cam.set_aspect(P, P)
            area_scenes[key] = (sc.build(dev, accel="bvh"), cam)
        return area_scenes[key]

    def area_instanced4(env):
        """instanced:4 (its gradient env whatever the case's) with its rig set
        to 1 directional + 1 area light."""
        if "i4" not in area_scenes:
            sc, cam = build_scene(BVH_PARITY_SCENE)
            with_area(sc, instanced_area)
            cam.set_aspect(P, P)
            area_scenes["i4"] = (sc.build(dev), cam)
        return area_scenes["i4"]

    def b5_cases(scene_of, label, prog_cases, rt_cases, realtime=True):
        """B5 against the plain version: progressive (S = 4) on each option
        set, realtime on every AOV and an S = 2 batch against two single
        launches; returns the largest max |d| of each."""
        errs = [0.0, 0.0]
        for name, opts, env in prog_cases:
            scene, cam = scene_of(env)
            if select_route(scene, "progressive") != "fused_traverse":
                raise RuntimeError(f"{label} {name} did not route to B5")
            options = default_options(**opts)
            cams = cameras(cam, P, P, PARITY_S, 11)
            got = ft.fused_traverse_progressive_sum(scene, options, cams, P, P, scene["env"]["kind"])
            want = ft.fused_traverse_progressive_sum_reference(scene, options, cams, P, P,
                                                               scene["env"]["kind"])
            torch.cuda.synchronize()
            errs[0] = max(errs[0], image_gate(f"{label} {name} {P}^2 S={PARITY_S}", got, want,
                                              PARITY_S)["max_abs_diff"])
        for name, opts, env in (rt_cases if realtime else ()):
            scene, cam = scene_of(env)
            options = default_options(**opts)
            cams = cameras(cam, P, P, 1, 2**31 + 5)
            ek = scene["env"]["kind"]
            got = ft.fused_traverse_realtime_outputs(scene, options, {k: v[0] for k, v in
                                                                      cams.items()}, P, P, ek)
            want = ft.fused_traverse_realtime_outputs_reference(scene, options, cams, P, P, ek)
            torch.cuda.synchronize()
            errs[1] = max(errs[1], aov_gate(f"{label} realtime {name} {P}^2", got,
                                            {k: v[0] for k, v in want.items()}))
        if realtime:
            scene, cam = scene_of("gradient")
            options = default_options(debug=2)
            cams = cameras(cam, P, P, 2, 40)
            batch = ft.realtime_aovs(scene, options, cams, P, P, 1)
            batch_err = max(float((batch[k][f] - ft.realtime_aovs(
                scene, options, {c: v[f:f + 1] for c, v in cams.items()}, P, P, 1)[k][0]
            ).abs().max()) for k in fs.AOV_KEYS for f in range(2))
            torch.cuda.synchronize()
            print(f"parity {label} realtime S=2 batch vs 2 single launches: max |d| "
                  f"{batch_err:.3e} (<= 1e-6)", flush=True)
            if not batch_err <= 1e-6:
                raise RuntimeError(f"{label} realtime S=2 batch differs from single launches")
        check_errors()
        return errs

    area_err = b5_cases(area_cornell, "B5 area cornell", OPTION_CASES, REALTIME_CASES)
    area4_err = b5_cases(area_instanced4, f"B5 area {BVH_PARITY_SCENE}",
                            [c for c in OPTION_CASES if c[0] in ("defaults", "debug2",
                                                                 "albedo_only")],
                            REALTIME_CASES[:2])
    # the plain versions' times at this shape, for the kernel lines
    scene_a4, cam_a4 = area_instanced4("gradient")
    cams_a4 = cameras(cam_a4, P, P, BVH_S, 60)
    area_small = {
        realtime: (kernel_ms(ft.prepare_launch(scene_a4, default_options(), cams_a4, P, P, 1,
                                               realtime), 10, torch) / BVH_S,
                   time_ms(lambda: (ft.fused_traverse_realtime_outputs_reference if realtime else
                                    ft.fused_traverse_progressive_sum_reference)(
                       scene_a4, default_options(), cams_a4, P, P, 1), 2, torch) / BVH_S)
        for realtime in (False, True)}
    check_errors()
    print(f"time B5 area mode at {BVH_PARITY_SCENE} {P}^2: progressive kernel "
          f"{area_small[False][0]:.4f} ms, plain {area_small[False][1]:.3f} ms per sample; realtime "
          f"kernel {area_small[True][0]:.4f} ms, plain {area_small[True][1]:.3f} ms per frame "
          f"[{card}]", flush=True)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 27", flush=True)
    # ---- 27. B5's albedo-texture mode vs plain at 128^2 --------------------------------
    def cornell_tex(env):
        """The CLI's cornell-tex, built as the CLI builds it (its routing BVH)."""
        if ("tex", env) not in area_scenes:
            sc, cam = build_scene("cornell-tex")
            cam.set_aspect(P, P)
            scene = sc.build(dev)
            if "tex_autoroute" not in scene["bvh"] or scene["bvh"]["mt_attr_lanes"] != 2:
                raise RuntimeError("cornell-tex did not get its routing BVH with the UV lanes")
            area_scenes["tex", env] = (scene, cam)
        return area_scenes["tex", env]

    tex_cases = [c for c in OPTION_CASES if c[0] in ("defaults", "debug2", "no_indirect_diffuse",
                                                     "albedo_only")]
    tex_err = b5_cases(cornell_tex, "B5 texture cornell-tex", tex_cases, (), realtime=False)
    tex_cube_err = b5_cases(lambda env: area_cornell("cubemap", textured=True),
                               f"B5 texture + area cornell, 6x{CUBE_S}^2 cubemap", tex_cases, (),
                               realtime=False)
    scene_tc, cam_tc = area_cornell("cubemap", textured=True)
    cams_tc = cameras(cam_tc, P, P, BVH_S, 60)
    tex_small = (kernel_ms(ft.prepare_launch(scene_tc, default_options(), cams_tc, P, P, 3, False),
                           10, torch) / BVH_S,
                 time_ms(lambda: ft.fused_traverse_progressive_sum_reference(
                     scene_tc, default_options(), cams_tc, P, P, 3), 2, torch) / BVH_S)
    check_errors()
    print(f"time B5 texture + area mode at cornell {P}^2 with the cubemap: kernel "
          f"{tex_small[0]:.4f} ms, plain {tex_small[1]:.3f} ms per sample [{card}]", flush=True)
    del area_scenes, scene_a4, scene_tc

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 28", flush=True)
    # ---- 28. the config-2 stand-in at full size: the slice's main path ---------------
    sc2, cam2 = config2_stand_in(cube_env)
    cam2.set_aspect(M, M)
    pipe2 = ProgressiveRaytracingPipeline(M, M, seed=0, samples_per_frame=C2_S, device=dev)
    pipe2.max_iterations = C2_S * C2_DISPATCHES
    pipe2.set_camera(cam2)
    t0 = time.perf_counter()
    pipe2.set_scene(sc2)
    torch.cuda.synchronize()
    c2_build_s = time.perf_counter() - t0
    scene2c, opts2c = pipe2.scene_data, pipe2.options
    c2_route = select_route(scene2c, "progressive")
    print(f"config-2 stand-in: {scene2c['num_tris']} triangles (a 960-triangle sphere x4 at "
          f"y = 4.2 for susanne, a 20 x 20 quad ground grid for ground.fbx), textures "
          f"{tuple(scene2c['textures']['texels'].shape)} texels, BVH tagged tex_autoroute "
          f"{'tex_autoroute' in scene2c['bvh']}, mt_attr_lanes {scene2c['bvh']['mt_attr_lanes']}, "
          f"route {c2_route}, built in {c2_build_s:.3f}s host clock", flush=True)
    if c2_route != "fused_traverse" or "tex_autoroute" not in scene2c["bvh"]:
        raise RuntimeError("the config-2 stand-in did not route to B5 through its routing BVH")
    first2 = None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in range(C2_DISPATCHES):
        pipe2.update(elapsed_time=f / 60.0, elapsed_frames=f)
        if first2 is None:
            first2 = pipe2._camera_params
        pipe2.render()
    torch.cuda.synchronize()
    c2_s = time.perf_counter() - t0
    c2_launches = launches("B5")
    others = launches("B1", "B3 closest", "B3 any", "B4a closest", "B4a any", "B6a closest",
                      "B6a any", "B5 realtime")
    img = pipe2.get_output()
    finite, mean = bool(img.isfinite().all()), float(img.mean())
    print(f"config-2 stand-in main path: {C2_DISPATCHES} dispatches x {C2_S} samples at {M}^2 "
          f"({pipe2.accum_count} spp) in {c2_s:.3f}s host clock, B5 launches {c2_launches}, "
          f"B1 / B3 closest / B3 any / B4a closest / B4a any / B6a closest / B6a any / B5 realtime "
          f"launches {others}, image finite {finite}, mean {mean:.5f} [{card}]", flush=True)
    if c2_launches != C2_DISPATCHES or any(others):
        raise RuntimeError(f"expected {C2_DISPATCHES} B5 launches and no other kernel's, got "
                           f"{c2_launches} and {others}")
    if not finite or not mean > 0.0 or pipe2.accum_count != C2_S * C2_DISPATCHES:
        raise RuntimeError("the config-2 stand-in's image is not finite with a positive mean")
    # the first dispatch against the plain version on sampled pixels, every
    # sample; each sample of B5 also on its own (one launch per camera, which
    # must add up to the dispatch) for the census of the bad pixels, beside
    # the wavefront route (B4a's walks with the plain shading) on its rays
    got2 = ft.fused_traverse_progressive_sum(scene2c, opts2c, first2, M, M, 3)
    pick2 = torch.as_tensor(rng.choice(M * M, COUNT_PIXELS, replace=False), device=dev)
    bvh_np2 = {k: scene2c["bvh"][k].cpu().numpy() for k in ("bvhf_rows", "mt_rows")}
    wc2, tex_hits = WalkCount(tv, bvh_np2), TexHits(tint)
    lights2 = light_counts(scene2c)
    want2, b5_sum2, c2_rows = None, None, []
    for s_i in range(C2_S):
        cam_s = {k: v[s_i] for k, v in first2.items()}
        o_s, d_s = (x.reshape(-1, 3).to(dev) for x in primary_ray_grid(cam_s, M, M,
                                                                        fs.JITTER_SCALE))
        seeds_s = trng.pixel_seeds(M, M, cam_s["frame_count"], device=dev).reshape(-1)
        rays_s = (o_s[pick2], d_s[pick2], seeds_s[pick2])
        b5_s = ft.fused_traverse_progressive_sum(scene2c, opts2c,
                                                 {k: v[s_i:s_i + 1] for k, v in first2.items()},
                                                 M, M, 3).reshape(-1, 3)[pick2]
        with PairCount(intersect, torch) as c2_count, TraceLog(tv, TraceLog.PLAIN) as plain_log:
            plain_s = trace_rays(scene2c, opts2c, *rays_s, impl="torch")["color"]
        with contextlib.ExitStack() as hooks:
            if s_i == 0:  # the walks and textured hits of one sample, for the bound
                hooks.enter_context(TraceHook(tv, wc2.add))
                hooks.enter_context(tex_hits)
            with TraceLog(tv) as wave_log:
                wave_s = trace_rays(scene2c, opts2c, *rays_s, impl="cuda")["color"]
        c2_rows += bad_pixel_census(tv, scene2c, lights2, b5_s, wave_s, plain_s, wave_log,
                                    plain_log, pick2.tolist(), s_i)
        want2 = plain_s if want2 is None else want2 + plain_s
        b5_sum2 = b5_s if b5_sum2 is None else b5_sum2 + b5_s
    torch.cuda.synchronize()
    check_errors()
    got2_pick = got2.reshape(-1, 3)[pick2]
    c2_split_err = float((b5_sum2 - got2_pick).abs().max())
    print(f"config-2 stand-in: B5's {C2_S} single-sample launches against its {C2_S}-sample "
          f"dispatch on the {COUNT_PIXELS} sampled pixels: max |d| {c2_split_err:.3e} (<= 1e-5 x "
          f"max(1, |sum|))", flush=True)
    if not c2_split_err <= 1e-5 * max(1.0, float(got2_pick.abs().max())):
        raise RuntimeError("the config-2 stand-in's single-sample B5 launches do not add up to "
                           "the dispatch")
    c2_gate = image_gate(f"config-2 stand-in first dispatch vs plain, {COUNT_PIXELS} sampled "
                         f"pixels of {M}^2, S={C2_S}", got2_pick[None], want2[None], C2_S)
    c2_census = census_verdict("config-2 stand-in", c2_rows)
    gate_bad = ((got2_pick - want2).abs() / C2_S > BAD_TOL).any(dim=-1)
    c2_census["gate_bad_pixels"] = int(gate_bad.sum())
    c2_census["gate_bad_pixels_by_cause"] = {}
    for i in torch.nonzero(gate_bad).flatten().tolist():
        causes = sorted({r["cause"] for r in c2_rows if r["pixel"] == int(pick2[i])})
        key = " + ".join(causes) or "none"
        c2_census["gate_bad_pixels_by_cause"][key] = (
            c2_census["gate_bad_pixels_by_cause"].get(key, 0) + 1)
    print(f"config-2 stand-in: the image gate's {c2_census['gate_bad_pixels']} bad pixels by the "
          f"causes of their bad samples: {json.dumps(c2_census['gate_bad_pixels_by_cause'])}",
          flush=True)
    c2_env_lookups = c2_count.env_lookups * M * M / COUNT_PIXELS  # one sample's
    c2_ops, c2_bytes = walk_work(wc2, M * M / COUNT_PIXELS, scene2c["bvh"],
                                 12 / max(wc2.c["rays"] / COUNT_PIXELS, 1), 16)
    texel_table = scene2c["textures"]["texels"]
    tex_bytes = min(tex_hits.hits * M * M / COUNT_PIXELS * ENV_LOOKUP_BYTES,
                    texel_table.numel() * texel_table.element_size())
    c2_bound = bound(c2_ops, c2_bytes + tex_bytes
                     + env_bytes(c2_env_lookups, scene2c["env"]["cube"]))  # per sample
    print(f"config-2 stand-in work per sample (host model of the walk on {COUNT_PIXELS} sampled "
          f"pixels): {wc2.c['visits'] / COUNT_PIXELS:.1f} visits and "
          f"{wc2.c['pair_tests'] / COUNT_PIXELS:.1f} pair tests over "
          f"{wc2.c['rays'] / COUNT_PIXELS:.2f} rays per pixel, "
          f"{tex_hits.hits / COUNT_PIXELS:.3f} textured hits and "
          f"{c2_count.env_lookups / COUNT_PIXELS:.3f} env lookups per pixel", flush=True)
    # times: the kernel alone, through the wrapper, the plain version (one
    # sample at full size), the host per dispatch enqueued and synchronised
    c2_prep = ft.prepare_launch(scene2c, opts2c, first2, M, M, 3, False)
    c2_ms = kernel_ms(c2_prep, 10, torch)
    c2_wrap_ms = time_ms(lambda: ft.fused_traverse_progressive_sum(scene2c, opts2c, first2, M, M,
                                                                   3), 10, torch)
    first2_one = {k: v[:1] for k, v in first2.items()}
    c2_plain_ms = time_ms(lambda: ft.fused_traverse_progressive_sum_reference(
        scene2c, opts2c, first2_one, M, M, 3), 1, torch)
    pipe2.max_iterations = 2**30  # every timed dispatch renders
    n_disp2 = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(n_disp2):
        pipe2.update(elapsed_time=0.0, elapsed_frames=C2_DISPATCHES + f)
        pipe2.render()
    c2_enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    c2_dispatch_s = time.perf_counter() - t0
    pipe2.get_output()
    print(f"time config-2 stand-in: B5 {c2_ms:.3f} ms per {C2_S}-sample {M}^2 dispatch (kernel "
          f"alone; {c2_ms / C2_S:.4f} ms per sample), {c2_wrap_ms:.3f} ms through the wrapper, "
          f"{C2_S * 1e3 / c2_ms:.1f} spp/s ({M * M * C2_S / c2_ms / 1e3:.2f} primary Mrays/s); "
          f"plain {c2_plain_ms:.1f} ms per sample; host per dispatch "
          f"{c2_enqueue_s / n_disp2 * 1e3:.3f} ms enqueued, {c2_dispatch_s / n_disp2 * 1e3:.3f} ms "
          f"synchronised ({n_disp2} dispatches); bound {c2_bound[0] * C2_S:.4f} ms per dispatch "
          f"({c2_bound[1]}) [{card}]", flush=True)
    del pipe2, c2_prep, got2, want2, bvh_np2
    # realtime + denoise at 1080p on the same scene: a textured scene's frame
    # takes the wavefront route (B4a + the albedo glue), as in JAX
    cam2.set_aspect(RT_W, RT_H)
    rt2 = RealtimeRaytracingPipeline(RT_W, RT_H, seed=0, device=dev)
    rt2.set_camera(cam2)
    rt2.set_scene(sc2)
    denoiser = DenoiseCompositor(device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    frame0 = None
    for f in range(C2_RT_FRAMES):
        rt2.update(elapsed_time=f / 60.0, elapsed_frames=f)
        direct, spec = rt2.render()
        if frame0 is None:
            frame0 = (rt2._camera_params, direct, spec)
        display = denoiser.dispatch(direct, spec)
    torch.cuda.synchronize()
    c2_rt_s = time.perf_counter() - t0
    check_errors()
    c2_rt_counts = launches("B4a closest", "B4a any", "B2", "B5 realtime", "B1 realtime")
    finite = bool((direct + spec).isfinite().all()) and bool(display.isfinite().all())
    mean = float(display.mean())
    print(f"config-2 stand-in realtime + denoise: {C2_RT_FRAMES} frames at {RT_W}x{RT_H} in "
          f"{c2_rt_s:.3f}s host clock, B4a closest / B4a any / bilateral / B5 realtime / B1 "
          f"realtime launches {c2_rt_counts}, display finite {finite}, mean {mean:.5f} [{card}]",
          flush=True)
    n = 2 * C2_RT_FRAMES
    if c2_rt_counts != (n, n, n, 0, 0) or not finite or not mean > 0.0:
        raise RuntimeError("the config-2 stand-in's realtime + denoise frames failed")
    # frame 0 against the plain version on sampled pixels: every AOV of the
    # wavefront route (B4a + the albedo glue) on those pixels' rays, and the
    # pipeline's own direct and specular AOVs there
    cam_r, direct0, spec0 = frame0
    scene2r = rt2.scene_data
    o_r, d_r = (x.reshape(-1, 3).to(dev) for x in primary_ray_grid(cam_r, RT_W, RT_H,
                                                                    fs.REALTIME_JITTER_SCALE))
    pick_r = torch.as_tensor(rng.choice(RT_W * RT_H, COUNT_PIXELS, replace=False), device=dev)
    seeds_r = trng.pixel_seeds(RT_W, RT_H, cam_r["frame_count"], device=dev).reshape(-1)
    rays_r = (o_r[pick_r], d_r[pick_r], seeds_r[pick_r])
    before = launches("B4a closest", "B4a any")
    wave_r = trace_rays(scene2r, rt2.options, *rays_r, mode="realtime", impl="cuda")
    plain_r = trace_rays(scene2r, rt2.options, *rays_r, mode="realtime", impl="torch")
    torch.cuda.synchronize()
    check_errors()
    if (launches("B4a closest") - before[0], launches("B4a any") - before[1]) != (2, 2):
        raise RuntimeError("the config-2 stand-in's realtime check did not run through B4a")

    def picked(x):
        return x.reshape(COUNT_PIXELS, -1)[None]

    c2_rt_err = aov_gate(f"config-2 stand-in realtime (B4a + the albedo glue) vs plain, "
                         f"{COUNT_PIXELS} sampled pixels of {RT_W}x{RT_H}",
                         {k: picked(v) for k, v in wave_r.items()},
                         {k: picked(v) for k, v in plain_r.items()})
    c2_rt_pipe = {k: image_gate(f"config-2 stand-in realtime pipeline frame 0 {k} vs plain, the "
                                f"same pixels", got.reshape(-1, 3)[pick_r][None],
                                picked(plain_r[k]), 1)["max_abs_diff"]
                  for k, got in (("direct", direct0), ("indirect_specular", spec0))}
    del rt2, direct, spec, display, frame0, direct0, spec0, wave_r, plain_r

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 29", flush=True)
    # ---- 29. B5's area mode at config 5's size: instanced:32, 512^2 -----------------
    area32 = dict(scene32, lights=with_area(build_scene(BVH_MAIN_SCENE)[0], instanced_area).lights)
    pipe_a = ProgressiveRaytracingPipeline(M, M, seed=0, samples_per_frame=BVH_S, device=dev)
    pipe_a.max_iterations = BVH_S * C5_AREA_DISPATCHES
    pipe_a.set_camera(cam32)
    pipe_a.set_scene_data(area32)
    first_a = None
    torch.cuda.synchronize()
    reset_counts()
    for f in range(C5_AREA_DISPATCHES):
        pipe_a.update(elapsed_time=f / 60.0, elapsed_frames=f)
        if first_a is None:
            first_a = pipe_a._camera_params
        pipe_a.render()
    torch.cuda.synchronize()
    c5a_launches = launches("B5")
    others = launches("B1", "B4a closest", "B4a any", "B3 closest")
    img = pipe_a.get_output()
    finite, mean = bool(img.isfinite().all()), float(img.mean())
    print(f"B5 area main path: {C5_AREA_DISPATCHES} dispatches x {BVH_S} samples at {M}^2 on "
          f"{BVH_MAIN_SCENE} with 1 directional + 1 area light, B5 launches {c5a_launches}, B1 / "
          f"B4a closest / B4a any / B3 launches {others}, image finite {finite}, mean {mean:.5f}",
          flush=True)
    if c5a_launches != C5_AREA_DISPATCHES or any(others) or not finite or not mean > 0.0:
        raise RuntimeError("the area rig on instanced:32 did not run through B5 as expected")
    cam_a = {k: v[0] for k, v in first_a.items()}
    b5_area_one = ft.fused_traverse_progressive_sum(area32, pipe_a.options,
                                                    {k: v[None] for k, v in cam_a.items()}, M, M,
                                                    1)
    o_a, d_a = (x.reshape(-1, 3).to(dev) for x in primary_ray_grid(cam_a, M, M, fs.JITTER_SCALE))
    pick_a = torch.as_tensor(rng.choice(M * M, COUNT_PIXELS, replace=False), device=dev)
    seeds_a = trng.pixel_seeds(M, M, cam_a["frame_count"], device=dev).reshape(-1)
    rays_a = (o_a[pick_a], d_a[pick_a], seeds_a[pick_a])
    with TraceLog(tv, TraceLog.PLAIN) as plain_log:
        plain_a = trace_rays(area32, pipe_a.options, *rays_a, impl="torch")["color"][None]
    torch.cuda.synchronize()
    check_errors()
    b5_area_pick = b5_area_one.reshape(-1, 3)[pick_a]
    c5a_gate = image_gate(f"B5 area vs plain {BVH_MAIN_SCENE} {COUNT_PIXELS} sampled pixels of "
                          f"{M}^2, 1 sample", b5_area_pick[None], plain_a, 1)
    bvh_np = {k: scene32["bvh"][k].cpu().numpy() for k in ("bvhf_rows", "mt_rows")}
    wc_a = WalkCount(tv, bvh_np)
    with TraceHook(tv, wc_a.add), TraceLog(tv) as wave_log:
        wave_a = trace_rays(area32, pipe_a.options, *rays_a, impl="cuda")["color"]
    c5a_census = census_verdict(f"B5 area {BVH_MAIN_SCENE}", bad_pixel_census(
        tv, area32, light_counts(area32), b5_area_pick, wave_a, plain_a[0], wave_log, plain_log,
        pick_a.tolist()))
    del plain_log, wave_log, wave_a
    c5a_bound = bound(*walk_work(wc_a, M * M / COUNT_PIXELS, scene32["bvh"],
                                 12 / max(wc_a.c["rays"] / COUNT_PIXELS, 1), 10))
    # B5 alone on phase 8's cameras, in turns: the area rig; phase 8's 1
    # directional + 1 point rig (the base mode); and that rig with the area
    # light added, whose gap to the base is what the area light's 4 shadow
    # walks per shading point cost (the point light's own shadow rays, from
    # a light in the floor's plane, graze the floor)
    full32 = dict(scene32, lights=dict(scene32["lights"], area=[instanced_area]))
    preps = [ft.prepare_launch(sc_, pipe_a.options, first32, M, M, 1, False)
             for sc_ in (area32, scene32, full32)]
    order = (0, 1, 2, 2, 1, 0)
    turns_a = [kernel_ms(preps[i], 5, torch) / BVH_S for i in order]
    c5a_ms, c5_base_ms, c5_full_ms = ((turns_a[i] + turns_a[5 - i]) / 2 for i in range(3))
    check_errors()
    print(f"time B5 area mode on {BVH_MAIN_SCENE}: kernel {c5a_ms:.3f} ms per {M}^2 sample with "
          f"1 directional + 1 area light, {c5_base_ms:.3f} ms with phase 8's 1 directional + 1 "
          f"point rig (the base mode), {c5_full_ms:.3f} ms with 1 "
          f"directional + 1 point + 1 area light, on the same cameras (turns "
          f"{', '.join(f'{t:.3f}' for t in turns_a)}); the area light's shadow walks cost "
          f"{c5_full_ms - c5_base_ms:.3f} ms ({(c5_full_ms / c5_base_ms - 1) * 100:.1f}%) over the "
          f"base rig; area rig walk per pixel {wc_a.c['visits'] / COUNT_PIXELS:.1f} visits, "
          f"{wc_a.c['pair_tests'] / COUNT_PIXELS:.1f} pair tests over "
          f"{wc_a.c['rays'] / COUNT_PIXELS:.2f} rays; bound {c5a_bound[0]:.4f} ms "
          f"({c5a_bound[1]}) [{card}]", flush=True)
    del pipe_a, preps, full32, b5_area_one, plain_a, o_a, d_a
    # realtime with the area rig at 1080p: two frames through the pipeline,
    # every AOV of frame 0 against the plain version on sampled pixels
    cam32.set_aspect(RT_W, RT_H)
    rt_a = RealtimeRaytracingPipeline(RT_W, RT_H, seed=0, device=dev)
    rt_a.set_camera(cam32)
    rt_a.set_scene_data(area32)
    torch.cuda.synchronize()
    reset_counts()
    frame0 = None
    for f in range(C5_AREA_RT_FRAMES):
        rt_a.update(elapsed_time=f / 60.0, elapsed_frames=f)
        direct, spec = rt_a.render()
        if frame0 is None:
            frame0 = rt_a._camera_params
    torch.cuda.synchronize()
    check_errors()
    c5a_rt_launches = launches("B5 realtime")
    if c5a_rt_launches != C5_AREA_RT_FRAMES or launches("B4a closest") or launches("B4a any"):
        raise RuntimeError("the area rig's realtime frames did not run through B5")
    cams0_a = {k: v[None] for k, v in frame0.items()}
    o_r, d_r = (x.reshape(-1, 3).to(dev) for x in primary_ray_grid(frame0, RT_W, RT_H,
                                                                    fs.REALTIME_JITTER_SCALE))
    pick_r = torch.as_tensor(rng.choice(RT_W * RT_H, COUNT_PIXELS, replace=False), device=dev)
    seeds_r = trng.pixel_seeds(RT_W, RT_H, frame0["frame_count"], device=dev).reshape(-1)
    aovs_a = ft.realtime_aovs(area32, rt_a.options, cams0_a, RT_W, RT_H, 1)
    got = {k: v[0].reshape(RT_W * RT_H, -1)[pick_r][None] for k, v in aovs_a.items()}
    got["color"] = got["direct"] + got["indirect_specular"]
    plain_r = trace_rays(area32, rt_a.options, o_r[pick_r], d_r[pick_r], seeds_r[pick_r],
                         mode="realtime", impl="torch")
    torch.cuda.synchronize()
    check_errors()
    c5a_rt_err = aov_gate(f"B5 area realtime vs plain {BVH_MAIN_SCENE} {COUNT_PIXELS} sampled "
                          f"pixels of {RT_W}x{RT_H}", got,
                          {k: v.reshape(COUNT_PIXELS, -1)[None] for k, v in plain_r.items()})
    wc_ra = WalkCount(tv, bvh_np)
    with TraceHook(tv, wc_ra.add):
        trace_rays(area32, rt_a.options, o_r[pick_r], d_r[pick_r], seeds_r[pick_r],
                   mode="realtime", impl="cuda")
    c5a_rt_bound = bound(*walk_work(wc_ra, RT_W * RT_H / COUNT_PIXELS, scene32["bvh"],
                                    40 / max(wc_ra.c["rays"] / COUNT_PIXELS, 1), 10))
    c5a_rt_ms = kernel_ms(ft.prepare_launch(area32, rt_a.options, cams0_a, RT_W, RT_H, 1, True),
                          5, torch)
    check_errors()
    print(f"time B5 area mode realtime: kernel {c5a_rt_ms:.3f} ms per {RT_W}x{RT_H} frame on "
          f"{BVH_MAIN_SCENE}, bound {c5a_rt_bound[0]:.4f} ms ({c5a_rt_bound[1]}) [{card}]",
          flush=True)
    del rt_a, aovs_a, got, plain_r, area32, scene32, bvh_np, direct, spec
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 30", flush=True)
    # ---- 30. the wavefront routes with albedo textures at 128^2 ----------------------
    wave_tex2 = {}
    for label, mode, build, ident, want_counts in (
            ("B3 cornell-tex accel none", "progressive", lambda s: s.build(dev, accel="none"),
             "B3", (2, 2)),
            ("B6a cornell-tex two-level", "progressive", lambda s: s.build_two_level(dev), "B6a",
             (2, 2)),
            ("B4a cornell-tex realtime", "realtime", lambda s: s.build(dev), "B4a", (2, 2))):
        sc_w, c_w = build_scene("cornell-tex")
        built = build(sc_w)
        c_w.set_aspect(P, P)
        if select_route(built, mode) != "wavefront" or "textures" not in built:
            raise RuntimeError(f"{label} did not take the wavefront route with its textures")
        cam_1 = {k: v[0] for k, v in cameras(c_w, P, P, 1, 91).items()}
        opts_w = default_options()
        scale = fs.REALTIME_JITTER_SCALE if mode == "realtime" else fs.JITTER_SCALE
        reset_counts()
        got = render_sample(built, opts_w, cam_1, P, P, mode=mode, jitter_scale=scale,
                            impl="cuda")
        torch.cuda.synchronize()
        counts = launches(f"{ident} closest", f"{ident} any")
        want = render_sample(built, opts_w, cam_1, P, P, mode=mode, jitter_scale=scale,
                             impl="torch")
        torch.cuda.synchronize()
        check_errors()
        if counts != want_counts:
            raise RuntimeError(f"{label}: expected {want_counts} launches, got {counts}")
        if mode == "realtime":
            wave_tex2[label] = {"max_abs_diff": aov_gate(f"{label} {P}^2 vs plain", got, want)}
        else:
            wave_tex2[label] = image_gate(f"{label} {P}^2, 1 sample, vs plain", got["color"],
                                          want["color"], 1)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 31", flush=True)
    # ---- 31. the CLI on cornell-tex ----------------------------------------------------
    before = launches("B5")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "cornell-tex.png")
        rc = headless_main(["--scene", "cornell-tex", "--size", f"{M}x{M}", "--spp", "16",
                            "--device", "cuda", "-o", png])
        cli_launches = launches("B5") - before
        if rc != 0 or not os.path.exists(png) or cli_launches < 1:
            raise RuntimeError(f"the CLI on cornell-tex failed (exit {rc}, B5 launches "
                               f"{cli_launches})")
    print(f"headless cornell-tex {M}^2 16 spp --device cuda (in process): exit 0, B5 launches "
          f"{cli_launches}", flush=True)
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 37", flush=True)
    # ---- 37. the roofline probes (B7) ---------------------------------------------------
    # each probe against its plain version at roofline.py's --interpret size on
    # seeded inputs, then roofline.py's full size on its own inputs: the main
    # path (one wrapper call per probe and overlap setting), then each launch
    # alone, timed
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain product in full float32
    a_s, b_s, mt_s, rays_s = rf.probe_inputs(dev, seed=37)
    it_s, grid_s, mit_s = rf.SMOKE_ITERS, rf.SMOKE_GRID, rf.SMOKE_M_ITERS
    b7_err, b7_small = {}, {}
    for name, fn, ref, prep in (("fma", rf.fma_peak, rf.fma_peak_reference, "fma"),
                                ("mix", rf.pair_mix, rf.pair_mix_reference, "mix")):
        got, want = fn(a_s, b_s, it_s, grid_s), ref(a_s, b_s, it_s, grid_s)
        torch.cuda.synchronize()
        b7_err[name] = float(((got - want).abs() / want.abs()).max())
        b7_small[name] = (kernel_ms(rf.prepare_vector(prep, a_s, b_s, it_s, grid_s), 20, torch),
                          time_ms(lambda: ref(a_s, b_s, it_s, grid_s), 2, torch))
        print(f"parity B7 {name} iters {it_s} grid {grid_s}: max relative |d| "
              f"{b7_err[name]:.3e} (<= 1e-4)", flush=True)
        if not b7_err[name] <= 1e-4:
            raise RuntimeError(f"the {name} probe differs from its plain version")
    scale_of = mt_s.abs() @ rays_s.abs()
    prod_tol = 2 * rf.K * 2.0**-23  # 2 K float32 ulps of sum |terms|
    b7_err["overlap"] = 0.0
    for do_v, do_m, vs in ((True, True, 1), (True, True, 2), (True, True, 4), (False, True, 1),
                           (True, False, 1)):
        got = rf.overlap(a_s, b_s, mt_s, rays_s, do_v, do_m, vs, mit_s, grid_s,
                         keep_product=True)
        want = rf.overlap_reference(a_s, b_s, mt_s, rays_s, do_v, do_m, vs, mit_s, grid_s)
        torch.cuda.synchronize()
        o_err = float(((got["o"] - want["o"]).abs() / want["o"].abs()).max())
        t_err = float(((got["t"] - want["t"]).abs() / want["t"].abs()).max())
        p_err = (float(((got["product"] - want["product"]).abs() / scale_of).max())
                 if do_m else 0.0)
        b7_err["overlap"] = max(b7_err["overlap"], o_err, t_err, p_err / prod_tol * 1e-4)
        print(f"parity B7 overlap vector {do_v} matrix {do_m} scale {vs} m_iters {mit_s} grid "
              f"{grid_s}: chains max relative |d| {o_err:.3e} (<= 1e-4), accumulator "
              f"{t_err:.3e} (<= 1e-6), product max |d| / sum |terms| {p_err:.3e} "
              f"(<= {prod_tol:.3e}, split TF32 vs float32)", flush=True)
        if not (o_err <= 1e-4 and t_err <= 1e-6 and p_err <= prod_tol):
            raise RuntimeError("the overlap probe differs from its plain version")
    b7_small["overlap"] = (
        kernel_ms(rf.prepare_overlap(a_s, b_s, mt_s, rays_s, True, True, 1, mit_s, grid_s), 20,
                  torch),
        time_ms(lambda: rf.overlap_reference(a_s, b_s, mt_s, rays_s, True, True, 1, mit_s,
                                             grid_s), 2, torch))

    a_f, b_f, mt_f, rays_f = rf.probe_inputs(dev)  # roofline.py's inputs and size
    ov_cases = [(False, True, 1)] + [(v, m, vs) for vs in (1, 2, 4)
                                     for v, m in ((True, False), (True, True))]
    reset_counts()
    full = {"fma": rf.fma_peak(a_f, b_f), "mix": rf.pair_mix(a_f, b_f)}
    for case in ov_cases:
        full[case] = rf.overlap(a_f, b_f, mt_f, rays_f, *case)
    torch.cuda.synchronize()
    b7_counts = expect_counts("B7 at roofline.py's size", {"B7 fma": 1, "B7 mix": 1,
                                                            "B7 overlap": len(ov_cases)})
    # the main path's outputs against the plain versions on the same tensors
    # (roofline.py's constants overflow the mix to inf: equal non-finite
    # values pass), then every probe and overlap setting again at full size on
    # the seeded inputs, where the elements differ and the chains stay finite
    # (the mix's a near its neutral growth, rf.mix_inputs): a trip count, a
    # grid block or a product schedule off shows there
    a_m, b_m = rf.mix_inputs(dev, seed=37)
    for label, (a_x, b_x, mt_x, rays_x), ab_mix in (
            ("roofline.py's inputs (the main path's launches)", (a_f, b_f, mt_f, rays_f),
             (a_f, b_f)),
            ("seeded inputs", (a_s, b_s, mt_s, rays_s), (a_m, b_m))):
        main_run = a_x is a_f
        t1 = time.perf_counter()
        for name, fn, ref, args in (("fma", rf.fma_peak, rf.fma_peak_reference, (a_x, b_x)),
                                    ("mix", rf.pair_mix, rf.pair_mix_reference, ab_mix)):
            got = full[name] if main_run else fn(*args)
            want = ref(*args)
            torch.cuda.synchronize()
            err = rf.max_rel_diff(got, want)
            b7_err[name] = max(b7_err[name], err)
            print(f"parity B7 {name} at full size (iters {rf.ITERS}, grid {rf.GRID}), {label}: "
                  f"max relative |d| {err:.3e} (<= 1e-4), finite "
                  f"{float(want.isfinite().float().mean()):.4f} of elements", flush=True)
            if not err <= 1e-4:
                raise RuntimeError(f"the {name} probe differs from its plain version at full size")
        scale_x = mt_x.abs() @ rays_x.abs()
        for case in ov_cases:
            got = (full[case] if main_run else
                   rf.overlap(a_x, b_x, mt_x, rays_x, *case, keep_product=True))
            want = rf.overlap_reference(a_x, b_x, mt_x, rays_x, *case)
            torch.cuda.synchronize()
            o_err, t_err = rf.max_rel_diff(got["o"], want["o"]), rf.max_rel_diff(got["t"], want["t"])
            p_err = (float(((got["product"] - want["product"]).abs() / scale_x).max())
                     if case[1] and not main_run else 0.0)
            b7_err["overlap"] = max(b7_err["overlap"], o_err, t_err, p_err / prod_tol * 1e-4)
            print(f"parity B7 overlap at full size (m_iters {rf.M_ITERS}, grid {rf.GRID}) vector "
                  f"{case[0]} matrix {case[1]} scale {case[2]}, {label}: chains max relative |d| "
                  f"{o_err:.3e} (<= 1e-4), accumulator {t_err:.3e} (<= 1e-6)"
                  + (f", product max |d| / sum |terms| {p_err:.3e} (<= {prod_tol:.3e})"
                     if case[1] and not main_run else ""), flush=True)
            if not (o_err <= 1e-4 and t_err <= 1e-6 and p_err <= prod_tol):
                raise RuntimeError("the overlap probe differs from its plain version at full size")
        print(f"B7 full-size parity on {label}: {time.perf_counter() - t1:.1f}s", flush=True)
    # the product of every column at full size, where it shows in t: b = 0,
    # mt and rays ~ 1e15, so that t sums rows 0..7 of the products times
    # 1e-30 and the column scale stays 1. t of all 65,536 columns (every
    # column tile and persistent pass) against the exact sum, within M_ITERS
    # x 2 K ulps of sum |terms| x 1e-30 for the products plus half an ulp of
    # each float32 multiply and add into t; the plain version's t is held to
    # the same gate, and the kept product to 2 K ulps of the plain one
    t1 = time.perf_counter()
    b_v, mt_v, rays_v = torch.zeros_like(b_s), mt_s * 1e15, rays_s * 1e15
    exact = (mt_v[:rf.SUB].double() @ rays_v.double()).repeat(1, rf.GRID) * 1e-30 * rf.M_ITERS
    sum_abs = (mt_v[:rf.SUB].abs().double() @ rays_v.abs().double()).repeat(1, rf.GRID) * 1e-30
    t_gate = (rf.M_ITERS * prod_tol + 2.0**-24 * rf.M_ITERS * (rf.M_ITERS + 3) / 2) * sum_abs
    scale_v = mt_v.abs() @ rays_v.abs()
    want = rf.overlap_reference(a_s, b_v, mt_v, rays_v, False, True, 1)
    t_errs = {"plain": float(((want["t"].double() - exact).abs() / t_gate).max())}
    p_err = 0.0
    for case in [c for c in ov_cases if c[1]]:
        got = rf.overlap(a_s, b_v, mt_v, rays_v, *case, keep_product=True)
        torch.cuda.synchronize()
        t_errs[case] = float(((got["t"].double() - exact).abs() / t_gate).max())
        p_err = max(p_err, float(((got["product"] - want["product"]).abs() / scale_v).max()))
    b7_err["overlap"] = max(b7_err["overlap"], p_err / prod_tol * 1e-4)
    print(f"parity B7 overlap at full size on inputs where the product shows in t (max |t| "
          f"{float(exact.abs().max()):.1f}): t of all {rf.LANES * rf.GRID} columns, |d| / gate "
          + ", ".join(f"{k if k == 'plain' else 'vector %s matrix %s scale %s' % k} {v:.3f}"
                      for k, v in t_errs.items())
          + f" (<= 1); product max |d| / sum |terms| {p_err:.3e} (<= {prod_tol:.3e}); "
          f"{time.perf_counter() - t1:.1f}s", flush=True)
    if not (max(t_errs.values()) <= 1.0 and p_err <= prod_tol and float(exact.abs().max()) > 1.0):
        raise RuntimeError("the overlap probe's product differs from the exact one at full size")
    del want, exact, sum_abs, t_gate
    b7_ms = {"fma": kernel_ms(rf.prepare_vector("fma", a_f, b_f), 5, torch),
             "mix": kernel_ms(rf.prepare_vector("mix", a_f, b_f), 5, torch)}
    # the overlap settings in turns (CUDA events around each launch alone),
    # B7_ROUNDS rounds; their medians set s* = round(matrix / vector at scale
    # 1), the scale where the two times are equal and the overlap fraction is
    # best conditioned. Its vector and both settings are then timed in
    # B7_ROUNDS rounds of their own, in turns with the matrix alone, as a
    # timing point (no new probe: o of both equals o of vector alone bit for
    # bit there, and t equals t of the matrix alone)
    ov_launch = {case: rf.prepare_overlap(a_f, b_f, mt_f, rays_f, *case) for case in ov_cases}

    def event_ms(launch) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rc = launch()
        end.record()
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"overlap kernel launch failed: cudaError {rc}")
        return start.elapsed_time(end)

    def in_turns(cases, rounds: int) -> dict:
        times = {case: [] for case in cases}
        for _ in range(rounds):
            for case in cases:
                times[case].append(event_ms(ov_launch[case][0]))
        return times

    in_turns(ov_cases, 1)  # warm-up
    b7_times = in_turns(ov_cases, B7_ROUNDS)
    s_star = max(1, round(statistics.median(b7_times[False, True, 1])
                          / statistics.median(b7_times[True, False, 1])))
    star_cases = [(True, False, s_star), (True, True, s_star), (False, True, 1)]
    for case in star_cases[:2]:
        ov_launch.setdefault(case, rf.prepare_overlap(a_f, b_f, mt_f, rays_f, *case))
    in_turns(star_cases, 1)  # warm-up, and the outputs compared below
    outs_of = {case: ov_launch[case][1] for case in star_cases}
    star_same = (torch.equal(outs_of[True, True, s_star]["o"], outs_of[True, False, s_star]["o"])
                 and torch.equal(outs_of[True, True, s_star]["t"], outs_of[False, True, 1]["t"]))
    print(f"B7 timing point s* = {s_star} (medians of matrix / vector at scale 1 over "
          f"{B7_ROUNDS} rounds): o of both equals o of vector alone and t equals t of matrix "
          f"alone, bit for bit: {star_same}", flush=True)
    if not star_same:
        raise RuntimeError("the overlap probe's outputs at s* depend on the other unit's work")
    star_times = in_turns(star_cases, B7_ROUNDS)
    if s_star not in (1, 2, 4):
        b7_times.update({case: star_times[case] for case in star_cases[:2]})
    b7_ms.update({case: statistics.median(v) for case, v in b7_times.items()})
    els = rf.SUB * rf.LANES * rf.GRID
    fma_flops = 2 * els * rf.ITERS * rf.UNROLL * rf.CHAINS  # an FMA counted as two
    mix_ops = els * rf.ITERS * rf.MIX_UNROLL * rf.MIX_OPS
    mix_flops = els * rf.ITERS * rf.MIX_UNROLL * (2 * rf.MIX_FMAS + rf.MIX_OPS - rf.MIX_FMAS)
    mm_flops = 4 * rf.C_TRIS * rf.K * rf.LANES * 2 * rf.GRID * rf.M_ITERS  # the product
    rates = {"fma TFLOP/s": fma_flops / b7_ms["fma"] / 1e9,
             "mix Tops/s": mix_ops / b7_ms["mix"] / 1e9,
             "mix TFLOP/s": mix_flops / b7_ms["mix"] / 1e9,
             "product TFLOP/s": mm_flops / b7_ms[False, True, 1] / 1e9,
             "TF32 TFLOP/s executed": 3 * mm_flops / b7_ms[False, True, 1] / 1e9}
    # the rates' ceilings, all at 1,980 MHz (a rate above one is a miscount)
    limits = {"fma TFLOP/s": FP32_PEAK / 1e12, "mix Tops/s": FP32_PEAK / 2e12,
              "mix TFLOP/s": FP32_PEAK / 1e12, "product TFLOP/s": TF32_PEAK_1980 / 1e12,
              "TF32 TFLOP/s executed": TF32_PEAK_1980 / 1e12}
    print(f"time B7 fma peak: {b7_ms['fma']:.4f} ms, {rates['fma TFLOP/s']:.2f} TFLOP/s float32 "
          f"(FMA = 2; data sheet {FP32_PEAK / 1e12:.0f}) [{card}]", flush=True)
    print(f"time B7 pair mix: {b7_ms['mix']:.4f} ms, {rates['mix Tops/s']:.2f} T ops/s "
          f"({rf.MIX_OPS} per step, {rf.MIX_FMAS} of them FMAs; issue limit "
          f"{FP32_PEAK / 2e12:.1f} T instructions/s), {rates['mix TFLOP/s']:.2f} TFLOP/s [{card}]",
          flush=True)
    b7_spread = {case: (min(v), max(v)) for case, v in b7_times.items()}
    for case in b7_times:
        print(f"time B7 overlap vector {case[0]} matrix {case[1]} scale {case[2]}: median "
              f"{b7_ms[case]:.4f} ms, spread {b7_spread[case][0]:.4f}-{b7_spread[case][1]:.4f} "
              f"over {B7_ROUNDS} rounds in turns [{card}]", flush=True)
    print(f"time B7 matrix alone: {b7_ms[False, True, 1]:.4f} ms, {rates['product TFLOP/s']:.2f}"
          f" TFLOP/s of the float32 product, {rates['TF32 TFLOP/s executed']:.2f} TFLOP/s of TF32"
          f" executed (3 products: hi*hi + hi*lo + lo*hi; data sheet {TF32_PEAK / 1e12:.1f} "
          f"dense at 1,830 MHz, {TF32_PEAK_1980 / 1e12:.1f} at 1,980 MHz) [{card}]", flush=True)
    b7_overlap = []
    for vs in (1, 2, 4, s_star):
        fracs, rounds = [], star_times if vs == s_star and vs not in (1, 2, 4) else b7_times
        for t_v, t_b, t_m in zip(rounds[True, False, vs], rounds[True, True, vs],
                                 rounds[False, True, 1]):  # each round's own fraction
            fracs.append((t_v + t_m - t_b) / max(min(t_v, t_m), 1e-12))
        t_v, t_b = b7_ms[True, False, vs], b7_ms[True, True, vs]
        t_m = statistics.median(rounds[False, True, 1])
        frac = statistics.median(fracs)
        b7_overlap.append({"vector_scale": vs, "timing_point": vs == s_star and vs not in (1, 2, 4),
                           "vector_ms": t_v, "matrix_ms": t_m, "both_ms": t_b,
                           "vector_ms_spread": b7_spread[True, False, vs],
                           "both_ms_spread": b7_spread[True, True, vs],
                           "overlap": frac, "overlap_spread": (min(fracs), max(fracs)),
                           "both_over_max": t_b / max(t_v, t_m)})
        print(f"time B7 overlap vector x{vs}{' (s*, a timing point)' if vs == s_star else ''}: "
              f"vector {t_v:.4f} ms, matrix {t_m:.4f} ms, both {t_b:.4f} ms (max "
              f"{max(t_v, t_m):.4f} / sum {t_v + t_m:.4f}; both / max {t_b / max(t_v, t_m):.3f}):"
              f" overlap median {frac * 100:.1f}%, spread {min(fracs) * 100:.1f}-"
              f"{max(fracs) * 100:.1f}% [{card}]", flush=True)
    for key, rate in rates.items():
        if rate > 1.05 * limits[key]:
            raise RuntimeError(f"B7 {key} {rate:.2f} exceeds 105% of the card's peak "
                               f"{limits[key]:.1f} at 1,980 MHz: a miscount")
    b7_bounds = {"fma": bound(fma_flops, 2 * 4 * rf.SUB * rf.LANES + 4 * els),
                 "mix": bound(mix_flops, 2 * 4 * rf.SUB * rf.LANES + 4 * els)}
    vec_flops = 2 * els * rf.M_ITERS * rf.V_UNROLL * rf.CHAINS
    ov_bytes = 4 * (2 * rf.SUB * rf.LANES + 4 * rf.C_TRIS * rf.K + rf.K * rf.LANES + 2 * els)
    t_ov = max(vec_flops / FP32_PEAK, 3 * mm_flops / TF32_PEAK) * 1e3
    b7_bounds["overlap"] = ((t_ov, "operations") if t_ov >= ov_bytes / HBM_RATE * 1e3
                            else (ov_bytes / HBM_RATE * 1e3, "bytes"))
    # library_ms: torch.bmm of mt, broadcast over the grid blocks, with the
    # scaled rays, M_ITERS calls; each call writes [GRID, 4 C_TRIS, LANES] of
    # products (256 MB), which the probe keeps in registers. float32 through
    # cuBLAS, then one TF32 pass (allow_tf32: less accurate). A yardstick
    # only: the port never calls it
    mt_b = mt_f.expand(rf.GRID, 4 * rf.C_TRIS, rf.K)
    rays_b = (rays_f * (1.0 + b_f[0:1] * 1e-30)).expand(rf.GRID, rf.K, rf.LANES)
    bmm_out = torch.empty((rf.GRID, 4 * rf.C_TRIS, rf.LANES), device=dev)

    def bmm_calls():
        for _ in range(rf.M_ITERS):
            torch.bmm(mt_b, rays_b, out=bmm_out)

    b7_library = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        b7_library[tf32] = time_ms(bmm_calls, 3, torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    del bmm_out, mt_b, rays_b
    share = b7_bounds["overlap"][0] / b7_ms[False, True, 1]
    share_1980 = 3 * mm_flops / TF32_PEAK_1980 * 1e3 / b7_ms[False, True, 1]
    print(f"B7 library yardstick: torch.bmm [{rf.GRID}, {4 * rf.C_TRIS}, {rf.K}] x [{rf.GRID}, "
          f"{rf.K}, {rf.LANES}] x {rf.M_ITERS} calls: float32 {b7_library[False]:.4f} ms, one "
          f"TF32 pass {b7_library[True]:.4f} ms; the probe's matrix alone "
          f"{b7_ms[False, True, 1]:.4f} ms against its bound {b7_bounds['overlap'][0]:.4f} ms "
          f"(the data sheet's TF32 peak): {share * 100:.1f}% of the bound, "
          f"{share_1980 * 100:.1f}% of the tensor cores' TF32 peak at 1,980 MHz [{card}]",
          flush=True)
    ptxas_ov = [c for c in cuda_build.ptxas_counts(cuda_build.BUILD_INFO["roofline"]["log"])
                if "overlap" in c["kernel"]]
    serialised = [line.strip() for line in cuda_build.BUILD_INFO["roofline"]["log"].splitlines()
                  if "wgmma" in line and "serialized" in line]
    print(f"B7 overlap kernel ptxas: {ptxas_ov}; wgmma serialised: {serialised or 'no'}",
          flush=True)
    print(f"B7 verdict: of the shorter unit's time, "
          + " / ".join(f"{r['overlap'] * 100:.1f}%" for r in b7_overlap)
          + f" hides under the other at vector scales 1 / 2 / 4 / s* = {s_star} (100%: the units "
          f"overlap; 0%: they serialise); bounds fma {b7_bounds['fma'][0]:.4f}, mix "
          f"{b7_bounds['mix'][0]:.4f}, overlap {b7_bounds['overlap'][0]:.4f} ms [{card}]",
          flush=True)
    del full, a_f, b_f, mt_f, rays_f, ov_launch, outs_of

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 39", flush=True)
    # ---- 39. row-block launches of B1 and B5, and B2's halo'd vertical pass ----------
    # each kernel launched whole and as 2 and 4 row blocks (py0, full_height),
    # the blocks put together against the whole launch; every launch alone
    # timed (kernel_ms: the outputs are the last timed launch's)
    sc39, cam39 = build_scene(BVH_MAIN_SCENE)
    scene39 = sc39.build(dev)  # phase 29 freed phase 8's scene; first32 are its cameras
    cam39.set_aspect(RT_W, RT_H)
    cams39 = cameras(cam39, RT_W, RT_H, 1, 3)
    row_report = {}
    for label, mod, sc_, op_, cm_, w_, h_, realtime, atol, s_, reps in (
            ("B1 progressive config 1", fs, scene1, options1, first_cams, MAIN_SIZE, MAIN_SIZE,
             False, 1e-6, MAIN_S, 10),
            ("B1 realtime config 4", fs, rt_scene, rt_options, cams0, RT_W, RT_H, True, 1e-5, 1,
             20),
            (f"B5 progressive {BVH_MAIN_SCENE}", ft, scene39, opts32, first32, M, M, False, 1e-6,
             BVH_S, 3),
            (f"B5 realtime {BVH_MAIN_SCENE}", ft, scene39, opts32, cams39, RT_W, RT_H, True, 1e-5,
             1, 3)):
        ek_ = int(sc_["env"]["kind"])

        def prep(py0, rows):
            """(launch, outs[, err]) of a launch of rows [py0, py0 + rows)."""
            if mod is fs:  # B1 takes its opt-ins (off) before py0
                return fs.prepare_launch(sc_, op_, cm_, w_, rows, ek_, realtime, 0, 0, py0=py0,
                                         full_height=h_ if py0 is not None else 0)
            return ft.prepare_launch(sc_, op_, cm_, w_, rows, ek_, realtime, py0=py0,
                                     full_height=h_ if py0 is not None else 0)

        full_p = prep(None, h_)
        full_ms = kernel_ms(full_p, reps, torch)
        row_axis = 1 if realtime else 0  # realtime outputs are [S, rows, ...]
        entry = {"full_ms": full_ms}
        for n in (2, 4):
            rows = h_ // n
            blocks = [prep(i * rows, rows) for i in range(n)]
            block_ms = [kernel_ms(b, reps, torch) for b in blocks]
            worst = {"bit_equal": True, "max_abs_diff": 0.0, "differing_pixels": 0.0}
            for o, want_o in enumerate(full_p[1]):
                got_o = torch.cat([b[1][o] for b in blocks], dim=row_axis)
                if torch.equal(got_o, want_o):
                    continue
                diff = (got_o - want_o).abs() / s_
                px = diff.reshape(*diff.shape[:row_axis + 2], -1).amax(-1) > 0
                worst = {"bit_equal": False,
                         "max_abs_diff": max(worst["max_abs_diff"], float(diff.max())),
                         "differing_pixels": max(worst["differing_pixels"],
                                                 float(px.float().mean()))}
            ok = worst["bit_equal"] or worst["max_abs_diff"] <= atol
            print(f"row blocks {label}: {n} blocks of {rows} rows against the whole launch: "
                  + ("bit-equal" if worst["bit_equal"] else
                     f"max |d| {worst['max_abs_diff']:.3e} (gate {atol:g}) on "
                     f"{worst['differing_pixels']:.4%} of pixels")
                  + f"; ms whole {full_ms:.4f}, blocks {' + '.join(f'{t:.4f}' for t in block_ms)}"
                  f" = {sum(block_ms):.4f} [{card}] -> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise RuntimeError(f"{label}: {n} row blocks differ from the whole launch")
            entry[f"{n}_blocks"] = dict(worst, block_ms=block_ms, sum_ms=sum(block_ms))
        row_report[label] = entry
    check_errors()

    # B2 on config 4's frame 0 as row blocks, one thread a block, each
    # thread driving parallel/render.py on its block (launch.run_tiles): the
    # vertical pass on the block padded by _halo_rows against the full pass,
    # and _denoise_local (the halo path, or gather_rows and the full columns
    # where a block is shorter than MAX_EXTENT) against the whole frame's
    # denoise_composite
    aovs39 = fs.realtime_aovs(rt_scene, rt_options, cams0, RT_W, RT_H, 0)
    d39, s39 = aovs39["direct"][0], aovs39["indirect_specular"][0]
    params39 = DenoiseCompositor(device=dev).params
    radius39 = float(params39["max_kernel_size"])
    pass0 = bl.bilateral_pass(s39, d39, radius39, 1)
    whole_v = bl.bilateral_pass(pass0, d39, radius39, 0)
    whole_c = denoise_composite(d39, s39, params39)
    r39 = bl.MAX_EXTENT
    whole_ms = time_ms(lambda: bl.bilateral_pass(pass0, d39, radius39, 0), 20, torch)
    halo_report = {"whole_ms": whole_ms}

    def differ(got, want):
        """(bit-equal, max |d|, share of differing pixels)."""
        if torch.equal(got, want):
            return True, 0.0, 0.0
        d = (got - want).abs()
        return False, float(d.max()), float((d.amax(-1) > 0).float().mean())

    for n in (2, 4, 72):
        h39 = RT_H // n
        halo = h39 >= r39

        def tile_job(mesh):
            """(this block's vertical pass on its halo'd rows or None, the
            padded inputs or None, its _denoise_local composite)."""
            a, b = mesh.tile * h39, (mesh.tile + 1) * h39
            vert = padded = None
            if halo:
                padded = par._halo_rows([pass0[a:b], d39[a:b]], r39, mesh)
                vert = bl.bilateral_pass(*padded, radius39, 0)[r39:-r39]
            return vert, padded, par._denoise_local(d39[a:b], s39[a:b], params39, mesh, h39)

        tiles = par_launch.run_tiles(n, tile_job, dev)
        checks = {"composite": differ(torch.cat([t[2] for t in tiles]), whole_c)}
        part_ms = []
        if halo:
            checks["vertical pass"] = differ(torch.cat([t[0] for t in tiles]), whole_v)
            part_ms = [time_ms(lambda p=t[1]: bl.bilateral_pass(*p, radius39, 0), 20, torch)
                       for t in tiles]
        path = "halo" if halo else "short-block (gather_rows, full columns)"
        ok = all(eq or err <= 1e-5 for eq, err, _ in checks.values())
        print(f"row blocks B2 {RT_W}x{RT_H}: {n} blocks of {h39} rows, {path} path, one thread "
              f"a block: " + "; ".join(
                  f"{name} " + ("bit-equal" if eq else f"max |d| {err:.3e} on {share:.4%} of "
                                                       f"pixels")
                  for name, (eq, err, share) in checks.items())
              + " against the whole frame"
              + (f"; ms whole vertical pass {whole_ms:.4f}, padded blocks "
                 f"{' + '.join(f'{t:.4f}' for t in part_ms)} = {sum(part_ms):.4f}" if part_ms
                 else "") + f" [{card}] -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"B2's {n} row blocks differ from the whole frame")
        halo_report[f"{n}_blocks"] = {
            "path": path, "block_ms": part_ms,
            **{name: {"bit_equal": eq, "max_abs_diff": err, "differing_pixels": share}
               for name, (eq, err, share) in checks.items()}}
        del tiles
    del aovs39, pass0, whole_v, whole_c

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 40", flush=True)
    # ---- 40. sharded steps through torch.distributed ---------------------------------
    import torch.distributed as dist

    steps40 = par_launch.camera_steps(np.random.default_rng(40), MAIN_SIZE, MAIN_SIZE,
                                      MAIN_FRAMES, MAIN_S)
    sc40, cam40 = build_scene("cornell-glossy")
    cam40.set_aspect(MAIN_SIZE, MAIN_SIZE)
    pipe40 = ProgressiveRaytracingPipeline(MAIN_SIZE, MAIN_SIZE, seed=40,
                                           samples_per_frame=MAIN_S, device=dev)
    pipe40.max_iterations = MAIN_S * MAIN_FRAMES
    pipe40.set_camera(cam40)
    pipe40.set_scene(sc40)
    pipe_ms = []
    for f in range(MAIN_FRAMES):
        t0 = time.perf_counter()
        pipe40.update(elapsed_time=f / 60.0, elapsed_frames=f)
        pipe40.render()
        torch.cuda.synchronize()
        pipe_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"time single-process progressive (the pipeline): host ms per {MAIN_S}-sample "
          f"dispatch (synchronised) {', '.join(f'{t:.3f}' for t in pipe_ms)} [{card}]",
          flush=True)
    want40 = pipe40.get_output().clone()
    den40 = DenoiseCompositor(device=dev)
    ref_rt = {k: v[0] for k, v in fs.realtime_aovs(rt_scene, rt_options, cams0, RT_W, RT_H,
                                                    0).items()}
    ref_rt["color"] = ref_rt["direct"] + ref_rt["indirect_specular"]
    ref_rt["display"] = den40.dispatch(ref_rt["direct"], ref_rt["indirect_specular"])
    torch.cuda.synchronize()

    def same_images(label, got, want, atol):
        """Bit-equal (values), or within atol + 1e-6 |want| (the spp sum
        reassociated); prints and raises."""
        want = want.cpu().numpy() if hasattr(want, "cpu") else want
        got = got.cpu().numpy() if hasattr(got, "cpu") else got
        equal = bool(np.array_equal(got, want))
        err = 0.0 if equal else float(np.abs(got - want).max())
        ok = equal or (atol > 0 and bool(np.all(np.abs(got - want) <= atol + 1e-6 * np.abs(want))))
        print(f"sharded {label}: " + ("bit-equal to the single process" if equal else
                                      f"max |d| {err:.3e} against the single process (gate "
                                      f"{atol:g} + 1e-6 |want|)") + f" -> {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise RuntimeError(f"sharded {label} differs from the single-process image")
        return {"bit_equal": equal, "max_abs_diff": err}

    sharded = {}
    par_launch.init_ranks(0, 1, f"tcp://localhost:{par_launch.free_port()}", "cuda")
    try:
        mesh1 = par.make_render_mesh(1, 1)
        scene40 = par.replicate_scene(pipe40.scene_data, mesh1)
        step40 = par.make_sharded_progressive_step(scene40, MAIN_SIZE, MAIN_SIZE, mesh1,
                                                   samples_per_step=MAIN_S)
        accum40 = torch.zeros((MAIN_SIZE, MAIN_SIZE, 3), dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        step_ms = []
        for cams in steps40:
            cameras40 = stack_cameras([camera_params(cam40, jitter=(jx, jy), frame_count=fc,
                                                     accum_count=ac) for jx, jy, fc, ac in cams])
            t0 = time.perf_counter()
            accum40 = step40(accum40, pipe40.options, cameras40, scene40["lights"],
                             scene40["env"], MAIN_S * MAIN_FRAMES)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        expect_counts("sharded progressive 1x1 on NCCL", {"B1": MAIN_FRAMES})
        print(f"time sharded progressive 1x1 (NCCL world of 1): host ms per {MAIN_S}-sample step "
              f"(synchronised) {', '.join(f'{t:.3f}' for t in step_ms)} [{card}]", flush=True)
        sharded["1x1 nccl progressive"] = dict(same_images("progressive 1x1 (NCCL)", accum40,
                                                           want40, 0.0), step_ms=step_ms)
        rt_step40 = par.make_sharded_realtime_step(rt_scene, RT_W, RT_H, mesh1, denoise=True)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out40 = rt_step40(rt_options, cam0, rt_scene["lights"], rt_scene["env"], den40.params)
        torch.cuda.synchronize()
        rt_ms = (time.perf_counter() - t0) * 1e3
        expect_counts("sharded realtime + denoise 1x1 on NCCL", {"B1 realtime": 1, "B2": 2})
        print(f"time sharded realtime+denoise 1x1 (NCCL world of 1): host ms per {RT_W}x{RT_H} "
              f"frame (synchronised) {rt_ms:.3f} [{card}]", flush=True)
        sharded["1x1 nccl realtime"] = {k: same_images(f"realtime 1x1 (NCCL) {k}", out40[k],
                                                       ref_rt[k], 0.0) for k in ref_rt}
    finally:
        dist.destroy_process_group()

    # two ranks sharing the card over gloo: broadcast and all-reduce of CUDA tensors
    jit0 = cam0["jitter"]
    spec40 = {"scene": "cornell-glossy", "width": MAIN_SIZE, "height": MAIN_SIZE,
              "steps": steps40, "max_iterations": MAIN_S * MAIN_FRAMES, "device": "cuda"}
    spec_rt = {"scene": "cornell-glossy", "width": RT_W, "height": RT_H, "mesh": (2, 1),
               "camera": (float(jit0[0]), float(jit0[1]), int(cam0["frame_count"])),
               "denoise": True, "device": "cuda", "repeat": 5}
    # 1920x48: 24-row blocks, shorter than MAX_EXTENT, take the short-block path
    short_h = 48
    spec_short = dict(spec_rt, height=short_h, repeat=2)
    sc48, cam48 = build_scene("cornell-glossy")
    cam48.set_aspect(RT_W, short_h)
    cams48 = {k: v[None] for k, v in camera_params(cam48, jitter=(float(jit0[0]), float(jit0[1])),
                                                   frame_count=int(cam0["frame_count"])).items()}
    ref_short = {k: v[0] for k, v in fs.realtime_aovs(rt_scene, rt_options, cams48, RT_W,
                                                       short_h, 0).items()}
    ref_short["color"] = ref_short["direct"] + ref_short["indirect_specular"]
    ref_short["display"] = den40.dispatch(ref_short["direct"], ref_short["indirect_specular"])
    refs40 = {"realtime+denoise 2x1": ref_rt,
              f"realtime+denoise 2x1 {RT_W}x{short_h} short blocks": ref_short}
    jobs40 = [("progressive 2x1", par_launch.progressive_job, dict(spec40, mesh=(2, 1))),
              ("progressive 1x2", par_launch.progressive_job, dict(spec40, mesh=(1, 2))),
              ("realtime+denoise 2x1", par_launch.realtime_job, spec_rt),
              (f"realtime+denoise 2x1 {RT_W}x{short_h} short blocks", par_launch.realtime_job,
               spec_short)]
    t0 = time.perf_counter()
    ranks40 = par_launch.spawn(par_launch.run_jobs, 2, ([(fn, sp) for _, fn, sp in jobs40],),
                               device="cuda", backend="gloo", timeout=600)
    spawn_s = time.perf_counter() - t0
    print(f"sharded: 2 spawned ranks on one card over gloo ran {len(jobs40)} renders in "
          f"{spawn_s:.1f}s host clock, start-up included", flush=True)
    for j, (label, fn, spec_j) in enumerate(jobs40):
        want_l = ({"B1 realtime": spec_j["repeat"], "B2": 2 * spec_j["repeat"]}
                  if fn is par_launch.realtime_job else {"B1": MAIN_FRAMES})
        for r in range(2):
            got_l = {k: v for k, v in ranks40[r][j]["launches"].items() if v}
            print(f"launches sharded {label} rank {r}: {got_l}; expected {want_l} -> "
                  f"{'ok' if got_l == want_l else 'FAIL'}", flush=True)
            if got_l != want_l:
                raise RuntimeError(f"sharded {label} rank {r}: launches {got_l}, want {want_l}")
        res = ranks40[0][j]
        if fn is par_launch.progressive_job:
            print(f"time sharded {label} (2 ranks, one card, gloo): host ms per step, rank 0 "
                  f"{', '.join(f'{t:.3f}' for t in res['step_ms'])}; rank 1 "
                  f"{', '.join(f'{t:.3f}' for t in ranks40[1][j]['step_ms'])} [{card}]",
                  flush=True)
            sharded[label] = dict(same_images(label, res["image"], want40,
                                              0.0 if label.endswith("2x1") else 1e-5),
                                  step_ms=res["step_ms"])
        else:
            print(f"time sharded {label} (2 ranks, one card, gloo): host ms per frame "
                  f"(synchronised, {spec_j['repeat']} frames), rank 0 "
                  f"{', '.join(f'{t:.3f}' for t in res['frame_ms'])}; rank 1 "
                  f"{', '.join(f'{t:.3f}' for t in ranks40[1][j]['frame_ms'])} [{card}]",
                  flush=True)
            sharded[label] = {k: same_images(f"{label} {k}", res["outputs"][k], want_k, 0.0)
                              for k, want_k in refs40[label].items()}
            sharded[label]["frame_ms"] = res["frame_ms"]
    headless(["--shard", "1x1", "--scene", "cornell-glossy", "--size",
              f"{MAIN_SIZE}x{MAIN_SIZE}", "--spp", "16"], "--shard 1x1 cornell-glossy")

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 41", flush=True)
    # ---- 41. frames in flight: K frames a dispatch --------------------------------------
    K41 = 4
    sc41, cam41 = build_scene("cornell-glossy")
    cam41.set_aspect(RT_W, RT_H)

    def rt_pipe(seed, scene_data=None, camera=cam41):
        p = RealtimeRaytracingPipeline(RT_W, RT_H, seed=seed, device=dev)
        p.set_camera(camera)
        if scene_data is None:
            p.set_scene(sc41)
        else:
            p.set_scene_data(scene_data)
        return p

    fif = {}
    for label, key, make in (("cornell-glossy (B1)", "B1 realtime", lambda: rt_pipe(41)),
                             (f"{BVH_MAIN_SCENE} (B5)", "B5 realtime",
                              lambda: rt_pipe(41, scene39, cam39))):
        batch, seq = make(), make()
        torch.cuda.synchronize()
        reset_counts()
        d_k, s_k = batch.render_frames(0, K41)
        torch.cuda.synchronize()
        expect_counts(f"render_frames K={K41} {label}", {key: 1})
        equal = True
        for f in range(K41):
            seq.update(elapsed_time=0.0, elapsed_frames=f)
            d, s_ = seq.render()
            equal &= torch.equal(d, d_k[f]) and torch.equal(s_, s_k[f])
        check_errors()
        print(f"frames in flight {label}: render_frames K={K41} at {RT_W}x{RT_H} against "
              f"{K41} sequential render() calls: {'bit-equal' if equal else 'DIFFER'}",
              flush=True)
        if not equal:
            raise RuntimeError(f"render_frames on {label} differs from sequential renders")
        fif[f"render_frames {label}"] = {"launches": 1, "bit_equal": equal}

    pipe41 = rt_pipe(42)
    scene41, params41 = pipe41.scene_data, den40.params
    lights41, env41 = scene41["lights"], scene41["env"]
    step41 = make_realtime_denoise_frames_step(scene41, RT_W, RT_H, K41)
    cams41 = pipe41.frame_cameras(0, K41)
    torch.cuda.synchronize()
    reset_counts()
    aovs41, imgs41 = step41(pipe41.options, cams41, lights41, env41, params41)
    torch.cuda.synchronize()
    expect_counts(f"make_realtime_denoise_frames_step K={K41}", {"B1 realtime": 1, "B2": 2 * K41})
    equal = all(torch.equal(imgs41[f], denoise_composite(aovs41["direct"][f],
                                                         aovs41["indirect_specular"][f],
                                                         params41)) for f in range(K41))
    temporal_a = DenoiseCompositor(temporal_alpha=0.2, device=dev)
    temporal_b = DenoiseCompositor(temporal_alpha=0.2, device=dev)
    outs41 = temporal_a.dispatch_frames(aovs41["direct"], aovs41["indirect_specular"])
    t_equal = all(torch.equal(outs41[f], temporal_b.dispatch(aovs41["direct"][f],
                                                             aovs41["indirect_specular"][f]))
                  for f in range(K41))
    t_equal &= torch.equal(temporal_a._history, temporal_b._history)
    print(f"frames in flight: the K={K41} denoise step against the sequential denoiser: "
          f"{'bit-equal' if equal else 'DIFFER'}; dispatch_frames temporal alpha 0.2 against "
          f"{K41} dispatch() calls: {'bit-equal' if t_equal else 'DIFFER'}", flush=True)
    if not (equal and t_equal):
        raise RuntimeError("the frames-in-flight denoiser differs from sequential dispatches")
    fif["denoise step bit_equal"], fif["temporal bit_equal"] = equal, t_equal

    # host ms per frame at K = 1, 2, 4, 8 beside the kernels' ms per frame,
    # and the pipeline's one-frame path (update + render + dispatch) before
    # and after them, on the same host clock
    b2_pass_ms = time_ms(lambda: bl.bilateral_pass(aovs41["indirect_specular"][0],
                                                   aovs41["direct"][0], radius39, 1), 20, torch)
    n41 = 48  # frames per setting

    def pipeline_frames(when):
        """update + render + dispatch, n41 frames: the synchronised ms a
        frame and each part's host enqueue ms a frame."""
        pp, den = rt_pipe(44), DenoiseCompositor(device=dev)
        pp.update(elapsed_time=0.0, elapsed_frames=0)
        den.dispatch(*pp.render())  # warm-up
        torch.cuda.synchronize()
        parts = [0.0, 0.0, 0.0]
        t0 = time.perf_counter()
        for f in range(1, n41 + 1):
            ta = time.perf_counter()
            pp.update(elapsed_time=0.0, elapsed_frames=f)
            tb = time.perf_counter()
            d, s_ = pp.render()
            tc = time.perf_counter()
            den.dispatch(d, s_)
            td = time.perf_counter()
            parts = [parts[0] + tb - ta, parts[1] + tc - tb, parts[2] + td - tc]
        torch.cuda.synchronize()
        frame = (time.perf_counter() - t0) / n41 * 1e3
        parts = [p_ / n41 * 1e3 for p_ in parts]
        print(f"time frames in flight, the pipeline's one-frame path ({when} the K sweep): "
              f"{frame:.3f} ms per {RT_W}x{RT_H} frame (update + render + dispatch, host clock, "
              f"synchronised, {n41} frames), host enqueue update {parts[0]:.3f} + render "
              f"{parts[1]:.3f} + dispatch {parts[2]:.3f} = {sum(parts):.3f} ms per frame "
              f"[{card}]", flush=True)
        return {"host_ms_per_frame": frame, "enqueue_update_render_dispatch_ms": parts}

    fif["pipeline one frame before"] = pipeline_frames("before")
    fif["per_k"] = {}
    for k in (1, 2, 4, 8):
        stepk = make_realtime_denoise_frames_step(scene41, RT_W, RT_H, k)
        pk = rt_pipe(43)
        stepk(pk.options, pk.frame_cameras(0, k), lights41, env41, params41)  # warm-up
        torch.cuda.synchronize()
        enq_cams = enq_step = 0.0
        t0 = time.perf_counter()
        for i in range(n41 // k):
            ta = time.perf_counter()
            cams_k = pk.frame_cameras(k * (i + 1), k)
            tb = time.perf_counter()
            stepk(pk.options, cams_k, lights41, env41, params41)
            tc = time.perf_counter()
            enq_cams, enq_step = enq_cams + tb - ta, enq_step + tc - tb
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / n41 * 1e3
        enqueue = enq_cams + enq_step
        # the step's two calls apart: realtime_frames, denoise_composite_frames
        scene_k = dict(scene41, lights=lights41, env=env41)
        enq_render = enq_denoise = 0.0
        for i in range(n41 // k):
            cams_k = pk.frame_cameras(k * (i + 1), k)
            ta = time.perf_counter()
            out_k = realtime_frames(scene_k, pk.options, cams_k, RT_W, RT_H)
            tb = time.perf_counter()
            denoise_composite_frames(out_k["direct"], out_k["indirect_specular"], params41)
            tc = time.perf_counter()
            enq_render, enq_denoise = enq_render + tb - ta, enq_denoise + tc - tb
        torch.cuda.synchronize()
        del out_k
        b1k_ms = kernel_ms(fs.prepare_launch(scene41, pk.options, pk.frame_cameras(0, k), RT_W,
                                             RT_H, 0, True, 0, 0), 10, torch)
        kern_frame = b1k_ms / k + 2 * b2_pass_ms
        n_prof = 8  # frames under the profiler
        busy, top = device_busy(lambda: [
            stepk(pk.options, pk.frame_cameras(k * (i + 1), k), lights41, env41, params41)
            for i in range(n_prof // k)], torch)
        busy_frame = busy / n_prof
        split = [x / n41 * 1e3 for x in (enq_cams, enq_render, enq_denoise)]
        fif["per_k"][k] = {"host_ms_per_frame": host_ms, "enqueue_ms_per_frame":
                           enqueue / n41 * 1e3,
                           "enqueue_cameras_render_denoise_ms": split,
                           "b1_launch_ms": b1k_ms, "kernel_ms_per_frame": kern_frame,
                           "device_busy_ms_per_frame": busy_frame,
                           "device_idle_share": max(0.0, 1.0 - busy_frame / host_ms)}
        print(f"profile frames in flight K={k}: the card busy {busy_frame:.3f} ms per frame "
              f"(torch.profiler, {n_prof} frames; idle share of the synchronised frame "
              f"{max(0.0, 1.0 - busy_frame / host_ms):.1%}); largest: "
              + "; ".join(f"{name[:48]} {ms / n_prof:.3f} ms x {calls}" for name, ms, calls in top)
              + f" [{card}]", flush=True)
        print(f"time frames in flight K={k}: {host_ms:.3f} ms per {RT_W}x{RT_H} frame "
              f"(render + denoise, host clock, synchronised, {n41} frames), host enqueue "
              f"{enqueue / n41 * 1e3:.3f} ms per frame (frame_cameras {split[0]:.3f}; the step "
              f"{enq_step / n41 * 1e3:.3f}, in a second pass of its two calls realtime_frames "
              f"{split[1]:.3f} + denoise_composite_frames {split[2]:.3f}); kernels "
              f"{kern_frame:.3f} ms per frame (the {k}-frame B1 launch {b1k_ms:.3f} ms / {k} + "
              f"2 x B2 {b2_pass_ms:.4f} ms) [{card}]", flush=True)
    fif["pipeline one frame after"] = pipeline_frames("after")
    check_errors()
    del aovs41, imgs41, outs41, scene39

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 42", flush=True)
    # ---- 42. mesh files: written here, loaded, rendered through the CLI ------------------
    if native.get_mesh_lib() is None:
        raise RuntimeError("g++ could not build csrc/mesh_io.cpp (the native OBJ parser)")
    tmp42 = tempfile.TemporaryDirectory(prefix="dxr_meshes_")
    d42 = tmp42.name
    front = {}  # counter name -> [{"path", "launches", gates...}] of phases 42-43

    def note_front(label, counts, **gates):
        for k, v in counts.items():
            if v:
                front.setdefault(k, []).append({"path": label, "launches": v, **gates})

    cb_mesh, cb_mats = cornell_box(glossy_tall_box=True)
    src42 = {"cornell": first_use_order(Mesh(cb_mesh.positions, cb_mesh.normals, cb_mesh.indices,
                                             material_ids=cb_mesh.material_ids,
                                             materials=cb_mats))}
    sph = sphere_mesh((0.0, 0.0, 0.0), 1.0, lat=16, lon=32)
    src42["sphere"] = Mesh(sph.positions, None, sph.indices[:, [0, 2, 1]])  # wound outward
    sc_big, _ = build_scene(F42_BIG)
    pos_l, nrm_l, idx_l, mid_l, base_v = [], [], [], [], 0
    for inst in sc_big.instances:  # the flattening of Scene.build, one mesh
        tf = inst.transform
        pos_l.append(inst.mesh.positions @ tf[:3, :3].T + tf[:3, 3])
        nrm_l.append(inst.mesh.normals)
        idx_l.append(inst.mesh.indices + base_v)
        mid_l.append(np.full(inst.mesh.num_triangles, inst.material_override, np.int32))
        base_v += len(inst.mesh.positions)
    src42["big"] = first_use_order(Mesh(
        np.concatenate(pos_l), unit_normals(np.concatenate(nrm_l)), np.concatenate(idx_l),
        material_ids=np.concatenate(mid_l), materials=sc_big.materials))
    del sc_big, pos_l, nrm_l, idx_l, mid_l
    files42 = [("cornell", "obj", write_obj), ("sphere", "ply", write_ply),
               ("sphere", "glb", write_glb), ("sphere", "gltf", write_gltf),
               ("sphere", "fbx", write_fbx), ("sphere", "dae", write_dae),
               ("big", "glb", write_glb), ("big", "obj", write_obj)]
    paths42, loads42 = {}, {}
    for name, ext, writer in files42:
        path = os.path.join(d42, f"{name}.{ext}")
        t0 = time.perf_counter()
        writer(path, src42[name])
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = load_mesh(path, on_error="raise")
        load_s = time.perf_counter() - t0
        src = src42[name]
        pos_eq = np.array_equal(got.positions[got.indices], src.positions[src.indices])
        idx_eq = ext == "obj" or np.array_equal(got.indices, src.indices)  # OBJ welds vertices
        nrm_d = float(np.abs(got.normals[got.indices] - src.normals[src.indices]).max())
        ids_eq = ext != "obj" or np.array_equal(got.material_ids, src.material_ids)
        ok = pos_eq and idx_eq and ids_eq and nrm_d <= 1e-6
        loads42[f"{name}.{ext}"] = {"loader": got.loader, "triangles": got.num_triangles,
                                    "write_s": write_s, "load_s": load_s,
                                    "bytes": os.path.getsize(path), "normals_max_abs": nrm_d}
        print(f"mesh file {name}.{ext}: {got.num_triangles} triangles, "
              f"{os.path.getsize(path):,} bytes, written in {write_s:.2f}s, loaded in "
              f"{load_s:.2f}s host clock by {got.loader}; corner positions exact {pos_eq}, "
              f"indices exact {idx_eq}, material ids exact {ids_eq}, normals max |d| "
              f"{nrm_d:.2e} (<= 1e-6) -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"{name}.{ext} does not load to the mesh written")
        paths42[name, ext] = path
    if loads42["big.obj"]["loader"] != "obj-native":
        raise RuntimeError("the large OBJ did not take the native parser")

    def pipeline_image(sc, cam, size, spp, realtime=False, scene_data=None):
        """The CLI's render loop on a scene built in memory: seed 0, one
        sample a frame (progressive), or one realtime frame + the denoiser."""
        w, h = size
        cam.set_aspect(w, h)
        if realtime:
            p = RealtimeRaytracingPipeline(w, h, seed=0, device=dev)
        else:
            p = ProgressiveRaytracingPipeline(w, h, seed=0, device=dev)
            p.max_iterations = spp
        p.set_camera(cam)
        if scene_data is None:
            p.set_scene(sc)
        else:
            p.set_scene_data(scene_data)
        if realtime:
            p.update(elapsed_time=0.0, elapsed_frames=0)
            direct, spec = p.render()
            return p, DenoiseCompositor(device=dev).dispatch(direct, spec)
        for f in range(spp):
            p.update(elapsed_time=f / 60.0, elapsed_frames=f)
            p.render()
        return p, p.get_output()

    renders42 = []
    for label, key, size, spp, realtime, want in (
            ("cornell.obj progressive", ("cornell", "obj"), (M, M), F42_CORNELL_SPP, False,
             {"B1": F42_CORNELL_SPP}),
            ("cornell.obj realtime + denoise", ("cornell", "obj"), (RT_W, RT_H), 1, True,
             {"B1 realtime": 1, "B2": 2}),
            ("sphere.ply progressive", ("sphere", "ply"), (M, M), F42_SPP, False,
             {"B3 closest": 2 * F42_SPP, "B3 any": 2 * F42_SPP}),
            (f"big.glb ({F42_BIG} flattened) progressive", ("big", "glb"), (M, M), F42_SPP,
             False, {"B5": F42_SPP})):
        out = os.path.join(d42, "cli.npy")
        args = ["--scene", paths42[key], "--size", f"{size[0]}x{size[1]}", "--device", "cuda",
                "-o", out]
        args += ["--pipeline", "realtime", "--denoise"] if realtime else ["--spp", str(spp)]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        if headless_main(args) != 0:
            raise RuntimeError(f"headless {label} failed")
        cli_s = time.perf_counter() - t0
        counts = expect_counts(f"headless {label}", want)
        cli_img = np.load(out)
        sc, cam = mesh_scene(src42[key[0]])
        pipe42, mem = pipeline_image(sc, cam, size, spp, realtime)
        scene42 = pipe42.scene_data
        route = select_route(scene42, "realtime" if realtime else "progressive")
        mem = mem.cpu().numpy()
        bit_eq = np.array_equal(cli_img, mem)
        finite = bool(np.isfinite(cli_img).all()) and float(cli_img.max()) > 0.0
        print(f"headless {label} at {size[0]}x{size[1]}: {cli_s:.2f}s host clock (load, build, "
              f"render, write), route {route}; the image against the written mesh built in "
              f"memory and framed by mesh_scene: {'bit-equal' if bit_eq else 'DIFFERS'}; "
              f"finite with max > 0 {finite} [{card}]", flush=True)
        if not (bit_eq and finite):
            raise RuntimeError(f"headless {label}: the image differs from the in-memory build")
        # the kernel against the plain path at F42_PARITY^2 on the same scene
        n = F42_PARITY
        pp, kern = pipeline_image(sc, cam, (n, n), 1, realtime, scene_data=scene42)
        cam_p = pp._camera_params if realtime else {k: v[0] for k, v in
                                                    pp._camera_params.items()}
        if realtime:
            got_aov = realtime_frames(pp.scene_data, pp.options, {k: v[None] for k, v in
                                                                  cam_p.items()}, n, n)
            plain = render_sample(pp.scene_data, pp.options, cam_p, n, n, mode="realtime",
                                  jitter_scale=fs.REALTIME_JITTER_SCALE, impl="torch")
            torch.cuda.synchronize()
            got_aov = {k: v[0] for k, v in got_aov.items()}
            got_aov.setdefault("color", got_aov["direct"] + got_aov["indirect_specular"])
            gate = aov_gate(f"{label} {n}^2 kernel vs plain", got_aov, plain)
            disp_plain = denoise_composite(plain["direct"], plain["indirect_specular"],
                                           DenoiseCompositor(device=dev).params, impl="torch")
            disp_gate = image_gate(f"{label} {n}^2 display vs the plain denoiser", kern,
                                   disp_plain, 1)
            gate = {"aov_max_abs_diff": gate, "display": disp_gate}
        else:
            plain = render_sample(pp.scene_data, pp.options, cam_p, n, n, impl="torch")["color"]
            torch.cuda.synchronize()
            gate = image_gate(f"{label} {n}^2 1 sample kernel vs plain", kern, plain, 1)
        check_errors()
        renders42.append({"path": label, "size": list(size), "route": route,
                          "host_s": cli_s, "bit_equal_in_memory": bit_eq,
                          f"parity_{n}": gate})
        note_front(f"phase 42: {label}", counts, route=route, host_s=cli_s,
                   bit_equal_in_memory=bit_eq, **{f"parity_{n}": gate})
        del pipe42, scene42, pp, mem, cli_img

    # --checkpoint-every: a render that dies after its frame-4 checkpoint, resumed
    full_npy, res_npy = os.path.join(d42, "full.npy"), os.path.join(d42, "resumed.npy")
    ck42 = os.path.join(d42, "ck")
    base_args = ["--scene", paths42["cornell", "obj"], "--size", f"{M}x{M}", "--spp", "8",
                 "--device", "cuda"]
    headless_main(base_args + ["-o", full_npy])
    real_render = ProgressiveRaytracingPipeline.render

    class ProcessDeath(Exception):
        pass

    def dies_in_frame_6(self):
        if self.accum_count == 6:
            raise ProcessDeath
        return real_render(self)

    ProgressiveRaytracingPipeline.render = dies_in_frame_6
    try:
        headless_main(base_args + ["--save-state", ck42, "--checkpoint-every", "4", "-o",
                                   res_npy])
        raise RuntimeError("the interrupted render did not stop")
    except ProcessDeath:
        pass
    finally:
        ProgressiveRaytracingPipeline.render = real_render
    frames_done = int(np.load(ck42 + ".npz")["frames_done"])
    headless_main(base_args + ["--resume", ck42, "-o", res_npy])
    ck_eq = frames_done == 4 and np.array_equal(np.load(res_npy), np.load(full_npy))
    print(f"headless --checkpoint-every 4 on 8 spp: the render stopped in frame 6, its "
          f"checkpoint at frame {frames_done}, resumed: "
          f"{'bit-equal' if ck_eq else 'DIFFERS'} to the uninterrupted render", flush=True)
    if not ck_eq:
        raise RuntimeError("--checkpoint-every + --resume differs from the uninterrupted render")
    del src42

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 43", flush=True)
    # ---- 43. live material edits, the graft entry and the viewer ------------------------
    rebake43 = {}
    for scene_name, want_key in (("cornell-glossy", "B1"), (BVH_PARITY_SCENE, "B5")):
        sc, cam = build_scene(scene_name)
        cam.set_aspect(P, P)
        base = sc.build(dev)
        edited = dataclasses.replace(sc.materials[0], albedo=(0.2, 0.8, 0.4, 1.0),
                                     roughness=0.3, reflectivity=0.6)
        sc.materials[0] = edited
        fresh = sc.build(dev)
        got = rebake_material(base, 0, edited)
        have, want_t = dict(tensor_items(got)), dict(tensor_items(fresh))
        same = sorted(have) == sorted(want_t) and all(
            torch.equal(have[k], v) for k, v in want_t.items())
        imgs = []
        reset_counts()
        for scene in (got, fresh):
            p = ProgressiveRaytracingPipeline(P, P, seed=5, samples_per_frame=PARITY_S, device=dev)
            p.set_camera(cam)
            p.set_scene_data(scene)
            p.update(0.0, 0)
            imgs.append(p.render().clone())
        torch.cuda.synchronize()
        counts = expect_counts(f"rebake {scene_name}", {want_key: 2})
        img_eq = torch.equal(imgs[0], imgs[1])
        print(f"rebake_material {scene_name} (material 0; {want_key}): every tensor equal to a "
              f"fresh build's {same} ({len(want_t)} tensors), the {P}^2 S={PARITY_S} images "
              f"{'bit-equal' if img_eq else 'DIFFER'}", flush=True)
        if not (same and img_eq):
            raise RuntimeError(f"rebake_material on {scene_name} differs from a fresh build")
        rebake43[scene_name] = {"tensors_equal": same, "image_bit_equal": img_eq}
        note_front(f"phase 43: rebake_material {scene_name}", counts, bit_equal=img_eq)
        del base, fresh, got, imgs

    fn43, args43 = entry_mod.entry()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out43 = fn43(*args43)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    counts = expect_counts("entry() progressive_step", {"B3 closest": 2, "B3 any": 2})
    fn_cpu, args_cpu = entry_mod.entry("cpu")
    want43 = fn_cpu(*args_cpu)
    d43 = (out43.cpu() - want43).abs()
    entry_gate = {"within_1e-3": float((d43 <= 1e-3).all(dim=-1).float().mean()),
                  "mean_abs_diff": float(d43.mean()), "max_abs_diff": float(d43.max()),
                  "within_2e-5": float((d43 <= 2e-5).all(dim=-1).float().mean())}
    ok = entry_gate["within_1e-3"] >= 0.99 and entry_gate["mean_abs_diff"] <= 1e-4 and bool(
        out43.isfinite().all())
    print(f"entry(): fn(*example_args) at 128^2 on the card in {entry_s * 1e3:.1f} ms host "
          f"clock, against entry('cpu'): pixels within 1e-3 {entry_gate['within_1e-3']:.4f} "
          f"(>= 0.99), mean |d| {entry_gate['mean_abs_diff']:.2e} (<= 1e-4), within 2e-5 "
          f"{entry_gate['within_2e-5']:.4f}, max |d| {entry_gate['max_abs_diff']:.2e} -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError("entry() on the card differs from entry('cpu')")
    note_front("phase 43: entry() progressive_step", counts, vs_cpu=entry_gate)
    del out43, want43, args43, args_cpu

    viewer43 = {}
    n_events = lambda script: len(viewer_mod.RawKeyboard(mouse=False).parse(script))  # noqa: E731
    for label, argv, script in (
            ("cornell-glossy", ["--scene", "cornell-glossy"], VIEWER_SCRIPT),
            ("instanced:8 --animate-instances", ["--scene", "instanced:8",
                                                 "--animate-instances"], VIEWER_SCRIPT_TWO)):
        report = {}
        buf = io.StringIO()
        argv = argv + ["--size", f"{VIEWER_W}x{VIEWER_H}", "--display", "kitty",
                       "--no-ui-state", "--max-frames", str(n_events(script) + 1), "--script",
                       script, "--auto-checkpoint", os.path.join(d42, "viewer_ck"),
                       "--checkpoint-every-sec", "0"]
        torch.cuda.synchronize()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = viewer_mod.main(argv, report=report)
        torch.cuda.synchronize()
        got_l = {k: v for k, v in par_launch.launch_counts().items() if v}
        prog = report["pipeline"].count(ProgressiveRaytracingPipeline.name)
        rt_n = report["pipeline"].count(RealtimeRaytracingPipeline.name)
        if label == "cornell-glossy":
            want_l = {"B1": prog, "B1 realtime": rt_n, "B2": 2 * rt_n}
            ok_l = got_l == {k: v for k, v in want_l.items() if v}
        else:  # the wavefront route's traces, B6a; the realtime frames' B2
            want_l = {"B6a closest": ">0", "B6a any": ">0", "B2": 2 * rt_n}
            ok_l = (set(got_l) == {"B6a closest", "B6a any", "B2"} and got_l["B2"] == 2 * rt_n)
        ms = report["frame_ms"]
        ok = (rc == 0 and report["recoveries"] == 0 and all(report["finite"])
              and min(report["max"]) > 0.0 and ok_l and report["frames"] == n_events(script)
              and prog > 0 and rt_n > 0)
        print(f"viewer {label} {VIEWER_W}x{VIEWER_H} (kitty, stdout captured, "
              f"{len(buf.getvalue()):,} characters): exit {rc}, {report['frames']} frames "
              f"presented ({prog} progressive, {rt_n} realtime + denoise; sizes "
              f"{sorted(set(report['size']))}), recoveries {report['recoveries']}, every frame "
              f"finite {all(report['finite'])}, min of the frames' max "
              f"{min(report['max']):.4f}; launches {got_l}, expected {want_l} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        print(f"time viewer {label}: ms per frame (step, host clock, synchronised: the image "
              f"on the host) median {statistics.median(ms):.3f}, first {ms[0]:.1f}, the "
              f"frames {', '.join(f'{t:.2f}' for t in ms)} [{card}]", flush=True)
        if not ok:
            raise RuntimeError(f"viewer {label} failed its checks")
        viewer43[label] = {"frames": report["frames"], "recoveries": report["recoveries"],
                           "frame_ms": ms, "median_ms": statistics.median(ms),
                           "launches": got_l}
        note_front(f"phase 43: viewer {label}", got_l, frames=report["frames"],
                   median_frame_ms=statistics.median(ms))

    # one realtime + denoise viewer frame under device_trace: in a fresh
    # process (a user's profiling run), which must show B1's and B2's
    # kernels, and in this one, printed only: late in a full run of this
    # script, this process's traces have lost the kernels launched through
    # ctypes, where a fresh process's and a short run's hold them
    trace_src = (f"import json, sys\nsys.path.insert(0, {ROOT!r})\nimport chip_smoke\n"
                 "from dxrexperiments_torch.app import viewer\n"
                 f"app = viewer.ViewerApp('cornell-glossy', {VIEWER_W}, {VIEWER_H})\n"
                 "app.handle_keys([']'])\n"
                 "print(json.dumps(chip_smoke.traced_frame_kernels(app, "
                 f"{os.path.join(d42, 'trace')!r})))\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", trace_src], cwd=ROOT, capture_output=True,
                          text=True, timeout=600, check=False)
    trace_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the traced viewer frame's process failed:\n{proc.stderr[-2000:]}")
    kernels43 = json.loads(proc.stdout.strip().splitlines()[-1])
    has_b1, has_b2 = b1_b2_traced(kernels43)
    app43 = viewer_mod.ViewerApp("cornell-glossy", VIEWER_W, VIEWER_H, device=dev)
    app43.handle_keys(["]"])
    here43 = traced_frame_kernels(app43, os.path.join(d42, "trace_here"))
    here_b1, here_b2 = b1_b2_traced(here43)
    traces43 = {"fresh_process": {"b1": has_b1, "b2_both": has_b2,
                                  "device_items": len(kernels43)},
                "this_process": {"b1": here_b1, "b2_both": here_b2, "device_items": len(here43)}}
    print(f"device_trace of one viewer frame (realtime + denoise, {VIEWER_W}x{VIEWER_H}) in a "
          f"fresh process ({trace_s:.1f}s): {len(kernels43)} device items, B1 realtime "
          f"(fused_realtime_kernel) {has_b1}, both B2 passes (bilateral_tile_kernel<0>, <1>) "
          f"{has_b2}; trace.json {os.path.getsize(os.path.join(d42, 'trace', 'trace.json')):,} "
          f"bytes -> {'ok' if has_b1 and has_b2 else 'FAIL'}; the same in this process (not "
          f"gated): {len(here43)} device items, B1 {here_b1}, both B2 {here_b2}", flush=True)
    if not (has_b1 and has_b2):
        raise RuntimeError(f"the traced viewer frame shows no B1 or B2 kernel: {kernels43}")
    check_errors()
    del app43
    tmp42.cleanup()
    print("front end (phases 42-43): " + json.dumps({
        "mesh_files": loads42, "renders": renders42, "checkpoint_every_resume_bit_equal": ck_eq,
        "rebake": rebake43, "entry_vs_cpu": entry_gate, "viewer": viewer43,
        "device_trace_kernels": kernels43, "device_traces": traces43,
        "card": card}), flush=True)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 44", flush=True)
    # ---- 44. re-baked instances, PRIME seeding, ray sorting, the device BVH build ----
    t44 = time.perf_counter()
    paths44 = {}  # counter name -> [{"path", "launches"}] of this phase's main paths
    report44 = {"card": card}

    def note44(label, counts):
        for k, v in counts.items():
            if v:
                paths44.setdefault(k, []).append({"path": label, "launches": v})

    def synced_s(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    def host_instances(mesh, mats, tfs, over):
        sc = Scene()
        for m in mats:
            sc.add_material(m)
        for t, o in zip(tfs, over):
            sc.add_model(mesh, transform=t, material=None if o < 0 else int(o))
        return sc

    def bake_equal_cpu(label, baked, base_cpu, tfs, over):
        """The card's bake against the same bake on the CPU, 1e-6 relative."""
        cpu = bake_instances(base_cpu, tfs, over)
        worst = 0.0
        for k, v in cpu.items():
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                g = baked[k].cpu()
                worst = max(worst, float(((g - v).abs() / v.abs().clamp(min=1.0)).max()))
            elif isinstance(v, torch.Tensor) and not torch.equal(baked[k].cpu(), v):
                raise RuntimeError(f"{label}: the card's bake differs from the CPU's in {k}")
        print(f"{label}: the card's bake against the CPU's, max |d| / max(1, |x|) {worst:.2e} "
              f"(<= 1e-6) -> {'ok' if worst <= 1e-6 else 'FAIL'}", flush=True)
        if worst > 1e-6:
            raise RuntimeError(f"{label}: the card's bake differs from the CPU's by {worst}")
        return worst

    def dispatch_loop(label, step, base, tf_of, over, cams_of, n, env44):
        """n dispatches, each on a fresh bake passed as geometry: the bakes
        (host clock, synchronised) and the dispatches (CUDA events around
        step) timed one by one. Returns (images, bakes, bake ms, dispatch ms)."""
        imgs, bakes, bake_ms, disp_ms = [], [], [], []
        zero = torch.zeros((M, M, 3), dtype=torch.float32, device=dev)
        for k in range(n):
            baked, s = synced_s(lambda: bake_instances(base, tf_of(k), over))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            img = step(zero, opts44, cams_of(k), default_lights(), env44, 1024, geometry=baked)
            end.record()
            torch.cuda.synchronize()
            imgs.append(img)
            bakes.append(baked)
            bake_ms.append(s * 1e3)
            disp_ms.append(start.elapsed_time(end))
        print(f"{label}: {n} dispatches on fresh bakes, bake ms (host clock, synchronised) "
              f"{[round(x, 3) for x in bake_ms]}, dispatch ms (CUDA events) "
              f"{[round(x, 3) for x in disp_ms]} [{card}]", flush=True)
        return imgs, bakes, bake_ms, disp_ms

    def differing_census(name, got, want, scene, o, d):
        """Where two walks of the same rays part: the hit gate and, on a
        flattened scene, the tail census of the rays that hit the same
        triangle (printed; the caller raises)."""
        for fn in (lambda: hit_gate(name, got, want, torch),
                   lambda: scene is not None and tail_census(name, got, want, scene, o, d)):
            try:
                fn()
            except RuntimeError as exc:
                print(f"{name}: {exc}", flush=True)

    def yawed(base_tf, k):  # the CLI's --animate-instances turn, 0.05 rad a frame
        return np.einsum("ij,njk->nik", yaw_matrix(0.05 * k), base_tf).astype(np.float32)

    mats44 = [Material(albedo=(0.8, 0.75, 0.7, 1.0)),
              Material(albedo=(0.85, 0.2, 0.15, 1.0), type=1, reflectivity=0.4, roughness=0.3)]
    env44 = envmap.gradient_env()
    opts44 = default_options()

    # (a) 16 boxes (12 triangles, 16 rows each: 256 rows, B1's MAX_TRIS), B1
    box44 = box_mesh((0.0, 0.5, 0.0), (1.0, 1.0, 1.0), 0)
    tf_a = np.stack([transform(((i % 4 - 1.5) * 2.5, 0.0, (i // 4 - 1.5) * 2.5), yaw=0.3 * i)
                     for i in range(16)])
    over_a = np.array([-1, 1] * 8, np.int64)
    base_sc = Scene()
    for m in mats44:
        base_sc.add_material(m)
    base_sc.add_model(box44)
    base_a = prepare_base(base_sc.build(dev, accel="none"), 16)
    base_a_cpu = prepare_base(base_sc.build("cpu", accel="none"), 16)
    cam_a = Camera()
    cam_a.set_eye_at_up((0.0, 8.0, 11.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0))
    cam_a.set_aspect(M, M)
    cams_a = [cameras(cam_a, M, M, MAIN_S, 4400 + 100 * k) for k in range(MAIN_FRAMES)]
    bake_a0 = bake_instances(base_a, tf_a, over_a, lights=default_lights(), env=env44)
    if bake_a0["num_tris"] != 256 or select_route(bake_a0, "progressive") != "fused":
        raise RuntimeError(f"the 16 baked boxes do not take B1: {bake_a0['num_tris']} rows")
    step_a = make_progressive_step(bake_a0, M, M, samples_per_step=MAIN_S)
    torch.cuda.synchronize()
    reset_counts()
    imgs_a, bakes_a, bake_ms_a, disp_ms_a = dispatch_loop(
        f"phase 44a B1 16 re-baked boxes {M}^2 S={MAIN_S}", step_a, base_a,
        lambda k: yawed(tf_a, k), over_a, lambda k: cams_a[k], MAIN_FRAMES, env44)
    note44("44a: 16 re-baked boxes, 8 dispatches of S = 16 (B1)",
           expect_counts("phase 44a (8 dispatches, each on a fresh bake)", {"B1": MAIN_FRAMES}))
    err_a = bake_equal_cpu("phase 44a dispatch 0", bakes_a[0], base_a_cpu, yawed(tf_a, 0), over_a)
    host_a = host_instances(box44, mats44, yawed(tf_a, 0), over_a)
    host_a.lights, host_a.environment = default_lights(), env44
    host_a_scene = host_a.build(dev)
    want_a = step_a(torch.zeros_like(imgs_a[0]), opts44, cams_a[0], default_lights(), env44,
                    1024, geometry=host_a_scene)
    gate_a = image_gate(f"phase 44a dispatch 0 (bake, {bake_a0['num_tris']} rows) vs the host "
                        f"build of the same 16 boxes ({host_a_scene['num_tris']} triangles), B1, "
                        f"{M}^2 S={MAIN_S}", imgs_a[0] * MAIN_S, want_a * MAIN_S, MAIN_S)
    moved_a = float((imgs_a[-1] - imgs_a[0]).abs().mean())
    if not moved_a > 1e-4 or not all(bool(i.isfinite().all()) for i in imgs_a):
        raise RuntimeError(f"phase 44a: dispatch 7's image does not differ from dispatch 0's "
                           f"(mean |d| {moved_a})")
    b1_alone = [kernel_ms(fs.prepare_launch(dict(bakes_a[k], lights=default_lights(), env=env44),
                                            opts44, cams_a[k], M, M, env44["kind"], False, 0,
                                            0), 5, torch) for k in (0, MAIN_FRAMES - 1)]
    print(f"phase 44a: dispatch 7 vs 0 mean |d| {moved_a:.4f} (the transforms reached B1); "
          f"B1 launch alone {b1_alone[0]:.4f} / {b1_alone[1]:.4f} ms (dispatch 0 / 7) [{card}]",
          flush=True)
    report44["a_b1"] = {"bake_ms": bake_ms_a, "dispatch_ms": disp_ms_a, "b1_alone_ms": b1_alone,
                        "cpu_bake_max_rel": err_a, "host_build_gate": gate_a,
                        "moved_mean_abs": moved_a}
    del bakes_a, imgs_a, host_a_scene, want_a, base_a_cpu

    # (b) 4 spheres (960 triangles, 1,024 rows each: 4,096 rows), the wavefront route, B3
    sph44 = sphere_mesh((0.0, 1.0, 0.0), 1.0, lat=16, lon=32)
    tf_b = np.stack([transform(((i % 2 - 0.5) * 2.5, 0.0, (i // 2 - 0.5) * 2.5), yaw=0.4 * i)
                     for i in range(4)])
    over_b = np.array([0, 1, 1, 0], np.int64)
    base_sc = Scene()
    for m in mats44:
        base_sc.add_material(m)
    base_sc.add_model(sph44)
    base_b = prepare_base(base_sc.build(dev, accel="none"), 4)
    base_b_cpu = prepare_base(base_sc.build("cpu", accel="none"), 4)
    cam_b = Camera()
    cam_b.set_eye_at_up((0.0, 4.5, 6.5), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    cam_b.set_aspect(M, M)
    cams_b = [cameras(cam_b, M, M, BVH_S, 4500 + 100 * k) for k in range(BVH_DISPATCHES)]
    bake_b0 = bake_instances(base_b, tf_b, over_b, lights=default_lights(), env=env44)
    if (bake_b0["num_tris"] != 4096 or "tri_records" not in bake_b0
            or select_route(bake_b0, "progressive") != "wavefront"):
        raise RuntimeError("the 4 baked spheres do not take the brute-force wavefront route")
    step_b = make_progressive_step(bake_b0, M, M, samples_per_step=BVH_S)
    torch.cuda.synchronize()
    reset_counts()
    imgs_b, bakes_b, bake_ms_b, disp_ms_b = dispatch_loop(
        f"phase 44b B3 4 re-baked spheres {M}^2 S={BVH_S}", step_b, base_b,
        lambda k: yawed(tf_b, k), over_b, lambda k: cams_b[k], BVH_DISPATCHES, env44)
    want_n = BVH_DISPATCHES * BVH_S * 2
    note44("44b: 4 re-baked spheres, 4 dispatches of S = 4 (B3)",
           expect_counts("phase 44b (4 dispatches, each on a fresh bake)",
                         {"B3 closest": want_n, "B3 any": want_n}))
    err_b = bake_equal_cpu("phase 44b dispatch 0", bakes_b[0], base_b_cpu, yawed(tf_b, 0), over_b)
    host_b = host_instances(sph44, mats44, yawed(tf_b, 0), over_b)
    host_b.lights, host_b.environment = default_lights(), env44
    host_b_scene = host_b.build(dev)
    if "bvh" in host_b_scene:
        raise RuntimeError("the host build of the 4 spheres got a BVH")
    want_b = step_b(torch.zeros_like(imgs_b[0]), opts44, cams_b[0], default_lights(), env44,
                    1024, geometry=host_b_scene)
    gate_b = image_gate(f"phase 44b dispatch 0 (bake, 4,096 rows) vs the host build of the same 4 "
                        f"spheres ({host_b_scene['num_tris']} triangles), B3, {M}^2 S={BVH_S}",
                        imgs_b[0] * BVH_S, want_b * BVH_S, BVH_S)
    full_b = dict(bakes_b[0], lights=default_lights(), env=env44)
    cam1_b = {k: v[0] for k, v in cams_b[0].items()}
    wave_b44 = render_sample(full_b, opts44, cam1_b, M, M, impl="cuda")["color"]
    o44, d44 = (x.reshape(-1, 3).to(dev) for x in primary_ray_grid(cam1_b, M, M, fs.JITTER_SCALE))
    pick44 = torch.as_tensor(rng.choice(M * M, COUNT_PIXELS, replace=False), device=dev)
    seeds44 = trng.pixel_seeds(M, M, cam1_b["frame_count"], device=dev).reshape(-1)
    plain_b = trace_rays(full_b, opts44, o44[pick44], d44[pick44], seeds44[pick44],
                         impl="torch")["color"][None]
    gate_b_plain = image_gate(f"phase 44b the B3 wavefront route on the bake vs plain, "
                              f"{COUNT_PIXELS} sampled pixels of {M}^2, 1 sample",
                              wave_b44.reshape(-1, 3)[pick44][None], plain_b, 1)
    report44["b_b3"] = {"bake_ms": bake_ms_b, "dispatch_ms": disp_ms_b, "cpu_bake_max_rel": err_b,
                        "host_build_gate": gate_b, "plain_gate": gate_b_plain}
    del imgs_b, host_b_scene, want_b, wave_b44, plain_b, o44, d44, base_b_cpu

    # (c) PRIME on config 5: the two-level dispatch (B6a) and the flattened frame (B4a)
    prime_env = os.environ.get("DXR_PRIME")

    def with_prime(on, fn):
        os.environ["DXR_PRIME"] = "1" if on else "0"
        try:
            return fn()
        finally:
            if prime_env is None:
                os.environ.pop("DXR_PRIME", None)
            else:
                os.environ["DXR_PRIME"] = prime_env

    if "prime_v0" not in scene2:
        raise RuntimeError(f"{BVH_MAIN_SCENE} two-level carries no PRIME table")
    two44 = {}
    for on in (False, True):
        pipe44 = ProgressiveRaytracingPipeline(M, M, seed=44, samples_per_frame=BVH_S, device=dev)
        pipe44.set_camera(cam32)
        pipe44.set_scene_data(scene2)
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        with_prime(on, lambda: (pipe44.update(0.0, 0), pipe44.render()))
        torch.cuda.synchronize()
        two44[on] = (pipe44.get_output().clone(), time.perf_counter() - t1)
        note44(f"44c: {BVH_MAIN_SCENE} two-level, one dispatch of S = {BVH_S}, DXR_PRIME="
               f"{int(on)} (B6a)",
               expect_counts(f"phase 44c two-level dispatch DXR_PRIME={int(on)}",
                             {"B6a closest": 2 * BVH_S, "B6a any": 2 * BVH_S}))
    if not torch.equal(two44[False][0], two44[True][0]):
        diff = (two44[False][0] - two44[True][0]).abs()
        raise RuntimeError(f"phase 44c: the two-level dispatch with DXR_PRIME=1 differs from "
                           f"the one without on {int((diff > 0).any(-1).sum())} pixels")
    print(f"phase 44c: {BVH_MAIN_SCENE} two-level dispatch with and without DXR_PRIME=1 "
          f"bit-equal; host s {two44[False][1]:.3f} / {two44[True][1]:.3f} (off / on, "
          f"synchronised)", flush=True)
    del pipe44

    scene_f, build_f_s = synced_s(lambda: sc32.build(dev))
    if "prime_v0" not in scene_f or "bvhf_nodes" not in scene_f["bvh"]:
        raise RuntimeError(f"{BVH_MAIN_SCENE} flattened has no PRIME table or no fat nodes")
    cam44 = {k: v[0] for k, v in cameras(cam32, M, M, 1, 4600).items()}

    def traced_frame(scene, mod, names, on):
        rec = []
        with TraceHook(mod, lambda o, d, t_min, t_max, cull, occlusion: rec.append(
                (o, d, t_min, t_max, cull, occlusion)), names):
            img = with_prime(on, lambda: render_sample(scene, opts44, cam44, M, M,
                                                       impl="cuda")["color"])
        torch.cuda.synchronize()
        if [t[5] for t in rec] != [False, True, False, True]:
            raise RuntimeError(f"phase 44c: expected closest, any, closest, any traces, got "
                               f"{[t[5] for t in rec]}")
        return img, rec

    frames44 = {}
    for on in (False, True):
        reset_counts()
        frames44["flat", on] = traced_frame(scene_f, tv, TraceHook.B4A, on)
        note44(f"44c: {BVH_MAIN_SCENE} flattened, one wavefront frame, DXR_PRIME={int(on)} (B4a)",
               expect_counts(f"phase 44c flattened frame DXR_PRIME={int(on)}",
                             {"B4a closest": 2, "B4a any": 2}))
    for on in (False, True):
        frames44["two", on] = traced_frame(scene2, tv2, TraceHook.TWO_LEVEL, on)
    prime44 = {}
    for key, scene, walk, label in (("flat", scene_f, "B4a", "flattened"),
                                    ("two", scene2, "B6a", "two-level")):
        (img0, rec0), (img1, rec1) = frames44[key, False], frames44[key, True]
        if not torch.equal(img0, img1):
            raise RuntimeError(f"phase 44c: the {label} frame with DXR_PRIME=1 differs from the "
                               f"one without")
        o, d, t_min, t_plain = rec0[2][:4]
        t_seed = rec1[2][3]
        if not (torch.equal(o, rec1[2][0]) and torch.equal(d, rec1[2][1])):
            raise RuntimeError(f"phase 44c: the {label} bounce rays differ with DXR_PRIME=1")
        active = t_plain > 0
        seeded = int((t_seed[active] < t_plain[active]).sum())
        share = seeded / max(int(active.sum()), 1)
        if not bool((t_seed <= t_plain).all()):
            raise RuntimeError(f"phase 44c: the {label} seed loosened a t_max")
        if key == "flat":
            fn = tv.traverse_fat_closest
            prep = [tv.prepare_launch(scene, o, d, t_min, t, False, False) for t in (t_plain, t_seed)]
        else:
            fn = tv2.traverse2_fat_closest
            prep = [tv2.prepare_launch(scene["tlas"], o, d, t_min, t, False, False)
                    for t in (t_plain, t_seed)]
        h0, h1 = fn(scene, o, d, t_min, t_plain), fn(scene, o, d, t_min, t_seed)
        differ = torch.zeros_like(h0["hit"])
        for k in h0:
            differ |= h0[k] != h1[k]
        if bool(differ.any()):
            differing_census(f"phase 44c {walk} seeded vs unseeded bounce", h1, h0,
                             scene if key == "flat" else None, o, d)
            raise RuntimeError(f"phase 44c: {int(differ.sum())} {label} bounce rays differ with "
                               f"the seeded t_max")
        turns = {False: [], True: []}
        for _ in range(5):
            for on in (False, True):
                turns[on].append(kernel_ms(prep[on], 5, torch))
        seed_ms = time_ms(lambda: tint._prime_seed_tmax(scene, o, d, t_plain), 10, torch)
        prime44[label] = {"walk": walk, "active": int(active.sum()), "seeded": seeded,
                          "seeded_share": share, "ms_unseeded": turns[False],
                          "ms_seeded": turns[True], "prime_seed_tmax_ms": seed_ms,
                          "prime_triangles": int(scene["prime_v0"].shape[0])}
        print(f"phase 44c {label}: frame bit-equal with and without DXR_PRIME=1; bounce launch "
              f"({len(o)} rays, {int(active.sum())} active) every hit field equal with the seed; "
              f"seeded {seeded} active lanes ({share:.4f}); {walk} bounce launch alone, 5 turns "
              f"of 5: unseeded {statistics.median(turns[False]):.4f} ms "
              f"{[round(x, 4) for x in turns[False]]}, seeded "
              f"{statistics.median(turns[True]):.4f} ms {[round(x, 4) for x in turns[True]]}; "
              f"_prime_seed_tmax {seed_ms:.4f} ms [{card}]", flush=True)
    report44["c_prime"] = prime44

    # (d) ray sorting on the flattened frame's bounce closest and depth-0 shadow launches
    sort44 = {}
    rec_f = frames44["flat", False][1]
    for label, (o, d, t_min, t_max, cull, occlusion) in (("bounce closest", rec_f[2]),
                                                          ("depth-0 shadow any", rec_f[1])):
        fn = tv.traverse_fat_any if occlusion else tv.traverse_fat_closest
        kw = {} if occlusion else {"cull_backface": cull}
        plain = fn(scene_f, o, d, t_min, t_max, **kw)
        srt = tint._sorted_trace(scene_f, fn, o, d, t_min, t_max, **kw)
        if occlusion:
            via = tint._trace_any(scene_f, o, d, t_min, t_max, "cuda", sort_rays=True)
            same = torch.equal(plain, srt) and torch.equal(plain, via)
            n_diff = int((plain != srt).sum())
        else:
            via = tint._trace_closest(scene_f, o, d, t_min, t_max, cull, "cuda", sort_rays=True)
            ref = tint._trace_closest(scene_f, o, d, t_min, t_max, cull, "cuda")
            differ = torch.zeros_like(plain["hit"])
            for k in plain:
                differ |= plain[k] != srt[k]
            n_diff = int(differ.sum())
            same = n_diff == 0 and all(torch.equal(a, b) for a, b in zip(via[:3], ref[:3])) and all(
                torch.equal(via[3][k], ref[3][k]) for k in ref[3])
        if not same:
            if not occlusion:
                differing_census(f"phase 44d sorted vs unsorted {label}", srt, plain, scene_f, o, d)
            raise RuntimeError(f"phase 44d: sorted {label} differs from unsorted on {n_diff} rays")
        order = tint._ray_sort_order(scene_f, o, d)
        tsort = t_max[order] if t_max.dim() else t_max
        prep = [tv.prepare_launch(scene_f, o, d, t_min, t_max, cull, occlusion),
                tv.prepare_launch(scene_f, o[order], d[order], t_min, tsort, cull, occlusion)]
        turns = {"alone_unsorted": [], "alone_sorted": [], "wrapper_unsorted": [],
                 "sorted_with_argsort_gather_scatter": []}
        for _ in range(5):
            turns["alone_unsorted"].append(kernel_ms(prep[0], 5, torch))
            turns["alone_sorted"].append(kernel_ms(prep[1], 5, torch))
            turns["wrapper_unsorted"].append(time_ms(lambda: fn(scene_f, o, d, t_min, t_max, **kw),
                                                     5, torch))
            turns["sorted_with_argsort_gather_scatter"].append(time_ms(
                lambda: tint._sorted_trace(scene_f, fn, o, d, t_min, t_max, **kw), 5, torch))
        sort44[label] = {"rays": len(o), "medians": {k: statistics.median(v)
                                                      for k, v in turns.items()}, "turns": turns}
        print(f"phase 44d {label} ({len(o)} rays): sorted bit-equal to unsorted (every "
              f"{'occlusion bit' if occlusion else 'hit field'}); ms, medians of 5 turns of 5: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sort44[label]["medians"].items())
              + f" [{card}]", flush=True)
    check_errors()
    report44["d_sorting"] = sort44
    del frames44, rec_f

    # (e) the device BVH build over the flattened triangles and each (b) bake
    def device_vs_host(label, v0, e1, e2, n):
        host_in = [x.cpu().numpy() for x in (v0, e1, e2)]
        dev_bvh, dev_s = synced_s(lambda: tbvh.build_bvh_device(v0, e1, e2, n, 32))
        _, dev_s2 = synced_s(lambda: tbvh.build_bvh_device(v0, e1, e2, n, 32))
        t1 = time.perf_counter()
        host_bvh = tbvh.build_bvh(*host_in, n, 32)
        host_s = time.perf_counter() - t1
        if not np.array_equal(dev_bvh["order"].cpu().numpy(), host_bvh["order"]):
            raise RuntimeError(f"phase 44e {label}: the device build's order differs from the host's")
        worst = max(float(np.abs(np.nan_to_num(dev_bvh[k].cpu().numpy())
                                 - np.nan_to_num(host_bvh[k])).max())
                    for k in ("nodes_lo", "nodes_hi"))
        if worst > 1e-6:
            raise RuntimeError(f"phase 44e {label}: node boxes differ by {worst}")
        print(f"phase 44e {label}: build_bvh_device {n:,} triangles, {dev_bvh['levels']} levels: "
              f"order equal to the host Morton build's, nodes max |d| {worst:.1e}; device "
              f"{dev_s:.4f} s (first) / {dev_s2:.4f} s, host {host_s:.4f} s [{card}]", flush=True)
        return {"triangles": n, "device_s": dev_s, "device_s_again": dev_s2, "host_s": host_s,
                "nodes_max_abs": worst}

    bvh44 = {BVH_MAIN_SCENE: device_vs_host(f"{BVH_MAIN_SCENE} flattened", scene_f["v0"],
                                             scene_f["e1"], scene_f["e2"],
                                             int(scene_f["num_tris"]))}
    for k, baked in enumerate(bakes_b):
        bvh44[f"44b bake {k}"] = device_vs_host(f"44b bake {k}", baked["v0"], baked["e1"],
                                                baked["e2"], baked["num_tris"])
    report44["e_bvh_device"] = bvh44
    del scene_f, bakes_b
    phase44_s = time.perf_counter() - t44
    report44["seconds"] = phase44_s
    print(f"phase 44: {phase44_s:.1f} s (scene build of {BVH_MAIN_SCENE} flattened "
          f"{build_f_s:.2f} s of it)", flush=True)
    print("re-bake, PRIME, sorting, device BVH (phase 44): " + json.dumps(report44), flush=True)

    print(f"[{time.perf_counter() - t_start:.1f}s] phase 38", flush=True)
    # ---- 38. the redesigned kernels B1, B5, B3, B6a, B4b, B6b, B4a, B2, B4d, B4c: ptxas, records, times
    # B1 reads each triangle as a record of five float4s (the scene's
    # tri_records, tv.tri_records); B5 and B4a read their leaves from
    # ft_test (B5 also ft_attr; tv.leaf_records), not from mt_rows. The
    # records against the packs they come from, on the card; their bytes; the
    # launch alone on each main path's first dispatch or frame beside its
    # bound; ptxas' counts of B1, B5, B3 (its queue and sweep kernels), B6a,
    # B4b, B6b, B4a, B2, B4d and B4c.
    ptx = {key: cuda_build.ptxas_counts(cuda_build.BUILD_INFO[src]["log"]) for key, src in (
        ("B1", "fused_sample"), ("B5", "fused_traverse"), ("B4a", "traverse_fat"),
        ("B4c", "traverse_fat_grouped"), ("B3", "intersect_brute"), ("B6a", "traverse2_fat"),
        ("B4b", "traverse_binary"), ("B6b", "traverse2_binary"), ("B2", "bilateral"),
        ("B4d", "traverse8"))}
    for key, rows in ptx.items():
        for r in rows:
            print(f"ptxas {key}: {r['kernel']}: {r.get('registers')} registers, spill stores "
                  f"{r.get('spill_stores')} / loads {r.get('spill_loads')} bytes, stack frame "
                  f"{r.get('stack')} bytes", flush=True)
    coef_lanes = list(tv.COEF_LANES)
    rec_bytes = {}
    for label, packs in (("config 1", scene1), ("config 3", c3_packs)):
        mt, rec, live = packs["mt_pack"], packs["tri_records"], int(packs["num_tris"])
        want = torch.stack([mt[lane // 16, :, lane % 16] for lane in coef_lanes], dim=1)
        if not (torch.equal(rec[:, :19], want) and not bool(rec[:, 19:].any())):
            raise RuntimeError(f"B1's records of {label} differ from its mt_pack")
        rec_bytes[label] = rec.numel() * 4
        print(f"B1 records {label}: [{rec.shape[0]}, {rec.shape[1]}] float32, "
              f"{rec_bytes[label]:,} bytes on the card, swept to row {live} "
              f"(num_tris) of {int(mt.shape[1])}; equal to mt_pack's slots: ok", flush=True)
    leaf_bytes = {}
    for label, b in (("instanced:32", bvh32), ("config-2 stand-in", scene2c["bvh"])):
        test, attr, rows = b["ft_test"], b["ft_attr"], b["mt_rows"]
        if not (torch.equal(test[:, :19], rows[:, coef_lanes]) and not bool(test[:, 19:].any())
                and torch.equal(attr, rows[:, 64:80])):
            raise RuntimeError(f"B5's leaf arrays of {label} differ from its mt_rows")
        leaf_bytes[label] = {"ft_test": test.numel() * 4, "ft_attr": attr.numel() * 4,
                             "mt_rows": rows.numel() * 4}
        print(f"B5 leaf arrays {label}: ft_test {tuple(test.shape)} "
              f"{leaf_bytes[label]['ft_test']:,} bytes, ft_attr {tuple(attr.shape)} "
              f"{leaf_bytes[label]['ft_attr']:,} bytes on the card, against mt_rows "
              f"{leaf_bytes[label]['mt_rows']:,} bytes; equal to mt_rows' lanes: ok", flush=True)
    redesign = {
        "B1 config 1": (kernel_ms(fs.prepare_launch(scene1, options1, first_cams, MAIN_SIZE,
                                                    MAIN_SIZE, 0, False, 0, 0), 20, torch),
                        b1_bound, f"per {MAIN_S}-sample {MAIN_SIZE}^2 dispatch"),
        "B1 config 3": (c3_launch_ms, c3_bound,
                        f"per {C3_S}-sample {C3_W}x{C3_H} dispatch (phase 25)"),
        "B1 config 4": (kernel_ms(fs.prepare_launch(rt_scene, rt_options, cams0, RT_W, RT_H, 0,
                                                    True, 0, 0), 20, torch),
                        b1_rt_bound, f"per {RT_W}x{RT_H} realtime frame"),
        "B5 config 5": (b5_ms, b5_bound, f"per {M}^2 {BVH_MAIN_SCENE} sample (phase 10a)"),
        "B5 config 5 realtime": (b5_rt_cams_ms, b5_rt_bound,
                                 f"per {RT_W}x{RT_H} frame (phase 10b, ten cameras)"),
        "B5 config-2 stand-in": (c2_ms / C2_S, c2_bound,
                                 f"per {M}^2 sample of {C2_S}-sample dispatches (phase 28)"),
    }
    for label, (ms, bnd, shape) in redesign.items():
        print(f"time {label}: {ms:.4f} ms {shape}, the launch alone; bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), {ms / bnd[0]:.2f}x it [{card}]", flush=True)

    kernels = [
        {
            "name": "fused_progressive_sum",
            "route": "cuda",
            "source": "dxrexperiments_torch/csrc/fused_sample.cu",
            "replaces": "dxrexperiments_tpu/ops/fused_sample_pallas.py:640",
            "launches": b1_launches,
            "max_abs_err": main_gate["max_abs_diff"],
            "ms": kern_ms,
            "plain_ms": plain_ms,
            "bound_ms": b1_bound[0],
            "bound_by": b1_bound[1],
            "library_ms": None,
            "launch_ms": {k: v[0] for k, v in redesign.items() if k.startswith("B1")},
            "ptxas": ptx["B1"],
            "records_bytes": rec_bytes,
            "row_blocks": row_report["B1 progressive config 1"],
            "sharded": sharded,
        },
        {
            "name": "fused_realtime_outputs",
            "route": "cuda",
            "source": "dxrexperiments_torch/csrc/fused_sample.cu",
            "replaces": "dxrexperiments_tpu/ops/fused_sample_pallas.py:640",
            "launches": rt_launches,
            "max_abs_err": rt_err,
            "ms": rt_kern_ms,
            "plain_ms": rt_plain_ms,
            "bound_ms": b1_rt_bound[0],
            "bound_by": b1_rt_bound[1],
            "library_ms": None,
            "row_blocks": row_report["B1 realtime config 4"],
            "frames_in_flight": fif,
        },
        {
            "name": "bilateral_pass",
            "route": "cuda",
            "source": "dxrexperiments_torch/csrc/bilateral.cu",
            "replaces": "dxrexperiments_tpu/ops/bilateral_pallas.py:53",
            "launches": bl_launches,
            "max_abs_err": bl_err,
            "ms": (bl_ms[0] + bl_ms[1]) / 2,
            "plain_ms": (bl_plain_ms[0] + bl_plain_ms[1]) / 2,
            "bound_ms": b2_bound[0],
            "bound_by": b2_bound[1],
            "library_ms": None,
            "ms_per_axis": {"horizontal": bl_ms[1], "vertical": bl_ms[0]},
            "ptxas": ptx["B2"],
            "halo_row_blocks": halo_report,
        },
    ]
    plain_shape = f"{BVH_PARITY_SCENE} {P}^2"
    wave_shape = f"{BVH_MAIN_SCENE} {M}^2, one wavefront sample"
    for name, source, replaces, n, err, ms, wrap, key, bnd, shape, extra in (
        ("traverse_fat_closest", "traverse_fat.cu", "ops/traverse_pallas.py:445", wf_closest,
         b4a_max_t, b4a[False]["ms"], b4a[False]["wrapper_ms"], "b4a_c", b4a_c_bound,
         f"{wave_shape}: its primary and bounce launches together",
         {"per_launch": b4a[False]["per_launch"], "ptxas": ptx["B4a"]}),
        ("traverse_fat_any", "traverse_fat.cu", "ops/traverse_pallas.py:445", wf_any,
         b4a_any_err, b4a[True]["ms"], b4a[True]["wrapper_ms"], "b4a_a", b4a_a_bound,
         f"{wave_shape}: its two merged shadow launches together",
         {"per_launch": b4a[True]["per_launch"]}),
        ("fused_traverse_progressive_sum", "fused_traverse.cu",
         "ops/fused_traverse_pallas.py:131", b5_launches, b5_plain_gate["max_abs_diff"], b5_ms,
         b5_wrap_ms, "b5", b5_bound, f"{BVH_MAIN_SCENE} {M}^2, per sample",
         {"max_abs_diff_vs_wavefront": b5_gate["max_abs_diff"], "ptxas": ptx["B5"],
          "leaf_array_bytes": leaf_bytes,
          "launch_ms": {k: v[0] for k, v in redesign.items() if k.startswith("B5")},
          "unchanged_kernels_ptxas": {k: ptx[k] for k in ("B4c",)},
          "row_blocks": row_report[f"B5 progressive {BVH_MAIN_SCENE}"]}),
        ("fused_traverse_realtime", "fused_traverse.cu", "ops/fused_traverse_pallas.py:131",
         b5_rt_launches, max(b5_rt_err, b5_rt_plain_err), b5_rt_cams_ms, b5_rt_wrap_ms, "b5_rt",
         b5_rt_bound, f"{BVH_MAIN_SCENE} {RT_W}x{RT_H}, per frame, ten frames' cameras in turn",
         {"max_abs_diff_vs_wavefront": b5_rt_wave_err, "ms_one_camera_repeated": b5_rt_ms,
          "frame_ms": bvh_frame_ms, "frame_ms_flag_read_per_launch": bvh_frame_read_ms,
          "frame_ms_without_denoiser": render_only_ms,
          "row_blocks": row_report[f"B5 realtime {BVH_MAIN_SCENE}"]}),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"dxrexperiments_torch/csrc/{source}",
            "replaces": f"dxrexperiments_tpu/{replaces}",
            "launches": n,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": small_ms[key][1],
            "bound_ms": bnd[0],
            "bound_by": bnd[1],
            "library_ms": None,
            "shape": shape,
            "wrapper_ms": wrap,
            "plain_shape": plain_shape,
            "ms_at_plain_shape": small_ms[key][0],
            **extra,
        })
    for occl, name in ((False, "traverse2_fat_closest"), (True, "traverse2_fat_any")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dxrexperiments_torch/csrc/traverse2_fat.cu",
            "replaces": "dxrexperiments_tpu/ops/traverse2_pallas.py:285",
            "launches": two_counts[occl],
            "max_abs_err": b6a_err[occl],
            "ms": b6a[occl]["ms"],
            "plain_ms": small2[occl][1],
            "bound_ms": b6a_bound[occl][0],
            "bound_by": b6a_bound[occl][1],
            "library_ms": None,
            "shape": f"{BVH_MAIN_SCENE} two-level {M}^2, one wavefront sample: its two "
                     f"{'shadow' if occl else 'closest'} launches together",
            "wrapper_ms": b6a[occl]["wrapper_ms"],
            "plain_shape": f"{BVH_PARITY_SCENE} two-level {P}^2, one "
                           f"{'shadow' if occl else 'primary'} trace",
            "ms_at_plain_shape": small2[occl][0],
            "per_launch": b6a[occl]["per_launch"],
            "ptxas": ptx["B6a"],
            **({} if occl else {"max_abs_diff_vs_flattened_b5": two_b5_gate["max_abs_diff"],
                                "vs_flattened_after_animation": anim_gate}),
        })
    for walk, occl, name, source, line in (
            ("binary", False, "traverse_closest", "traverse_binary.cu", 282),
            ("binary", True, "traverse_any", "traverse_binary.cu", 282),
            ("wide", False, "traverse8_closest", "traverse8.cu", 709),
            ("wide", True, "traverse8_any", "traverse8.cu", 709)):
        acc = wtime[walk, occl]
        extra = {}
        if walk == "binary" and not occl:
            extra = {"route_vs_b4a_route_image": b4b_wave_gate, "route_vs_plain_image":
                     b4b_plain_gate, "realtime_frame0_vs_plain_max_abs_diff": b4b_rt_err,
                     "dispatch_ms_enqueued": bin_enqueue_s / n_disp_b * 1e3,
                     "dispatch_ms_synchronised": bin_dispatch_s / n_disp_b * 1e3}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"dxrexperiments_torch/csrc/{source}",
            "replaces": f"dxrexperiments_tpu/ops/traverse_pallas.py:{line}",
            "launches": (b4b_counts if walk == "binary" else b4d_counts)[occl],
            "max_abs_err": walk_err[walk, occl],
            "ms": acc["ms"],
            "plain_ms": small_ms["b4a_a" if occl else "b4a_c"][1],
            "bound_ms": wbound[walk, occl][0],
            "bound_by": wbound[walk, occl][1],
            "library_ms": None,
            "shape": f"{wave_shape} without fat nodes: its two "
                     f"{'shadow' if occl else 'closest'} launches together",
            "b4a_ms_same_rays": acc["fat_ms"],
            "launches_are": ("the B4b route's main path" if walk == "binary" else
                             "direct calls on the B4b route's four launch inputs"),
            "plain_shape": plain_shape,
            "ms_at_plain_shape": small_bin[walk, occl],
            "parity_128_max_abs_err": bin_parity[walk, occl],
            "deepest_stack": deepest[walk],
            "per_launch": acc["per_launch"],
            "ptxas": ptx["B4b" if walk == "binary" else "B4d"],
            "max_abs_err_is": ("occlusion disagreement fraction" if occl else
                               "max |t - plain t| on rays that hit the same triangle"),
            **extra,
        })
    for occl, name in ((False, "traverse2_closest"), (True, "traverse2_any")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dxrexperiments_torch/csrc/traverse2_binary.cu",
            "replaces": "dxrexperiments_tpu/ops/traverse2_pallas.py:53",
            "launches": b6b_counts[occl],
            "max_abs_err": b6b_err[occl],
            "ms": b6b[occl]["ms"],
            "plain_ms": small2[occl][1],
            "bound_ms": b6b_bound[occl][0],
            "bound_by": b6b_bound[occl][1],
            "library_ms": None,
            "shape": f"{BVH_MAIN_SCENE} two-level without fat nodes {M}^2, one wavefront sample: "
                     f"its two {'shadow' if occl else 'closest'} launches together",
            "b6a_ms_same_rays": b6b[occl]["fat_ms"],
            "plain_shape": f"{BVH_PARITY_SCENE} two-level {P}^2, one "
                           f"{'shadow' if occl else 'primary'} trace",
            "ms_at_plain_shape": small2_bin[occl],
            "parity_128_max_abs_err": bin_parity["two_level", occl],
            "per_launch": b6b[occl]["per_launch"],
            "ptxas": ptx["B6b"],
            **({} if occl else {"route_vs_b6a_route_image": b6b_wave_gate,
                                "vs_b6a_after_animation": b6b_anim_gate,
                                "dispatch_ms_enqueued": bin2_enqueue_s / n_disp_c * 1e3,
                                "dispatch_ms_synchronised": bin2_dispatch_s / n_disp_c * 1e3}),
        })
    for occl, name, line in ((False, "trace_closest", 130), (True, "trace_any", 207)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dxrexperiments_torch/csrc/intersect_brute.cu",
            "replaces": f"dxrexperiments_tpu/ops/intersect_pallas.py:{line}",
            "launches": b3_counts[occl],
            "max_abs_err": b3_err[occl],
            "ms": b3[occl]["ms"],
            "plain_ms": b3_small[occl][1],
            "bound_ms": b3_bound[occl][0],
            "bound_by": b3_bound[occl][1],
            "library_ms": None,
            "shape": f"{BRUTE_MAIN_SCENE} {M}^2, one wavefront sample: its two "
                     f"{'shadow' if occl else 'closest'} launches together",
            "wrapper_ms": b3[occl]["wrapper_ms"],
            "plain_shape": f"{BRUTE_MAIN_SCENE} {P}^2, one {'shadow' if occl else 'primary'} trace",
            "ms_at_plain_shape": b3_small[occl][0],
            "per_launch": b3[occl]["per_launch"],
            "ptxas": ptx["B3"],
            **({"max_abs_err_is": "occlusion disagreement fraction"} if occl else
               {"max_abs_err_is": "max |t - plain t| on rays that hit the same triangle",
                "attributes": b3_attr, "image_vs_plain": b3_image, "side_paths": side,
                "dispatch_ms_enqueued": b3_enqueue_s / n_disp * 1e3,
                "dispatch_ms_synchronised": b3_dispatch_s / n_disp * 1e3}),
        })
    tex_shape = f"cornell-glossy with the {HDR_W}x{HDR_H} lat-long env"
    for name, source, replaces, n, err, ms, plain, bnd, extra in (
        ("fused_progressive_sum, texture env", "fused_sample.cu",
         "ops/fused_sample_pallas.py:640", c3_launches, c3_gate["max_abs_diff"], c3_ms,
         c3_plain_ms, c3_bound,
         {"shape": f"{tex_shape}, {C3_W}x{C3_H}, per {C3_S}-sample dispatch (BASELINE config 3)",
          "ms_black_constant_env": c3_black_ms,
          "host_ms_per_dispatch_enqueued": c3_enqueue_s / n_disp * 1e3,
          "host_ms_per_dispatch_synchronised": c3_dispatch_s / n_disp * 1e3,
          "seconds_to_1024_spp": c3_s, "parity_128_max_abs_diff": b1_tex_err[0]}),
        ("fused_realtime_outputs, texture env", "fused_sample.cu",
         "ops/fused_sample_pallas.py:640", c3_rt_counts[0], max(c3_rt_err, b1_tex_err[1]),
         c3_rt_ms, c3_rt_plain_ms, c3_rt_bound,
         {"shape": f"{tex_shape}, {RT_W}x{RT_H}, per frame"}),
        ("fused_traverse_progressive_sum, texture env", "fused_traverse.cu",
         "ops/fused_traverse_pallas.py:131", b5_tex_launches, b5_tex_gate["max_abs_diff"],
         b5_tex_ms, b5_tex_small[1], b5_tex_bound,
         {"shape": f"{BVH_MAIN_SCENE} with the 6x{CUBE_S}^2 cubemap, {M}^2, per sample",
          "ms_gradient_env": b5_grad_ms, "plain_shape": f"{BVH_PARITY_SCENE} {P}^2 cubemap",
          "ms_at_plain_shape": b5_tex_small[0], "parity_128_max_abs_diff": max(b5_tex_err),
          "bad_pixel_causes": census, "gradient_env_same_pixels": b5_grad_gate,
          "wavefront_routes_vs_plain": wave_tex}),
        ("fused_traverse_progressive_sum, area + albedo textures", "fused_traverse.cu",
         "ops/fused_traverse_pallas.py:131", c2_launches, c2_gate["max_abs_diff"], c2_ms / C2_S,
         c2_plain_ms, c2_bound,
         {"shape": f"the config-2 stand-in ({scene2c['num_tris']} triangles, 1 directional + 1 "
                   f"area light, the checker texture, the 6x{CUBE_S}^2 cubemap), {M}^2, per "
                   f"sample of {C2_DISPATCHES} dispatches of S = {C2_S}",
          "ms_per_dispatch": c2_ms, "wrapper_ms_per_dispatch": c2_wrap_ms,
          "spp_per_s": C2_S * 1e3 / c2_ms,
          "host_ms_per_dispatch_enqueued": c2_enqueue_s / n_disp2 * 1e3,
          "host_ms_per_dispatch_synchronised": c2_dispatch_s / n_disp2 * 1e3,
          "area_mode_instanced32_ms": c5a_ms, "base_mode_instanced32_ms": c5_base_ms,
          "base_plus_area_instanced32_ms": c5_full_ms,
          "area_mode_instanced32_bound_ms": c5a_bound[0],
          "area_mode_instanced32_vs_plain": c5a_gate,
          "area_mode_instanced32_bad_pixel_causes": c5a_census,
          "bad_pixel_causes": c2_census, "single_sample_launches_vs_dispatch": c2_split_err,
          "realtime_wavefront_vs_plain": c2_rt_err,
          "realtime_pipeline_frame_vs_plain": c2_rt_pipe,
          "parity_128_max_abs_diff": max(area_err[0], area4_err[0], tex_err[0], tex_cube_err[0]),
          "texture_and_area_at_plain_shape": {"shape": f"cornell, textured, cubemap, {P}^2",
                                              "ms": tex_small[0], "plain_ms": tex_small[1]},
          "wavefront_routes_with_textures_vs_plain": wave_tex2, "cli_launches": cli_launches}),
        ("fused_traverse_realtime, area light", "fused_traverse.cu",
         "ops/fused_traverse_pallas.py:131", c5a_rt_launches,
         max(c5a_rt_err, area_err[1], area4_err[1]), c5a_rt_ms, area_small[True][1], c5a_rt_bound,
         {"shape": f"{BVH_MAIN_SCENE} with 1 directional + 1 area light, {RT_W}x{RT_H}, per frame",
          "plain_shape": f"{BVH_PARITY_SCENE} with the area rig {P}^2, per frame",
          "ms_at_plain_shape": area_small[True][0]}),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"dxrexperiments_torch/csrc/{source}",
            "replaces": f"dxrexperiments_tpu/{replaces}",
            "launches": n,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bnd[0],
            "bound_by": bnd[1],
            "library_ms": None,
            **extra,
        })
    main_layout = (2048, 4)  # the JAX kernel's default packet (TILE_R) in 4 sub-packets
    for occl, name in ((False, "traverse_fat_closest, grouped"),
                       (True, "traverse_fat_any, grouped")):
        acc = b4c[main_layout][occl]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dxrexperiments_torch/csrc/traverse_fat_grouped.cu",
            "replaces": "dxrexperiments_tpu/ops/traverse_pallas.py:873",
            "launches": b4c_counts[occl],
            "max_abs_err": b4c_err[occl],
            "ms": acc["ms"],
            "plain_ms": small_ms["b4a_a" if occl else "b4a_c"][1],
            "bound_ms": b4c_bound[occl][0],
            "bound_by": b4c_bound[occl][1],
            "bound_is": "B4a's: the same function of the same rays (phase 10a's host model)",
            "library_ms": None,
            "shape": f"{wave_shape}: its two {'shadow' if occl else 'closest'} launches together,"
                     f" tile {main_layout[0]}, group {main_layout[1]}",
            "b4a_ms_same_rays": acc["fat_ms"],
            "launches_are": f"direct calls on phase 8's launch inputs, one per layout of "
                            f"{list(GROUPINGS)}",
            "plain_shape": plain_shape,
            "ms_at_plain_shape": b4c_small[main_layout][3 if occl else 2],
            "parity_128_max_abs_err": max(b4c_small[k][1 if occl else 0] for k in GROUPINGS),
            "deepest_stack": b4c_deepest,
            "ptxas": ptx["B4c"],
            "per_layout": {f"{t}x{g}": {"ms": b4c[t, g][occl]["ms"],
                                        "b4a_ms": b4c[t, g][occl]["fat_ms"],
                                        "per_launch": b4c[t, g][occl]["per_launch"]}
                           for t, g in GROUPINGS},
            "max_abs_err_is": ("occlusion disagreement fraction" if occl else
                               "max |t - plain t| on rays that hit the same triangle"),
        })
    for key, name, knob in (((16, 0), "fused_progressive_sum, clustered", "B1 clustered"),
                            ((0, 16), "fused_progressive_sum, blocked", "B1 blocked")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dxrexperiments_torch/csrc/fused_sample.cu",
            "replaces": ("dxrexperiments_tpu/ops/fused_sample_pallas.py:360" if key[0] else
                         "dxrexperiments_tpu/ops/fused_sample_pallas.py:678"),
            "launches": opt_counts[knob],
            "max_abs_err": opt_gate["max_abs_diff"],
            "ms": opt_ms[key],
            "plain_ms": plain_ms,
            "bound_ms": b1_bound[0],
            "bound_by": b1_bound[1],
            "library_ms": None,
            "shape": f"Cornell-glossy {MAIN_SIZE}^2, per {MAIN_S}-sample dispatch (config 1), "
                     f"{'cluster_rows' if key[0] else 'block_w'} 16",
            "base_ms": opt_ms[0, 0],
            "ms_per_setting": {f"cluster_rows {r}" if r else f"block_w {w}": opt_ms[r, w]
                               for r, w in OPT_SETTINGS},
            "bit_equal_to_base_cases": opt_cases,
            "bound_is": "the flat sweep's pair tests (the gate skips some; the result is the same)",
        })
    for probe, name, line in (("fma", "roofline fma_peak", 68), ("mix", "roofline pair_mix", 88),
                              ("overlap", "roofline overlap", 138)):
        ms = b7_ms[True, True, 1] if probe == "overlap" else b7_ms[probe]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dxrexperiments_torch/csrc/roofline.cu",
            "replaces": f"benchmarks/roofline.py:{line}",
            "launches": b7_counts[f"B7 {probe}"],
            "max_abs_err": b7_err[probe],
            "ms": ms,
            "plain_ms": b7_small[probe][1],
            "bound_ms": b7_bounds[probe][0],
            "bound_by": b7_bounds[probe][1],
            "library_ms": b7_library[False] if probe == "overlap" else None,
            "shape": f"roofline.py's size: [{rf.SUB}, {rf.LANES}] x grid {rf.GRID}, "
                     + (f"m_iters {rf.M_ITERS}, vector and matrix, scale 1" if probe == "overlap"
                        else f"iters {rf.ITERS}"),
            "plain_shape": f"iters {rf.SMOKE_ITERS}, grid {rf.SMOKE_GRID} (seeded inputs)",
            "ms_at_plain_shape": b7_small[probe][0],
            "max_abs_err_is": ("max relative |d| of the chains and the accumulator, and the "
                               "product's max |d| / sum |terms| scaled to 1e-4 at its tolerance"
                               if probe == "overlap" else "max relative |d|"),
            **({"rates": rates} if probe != "overlap" else
               {"overlap": b7_overlap, "matrix_alone_ms": b7_ms[False, True, 1],
                "matrix_alone_ms_spread": b7_spread[False, True, 1],
                "matrix_share_of_bound": share,
                "matrix_share_of_peak_1980": share_1980, "s_star": s_star, "rounds": B7_ROUNDS,
                "library_ms_is": "torch.bmm, float32 (cuBLAS), M_ITERS calls",
                "library_ms_tf32": b7_library[True], "ptxas": ptxas_ov}),
        })
    # the launches and gates of phases 42-43's new paths, by kernel
    front_keys = {"fused_progressive_sum": "B1", "fused_realtime_outputs": "B1 realtime",
                  "bilateral_pass": "B2", "trace_closest": "B3 closest", "trace_any": "B3 any",
                  "fused_traverse_progressive_sum": "B5", "traverse2_fat_closest": "B6a closest",
                  "traverse2_fat_any": "B6a any"}
    for kern in kernels:
        if kern["name"] in front_keys:
            kern["front_end_paths"] = front.get(front_keys[kern["name"]], [])
    # phase 44's paths (re-baked instances, PRIME seeding), by kernel
    p44_keys = {"fused_progressive_sum": "B1", "trace_closest": "B3 closest",
                "trace_any": "B3 any", "traverse_fat_closest": "B4a closest",
                "traverse_fat_any": "B4a any", "traverse2_fat_closest": "B6a closest",
                "traverse2_fat_any": "B6a any"}
    for kern in kernels:
        if kern["name"] in p44_keys:
            kern["phase44_paths"] = paths44.get(p44_keys[kern["name"]], [])
    check_errors()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
