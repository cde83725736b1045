// Fat-node BVH walk kernel (B4a) for Hopper (sm_90a).
//
// Replaces the TPU kernel _make_traverse_fat_kernel
// (dxrexperiments_tpu/ops/traverse_pallas.py:445, launched by _call_fat) in
// both of its modes: closest hit (t, leaf slot, u, v) and occlusion. The
// wavefront integrator launches it once per trace stage of a BVH scene.
//
// What bounds it: divergence and memory latency, not bytes or flops. A ray
// visits tens of fat nodes (64 bytes each) and tests a few leaves of up to
// 32 slots, each step depending on the last; neighbouring rays agree on the
// path only as long as their directions do (the bounce and shadow batches
// of the wavefront route are less coherent than primary rays). A leaf costs
// up to 32 pair tests against a visit's two slab tests, so a warp whose
// lanes test leaves in different turns pays for each lane's leaves one
// after another: the warps' pair slots are 85-86% of the walk's modelled
// cost (ops/traverse2.turn_costs, PERF.md). Design answer: one thread per
// ray in the caller's order (raster for primaries); the node read as four
// float4 loads from the row-major bvhf_rows; the running best t clips both
// children's slab tests and the near child is popped first, so a close hit
// prunes the far subtrees; occlusion ends at the first hit; a slot's 19
// coefficients read as one record of five float4s from the BVH's ft_test
// (ops/traverse.leaf_records, as B4b, B5 and B6a read them), five 16-byte
// loads a pair test where mt_rows' 512-byte rows took 19 scalar ones; and
// leaf tests postponed per warp (rec_leaf.cuh's postponed_fat_walk, which
// B5's walks share). What the TPU kernel does for Mosaic has no counterpart
// here: packet stacks in SMEM, the double-buffered leaf DMA, half_gate,
// leaf_bestt and common_origin.
//
// The per-thread stack holds kMaxStack (96) entries in local memory; an
// overflow or an index outside the arrays sets the error flag, which the
// wrapper reads later (ops/traverse.check_errors).

#include "rec_leaf.cuh"

namespace {

using namespace dxr;

constexpr int kThreads = 128;

// rays [n, 8]: origin, direction, t_min, t_max (ops/traverse.pack_rays)
template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
traverse_fat_kernel(const float4* __restrict__ rays, FatBvh B, const float4* __restrict__ rec,
                    int n_rays, int cull, float* __restrict__ t_out, int* __restrict__ slot_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned warp = __ballot_sync(0xffffffffu, i < n_rays);  // the lanes that walk together
  if (i >= n_rays) return;
  const float4 r0 = __ldg(rays + 2 * i), r1 = __ldg(rays + 2 * i + 1);
  const V3 o = v3(r0.x, r0.y, r0.z), d = v3(r0.w, r1.x, r1.y);
  const float tmin = r1.z, tmax = r1.w;
  int stack[kMaxStack];
  if (kOcclusion) {
    AnyRecLeaf leaf(B, rec, o, d, tmin, tmax);
    // zero directions mark dead lanes (the integrator's inactive shadow rays)
    const bool live = fabsf(d.x) + fabsf(d.y) + fabsf(d.z) >= 1e-30f;
    postponed_fat_walk(warp, B, o, safe_inv(d), tmin, leaf, stack, live);
    occ_out[i] = leaf.occluded ? 1 : 0;
  } else {
    ClosestRecLeaf leaf(B, rec, o, d, tmin, tmax, cull != 0);
    postponed_fat_walk(warp, B, o, safe_inv(d), tmin, leaf, stack, true);
    const bool hit = leaf.hit();
    t_out[i] = hit ? leaf.best_t : -1.0f;
    slot_out[i] = hit ? leaf.best_slot : -1;
    u_out[i] = hit ? leaf.u() : 0.0f;
    v_out[i] = hit ? leaf.v() : 0.0f;
  }
}

}  // namespace

// One launch over n_rays rays on `stream`.
//   rays [n_rays, 8] f32, nodes = bvhf_rows [n_nodes, 16] f32, rec = ft_test
//   [n_slots, 20] f32 (16-byte aligned: each leaf slot's record);
//   occlusion != 0 writes occ [n_rays] (bool bytes), else t, u, v [n_rays]
//   f32 and slot [n_rays] i32 (-1 on a miss); err [1] i32 must be 0 on
//   entry and is set to 1 (stack overflow) or 2 (index out of range).
//   Returns cudaGetLastError() (0 on success).
extern "C" int dxr_traverse_fat(const float* rays, const float* nodes, const float* rec,
                                int n_rays, int n_nodes, int n_slots, int occlusion, int cull,
                                float* t, int* slot, float* u, float* v, unsigned char* occ,
                                int* err, void* stream) {
  if (n_rays < 0 || n_nodes < 1 || n_slots < 1 || rec == nullptr ||
      reinterpret_cast<uintptr_t>(rec) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return 0;
  FatBvh B{reinterpret_cast<const float4*>(nodes), nullptr, n_nodes, n_slots, err};
  const float4* rc = reinterpret_cast<const float4*>(rec);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const float4* r = reinterpret_cast<const float4*>(rays);
  cudaStream_t s = (cudaStream_t)stream;
  if (occlusion) {
    traverse_fat_kernel<true><<<blocks, kThreads, 0, s>>>(r, B, rc, n_rays, 0, t, slot, u, v,
                                                          occ);
  } else {
    traverse_fat_kernel<false><<<blocks, kThreads, 0, s>>>(r, B, rc, n_rays, cull, t, slot, u,
                                                           v, occ);
  }
  return (int)cudaGetLastError();
}
