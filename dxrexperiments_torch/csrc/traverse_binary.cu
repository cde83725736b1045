// Binary-node BVH walk kernel (B4b) for Hopper (sm_90a).
//
// Replaces the TPU kernel _make_traverse_kernel
// (dxrexperiments_tpu/ops/traverse_pallas.py:282, launched by
// traverse_closest and traverse_any) in both of its modes: closest hit (t,
// leaf slot, u, v) and occlusion. The wavefront integrator launches it once
// per trace stage of a BVH scene whose pack has no fat nodes.
//
// What bounds it: memory latency and divergence, as for B4a, with more
// steps: each visit reads one 32-byte node and tests one box, and the walk
// goes in the tree's fixed order (right child first), not near-first, so a
// ray visits more nodes before its best hit prunes the rest. Design answer:
// one thread per ray in the caller's order, each node read as two float4
// loads from the row-major copy (bvh_rows) through the read-only cache, a
// leaf's 19 used coefficients per slot read as B4a reads them (common.cuh's
// ClosestLeaf / AnyLeaf), occlusion ending at the first hit. The TPU
// kernel's packet stack in SMEM and its double-buffered leaf DMA have no
// counterpart here; its visit order is kept, since it decides which
// triangle wins an equal-t tie.
//
// The per-thread stack holds kMaxStack (96) entries in local memory; an
// overflow or an index outside the arrays sets the error flag, which the
// wrapper reads later (ops/traverse.check_errors).

#include "walk_binary.cuh"

namespace {

using namespace dxr;

constexpr int kThreads = 128;

// rays [n, 8]: origin, direction, t_min, t_max (ops/traverse.pack_rays)
template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
traverse_binary_kernel(const float4* __restrict__ rays, BinNodes N, FatBvh L, int n_rays,
                       int cull, float* __restrict__ t_out, int* __restrict__ slot_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float4 r0 = __ldg(rays + 2 * i), r1 = __ldg(rays + 2 * i + 1);
  const V3 o = v3(r0.x, r0.y, r0.z), d = v3(r0.w, r1.x, r1.y);
  const float tmin = r1.z, tmax = r1.w;
  int stack[kMaxStack];
  if (kOcclusion) {
    AnyLeaf leaf(L, o, d, tmin, tmax);
    // zero directions mark dead lanes (the integrator's inactive shadow rays)
    if (fabsf(d.x) + fabsf(d.y) + fabsf(d.z) >= 1e-30f) {
      binary_walk(N, o, safe_inv(d), tmin, leaf, stack);
    }
    occ_out[i] = leaf.occluded ? 1 : 0;
  } else {
    ClosestLeaf leaf(L, o, d, tmin, tmax, cull != 0);
    binary_walk(N, o, safe_inv(d), tmin, leaf, stack);
    const bool hit = leaf.hit();
    t_out[i] = hit ? leaf.best_t : -1.0f;
    slot_out[i] = hit ? leaf.best_slot : -1;
    u_out[i] = hit ? leaf.u() : 0.0f;
    v_out[i] = hit ? leaf.v() : 0.0f;
  }
}

}  // namespace

// One launch over n_rays rays on `stream`.
//   rays [n_rays, 8] f32, nodes = bvh_rows [n_nodes, 8] f32, rows = mt_rows
//   [n_slots, 128] f32; occlusion != 0 writes occ [n_rays] (bool bytes),
//   else t, u, v [n_rays] f32 and slot [n_rays] i32 (-1 on a miss); err [1]
//   i32 must be 0 on entry and is set to 1 (stack overflow) or 2 (index out
//   of range). Returns cudaGetLastError() (0 on success).
extern "C" int dxr_traverse_binary(const float* rays, const float* nodes, const float* rows,
                                   int n_rays, int n_nodes, int n_slots, int occlusion, int cull,
                                   float* t, int* slot, float* u, float* v, unsigned char* occ,
                                   int* err, void* stream) {
  if (n_rays < 0 || n_nodes < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  BinNodes N{reinterpret_cast<const float4*>(nodes), n_nodes, err};
  FatBvh L{nullptr, rows, 0, n_slots, err};  // the leaf tests' slots
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const float4* r = reinterpret_cast<const float4*>(rays);
  cudaStream_t s = (cudaStream_t)stream;
  if (occlusion) {
    traverse_binary_kernel<true><<<blocks, kThreads, 0, s>>>(r, N, L, n_rays, 0, t, slot, u, v,
                                                             occ);
  } else {
    traverse_binary_kernel<false><<<blocks, kThreads, 0, s>>>(r, N, L, n_rays, cull, t, slot, u,
                                                              v, occ);
  }
  return (int)cudaGetLastError();
}
