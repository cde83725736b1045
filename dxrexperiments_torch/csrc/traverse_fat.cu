// Fat-node BVH walk kernel (B4a) for Hopper (sm_90a).
//
// Replaces the TPU kernel _make_traverse_fat_kernel
// (dxrexperiments_tpu/ops/traverse_pallas.py:445, launched by _call_fat) in
// both of its modes: closest hit (t, leaf slot, u, v) and occlusion. The
// wavefront integrator launches it once per trace stage of a BVH scene.
//
// What bounds it: memory latency and divergence, not bytes or flops. A ray
// visits tens of fat nodes (64 bytes each) and tests a few 32-slot leaves
// (19 coefficients per slot, read from 512-byte mt_rows rows), each step
// depending on the last, so a thread waits on dependent loads; neighbouring
// rays agree on the path only as long as their directions do (the bounce
// and shadow batches of the wavefront route are less coherent than primary
// rays). Design answer: one thread per ray, in the caller's order (raster
// for primaries, so a warp holds 32 neighbouring pixels and shares most of
// its walk); the node read as four float4 loads from the row-major copy of
// the fat nodes (bvhf_rows); only the 19 used coefficients of a slot read,
// through the read-only cache; the running best t clips both children's
// slab tests, and the near child is popped first, so a close hit prunes the
// far subtrees; occlusion ends at the first hit. What the TPU kernel does
// for Mosaic has no counterpart here: packet stacks in SMEM, the
// double-buffered leaf DMA, half_gate, leaf_bestt and common_origin.
//
// The per-thread stack holds kMaxStack (96) entries in local memory; an
// overflow sets the error flag, which the wrapper reads and raises on.

#include "common.cuh"

namespace {

using namespace dxr;

constexpr int kThreads = 128;

// rays [n, 8]: origin, direction, t_min, t_max (ops/traverse.pack_rays)
template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
traverse_fat_kernel(const float4* __restrict__ rays, FatBvh B, int n_rays, int cull,
                    float* __restrict__ t_out, int* __restrict__ slot_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float4 r0 = __ldg(rays + 2 * i), r1 = __ldg(rays + 2 * i + 1);
  const V3 o = v3(r0.x, r0.y, r0.z), d = v3(r0.w, r1.x, r1.y);
  const float tmin = r1.z, tmax = r1.w;
  int stack[kMaxStack];
  if (kOcclusion) {
    AnyLeaf leaf(B, o, d, tmin, tmax);
    // zero directions mark dead lanes (the integrator's inactive shadow rays)
    if (fabsf(d.x) + fabsf(d.y) + fabsf(d.z) >= 1e-30f) {
      fat_walk(B, o, safe_inv(d), tmin, leaf, stack);
    }
    occ_out[i] = leaf.occluded ? 1 : 0;
  } else {
    ClosestLeaf leaf(B, o, d, tmin, tmax, cull != 0);
    fat_walk(B, o, safe_inv(d), tmin, leaf, stack);
    const bool hit = leaf.hit();
    t_out[i] = hit ? leaf.best_t : -1.0f;
    slot_out[i] = hit ? leaf.best_slot : -1;
    u_out[i] = hit ? leaf.u() : 0.0f;
    v_out[i] = hit ? leaf.v() : 0.0f;
  }
}

}  // namespace

// One launch over n_rays rays on `stream`.
//   rays [n_rays, 8] f32, nodes = bvhf_rows [n_nodes, 16] f32, rows = mt_rows
//   [n_slots, 128] f32; occlusion != 0 writes occ [n_rays] (bool bytes),
//   else t, u, v [n_rays] f32 and slot [n_rays] i32 (-1 on a miss); err [1]
//   i32 must be 0 on entry and is set to 1 (stack overflow) or 2 (index out
//   of range). Returns cudaGetLastError() (0 on success).
extern "C" int dxr_traverse_fat(const float* rays, const float* nodes, const float* rows,
                                int n_rays, int n_nodes, int n_slots, int occlusion, int cull,
                                float* t, int* slot, float* u, float* v, unsigned char* occ,
                                int* err, void* stream) {
  if (n_rays < 0 || n_nodes < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  FatBvh B{reinterpret_cast<const float4*>(nodes), rows, n_nodes, n_slots, err};
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const float4* r = reinterpret_cast<const float4*>(rays);
  cudaStream_t s = (cudaStream_t)stream;
  if (occlusion) {
    traverse_fat_kernel<true><<<blocks, kThreads, 0, s>>>(r, B, n_rays, 0, t, slot, u, v, occ);
  } else {
    traverse_fat_kernel<false><<<blocks, kThreads, 0, s>>>(r, B, n_rays, cull, t, slot, u, v,
                                                            occ);
  }
  return (int)cudaGetLastError();
}
