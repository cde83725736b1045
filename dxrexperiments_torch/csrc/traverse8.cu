// 8-wide BVH walk kernel (B4d) for Hopper (sm_90a).
//
// Replaces the TPU kernel _make_traverse8_kernel
// (dxrexperiments_tpu/ops/traverse_pallas.py:709, launched by
// traverse8_closest and traverse8_any) in both of its modes: closest hit
// (t, leaf slot, u, v) and occlusion. The tree is accel/bvh.collapse_wide's
// 8-wide collapse of the binary BVH, with the same leaf slot ranges
// (bvh8_rows [W*8, 8]: per wide node 8 child rows lo3, hi3, child, count).
//
// What bounds it: memory latency and divergence, as for B4a and B4b. A
// visit reads one 256-byte wide node (eight 32-byte child rows, two float4
// loads each) and tests eight boxes, so a ray makes fewer, wider steps
// than in the binary walk; the TPU kernel took its eight boxes on
// sublanes for the same reason. Design answer: one thread per ray in the
// caller's order; the eight slab tests against one far end (the running
// best t, or t_max), unrolled so their loads are in flight together; then,
// in child order 0..7, each hit leaf child tested at once (count > 0.5) and
// each hit internal child pushed (count < -0.5), so child 7's subtree pops
// first; an empty slot (count 0, box at +BIG) is skipped by its count
// whatever its box does. This is the TPU kernel's order of visits, which
// decides which triangle wins an equal-t tie. Occlusion ends at the first
// hit. The packet stack in SMEM and the double-buffered leaf DMA have no
// counterpart here.
//
// The per-thread stack holds kMaxStack (96) entries in local memory; a wide
// visit can push seven more entries than it pops. An overflow or an index
// outside the arrays sets the error flag, which the wrapper reads later
// (ops/traverse.check_errors).

#include "common.cuh"

namespace {

using namespace dxr;

constexpr int kThreads = 128;
constexpr int kWidth = 8;

template <class Leaf>
__device__ __forceinline__ void wide_walk(const float4* __restrict__ rows, int n_wide, int* err,
                                          V3 o, V3 inv, float tmin, Leaf& leaf, int* stack) {
  int sp = 1;
  stack[0] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    if (node < 0 || node >= n_wide) {
      *err = E_INDEX;
      return;
    }
    const float4* q = rows + 2 * kWidth * node;
    const float tf = leaf.far();
    unsigned hits = 0u;
#pragma unroll
    for (int c = 0; c < kWidth; ++c) {
      const float4 a = __ldg(q + 2 * c), b = __ldg(q + 2 * c + 1);
      float tn;
      if (slab(v3(a.x, a.y, a.z), v3(a.w, b.x, b.y), o, inv, tmin, tf, &tn)) hits |= 1u << c;
    }
#pragma unroll 1
    for (int c = 0; c < kWidth; ++c) {
      if (!((hits >> c) & 1u)) continue;
      const float4 b = __ldg(q + 2 * c + 1);  // child, count in .z, .w
      if (b.w > 0.5f) {
        if (leaf.visit(__float2int_rz(-b.z - 1.0f), __float2int_rz(b.w))) return;
      } else if (b.w < -0.5f) {
        if (sp >= kMaxStack) {
          *err = E_STACK;
          return;
        }
        stack[sp++] = __float2int_rz(b.z);
      }
    }
  }
}

// rays [n, 8]: origin, direction, t_min, t_max (ops/traverse.pack_rays)
template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
traverse8_kernel(const float4* __restrict__ rays, const float4* __restrict__ nodes, int n_wide,
                 FatBvh L, int n_rays, int cull, float* __restrict__ t_out,
                 int* __restrict__ slot_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, unsigned char* __restrict__ occ_out) {
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
      wide_walk(nodes, n_wide, L.err, o, safe_inv(d), tmin, leaf, stack);
    }
    occ_out[i] = leaf.occluded ? 1 : 0;
  } else {
    ClosestLeaf leaf(L, o, d, tmin, tmax, cull != 0);
    wide_walk(nodes, n_wide, L.err, o, safe_inv(d), tmin, leaf, stack);
    const bool hit = leaf.hit();
    t_out[i] = hit ? leaf.best_t : -1.0f;
    slot_out[i] = hit ? leaf.best_slot : -1;
    u_out[i] = hit ? leaf.u() : 0.0f;
    v_out[i] = hit ? leaf.v() : 0.0f;
  }
}

}  // namespace

// One launch over n_rays rays on `stream`.
//   rays [n_rays, 8] f32, nodes = bvh8_rows [n_rows, 8] f32 (n_rows a
//   multiple of 8: n_rows / 8 wide nodes), rows = mt_rows [n_slots, 128]
//   f32; occlusion != 0 writes occ [n_rays] (bool bytes), else t, u, v
//   [n_rays] f32 and slot [n_rays] i32 (-1 on a miss); err [1] i32 must be
//   0 on entry and is set to 1 (stack overflow) or 2 (index out of range).
//   Returns cudaGetLastError() (0 on success).
extern "C" int dxr_traverse8(const float* rays, const float* nodes, const float* rows, int n_rays,
                             int n_rows, int n_slots, int occlusion, int cull, float* t, int* slot,
                             float* u, float* v, unsigned char* occ, int* err, void* stream) {
  if (n_rays < 0 || n_rows < kWidth || n_rows % kWidth || n_slots < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return 0;
  FatBvh L{nullptr, rows, 0, n_slots, err};  // the leaf tests' slots
  const float4* w = reinterpret_cast<const float4*>(nodes);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const float4* r = reinterpret_cast<const float4*>(rays);
  cudaStream_t s = (cudaStream_t)stream;
  if (occlusion) {
    traverse8_kernel<true><<<blocks, kThreads, 0, s>>>(r, w, n_rows / kWidth, L, n_rays, 0, t,
                                                       slot, u, v, occ);
  } else {
    traverse8_kernel<false><<<blocks, kThreads, 0, s>>>(r, w, n_rows / kWidth, L, n_rays, cull, t,
                                                        slot, u, v, occ);
  }
  return (int)cudaGetLastError();
}
