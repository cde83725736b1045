// Two-level binary walk kernel (B6b) for Hopper (sm_90a).
//
// Replaces the TPU kernel _make_traverse2_kernel
// (dxrexperiments_tpu/ops/traverse2_pallas.py:53, launched by _call) in
// both of its modes: closest hit (t, leaf slot, u, v, instance slot) and
// occlusion. The wavefront integrator launches it once per trace stage of a
// two-level (TLAS/BLAS) scene whose TLAS has no fat nodes.
//
// What bounds it: memory latency and divergence, as for B6a. A ray walks
// the binary TLAS (32-byte nodes, right child first), and at each instance
// leaf its box admits it reads the instance's 64-byte row, moves itself
// into object space and walks that instance's binary BLAS (32-byte nodes,
// 32-slot leaves) the same way. The working set of BASELINE config 5
// (1,025 instances of two meshes) is about 1.4 MB and stays in the 50 MB
// L2. Design answer: one thread per ray in the caller's order;
// walk_binary.cuh's binary_walk (the JAX kernel's walk) on the TLAS
// (64-entry stack) whose leaf visit (InstanceLeaf) loads the instance row
// as four float4 loads, forms o' = A o + b and d' = A d, and walks the BLAS
// from the instance's binary root (inst_rows row 12, not B6a's fat root in
// row 15) on a 96-entry stack with rec_leaf.cuh's leaf tests, each slot's
// coefficients read as one record of five float4s from blas_test (as B6a
// reads them). The map is affine, so t needs no rescale: one running best
// t prunes both levels and hits of different instances compare directly;
// the instance slot is recorded where the best improves. Occlusion ends at
// the first hit. B4b's children tested at the parent and its leaf
// postponement measured slower here (PERF.md, PR 12). The TPU kernel's
// packet stacks, its whole-packet transform, its per-lane live mask and its
// leaf DMA have no counterpart; its visit order is kept (it decides equal-t
// ties).
//
// A stack overflow (either level) or an index outside the arrays sets the
// error flag, which the wrapper reads later.

#include "rec_leaf.cuh"
#include "walk_binary.cuh"

namespace {

using namespace dxr;

constexpr int kThreads = 128;
constexpr int kTlasStack = 64;  // traverse2_pallas.TLAS_STACK

// The TLAS leaf test: instance `slot` walks its binary BLAS with the inner
// leaf test's ray moved into object space.
template <class Inner>
struct InstanceLeaf {
  const BinNodes& blas;
  const float4* inst;  // inst_rows_t [n_inst, 16]: A (0-8), b (9-11), binary root (12)
  int n_inst;
  Inner& inner;
  V3 o, d;  // the world-space ray
  float tmin;
  int* stack;  // the BLAS walk's kMaxStack entries
  int best_inst;

  __device__ __forceinline__ float far() const { return inner.far(); }
  __device__ __forceinline__ bool visit(int slot, int) {
    if (slot < 0 || slot >= n_inst) {
      *blas.err = E_INDEX;
      return true;
    }
    const float4* q = inst + 4 * slot;
    const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), m = __ldg(q + 3);
    const V3 o2 = v3(a.x * o.x + a.y * o.y + a.z * o.z + c.y,
                     a.w * o.x + b.x * o.y + b.y * o.z + c.z,
                     b.z * o.x + b.w * o.y + c.x * o.z + c.w);
    const V3 d2 = v3(a.x * d.x + a.y * d.y + a.z * d.z, a.w * d.x + b.x * d.y + b.y * d.z,
                     b.z * d.x + b.w * d.y + c.x * d.z);
    inner.set_ray(o2, d2);
    const float before = inner.far();  // falls only when this instance holds the best hit
    binary_walk(blas, o2, safe_inv(d2), tmin, inner, stack, __float2int_rz(m.x));
    if (inner.far() < before) best_inst = slot;
    return ended(inner);
  }
};

// rays [n, 8]: origin, direction, t_min, t_max (ops/traverse.pack_rays)
template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
traverse2_binary_kernel(const float4* __restrict__ rays, BinNodes T, const float4* __restrict__ inst,
                        int n_inst, BinNodes B, FatBvh L, const float4* __restrict__ rec,
                        int n_rays, int cull,
                        float* __restrict__ t_out, int* __restrict__ slot_out,
                        float* __restrict__ u_out, float* __restrict__ v_out,
                        int* __restrict__ inst_out, unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float4 r0 = __ldg(rays + 2 * i), r1 = __ldg(rays + 2 * i + 1);
  const V3 o = v3(r0.x, r0.y, r0.z), d = v3(r0.w, r1.x, r1.y);
  const float tmin = r1.z, tmax = r1.w;
  int tstack[kTlasStack];
  int bstack[kMaxStack];
  if (kOcclusion) {
    AnyRecLeaf leaf(L, rec, o, d, tmin, tmax);
    // zero directions mark dead lanes (the integrator's inactive shadow rays)
    if (fabsf(d.x) + fabsf(d.y) + fabsf(d.z) >= 1e-30f) {
      InstanceLeaf<AnyRecLeaf> tleaf{B, inst, n_inst, leaf, o, d, tmin, bstack, -1};
      binary_walk<InstanceLeaf<AnyRecLeaf>, kTlasStack>(T, o, safe_inv(d), tmin, tleaf, tstack);
    }
    occ_out[i] = leaf.occluded ? 1 : 0;
  } else {
    ClosestRecLeaf leaf(L, rec, o, d, tmin, tmax, cull != 0);
    InstanceLeaf<ClosestRecLeaf> tleaf{B, inst, n_inst, leaf, o, d, tmin, bstack, -1};
    binary_walk<InstanceLeaf<ClosestRecLeaf>, kTlasStack>(T, o, safe_inv(d), tmin, tleaf, tstack);
    const bool hit = leaf.hit();
    t_out[i] = hit ? leaf.best_t : -1.0f;
    slot_out[i] = hit ? leaf.best_slot : -1;
    u_out[i] = hit ? leaf.u() : 0.0f;
    v_out[i] = hit ? leaf.v() : 0.0f;
    inst_out[i] = hit ? tleaf.best_inst : -1;
  }
}

}  // namespace

// One launch over n_rays rays on `stream`.
//   rays [n_rays, 8] f32; tlas = tlas_rows [n_tlas, 8] f32; inst =
//   inst_rows_t [n_inst, 16] f32; blas = blas_rows [n_blas, 8] f32; rec =
//   blas_test [n_slots, 20] f32 (16-byte aligned: each leaf slot's record).
//   occlusion != 0 writes occ [n_rays] (bool bytes), else t, u, v [n_rays]
//   f32 and slot, inst_out [n_rays] i32 (-1 on a miss). err [1] i32 must
//   be 0 on entry and is set to 1 (a stack overflow) or 2 (an index out of
//   range). Returns cudaGetLastError() (0 on success).
extern "C" int dxr_traverse2_binary(const float* rays, const float* tlas, const float* inst,
                                    const float* blas, const float* rec, int n_rays, int n_tlas,
                                    int n_inst, int n_blas, int n_slots, int occlusion, int cull,
                                    float* t, int* slot, float* u, float* v, int* inst_out,
                                    unsigned char* occ, int* err, void* stream) {
  if (n_rays < 0 || n_tlas < 1 || n_inst < 1 || n_blas < 1 || n_slots < 1 || rec == nullptr ||
      reinterpret_cast<uintptr_t>(rec) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return 0;
  BinNodes T{reinterpret_cast<const float4*>(tlas), n_tlas, err};
  BinNodes B{reinterpret_cast<const float4*>(blas), n_blas, err};
  FatBvh L{nullptr, nullptr, 0, n_slots, err};  // the leaf tests' slot count
  const float4* rc = reinterpret_cast<const float4*>(rec);
  const float4* in = reinterpret_cast<const float4*>(inst);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const float4* r = reinterpret_cast<const float4*>(rays);
  cudaStream_t s = (cudaStream_t)stream;
  if (occlusion) {
    traverse2_binary_kernel<true><<<blocks, kThreads, 0, s>>>(r, T, in, n_inst, B, L, rc, n_rays, 0,
                                                              t, slot, u, v, inst_out, occ);
  } else {
    traverse2_binary_kernel<false><<<blocks, kThreads, 0, s>>>(r, T, in, n_inst, B, L, rc, n_rays,
                                                               cull, t, slot, u, v, inst_out, occ);
  }
  return (int)cudaGetLastError();
}
