// Two-level fat-node walk kernel (B6a) for Hopper (sm_90a).
//
// Replaces the TPU kernel _make_traverse2_fat_kernel
// (dxrexperiments_tpu/ops/traverse2_pallas.py:285, launched by _call_fat) in
// both of its modes: closest hit (t, leaf slot, u, v, instance slot) and
// occlusion. The wavefront integrator launches it once per trace stage of a
// two-level (TLAS/BLAS) scene.
//
// What bounds it: memory latency and divergence, as for B4a. A ray walks
// the fat TLAS (64-byte nodes), and at each instance it enters it reads the
// instance's 64-byte row, moves itself into object space and walks that
// instance's BLAS (64-byte nodes, 32-slot leaves), each step depending on
// the last. The working set is small: for BASELINE config 5 (1,025
// instances of two meshes) the TLAS, the instance table and both BLASes
// with their triangle records take about 1 MB, which stays in the 50 MB L2,
// against the 649 MB triangle pack of the flattened scene. Design answer:
// one thread per ray, in the caller's order; the TLAS walked near-first on
// a 64-entry stack with common.cuh's fat_walk, whose leaf visit
// (InstanceLeaf) loads the instance row as four float4 loads, forms
// o' = A o + b, d' = A d (the leaf test's o' x d' and 1 / d' follow), and
// runs fat_walk again from the instance's BLAS root on a 96-entry stack.
// The BLAS leaf tests read each slot's 19 coefficients as a record of five
// float4s (blas_test [S, 20], ops/traverse.coef_records of mt_rows, built
// once beside blasf_rows by the two-level build): five 16-byte loads a pair
// test where mt_rows' 512-byte rows took 19 scalar ones, and the leaf loop
// issues fewer instructions. The affine map keeps t, so one running best t
// (closest) prunes both levels in world units and hits of different
// instances compare directly; occlusion ends at the first hit. What the TPU
// kernel does for Mosaic has no counterpart here: the packet's shared SMEM
// stacks, the whole-packet transform, the per-lane live mask (a thread
// enters only the instances its own ray hits) and the double-buffered leaf
// DMA.
//
// A stack overflow (either level) or an index outside the arrays sets the
// error flag, which the wrapper reads later.

#include "rec_leaf.cuh"

namespace {

using namespace dxr;

constexpr int kThreads = 128;
constexpr int kTlasStack = 64;  // traverse2_pallas.TLAS_STACK

// The TLAS leaf test: an instance leaf (meta 1) walks the instance's BLAS
// with the inner leaf test's ray moved into object space.
template <class Inner>
struct InstanceLeaf {
  const FatBvh& blas;
  const float4* inst;  // inst_rows_t [n_inst, 16]: A (0-8), b (9-11), fat root (15)
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
    fat_walk(blas, o2, safe_inv(d2), tmin, inner, stack, (int)m.w);
    if (inner.far() < before) best_inst = slot;
    return ended(inner);
  }
};

// rays [n, 8]: origin, direction, t_min, t_max (ops/traverse.pack_rays);
// rec: the BLAS records
template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
traverse2_fat_kernel(const float4* __restrict__ rays, FatBvh T, const float4* __restrict__ inst,
                     int n_inst, FatBvh B, const float4* __restrict__ rec, int n_rays, int cull,
                     float* __restrict__ t_out,
                     int* __restrict__ slot_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, int* __restrict__ inst_out,
                     unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float4 r0 = __ldg(rays + 2 * i), r1 = __ldg(rays + 2 * i + 1);
  const V3 o = v3(r0.x, r0.y, r0.z), d = v3(r0.w, r1.x, r1.y);
  const float tmin = r1.z, tmax = r1.w;
  int tstack[kTlasStack];
  int bstack[kMaxStack];
  if (kOcclusion) {
    AnyRecLeaf leaf(B, rec, o, d, tmin, tmax);
    // zero directions mark dead lanes (the integrator's inactive shadow rays)
    if (fabsf(d.x) + fabsf(d.y) + fabsf(d.z) >= 1e-30f) {
      InstanceLeaf<AnyRecLeaf> tleaf{B, inst, n_inst, leaf, o, d, tmin, bstack, -1};
      fat_walk<InstanceLeaf<AnyRecLeaf>, kTlasStack>(T, o, safe_inv(d), tmin, tleaf, tstack);
    }
    occ_out[i] = leaf.occluded ? 1 : 0;
  } else {
    ClosestRecLeaf leaf(B, rec, o, d, tmin, tmax, cull != 0);
    InstanceLeaf<ClosestRecLeaf> tleaf{B, inst, n_inst, leaf, o, d, tmin, bstack, -1};
    fat_walk<InstanceLeaf<ClosestRecLeaf>, kTlasStack>(T, o, safe_inv(d), tmin, tleaf, tstack);
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
//   rays [n_rays, 8] f32; tlas = tlasf_rows [n_tlas, 16] f32; inst =
//   inst_rows_t [n_inst, 16] f32; blas = blasf_rows [n_blas, 16] f32; rec =
//   blas_test [n_slots, 20] f32 (16-byte aligned: each leaf slot's record).
//   occlusion != 0 writes occ [n_rays] (bool
//   bytes), else t, u, v [n_rays] f32 and slot, inst_out [n_rays] i32 (-1 on
//   a miss). err [1] i32 must be 0 on entry and is set to 1 (a stack
//   overflow) or 2 (an index out of range). Returns cudaGetLastError() (0 on
//   success).
extern "C" int dxr_traverse2_fat(const float* rays, const float* tlas, const float* inst,
                                 const float* blas, const float* rec, int n_rays, int n_tlas,
                                 int n_inst, int n_blas, int n_slots, int occlusion, int cull,
                                 float* t, int* slot, float* u, float* v, int* inst_out,
                                 unsigned char* occ, int* err, void* stream) {
  if (n_rays < 0 || n_tlas < 1 || n_inst < 1 || n_blas < 1 || n_slots < 1 || rec == nullptr ||
      reinterpret_cast<uintptr_t>(rec) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return 0;
  FatBvh T{reinterpret_cast<const float4*>(tlas), nullptr, n_tlas, n_inst, err};
  FatBvh B{reinterpret_cast<const float4*>(blas), nullptr, n_blas, n_slots, err};
  const float4* in = reinterpret_cast<const float4*>(inst);
  const float4* rc = reinterpret_cast<const float4*>(rec);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const float4* r = reinterpret_cast<const float4*>(rays);
  cudaStream_t s = (cudaStream_t)stream;
  if (occlusion) {
    traverse2_fat_kernel<true><<<blocks, kThreads, 0, s>>>(r, T, in, n_inst, B, rc, n_rays, 0, t,
                                                           slot, u, v, inst_out, occ);
  } else {
    traverse2_fat_kernel<false><<<blocks, kThreads, 0, s>>>(r, T, in, n_inst, B, rc, n_rays, cull,
                                                            t, slot, u, v, inst_out, occ);
  }
  return (int)cudaGetLastError();
}
