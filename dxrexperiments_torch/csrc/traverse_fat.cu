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
// leaf tests postponed per warp (postponed_fat_walk below). What the TPU
// kernel does for Mosaic has no counterpart here: packet stacks in SMEM,
// the double-buffered leaf DMA, half_gate, leaf_bestt and common_origin.
//
// The per-thread stack holds kMaxStack (96) entries in local memory; an
// overflow or an index outside the arrays sets the error flag, which the
// wrapper reads later (ops/traverse.check_errors).

#include "rec_leaf.cuh"

namespace {

using namespace dxr;

constexpr int kThreads = 128;

// The leaves a lane holds: up to two (a visit hits at most both children),
// in the order the visit found them, child 0 first.
struct Held {
  int start[2], count[2];
  int n;
};

__device__ __forceinline__ bool outside(const FatBvh& B, int start, int count) {
  return start < 0 || start + count > B.n_slots;
}

// Slot k of the held leaves' slots taken as one run: leaf 0's, then leaf 1's.
__device__ __forceinline__ int run_slot(const Held& h, int k) {
  return k + (k < h.count[0] ? h.start[0] : h.start[1] - h.count[0]);
}

// The run's length: both leaves, or leaf 0's alone when leaf 1 lies outside
// the slots (then *bad1: the walk ends with E_INDEX after leaf 0's tests, as
// it does when the leaves are tested one by one).
__device__ __forceinline__ int run_length(const FatBvh& B, const Held& h, bool* bad1) {
  *bad1 = h.n > 1 && outside(B, h.start[1], h.count[1]);
  return h.count[0] + (h.n > 1 && !*bad1 ? h.count[1] : 0);
}

// Test a lane's held leaves in order, as one loop over their slots (a warp
// pays for its lane with the most slots, not for each leaf's largest in
// turn): the closest hit with a strict '<' in slot order, which is
// ClosestRecLeaf::visit on each leaf in turn. Returns true to end the walk
// (an index outside the slots).
__device__ __forceinline__ bool test_held(ClosestRecLeaf& L, const Held& h) {
  const FatBvh& B = L.B;
  if (outside(B, h.start[0], h.count[0])) {
    *B.err = E_INDEX;
    return true;
  }
  bool bad1;
  const int n = run_length(B, h, &bad1);
  for (int k = 0; k < n; ++k) {
    const int slot = run_slot(h, k);
    Pair p = pair_test(rec_coef_ldg(L.rec + (size_t)slot * kRecQuads), L.o, L.d, L.mo, L.tmin,
                       true, L.tmax, L.cull);
    if (p.valid) {
      float t = p.ts / fmaxf(p.det_abs, kDetEps);
      if (t < L.best_t) {
        L.best_t = t;
        L.best_slot = slot;
        L.b_us = p.us;
        L.b_vs = p.vs;
        L.b_det = p.det_abs;
      }
    }
  }
  if (bad1) *B.err = E_INDEX;
  return bad1;
}

// Occlusion: the first valid pair of the run ends the walk, so a second
// leaf is not tested once the first has occluded the ray.
__device__ __forceinline__ bool test_held(AnyRecLeaf& L, const Held& h) {
  const FatBvh& B = L.B;
  if (outside(B, h.start[0], h.count[0])) {
    *B.err = E_INDEX;
    return true;
  }
  bool bad1;
  const int n = run_length(B, h, &bad1);
  for (int k = 0; k < n; ++k) {
    if (pair_test(rec_coef_ldg(L.rec + (size_t)run_slot(h, k) * kRecQuads), L.o, L.d, L.mo,
                  L.tmin, true, L.tmax, false).valid) {
      L.occluded = true;
      return true;
    }
  }
  if (bad1) *B.err = E_INDEX;
  return bad1;
}

// common.cuh's fat_walk with leaf postponement (Aila and Laine,
// "Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009: the
// while-while loop), for the lanes `warp` (each ray on its own stack; every
// lane of the mask calls it, `walks` false for a lane with no walk to make).
// A visit pops a node, slab-tests both children against the window of now,
// holds the leaf children that hit (child 0 first) and pushes the internal
// ones that hit, far first; a lane holding a leaf stops walking. While any
// lane of the warp still walks without a held leaf, the warp walks on; then
// every holding lane tests its held leaves in order (test_held), and an
// occlusion hit skips the second leaf and ends the walk.
//
// Why the hits are fat_walk's: a lane's window (far(): t_max, or the best
// t) changes only at its own leaf tests, and a lane pops nothing while it
// holds a leaf. So each visit sees the window it sees in fat_walk, the held
// leaves are tested against the window they were found with, with nothing
// between (fat_walk tests them at once, in the same order and without a
// second slab test), and the pushes are the same. The leaves tested, their
// order and the hits are fat_walk's; a warp pays for a round of leaf tests
// once, not once per turn in which some lane tests a leaf. An overflow at a
// visit whose leaves are held sets E_STACK after they are tested, unless
// they end the walk, as in fat_walk, where they are tested before the
// pushes.
template <class Leaf>
__device__ __forceinline__ void postponed_fat_walk(unsigned warp, const FatBvh& B, V3 o, V3 inv,
                                                   float tmin, Leaf& leaf, int* stack,
                                                   bool walks) {
  int sp = walks ? 1 : 0;
  stack[0] = 0;
  Held h;
  h.n = 0;
  bool overflow = false;  // at the visit that found the held leaves
  while (true) {
    if (h.n == 0 && sp > 0) {
      const int node = stack[--sp];
      if (node < 0 || node >= B.n_nodes) {
        *B.err = E_INDEX;
        sp = 0;
      } else {
        const float4* q = B.nodes + 4 * node;
        const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), m = __ldg(q + 3);
        const float tf = leaf.far();
        float tn0, tn1;
        const bool h0 = slab(v3(a.x, a.y, a.z), v3(a.w, b.x, b.y), o, inv, tmin, tf, &tn0);
        const bool h1 = slab(v3(b.z, b.w, c.x), v3(c.y, c.z, c.w), o, inv, tmin, tf, &tn1);
        const int ptr0 = (int)m.x, ptr1 = (int)m.z;
        if (h0 && m.y > 0.5f) {
          h.start[0] = ptr0;
          h.count[0] = (int)m.y;
          h.n = 1;
        }
        if (h1 && m.w > 0.5f) {  // constant indices keep h in registers
          if (h.n) {
            h.start[1] = ptr1;
            h.count[1] = (int)m.w;
          } else {
            h.start[0] = ptr1;
            h.count[0] = (int)m.w;
          }
          ++h.n;
        }
        const bool int0 = h0 && m.y < -0.5f, int1 = h1 && m.w < -0.5f;
        const int pushes = (int)int0 + (int)int1;
        if (sp + pushes > kMaxStack) {
          sp = 0;
          if (h.n) {
            overflow = true;
          } else {
            *B.err = E_STACK;
          }
        } else if (int0 && int1) {
          const bool near0 = tn0 <= tn1;  // far pushed first, near pops next
          stack[sp++] = near0 ? ptr1 : ptr0;
          stack[sp++] = near0 ? ptr0 : ptr1;
        } else if (pushes) {
          stack[sp++] = int0 ? ptr0 : ptr1;
        }
      }
    }
    if (__any_sync(warp, h.n == 0 && sp > 0)) continue;  // a lane still looks for a leaf
    if (!__any_sync(warp, h.n > 0)) return;  // every lane has ended
    if (h.n) {
      if (test_held(leaf, h)) {
        sp = 0;
      } else if (overflow) {
        *B.err = E_STACK;
      }
      h.n = 0;
      overflow = false;
    }
  }
}

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
