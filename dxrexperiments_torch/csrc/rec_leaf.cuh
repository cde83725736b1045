// The leaf tests over triangle records, shared by the walks that read them:
// B4a (csrc/traverse_fat.cu), B4b (csrc/traverse_binary.cu), B4c
// (csrc/traverse_fat_grouped.cu), B4d (csrc/traverse8.cu), B5
// (csrc/fused_traverse.cu), B6a (csrc/traverse2_fat.cu) and B6b
// (csrc/traverse2_binary.cu); and the fat-node walk with per-warp leaf
// postponement (postponed_fat_walk) of B4a and B5.
//
// ClosestRecLeaf and AnyRecLeaf are common.cuh's ClosestLeaf and AnyLeaf
// with each slot's 19 coefficients read from a record of five float4s
// (rec [S, kRecWords]: the slots in slot order and a zero pad;
// ops/traverse.coef_records of mt_rows: the BVH's ft_test, the two-level
// blas_test), five 16-byte loads a pair test instead of mt_rows' 19 scalar
// ones. The arithmetic is the same in the same order, so the hits are the
// same to the bit.
//
// Kept out of common.cuh so that the kernels that include only that header
// compile exactly as before.

#pragma once

#include "common.cuh"

namespace dxr {

struct ClosestRecLeaf : ClosestLeaf {
  const float4* rec;
  __device__ __forceinline__ ClosestRecLeaf(const FatBvh& b, const float4* rec_, V3 o_, V3 d_,
                                            float tmin_, float tmax_, bool cull_)
      : ClosestLeaf(b, o_, d_, tmin_, tmax_, cull_), rec(rec_) {}
  __device__ __forceinline__ bool visit(int start, int count) {
    if (start < 0 || start + count > B.n_slots) {
      *B.err = E_INDEX;
      return true;
    }
    for (int r = 0; r < count; ++r) {
      Pair p = pair_test(rec_coef_ldg(rec + (size_t)(start + r) * kRecQuads), o, d, mo, tmin,
                         true, tmax, cull);
      if (p.valid) {
        float t = p.ts / fmaxf(p.det_abs, kDetEps);
        if (t < best_t) {
          best_t = t;
          best_slot = start + r;
          b_us = p.us;
          b_vs = p.vs;
          b_det = p.det_abs;
        }
      }
    }
    return false;
  }
};

struct AnyRecLeaf : AnyLeaf {
  const float4* rec;
  __device__ __forceinline__ AnyRecLeaf(const FatBvh& b, const float4* rec_, V3 o_, V3 d_,
                                        float tmin_, float tmax_)
      : AnyLeaf(b, o_, d_, tmin_, tmax_), rec(rec_) {}
  __device__ __forceinline__ bool visit(int start, int count) {
    if (start < 0 || start + count > B.n_slots) {
      *B.err = E_INDEX;
      return true;
    }
    for (int r = 0; r < count; ++r) {
      if (pair_test(rec_coef_ldg(rec + (size_t)(start + r) * kRecQuads), o, d, mo, tmin, true,
                    tmax, false).valid) {
        occluded = true;
        return true;
      }
    }
    return false;
  }
};

// Whether a leaf test has ended the walk (occlusion found a hit).
__device__ __forceinline__ bool ended(const ClosestRecLeaf&) { return false; }
__device__ __forceinline__ bool ended(const AnyRecLeaf& l) { return l.occluded; }

// What postponed_fat_walk reports of its warps: nothing. A counting tally
// (B5's opt-in build) has the same two calls: walk(mask) at a walk's
// entry and phase(mask, holds) at each leaf phase, by every lane of mask.
struct NoTally {
  __device__ __forceinline__ void walk(unsigned) const {}
  __device__ __forceinline__ void phase(unsigned, bool) const {}
};

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
// B4a passes the lanes of its launch; B5 passes __activemask() at each
// walk's entry, the lanes that make that walk together. Either mask holds
// only lanes that run the same sequence of votes, since the loop's exits
// come from the votes themselves. `tally` sees each walk's mask and each
// leaf phase (NoTally: nothing, so the walk compiles as without it).
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
template <class Leaf, class Tally = NoTally>
__device__ __forceinline__ void postponed_fat_walk(unsigned warp, const FatBvh& B, V3 o, V3 inv,
                                                   float tmin, Leaf& leaf, int* stack,
                                                   bool walks, Tally tally = Tally()) {
  tally.walk(warp);
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
    tally.phase(warp, h.n > 0);
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

}  // namespace dxr
