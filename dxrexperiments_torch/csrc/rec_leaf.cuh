// The leaf tests over triangle records, shared by the walks that read them:
// B4a (csrc/traverse_fat.cu), B4b (csrc/traverse_binary.cu), B4c
// (csrc/traverse_fat_grouped.cu), B4d (csrc/traverse8.cu), B6a
// (csrc/traverse2_fat.cu) and B6b (csrc/traverse2_binary.cu).
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

}  // namespace dxr
