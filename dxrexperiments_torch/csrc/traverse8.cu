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
// sublanes for the same reason. A visit can hit up to eight leaves of up to
// 32 slots each, so a warp whose lanes test leaves in different turns pays
// for each lane's leaves one after another. Design answer: one thread per
// ray in the caller's order; the eight slab tests against one far end (the
// running best t, or t_max), unrolled so their loads are in flight
// together; then, in child order 0..7, each hit leaf child held (count >
// 0.5) and each hit internal child pushed (count < -0.5), so child 7's
// subtree pops first; an empty slot (count 0, box at +BIG) is skipped by
// its count whatever its box does. This is the TPU kernel's order of
// visits, which decides which triangle wins an equal-t tie. The held
// leaves are tested per warp (postponed_wide_walk below), a slot's 19
// coefficients read as one record of five float4s from the BVH's ft_test
// (ops/traverse.leaf_records, as B4a, B4b and B5 read them). Occlusion
// ends at the first hit. The packet stack in SMEM and the
// double-buffered leaf DMA have no counterpart here.
//
// The per-thread stack holds kMaxStack (96) entries in local memory; a wide
// visit can push seven more entries than it pops. An overflow or an index
// outside the arrays sets the error flag, which the wrapper reads later
// (ops/traverse.check_errors).

#include "rec_leaf.cuh"

namespace {

using namespace dxr;

constexpr int kThreads = 128;
constexpr int kWidth = 8;

// The next held leaf child of the wide node at q (the lowest bit of *held,
// which it clears): its slots [*s, *end). False (E_INDEX set) if they lie
// outside the slots.
__device__ __forceinline__ bool next_leaf(const FatBvh& B, const float4* q, unsigned* held,
                                          int* s, int* end) {
  const int c = __ffs(*held) - 1;
  *held &= *held - 1u;
  const float4 b = __ldg(q + 2 * c + 1);  // child, count in .z, .w
  const int start = __float2int_rz(-b.z - 1.0f), count = __float2int_rz(b.w);
  if (start < 0 || start + count > B.n_slots) {
    *B.err = E_INDEX;
    return false;
  }
  *s = start;
  *end = start + count;
  return true;
}

// Test a lane's held leaves (the bits of `held`, children of the wide node
// at q) in child order, as one loop over their slots, one pair test a turn
// (a warp pays for its lane with the most slots, not for each leaf's
// largest in turn): the closest hit with a strict '<' in slot order, which
// is ClosestRecLeaf::visit on each leaf in turn. Returns true to end the
// walk (an index outside the slots, after the leaves before it).
__device__ __forceinline__ bool test_held(ClosestRecLeaf& L, const float4* q, unsigned held) {
  int s = 0, end = 0;
  while (true) {
    while (s >= end) {
      if (!held) return false;
      if (!next_leaf(L.B, q, &held, &s, &end)) return true;
    }
    Pair p = pair_test(rec_coef_ldg(L.rec + (size_t)s * kRecQuads), L.o, L.d, L.mo, L.tmin, true,
                       L.tmax, L.cull);
    if (p.valid) {
      float t = p.ts / fmaxf(p.det_abs, kDetEps);
      if (t < L.best_t) {
        L.best_t = t;
        L.best_slot = s;
        L.b_us = p.us;
        L.b_vs = p.vs;
        L.b_det = p.det_abs;
      }
    }
    ++s;
  }
}

// Occlusion: the first valid pair of the run ends the walk, so no later
// leaf is tested once one has occluded the ray.
__device__ __forceinline__ bool test_held(AnyRecLeaf& L, const float4* q, unsigned held) {
  int s = 0, end = 0;
  while (true) {
    while (s >= end) {
      if (!held) return false;
      if (!next_leaf(L.B, q, &held, &s, &end)) return true;
    }
    if (pair_test(rec_coef_ldg(L.rec + (size_t)s * kRecQuads), L.o, L.d, L.mo, L.tmin, true,
                  L.tmax, false).valid) {
      L.occluded = true;
      return true;
    }
    ++s;
  }
}

// The 8-wide walk with leaf postponement (Aila and Laine, "Understanding
// the Efficiency of Ray Traversal on GPUs", HPG 2009: the while-while
// loop), for the lanes `warp` (each ray on its own stack; every lane of the
// mask calls it, `walks` false for a lane with no walk to make). A visit
// pops a wide node, slab-tests its eight children against the window of
// now, and in child order holds the leaf children that hit (the node and an
// 8-bit mask: two registers, where eight (start, count) pairs would take
// sixteen) and pushes the internal ones that hit; a lane holding a leaf
// stops walking. While any lane of the warp still walks without a held
// leaf, the warp walks on; then every holding lane tests its held leaves
// (test_held), and an occlusion hit ends the walk.
//
// Why the hits are the unpostponed walk's (the TPU kernel's order): a
// lane's window (far(): t_max, or the best t) changes only at its own leaf
// tests, and a lane pops nothing while it holds leaves. So each visit sees
// the window it sees when leaves are tested at once, the held leaves are
// tested in child order against the window they were found with (the
// unpostponed walk tests them within the visit, after its eight slab
// tests), and the pushes do not depend on the leaf tests. A push that
// overflows the stack at child c ends the walk after the leaves of children
// before c, as the unpostponed walk does: the mask keeps only those, and
// E_STACK is set after them unless they end the walk.
template <class Leaf>
__device__ __forceinline__ void postponed_wide_walk(unsigned warp, const float4* __restrict__ rows,
                                                    int n_wide, V3 o, V3 inv, float tmin,
                                                    Leaf& leaf, int* stack, bool walks) {
  const FatBvh& B = leaf.B;
  int sp = walks ? 1 : 0;
  stack[0] = 0;
  const float4* held_q = rows;
  unsigned held = 0u;     // the hit leaf children of the wide node at held_q
  bool overflow = false;  // a push of the visit that found them overflowed
  while (true) {
    if (held == 0u && sp > 0) {
      const int node = stack[--sp];
      if (node < 0 || node >= n_wide) {
        *B.err = E_INDEX;
        sp = 0;
      } else {
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
            held |= 1u << c;
          } else if (b.w < -0.5f) {
            if (sp >= kMaxStack) {
              sp = 0;
              if (held) {
                overflow = true;
              } else {
                *B.err = E_STACK;
              }
              break;
            }
            stack[sp++] = __float2int_rz(b.z);
          }
        }
        held_q = q;
      }
    }
    if (__any_sync(warp, held == 0u && sp > 0)) continue;  // a lane still looks for a leaf
    if (!__any_sync(warp, held != 0u)) return;  // every lane has ended
    if (held) {
      if (test_held(leaf, held_q, held)) {
        sp = 0;
      } else if (overflow) {
        *B.err = E_STACK;
      }
      held = 0u;
      overflow = false;
    }
  }
}

// rays [n, 8]: origin, direction, t_min, t_max (ops/traverse.pack_rays)
template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
traverse8_kernel(const float4* __restrict__ rays, const float4* __restrict__ nodes, int n_wide,
                 FatBvh L, const float4* __restrict__ rec, int n_rays, int cull,
                 float* __restrict__ t_out, int* __restrict__ slot_out,
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
    AnyRecLeaf leaf(L, rec, o, d, tmin, tmax);
    // zero directions mark dead lanes (the integrator's inactive shadow rays)
    const bool live = fabsf(d.x) + fabsf(d.y) + fabsf(d.z) >= 1e-30f;
    postponed_wide_walk(warp, nodes, n_wide, o, safe_inv(d), tmin, leaf, stack, live);
    occ_out[i] = leaf.occluded ? 1 : 0;
  } else {
    ClosestRecLeaf leaf(L, rec, o, d, tmin, tmax, cull != 0);
    postponed_wide_walk(warp, nodes, n_wide, o, safe_inv(d), tmin, leaf, stack, true);
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
//   multiple of 8: n_rows / 8 wide nodes), rec = ft_test [n_slots, 20] f32
//   (16-byte aligned: each leaf slot's record); occlusion != 0 writes occ
//   [n_rays] (bool bytes), else t, u, v [n_rays] f32 and slot [n_rays] i32
//   (-1 on a miss); err [1] i32 must be 0 on entry and is set to 1 (stack
//   overflow) or 2 (index out of range).
//   Returns cudaGetLastError() (0 on success).
extern "C" int dxr_traverse8(const float* rays, const float* nodes, const float* rec, int n_rays,
                             int n_rows, int n_slots, int occlusion, int cull, float* t, int* slot,
                             float* u, float* v, unsigned char* occ, int* err, void* stream) {
  if (n_rays < 0 || n_rows < kWidth || n_rows % kWidth || n_slots < 1 || rec == nullptr ||
      reinterpret_cast<uintptr_t>(rec) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return 0;
  FatBvh L{nullptr, nullptr, 0, n_slots, err};  // the leaf tests' slots
  const float4* rc = reinterpret_cast<const float4*>(rec);
  const float4* w = reinterpret_cast<const float4*>(nodes);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const float4* r = reinterpret_cast<const float4*>(rays);
  cudaStream_t s = (cudaStream_t)stream;
  if (occlusion) {
    traverse8_kernel<true><<<blocks, kThreads, 0, s>>>(r, w, n_rows / kWidth, L, rc, n_rays, 0,
                                                       t, slot, u, v, occ);
  } else {
    traverse8_kernel<false><<<blocks, kThreads, 0, s>>>(r, w, n_rows / kWidth, L, rc, n_rays,
                                                        cull, t, slot, u, v, occ);
  }
  return (int)cudaGetLastError();
}
