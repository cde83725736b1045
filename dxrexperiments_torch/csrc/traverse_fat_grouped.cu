// Grouped fat-node packet walk kernel (B4c) for Hopper (sm_90a).
//
// Replaces the TPU kernel _make_traverse_fat_grouped_kernel
// (dxrexperiments_tpu/ops/traverse_pallas.py:873, launched by
// _call_fat_grouped), reached from traverse_fat_closest / traverse_fat_any
// with group > 1, in both of its modes: closest hit (t, leaf slot, u, v) and
// occlusion.
//
// What it computes: a packet of `tile` consecutive rays walks the fat-node
// BVH on ONE stack. At each node every lane slab-tests both children
// against its window (t_min, min(t_max, best)] (an occluded or
// zero-direction occlusion lane has an empty window); a child is taken if
// any lane hits it. Hit leaves are handled child 0 first: each lane
// re-tests the leaf box, and the pair test runs in every sub-packet of
// R = tile / group rays that holds a live lane, all R lanes of it. Two hit
// internal children are pushed so that the one with the smaller
// packet-minimum entry t pops first (ties to child 0). Occlusion ends
// once every lane is occluded. ops/traverse.fat_packet_walk_numpy(lag=False)
// is its host model, step for step.
//
// What bounds it: latency and barriers, not bytes or flops. Every node step
// needs a block-wide decision (any lane hit? the smallest entry t?), so the
// whole packet waits on its slowest warp at each step, and an incoherent
// packet visits the union of its rays' paths. Design answer: one packet per
// block, one ray per thread up to 1,024 rays and two per thread at 2,048
// (the JAX kernel's TILE_R); the stack lives in shared memory, written by
// thread 0, its top kept in registers so that a pop after a push needs no
// extra barrier; one barrier per step reduces the per-warp votes
// (__any_sync) and entry minima (warp shuffles) through shared memory,
// double-buffered by step parity; a leaf costs one more barrier, where a
// warp ballot per 32 rays says which sub-packets run their pair tests. The
// pair test and the closest-hit merge are common.cuh's (ClosestLeaf,
// AnyLeaf), as B4a runs them. What the TPU kernel does for Mosaic has no
// counterpart here: the [n_tiles, 8, G, R] block layout, the SMEM scalar
// loop and the double-buffered leaf DMA, which tests each leaf one enqueue
// late (the lag changes which nodes a stale best fails to prune, never the
// winner).
//
// The stack holds kMaxStack (96) entries; an overflow sets the error flag
// to 1, a node or slot index outside the arrays sets it to 2, and the block
// stops (the wrapper raises).

#include "common.cuh"

namespace {

using namespace dxr;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxRayWarps = 2048 / 32;  // 32-ray groups of the largest packet

struct Shared {
  int stack[kMaxStack];
  unsigned any[2][kMaxWarps];         // [step parity][warp]: bit c = a lane hit child c
  float enter[2][2][kMaxWarps];       // [step parity][child][warp]: smallest entry t
  unsigned live[2][kMaxRayWarps];     // [leaf 0/1 of the step][ray warp]: live lanes
};

template <bool kOcc>
struct LeafOf {
  using T = ClosestLeaf;
};
template <>
struct LeafOf<true> {
  using T = AnyLeaf;
};

// The packet's lanes: a thread's kR rays j = 0..kR-1 are rays
// j * blockDim.x + threadIdx.x of the packet.
template <bool kOcc, int kR>
struct Lanes {
  using Leaf = typename LeafOf<kOcc>::T;
  Leaf (&L)[kR];
  V3 inv[kR];
  bool present[kR];  // the ray exists (the last packet may be short)
  bool dead[kR];     // occlusion: a zero direction, never occluded

  // The lane takes part in slab tests and pair tests.
  __device__ __forceinline__ bool active(int j) const {
    if (!present[j]) return false;
    if constexpr (kOcc) return !dead[j] && !L[j].occluded;
    return true;
  }
  // The far end of the lane's window: min(t_max, best), or t_max.
  __device__ __forceinline__ float far(int j) const { return L[j].far(); }
};

__device__ __forceinline__ V3 box_lo(const float* f) { return v3(f[0], f[1], f[2]); }
__device__ __forceinline__ V3 box_hi(const float* f) { return v3(f[3], f[4], f[5]); }

// Re-test a hit leaf per lane and run its pair test in the sub-packets
// with a live lane. `buf` separates the step's two leaves in shared memory.
// Returns false (error flag set) if the leaf lies outside mt_rows.
template <bool kOcc, int kR>
__device__ __forceinline__ bool process_leaf(Shared& S, const FatBvh& B, Lanes<kOcc, kR>& P,
                                             int start, int count, V3 lo, V3 hi, int buf,
                                             int sub_warps) {
  if (start < 0 || count < 0 || start + count > B.n_slots) {
    if (threadIdx.x == 0) *B.err = E_INDEX;
    return false;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    float tn;
    const bool live = P.active(j) && slab(lo, hi, P.L[j].o, P.inv[j], P.L[j].tmin, P.far(j), &tn);
    const unsigned votes = __ballot_sync(kFull, live);
    if (lane == 0) S.live[buf][j * n_warps + warp] = votes;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int g0 = (j * n_warps + warp) / sub_warps * sub_warps;  // the sub-packet's first warp
    bool run = false;
    for (int w = g0; w < g0 + sub_warps; ++w) run |= S.live[buf][w] != 0u;
    if (run && P.active(j)) P.L[j].visit(start, count);
  }
  return true;
}

template <bool kOcc, int kR>
__device__ __forceinline__ void packet_walk(Shared& S, const FatBvh& B, Lanes<kOcc, kR>& P,
                                            int sub_warps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int sp = 1, top = 0, parity = 0;
  bool top_known = true;  // the node on top of the stack, without reading it back
  if (threadIdx.x == 0) S.stack[0] = 0;
  while (sp > 0) {
    const int node = top_known ? top : S.stack[sp - 1];
    --sp;
    if (node < 0 || node >= B.n_nodes) {
      if (threadIdx.x == 0) *B.err = E_INDEX;
      return;
    }
    const float4* q = B.nodes + 4 * node;
    const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), m = __ldg(q + 3);
    const float f[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
    bool h0 = false, h1 = false;
    float e0 = kBig, e1 = kBig;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (!P.active(j)) continue;
      const float tf = P.far(j);
      float tn0, tn1;
      if (slab(box_lo(f), box_hi(f), P.L[j].o, P.inv[j], P.L[j].tmin, tf, &tn0)) {
        h0 = true;
        e0 = fminf(e0, tn0);
      }
      if (slab(box_lo(f + 6), box_hi(f + 6), P.L[j].o, P.inv[j], P.L[j].tmin, tf, &tn1)) {
        h1 = true;
        e1 = fminf(e1, tn1);
      }
    }
    const unsigned bits = (__any_sync(kFull, h0) ? 1u : 0u) | (__any_sync(kFull, h1) ? 2u : 0u);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      e0 = fminf(e0, __shfl_xor_sync(kFull, e0, off));
      e1 = fminf(e1, __shfl_xor_sync(kFull, e1, off));
    }
    if (lane == 0) {
      S.any[parity][warp] = bits;
      S.enter[parity][0][warp] = e0;
      S.enter[parity][1][warp] = e1;
    }
    __syncthreads();
    unsigned hits = 0u;
    float enter0 = kBig, enter1 = kBig;
    for (int w = 0; w < n_warps; ++w) {
      hits |= S.any[parity][w];
      enter0 = fminf(enter0, S.enter[parity][0][w]);
      enter1 = fminf(enter1, S.enter[parity][1][w]);
    }
    parity ^= 1;
    const int ptr0 = __float2int_rz(m.x), ptr1 = __float2int_rz(m.z);
    // leaves first, child 0 before child 1, each tested at once
    if ((hits & 1u) && m.y > 0.5f &&
        !process_leaf(S, B, P, ptr0, __float2int_rz(m.y), box_lo(f), box_hi(f), 0, sub_warps)) {
      return;
    }
    if ((hits & 2u) && m.w > 0.5f &&
        !process_leaf(S, B, P, ptr1, __float2int_rz(m.w), box_lo(f + 6), box_hi(f + 6), 1,
                      sub_warps)) {
      return;
    }
    const bool int0 = (hits & 1u) && m.y < -0.5f, int1 = (hits & 2u) && m.w < -0.5f;
    const int pushes = (int)int0 + (int)int1;
    if (sp + pushes > kMaxStack) {
      if (threadIdx.x == 0) *B.err = E_STACK;
      return;
    }
    if (int0 && int1) {
      const bool near0 = enter0 <= enter1;  // the far child pushed first, the near one pops next
      const int first = near0 ? ptr1 : ptr0, second = near0 ? ptr0 : ptr1;
      if (threadIdx.x == 0) {
        S.stack[sp] = first;
        S.stack[sp + 1] = second;
      }
      sp += 2;
      top = second;
    } else if (pushes) {
      top = int0 ? ptr0 : ptr1;
      if (threadIdx.x == 0) S.stack[sp] = top;
      sp += 1;
    }
    top_known = pushes > 0;
    if constexpr (kOcc) {
      bool done = true;
#pragma unroll
      for (int j = 0; j < kR; ++j) done = done && !P.active(j);
      if (__syncthreads_and(done)) return;
    }
  }
}

template <bool kOcc, int kR>
__global__ void __launch_bounds__(kMaxThreads)
traverse_fat_grouped_kernel(const float4* __restrict__ rays, FatBvh B, int n_rays, int tile,
                            int sub_warps, int common_origin, int cull,
                            float* __restrict__ t_out, int* __restrict__ slot_out,
                            float* __restrict__ u_out, float* __restrict__ v_out,
                            unsigned char* __restrict__ occ_out) {
  using Leaf = typename LeafOf<kOcc>::T;
  __shared__ Shared S;
  const V3 o0 = common_origin ? v3(__ldg(rays).x, __ldg(rays).y, __ldg(rays).z) : v3(0, 0, 0);
  int ray[kR];
  V3 o[kR], d[kR];
  float tmin[kR], tmax[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    ray[j] = blockIdx.x * tile + j * blockDim.x + threadIdx.x;
    const bool present = ray[j] < n_rays && j * (int)blockDim.x + (int)threadIdx.x < tile;
    const int i = present ? ray[j] : 0;
    const float4 r0 = __ldg(rays + 2 * i), r1 = __ldg(rays + 2 * i + 1);
    o[j] = common_origin ? o0 : v3(r0.x, r0.y, r0.z);
    d[j] = v3(r0.w, r1.x, r1.y);
    tmin[j] = r1.z;
    tmax[j] = r1.w;
    if (!present) ray[j] = -1;
  }
  auto make = [&](int j) {
    if constexpr (kOcc) {
      return Leaf(B, o[j], d[j], tmin[j], tmax[j]);
    } else {
      return Leaf(B, o[j], d[j], tmin[j], tmax[j], cull != 0);
    }
  };
  auto run = [&](Leaf(&L)[kR]) {
    Lanes<kOcc, kR> P{L};
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      P.inv[j] = safe_inv(d[j]);
      P.present[j] = ray[j] >= 0;
      P.dead[j] = kOcc && fabsf(d[j].x) + fabsf(d[j].y) + fabsf(d[j].z) < 1e-30f;
    }
    packet_walk(S, B, P, sub_warps);
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int i = ray[j];
      if (i < 0) continue;
      if constexpr (kOcc) {
        occ_out[i] = L[j].occluded ? 1 : 0;
      } else {
        const bool hit = L[j].hit();
        t_out[i] = hit ? L[j].best_t : -1.0f;
        slot_out[i] = hit ? L[j].best_slot : -1;
        u_out[i] = hit ? L[j].u() : 0.0f;
        v_out[i] = hit ? L[j].v() : 0.0f;
      }
    }
  };
  if constexpr (kR == 1) {
    Leaf L[1] = {make(0)};
    run(L);
  } else {
    Leaf L[2] = {make(0), make(1)};
    run(L);
  }
}

template <bool kOcc>
int launch(const float4* r, const FatBvh& B, int n_rays, int tile, int sub_warps, int common_origin,
           int cull, float* t, int* slot, float* u, float* v, unsigned char* occ,
           cudaStream_t s) {
  const int blocks = (n_rays + tile - 1) / tile;
  if (tile <= kMaxThreads) {
    traverse_fat_grouped_kernel<kOcc, 1><<<blocks, tile, 0, s>>>(
        r, B, n_rays, tile, sub_warps, common_origin, cull, t, slot, u, v, occ);
  } else {
    traverse_fat_grouped_kernel<kOcc, 2><<<blocks, tile / 2, 0, s>>>(
        r, B, n_rays, tile, sub_warps, common_origin, cull, t, slot, u, v, occ);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One launch over n_rays rays on `stream`, in packets of `tile` rays (one
// block each) cut into `group` sub-packets: tile % group == 0, tile / group
// a multiple of 32 and tile <= 2048 (ops/traverse.check_grouping), else
// cudaErrorInvalidValue. common_origin != 0: every ray starts at ray 0's
// origin. The other arguments as for dxr_traverse_fat (csrc/traverse_fat.cu):
//   rays [n_rays, 8] f32, nodes = bvhf_rows [n_nodes, 16] f32, rows = mt_rows
//   [n_slots, 128] f32; occlusion != 0 writes occ [n_rays] (bool bytes),
//   else t, u, v [n_rays] f32 and slot [n_rays] i32 (-1 on a miss); err [1]
//   i32 must be 0 on entry and is set to 1 (stack overflow) or 2 (index out
//   of range). Returns cudaGetLastError() (0 on success).
extern "C" int dxr_traverse_fat_grouped(const float* rays, const float* nodes, const float* rows,
                                        int n_rays, int n_nodes, int n_slots, int occlusion,
                                        int cull, int tile, int group, int common_origin,
                                        float* t, int* slot, float* u, float* v,
                                        unsigned char* occ, int* err, void* stream) {
  if (n_rays < 0 || n_nodes < 1 || n_slots < 1 || group < 2 || tile < group || tile % group ||
      (tile / group) % 32 || tile > 2 * kMaxThreads || (tile > kMaxThreads && tile % 64)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return 0;
  FatBvh B{reinterpret_cast<const float4*>(nodes), rows, n_nodes, n_slots, err};
  const float4* r = reinterpret_cast<const float4*>(rays);
  const int sub_warps = tile / group / 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (occlusion) return launch<true>(r, B, n_rays, tile, sub_warps, 0, 0, t, slot, u, v, occ, s);
  return launch<false>(r, B, n_rays, tile, sub_warps, common_origin, cull, t, slot, u, v, occ, s);
}
