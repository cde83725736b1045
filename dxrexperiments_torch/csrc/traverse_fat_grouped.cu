// Grouped fat-node packet walk kernel (B4c) for Hopper (sm_90a).
//
// Replaces the TPU kernel _make_traverse_fat_grouped_kernel
// (dxrexperiments_tpu/ops/traverse_pallas.py:873, launched by
// _call_fat_grouped), reached from traverse_fat_closest / traverse_fat_any
// with group > 1, in both of its modes: closest hit (t, leaf slot, u, v) and
// occlusion.
//
// What it computes: a packet of consecutive rays walks the fat-node BVH on
// ONE stack. At each node every lane slab-tests both children against its
// window (t_min, min(t_max, best)] (an occluded or zero-direction occlusion
// lane has an empty window); a child is taken if any lane hits it. Hit
// leaves are handled child 0 first: each lane re-tests the leaf box, and
// the pair test runs in every active lane of a sub-packet that holds a live
// lane. Two hit internal children are pushed so that the one with the
// smaller packet-minimum entry t pops first (ties to child 0). Occlusion
// ends once every lane is occluded. ops/traverse.fat_packet_walk_numpy(
// packet=32) is its host model, step for step.
//
// The packet on this card is a warp: 32 consecutive rays. The TPU kernel's
// packet is its tile of `tile` rays, cut into `group` sub-packets of R =
// tile / group rays, because Mosaic broadcasts a decision to 1,024 lanes
// at least and gates pair tests per sub-packet below that. Here the unit
// that runs in lockstep is the warp, and R is a multiple of 32 whose
// sub-packets start at multiples of 32 (check_grouping), so every warp lies
// inside one sub-packet and one tile: with the warp as the packet, its
// sub-packet is the warp itself whatever the layout, and `tile` and `group`
// select no different walk (the entry point still refuses a layout the TPU
// kernel refuses). A packet of 1,024-2,048 rays would make one block wait
// on its slowest warp at every step (two barriers a step) and walk the
// union of 1,024-2,048 rays' paths; a warp needs no barrier and walks the
// union of 32.
//
// What bounds it: latency and divergence, as for B4a. Design answer: one
// ray per thread, four packets a block (blocks of 128 threads, so a 512^2
// launch has 2,048 blocks); every decision is a warp vote (__any_sync,
// __all_sync) and the entry-t minima take five butterfly shuffles, only at
// a node whose two internal children are both taken; the stack is spread
// over the lanes' registers (entry e in lane e % 32's register e / 32,
// read by a shuffle) with its top kept in registers, so a pop after a push
// reads nothing. The pair test and the closest-hit merge are rec_leaf.cuh's
// (ClosestRecLeaf, AnyRecLeaf), as B4a runs them: a slot's coefficients
// read as one record of five float4s from the BVH's ft_test. What the TPU
// kernel does for Mosaic has no counterpart here: the [n_tiles, 8, G, R]
// block layout, the SMEM scalar loop and the double-buffered leaf DMA,
// which tests each leaf one enqueue late (the lag changes which nodes a
// stale best fails to prune, never the winner).
//
// The stack holds kMaxStack (96) entries; an overflow sets the error flag
// to 1, a node or slot index outside the arrays sets it to 2, and the
// packet stops (the wrapper raises).

#include "rec_leaf.cuh"

namespace {

using namespace dxr;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // four warp packets a block
static_assert(kMaxStack == 3 * 32, "the stack is three registers a lane");

template <bool kOcc>
struct LeafOf {
  using T = ClosestRecLeaf;
};
template <>
struct LeafOf<true> {
  using T = AnyRecLeaf;
};

// One lane of a warp packet.
template <bool kOcc>
struct Lane {
  typename LeafOf<kOcc>::T& L;
  V3 inv;
  bool present;  // the ray exists (the last warp may be short)
  bool dead;     // occlusion: a zero direction, never occluded

  // The lane takes part in slab tests and pair tests.
  __device__ __forceinline__ bool active() const {
    if (!present) return false;
    if constexpr (kOcc) return !dead && !L.occluded;
    return true;
  }
};

// The packet's stack, entry e in lane e % 32's register s[e / 32]. Every
// lane calls push and pop with the same arguments.
struct WarpStack {
  int s0, s1, s2;
  __device__ __forceinline__ void push(int e, int node, int lane) {
    if (lane == (e & 31)) {
      if (e < 32) {
        s0 = node;
      } else if (e < 64) {
        s1 = node;
      } else {
        s2 = node;
      }
    }
  }
  __device__ __forceinline__ int read(int e) const {
    return __shfl_sync(kFull, e < 32 ? s0 : (e < 64 ? s1 : s2), e & 31);
  }
};

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Re-test a hit leaf per lane and run its pair test in the active lanes if
// any lane is live. Returns false (error flag set) if the leaf lies outside
// the slots.
template <bool kOcc>
__device__ __forceinline__ bool process_leaf(const FatBvh& B, Lane<kOcc>& P, int start, int count,
                                             V3 lo, V3 hi) {
  if (start < 0 || count < 0 || start + count > B.n_slots) {
    if ((threadIdx.x & 31) == 0) *B.err = E_INDEX;
    return false;
  }
  float tn;
  const bool live = P.active() && slab(lo, hi, P.L.o, P.inv, P.L.tmin, P.L.far(), &tn);
  if (__any_sync(kFull, live) && P.active()) P.L.visit(start, count);
  return true;
}

template <bool kOcc>
__device__ __forceinline__ void packet_walk(const FatBvh& B, Lane<kOcc>& P) {
  const int lane = threadIdx.x & 31;
  WarpStack st{0, 0, 0};
  int sp = 1, top = 0;
  bool top_known = true;  // the node on top of the stack, without reading it back
  while (sp > 0) {
    const int node = top_known ? top : st.read(sp - 1);
    --sp;
    if (node < 0 || node >= B.n_nodes) {
      if (lane == 0) *B.err = E_INDEX;
      return;
    }
    const float4* q = B.nodes + 4 * node;
    const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), m = __ldg(q + 3);
    const V3 lo0 = v3(a.x, a.y, a.z), hi0 = v3(a.w, b.x, b.y);
    const V3 lo1 = v3(b.z, b.w, c.x), hi1 = v3(c.y, c.z, c.w);
    bool h0 = false, h1 = false;
    float tn0 = kBig, tn1 = kBig;
    if (P.active()) {
      const float tf = P.L.far();
      h0 = slab(lo0, hi0, P.L.o, P.inv, P.L.tmin, tf, &tn0);
      h1 = slab(lo1, hi1, P.L.o, P.inv, P.L.tmin, tf, &tn1);
    }
    const bool any0 = __any_sync(kFull, h0), any1 = __any_sync(kFull, h1);
    const int ptr0 = __float2int_rz(m.x), ptr1 = __float2int_rz(m.z);
    // leaves first, child 0 before child 1, each tested at once
    if (any0 && m.y > 0.5f && !process_leaf(B, P, ptr0, __float2int_rz(m.y), lo0, hi0)) return;
    if (any1 && m.w > 0.5f && !process_leaf(B, P, ptr1, __float2int_rz(m.w), lo1, hi1)) return;
    const bool int0 = any0 && m.y < -0.5f, int1 = any1 && m.w < -0.5f;
    const int pushes = (int)int0 + (int)int1;
    if (sp + pushes > kMaxStack) {
      if (lane == 0) *B.err = E_STACK;
      return;
    }
    if (int0 && int1) {
      // the packet's smallest entry t of each child; the far child pushed
      // first, the near one pops next
      const bool near0 = warp_min(h0 ? tn0 : kBig) <= warp_min(h1 ? tn1 : kBig);
      st.push(sp, near0 ? ptr1 : ptr0, lane);
      top = near0 ? ptr0 : ptr1;
      st.push(sp + 1, top, lane);
      sp += 2;
    } else if (pushes) {
      top = int0 ? ptr0 : ptr1;
      st.push(sp, top, lane);
      sp += 1;
    }
    top_known = pushes > 0;
    if constexpr (kOcc) {
      if (__all_sync(kFull, !P.active())) return;
    }
  }
}

// rays [n, 8]: origin, direction, t_min, t_max (ops/traverse.pack_rays)
template <bool kOcc>
__global__ void __launch_bounds__(kThreads)
traverse_fat_grouped_kernel(const float4* __restrict__ rays, FatBvh B,
                            const float4* __restrict__ rec, int n_rays, int common_origin,
                            int cull, float* __restrict__ t_out, int* __restrict__ slot_out,
                            float* __restrict__ u_out, float* __restrict__ v_out,
                            unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if ((i & ~31) >= n_rays) return;  // a warp without rays (the same for all its lanes)
  const bool present = i < n_rays;
  const int k = present ? i : 0;
  const float4 r0 = __ldg(rays + 2 * k), r1 = __ldg(rays + 2 * k + 1);
  const V3 o = common_origin ? v3(__ldg(rays).x, __ldg(rays).y, __ldg(rays).z)
                             : v3(r0.x, r0.y, r0.z);
  const V3 d = v3(r0.w, r1.x, r1.y);
  const float tmin = r1.z, tmax = r1.w;
  if constexpr (kOcc) {
    AnyRecLeaf leaf(B, rec, o, d, tmin, tmax);
    Lane<true> P{leaf, safe_inv(d), present,
                 fabsf(d.x) + fabsf(d.y) + fabsf(d.z) < 1e-30f};
    packet_walk(B, P);
    if (present) occ_out[i] = leaf.occluded ? 1 : 0;
  } else {
    ClosestRecLeaf leaf(B, rec, o, d, tmin, tmax, cull != 0);
    Lane<false> P{leaf, safe_inv(d), present, false};
    packet_walk(B, P);
    if (!present) return;
    const bool hit = leaf.hit();
    t_out[i] = hit ? leaf.best_t : -1.0f;
    slot_out[i] = hit ? leaf.best_slot : -1;
    u_out[i] = hit ? leaf.u() : 0.0f;
    v_out[i] = hit ? leaf.v() : 0.0f;
  }
}

}  // namespace

// One launch over n_rays rays on `stream`, in packets of 32 consecutive rays
// (one warp each). The TPU kernel's layout, packets of `tile` rays cut into
// `group` sub-packets, is checked and selects nothing else: tile % group
// == 0, tile / group a multiple of 32 and tile <= 2048, above 1024 a
// multiple of 64 (ops/traverse.check_grouping), else cudaErrorInvalidValue.
// common_origin != 0: every ray starts at ray 0's origin. The other
// arguments as for dxr_traverse_fat (csrc/traverse_fat.cu):
//   rays [n_rays, 8] f32, nodes = bvhf_rows [n_nodes, 16] f32, rec = ft_test
//   [n_slots, 20] f32 (16-byte aligned); occlusion != 0 writes occ [n_rays]
//   (bool bytes), else t, u, v [n_rays] f32 and slot [n_rays] i32 (-1 on a
//   miss); err [1] i32 must be 0 on entry and is set to 1 (stack overflow)
//   or 2 (index out of range). Returns cudaGetLastError() (0 on success).
extern "C" int dxr_traverse_fat_grouped(const float* rays, const float* nodes, const float* rec,
                                        int n_rays, int n_nodes, int n_slots, int occlusion,
                                        int cull, int tile, int group, int common_origin,
                                        float* t, int* slot, float* u, float* v,
                                        unsigned char* occ, int* err, void* stream) {
  if (n_rays < 0 || n_nodes < 1 || n_slots < 1 || group < 2 || tile < group || tile % group ||
      (tile / group) % 32 || tile > 2048 || (tile > 1024 && tile % 64) || rec == nullptr ||
      reinterpret_cast<uintptr_t>(rec) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return 0;
  FatBvh B{reinterpret_cast<const float4*>(nodes), nullptr, n_nodes, n_slots, err};
  const float4* r = reinterpret_cast<const float4*>(rays);
  const float4* rc = reinterpret_cast<const float4*>(rec);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (occlusion) {
    traverse_fat_grouped_kernel<true><<<blocks, kThreads, 0, s>>>(r, B, rc, n_rays, 0, 0, t, slot,
                                                                   u, v, occ);
  } else {
    traverse_fat_grouped_kernel<false><<<blocks, kThreads, 0, s>>>(r, B, rc, n_rays,
                                                                    common_origin, cull, t, slot,
                                                                    u, v, occ);
  }
  return (int)cudaGetLastError();
}
