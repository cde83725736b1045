// The binary-node BVH walks of kernels B4b (csrc/traverse_binary.cu) and
// B6b (csrc/traverse2_binary.cu), one ray per thread. Both visit the nodes
// traverse_pallas._make_traverse_kernel visits, in its order, which
// decides which triangle wins an equal-t tie: the right subtree before the
// left, the far end of the window the running best t (closest) or t_max
// (occlusion), so a close hit prunes the subtrees still on the stack.
//
// binary_walk (B6b) is the JAX kernel's walk: pop a node, slab-test its own
// box against (t_min, far], test a hit leaf's triangles at once, and push a
// hit internal node's left child, then its right one.
//
// postponed_walk (B4b) tests a node's children when it is popped, both rows
// read at once (two independent pairs of float4 loads), and pushes only the
// children that hit, each with its links (its row's left and right words)
// and the entry t of its box. A popped entry is visited only if that t is
// still within the window (far() only falls, and min and max are exact, so
// this is the JAX kernel's own slab test of the node against the window of
// now); a leaf entry is tested without reading its row. An occlusion walk
// keeps no entry t (its window never shrinks). It also postpones leaf
// tests (Aila and Laine, "Understanding the Efficiency of Ray Traversal on
// GPUs", HPG 2009: the while-while loop): a lane that pops a leaf holds it
// and waits while the other lanes of its warp walk on; once every lane
// still walking holds a leaf or has ended, the warp tests the held leaves
// together, each re-checked against its ray's window of that moment. A
// lane tests its leaves in its own order and prunes with the window they
// leave, so the leaves tested, their order and the hits are the walk's
// without postponement; what changes is that a warp pays for a round of
// leaf tests once, not once per turn in which some lane tests one.
//
// B6b keeps the JAX kernel's walk: the children tested at the parent made
// its depth-0 shadow launch 20-23% slower and the sum of its four launches
// 2-4% slower, and postponement among the lanes that enter instances at
// the same TLAS turn was slower too (PERF.md, PR 12).
//
// Kept out of common.cuh so that the fat-node kernels (B4a, B5, B6a), which
// include that header, compile exactly as before.

#pragma once

#include "common.cuh"

namespace dxr {

// Binary nodes, one 32-byte row per node (bvh_rows, tlas_rows, blas_rows
// [M, 8] f32): lo3, hi3, left, right. Internal: left/right = child node
// ids; leaf: left = -(start+1), right = count (B4b: leaf slots; a TLAS leaf:
// start = instance slot, count 1). Ids are exact floats below 2^24 and are
// read with __float2int_rz; a child outside the array sets E_INDEX.
struct BinNodes {
  const float4* nodes;  // [n_nodes][2] float4
  int n_nodes;
  int* err;  // device error flag (E_STACK, E_INDEX)
};

// The JAX kernel's walk (B6b) from node `root` (0 for a whole tree; a
// BLAS's first node among concatenated BLASes). Leaf provides far() and
// visit(start, count), which tests one leaf and returns true to end the
// walk. `stack` holds kCap entries; an overflow sets E_STACK and ends the
// walk, never a subtree.
template <class Leaf, int kCap = kMaxStack>
__device__ __forceinline__ void binary_walk(const BinNodes& N, V3 o, V3 inv, float tmin,
                                            Leaf& leaf, int* stack, int root = 0) {
  int sp = 1;
  stack[0] = root;
  while (sp > 0) {
    const int node = stack[--sp];
    if (node < 0 || node >= N.n_nodes) {
      *N.err = E_INDEX;
      return;
    }
    const float4 a = __ldg(N.nodes + 2 * node), b = __ldg(N.nodes + 2 * node + 1);
    float tn;
    if (!slab(v3(a.x, a.y, a.z), v3(a.w, b.x, b.y), o, inv, tmin, leaf.far(), &tn)) continue;
    if (b.z < 0.0f) {
      if (leaf.visit(__float2int_rz(-b.z - 1.0f), __float2int_rz(b.w))) return;
      continue;
    }
    if (sp + 2 > kCap) {
      *N.err = E_STACK;
      return;
    }
    stack[sp++] = __float2int_rz(b.z);  // left: walked after the right subtree
    stack[sp++] = __float2int_rz(b.w);
  }
}

// A walk's stack of kCap entries: each entry's links and, where the window
// can shrink (kEntryT), the entry t of its box.
template <int kCap, bool kEntryT>
struct BinStack {
  int2 link[kCap];
  float tn[kEntryT ? kCap : 1];
  int sp;

  __device__ __forceinline__ void push(float4 row_b, float t) {
    link[sp] = make_int2(__float2int_rz(row_b.z), __float2int_rz(row_b.w));
    if (kEntryT) tn[sp] = t;
    ++sp;
  }
};

// Start a walk at node `root`: its own box slab-tested against (tmin, tf]
// and, if it hits, pushed. An index outside the nodes sets E_INDEX.
template <bool kAny, int kCap>
__device__ __forceinline__ void begin(const BinNodes& N, int root, V3 o, V3 inv, float tmin,
                                      float tf, BinStack<kCap, !kAny>& st) {
  st.sp = 0;
  if (root < 0 || root >= N.n_nodes) {
    *N.err = E_INDEX;
    return;
  }
  const float4 a = __ldg(N.nodes + 2 * root), b = __ldg(N.nodes + 2 * root + 1);
  float tn;
  if (slab(v3(a.x, a.y, a.z), v3(a.w, b.x, b.y), o, inv, tmin, tf, &tn)) st.push(b, tn);
}

// Visit internal entry e: slab-test both children against (tmin, tf] and
// push those that hit, the left first so that the right pops first. An
// index outside the nodes sets E_INDEX, an overflow E_STACK; either empties
// the stack, which ends the walk (never a subtree alone).
template <bool kAny, int kCap>
__device__ __forceinline__ void expand(const BinNodes& N, int2 e, V3 o, V3 inv, float tmin,
                                       float tf, BinStack<kCap, !kAny>& st) {
  if (e.x >= N.n_nodes || e.y < 0 || e.y >= N.n_nodes) {
    *N.err = E_INDEX;
    st.sp = 0;
    return;
  }
  const float4 la = __ldg(N.nodes + 2 * e.x), lb = __ldg(N.nodes + 2 * e.x + 1);
  const float4 ra = __ldg(N.nodes + 2 * e.y), rb = __ldg(N.nodes + 2 * e.y + 1);
  float tl, tr;
  const bool hl = slab(v3(la.x, la.y, la.z), v3(la.w, lb.x, lb.y), o, inv, tmin, tf, &tl);
  const bool hr = slab(v3(ra.x, ra.y, ra.z), v3(ra.w, rb.x, rb.y), o, inv, tmin, tf, &tr);
  if (st.sp + (int)hl + (int)hr > kCap) {
    *N.err = E_STACK;
    st.sp = 0;
    return;
  }
  if (hl) st.push(lb, tl);
  if (hr) st.push(rb, tr);
}

// B4b's walk from node 0, children tested at the parent, with leaf
// postponement, for the lanes `warp` (each ray on its own stack; every lane
// of the mask calls it, `walks` false for a lane with no walk to make): a
// lane that pops a leaf holds it while the others walk on, and once no
// lane is still looking for a leaf, the lanes that hold one test it,
// re-checked against the window of that moment. Leaf provides far() and
// visit(start, count), as for binary_walk.
template <bool kAny, class Leaf, int kCap>
__device__ __forceinline__ void postponed_walk(unsigned warp, const BinNodes& N, V3 o, V3 inv,
                                               float tmin, Leaf& leaf,
                                               BinStack<kCap, !kAny>& st, bool walks) {
  st.sp = 0;
  if (walks) begin<kAny>(N, 0, o, inv, tmin, leaf.far(), st);
  int2 held = make_int2(0, 0);
  float held_t = 0.0f;
  bool holding = false;
  while (true) {
    if (!holding && st.sp > 0) {
      --st.sp;
      const int2 e = st.link[st.sp];
      const float tn = kAny ? 0.0f : st.tn[st.sp];
      if (e.x < 0) {
        holding = true;
        held = e;
        held_t = tn;
      } else if (kAny || tn <= leaf.far()) {  // else pruned since it was pushed
        expand<kAny>(N, e, o, inv, tmin, leaf.far(), st);
      }
    }
    if (__any_sync(warp, !holding && st.sp > 0)) continue;  // a lane still looks for a leaf
    if (!__any_sync(warp, holding)) return;  // every lane has ended
    if (holding) {
      holding = false;
      if ((kAny || held_t <= leaf.far()) && leaf.visit(-held.x - 1, held.y)) st.sp = 0;
    }
  }
}

}  // namespace dxr
