// The binary-node BVH walk shared by kernels B4b (csrc/traverse_binary.cu)
// and B6b (csrc/traverse2_binary.cu), one ray per thread.
//
// It follows traverse_pallas._make_traverse_kernel's order of visits, which
// decides which triangle wins an equal-t tie: pop a node, slab-test its own
// box against (t_min, far], test a hit leaf's triangles at once, and push a
// hit internal node's left child, then its right one, so the right subtree
// is walked first. The far end is the running best t (closest) or t_max
// (occlusion), so a close hit prunes the subtrees still on the stack.
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

// Walk from node `root` (0 for a whole tree; a BLAS's first node among
// concatenated BLASes). Leaf provides far() and visit(start, count), which
// tests one leaf and returns true to end the walk. `stack` holds kCap
// entries; an overflow sets E_STACK and ends the walk, never a subtree.
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

}  // namespace dxr
