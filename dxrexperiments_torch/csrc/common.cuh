// Device code shared by the sample megakernels (B1 csrc/fused_sample.cu, B5
// csrc/fused_traverse.cu) and the fat-node walk kernels (B4a
// csrc/traverse_fat.cu, B6a csrc/traverse2_fat.cu).
//
// 1. The per-pixel ray tree of the reference shaders: raygen, the TEA/LCG
//    draws, direct lighting with its shadow rays, the depth-1 radiance of a
//    bounce, the Phong lobe, and the whole progressive sample
//    (sample_pixel) or realtime frame (realtime_pixel). It is templated on a
//    trace backend Tr, which provides
//      Hit closest(V3 o, V3 d, float tmin, bool cull) const;
//      bool occluded(V3 o, V3 d, float tmin, bool has_tmax, float tmax) const;
//      float a(int field, int row) const;  // material field A_* of Hit::row
//      float albedo(const Hit& h, int k) const;  // channel k of h's albedo
//      int rig;  // lights present: 1 directional, 2 point (B1: always 3)
//      static constexpr bool kArea;  // one area light (B5's area mode)
//      const float* area;  // with kArea: the area pack (AC_* lanes)
//    B1's backend sweeps every triangle staged in shared memory; B5's walks
//    the fat-node BVH with rec_leaf.cuh's postponed walk. Both read a triangle's coefficients as one
//    80-byte record of five float4s (RecCoef). B5's albedo-texture mode
//    multiplies each closest hit's albedo by the texture at its UV
//    (sample_albedo) before any use of it.
// 2. The fat-node BVH walk of traverse_pallas._make_traverse_fat_kernel,
//    one ray per thread: each visit tests both children's boxes against
//    the ray's window clipped by the running best t, tests a hit leaf's
//    triangles at once, and pushes the hit internal children far first so
//    the near one pops next. The stack holds kMaxStack entries; an overflow
//    sets the error flag (the wrapper raises), it never drops a subtree.
//    B6a runs this walk on the TLAS, whose leaf visit walks a BLAS with
//    the leaf test's ray moved into object space (set_ray); B4a and B5 run
//    it with leaf postponement (rec_leaf.cuh postponed_fat_walk).
//
// 3. The area light (area_light_term, B5's area mode): kAreaSamples
//    stratified points on the quad, drawn from the pixel's TEA seed by a
//    chain of their own (scene/lights.area_light_draws), one shadow walk
//    each; and the albedo textures (sample_albedo): four float32 taps with
//    WRAP on both axes from the flat [R][3] texel table, as
//    scene/textures.sample_albedo reads them.
//
// 4. The miss shader's environment (env_color): constant and gradient from
//    the const pack, and the lat-long and cubemap textures of
//    scene/envmap.py, looked up at every miss of the ray tree. The TPU kernel
//    wrote the bounce directions and env weights out for a gather pass
//    outside it (its env-deferred mode), since gathers do not lower in
//    Mosaic; here a texel is an ordinary load, so the lookup stays inside
//    the kernel and nothing is written out for it. Four float32 taps with
//    float32 weights (__ldg; no hardware-filtered texture fetch, whose 9-bit
//    weights would not hold the image gate on HDR radiance), from the plain
//    [h][w][3] or [6][s][s][3] texture (an 8192 x 4096 lat-long, the size
//    BASELINE config 3 loads, is 403 MB, past the 50 MB L2; the quad-packed
//    table of the TPU layout would be 4x that).
//
// Arithmetic follows the TPU kernels: the same term sums, the same
// sign-multiplied validity windows, t = ts / max(|det|, 1e-12), ties to the
// lowest row, strict '<' across leaves, and the same draw routing. Build
// without --use_fast_math (IEEE sqrtf, division, sinf, cosf, expf, powf,
// atan2f, acosf).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dxr {

constexpr float kBig = 3.0e38f;
constexpr float kRayFar = 3.0e37f;  // finite "infinity" of the BVH walks' windows
constexpr float kRayEps = 1.0e-4f;
constexpr float kDetEps = 1.0e-12f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInvPi = 0.318309886183790671538f;  // float32(1 / pi), envmap._INV_PI
constexpr int kMaxStack = 96;  // traverse_pallas.MAX_STACK
constexpr int kRowLanes = 128;  // mt_rows row width

// const pack [2, 16]: row 0 lights + env colour 0, row 1 flags + env colour 1
enum { C_DLDIR = 0, C_DLCI = 3, C_PLPOS = 6, C_PLCI = 9, C_ENV0 = 12, C_STRENGTH = 15 };
enum {
  F_COSINE = 16, F_NO_IND, F_IS_MC, F_SHOW_DIRECT, F_SHOW_ALBEDO,
  F_SHOW_FRESNEL, F_SHOW_IND_SPEC, F_SHOW_IND_DIFF, F_ENV1
};
// attr_pack rows; the material fields A_ALBEDO..A_TYPE name what a backend's
// a(field, row) returns
enum {
  A_N0 = 0, A_N1 = 3, A_N2 = 6, A_ALBEDO = 10, A_SPECULAR = 13,
  A_EMISSIVE = 16, A_ESTR = 19, A_REFL = 20, A_ROUGH = 21, A_IOR = 22, A_TYPE = 23
};
// Möller–Trumbore coefficient slots: det = D.s[0:3]; u*det = D.s[3:6] +
// M.s[6:9]; v*det = D.s[9:12] + M.s[12:15]; t*det = O.s[15:18] + s[18]
enum { S_DET = 0, S_U = 3, S_V = 9, S_T = 15 };
constexpr int kMtSlots = 19;
// Error flag values (ops/traverse.py _ERRORS)
enum { E_STACK = 1, E_INDEX = 2 };
// area pack [16] (ops/fused_traverse.pack_area_consts): corner, edge u,
// edge v, colour * intensity, unit normal, quad area
enum { AC_CORNER = 0, AC_EU = 3, AC_EV = 6, AC_CI = 9, AC_NL = 12, AC_AREA = 15 };
constexpr int kAreaSamples = 4;  // scene/lights.AREA_LIGHT_SAMPLES, a 2 x 2 stratum grid

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float saturate(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ float comp(V3 a, int k) { return k == 0 ? a.x : (k == 1 ? a.y : a.z); }
__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }

// vecmath.normalize: zero vectors map to zero
__device__ __forceinline__ V3 normalize3(V3 v) {
  float n2 = dot3(v, v);
  float inv = n2 > 1e-8f ? 1.0f / sqrtf(fmaxf(n2, 1e-8f)) : 0.0f;
  return v3(v.x * inv, v.y * inv, v.z * inv);
}

// Branchless smallest-axis perpendicular and the (tangent, bitangent) frame.
__device__ __forceinline__ void onb(V3 n, V3* tan, V3* bit) {
  float ax = fabsf(n.x), ay = fabsf(n.y), az = fabsf(n.z);
  bool xm = ((ax - ay) < 0.0f) && ((ax - az) < 0.0f);
  bool ym = ((ay - az) < 0.0f) && !xm;
  bool zm = !(xm || ym);
  *bit = cross3(n, v3(xm ? 1.0f : 0.0f, ym ? 1.0f : 0.0f, zm ? 1.0f : 0.0f));
  *tan = cross3(*bit, n);
}

__device__ __forceinline__ uint32_t tea_init(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

// Möller–Trumbore terms of one (triangle, ray) pair and its validity.
struct Pair {
  bool valid;
  float ts, us, vs, det_abs;
};

// c(j) returns the triangle's coefficient slot j (S_DET..S_T+3).
template <class Coef>
__device__ __forceinline__ Pair pair_test(const Coef& c, V3 o, V3 d, V3 mo, float tmin,
                                          bool has_tmax, float tmax, bool cull) {
  float det = d.x * c(S_DET) + d.y * c(S_DET + 1) + d.z * c(S_DET + 2);
  float u_d = d.x * c(S_U) + d.y * c(S_U + 1) + d.z * c(S_U + 2) +
              mo.x * c(S_U + 3) + mo.y * c(S_U + 4) + mo.z * c(S_U + 5);
  float v_d = d.x * c(S_V) + d.y * c(S_V + 1) + d.z * c(S_V + 2) +
              mo.x * c(S_V + 3) + mo.y * c(S_V + 4) + mo.z * c(S_V + 5);
  float t_d = o.x * c(S_T) + o.y * c(S_T + 1) + o.z * c(S_T + 2) + c(S_T + 3);
  float s = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
  Pair p;
  p.det_abs = det * s;
  p.us = u_d * s;
  p.vs = v_d * s;
  p.ts = t_d * s;
  bool alive = cull ? (det > kDetEps) : (p.det_abs > kDetEps);
  float m_soft = fminf(fminf(p.us, p.vs), p.det_abs - (p.us + p.vs));
  float m_strict = p.ts - tmin * p.det_abs;
  if (has_tmax) m_strict = fminf(m_strict, tmax * p.det_abs - p.ts);
  p.valid = alive && (m_soft >= 0.0f) && (m_strict > 0.0f);
  return p;
}

// A triangle record: the kMtSlots coefficient slots in slot order and one
// pad word, kRecQuads float4s (B1's tri_records, B5's ft_test). A pair test
// reads it with kRecQuads 16-byte loads instead of kMtSlots 4-byte ones.
constexpr int kRecWords = 20;
constexpr int kRecQuads = kRecWords / 4;

struct RecCoef {
  float v[kRecWords];
  __device__ __forceinline__ void set(int q, float4 x) {
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
  __device__ __forceinline__ float operator()(int j) const { return v[j]; }
};

// The record at p: shared memory (B1) or read-only device memory (B5).
__device__ __forceinline__ RecCoef rec_coef(const float4* p) {
  RecCoef k;
#pragma unroll
  for (int q = 0; q < kRecQuads; ++q) k.set(q, p[q]);
  return k;
}
__device__ __forceinline__ RecCoef rec_coef_ldg(const float4* p) {
  RecCoef k;
#pragma unroll
  for (int q = 0; q < kRecQuads; ++q) k.set(q, __ldg(p + q));
  return k;
}

struct Hit {
  bool hit;
  int row;  // the backend's material handle (B1: triangle, B5: material id)
  float t;
  V3 pos, normal;
  V3 tex;  // B5's albedo-texture mode: the texture at the hit's UV (else unset)
};

// Barycentric normal of vertex normals n0/n1/n2 (9 values at stride `step`
// from p), normalised as the TPU kernels do.
__device__ __forceinline__ V3 interp_normal(const float* p, int step, float u, float v) {
  float w = 1.0f - u - v;
  V3 n = v3(w * p[(A_N0 + 0) * step] + u * p[(A_N1 + 0) * step] + v * p[(A_N2 + 0) * step],
            w * p[(A_N0 + 1) * step] + u * p[(A_N1 + 1) * step] + v * p[(A_N2 + 1) * step],
            w * p[(A_N0 + 2) * step] + u * p[(A_N1 + 2) * step] + v * p[(A_N2 + 2) * step]);
  float inv = 1.0f / sqrtf(fmaxf(dot3(n, n), 1e-24f));
  return v3(n.x * inv, n.y * inv, n.z * inv);
}

// ---------------------------------------------------------------------------
// The fat-node BVH walk (B4a, B5 and B6a)
// ---------------------------------------------------------------------------

// mt_rows lane of coefficient slot j (pack_for_traversal: group g, column
// col at lane 16 g + col).
__host__ __device__ constexpr int coef_lane(int j) {
  return j < S_U ? j : (j < S_V ? 16 + (j - S_U) : (j < S_T ? 32 + (j - S_V) : 54 + (j - S_T)));
}

struct RowCoef {
  const float* row;  // one mt_rows row
  __device__ __forceinline__ float operator()(int j) const { return __ldg(row + coef_lane(j)); }
};

struct FatBvh {
  const float4* nodes;  // bvhf_rows [F, 16] as [F][4] float4
  const float* rows;    // mt_rows [S, 128]
  int n_nodes, n_slots;
  int* err;  // device error flag (E_STACK, E_INDEX)
};

// 1 / d per axis with |d| <= 1e-12 replaced by +1e-12 (the TPU kernels' rule).
__device__ __forceinline__ V3 safe_inv(V3 d) {
  return v3(1.0f / (fabsf(d.x) > 1e-12f ? d.x : 1e-12f),
            1.0f / (fabsf(d.y) > 1e-12f ? d.y : 1e-12f),
            1.0f / (fabsf(d.z) > 1e-12f ? d.z : 1e-12f));
}

// Slab test of box [lo, hi] against the window (tmin, tf]; *tn = entry t.
__device__ __forceinline__ bool slab(V3 lo, V3 hi, V3 o, V3 inv, float tmin, float tf,
                                     float* tn) {
  float t0x = (lo.x - o.x) * inv.x, t1x = (hi.x - o.x) * inv.x;
  float t0y = (lo.y - o.y) * inv.y, t1y = (hi.y - o.y) * inv.y;
  float t0z = (lo.z - o.z) * inv.z, t1z = (hi.z - o.z) * inv.z;
  float n = fmaxf(fmaxf(fmaxf(tmin, fminf(t0x, t1x)), fminf(t0y, t1y)), fminf(t0z, t1z));
  float f = fminf(fminf(fminf(tf, fmaxf(t0x, t1x)), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  *tn = n;
  return n <= f;
}

// Near-first walk from node `root` (0 for a whole BVH; a BLAS's first node
// among concatenated BLASes, whose ptrs are already rebased). Leaf provides
// far() (the window's far end: the running best t, or t_max) and
// visit(ptr, meta), which tests one leaf and returns true to end the walk.
// `stack` holds kCap entries.
template <class Leaf, int kCap = kMaxStack>
__device__ __forceinline__ void fat_walk(const FatBvh& B, V3 o, V3 inv, float tmin, Leaf& leaf,
                                         int* stack, int root = 0) {
  int sp = 1;
  stack[0] = root;
  while (sp > 0) {
    const int node = stack[--sp];
    if (node < 0 || node >= B.n_nodes) {
      *B.err = E_INDEX;
      return;
    }
    const float4* q = B.nodes + 4 * node;
    const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), m = __ldg(q + 3);
    const float tf = leaf.far();
    float tn0, tn1;
    const bool h0 = slab(v3(a.x, a.y, a.z), v3(a.w, b.x, b.y), o, inv, tmin, tf, &tn0);
    const bool h1 = slab(v3(b.z, b.w, c.x), v3(c.y, c.z, c.w), o, inv, tmin, tf, &tn1);
    const int ptr0 = (int)m.x, ptr1 = (int)m.z;
    if (h0 && m.y > 0.5f && leaf.visit(ptr0, (int)m.y)) return;
    if (h1 && m.w > 0.5f && leaf.visit(ptr1, (int)m.w)) return;
    const bool int0 = h0 && m.y < -0.5f, int1 = h1 && m.w < -0.5f;
    const int pushes = (int)int0 + (int)int1;
    if (sp + pushes > kCap) {
      *B.err = E_STACK;
      return;
    }
    if (int0 && int1) {
      const bool near0 = tn0 <= tn1;  // far pushed first, near pops next
      stack[sp++] = near0 ? ptr1 : ptr0;
      stack[sp++] = near0 ? ptr0 : ptr1;
    } else if (pushes) {
      stack[sp++] = int0 ? ptr0 : ptr1;
    }
  }
}

// Closest-hit leaf test: rows ascending with a strict '<', so the lowest row
// wins within a leaf and an equal t never replaces an earlier leaf's hit.
struct ClosestLeaf {
  const FatBvh& B;
  V3 o, d, mo;
  float tmin, tmax;
  bool cull;
  float best_t, b_us, b_vs, b_det;
  int best_slot;

  __device__ __forceinline__ ClosestLeaf(const FatBvh& b, V3 o_, V3 d_, float tmin_, float tmax_,
                                         bool cull_)
      : B(b), o(o_), d(d_), mo(cross3(o_, d_)), tmin(tmin_), tmax(tmax_), cull(cull_),
        best_t(kBig), b_us(0.0f), b_vs(0.0f), b_det(0.0f), best_slot(-1) {}
  // Move the ray (a two-level walk's object-space copy); the best hit stays.
  __device__ __forceinline__ void set_ray(V3 o_, V3 d_) {
    o = o_;
    d = d_;
    mo = cross3(o_, d_);
  }
  __device__ __forceinline__ float far() const { return fminf(tmax, best_t); }
  __device__ __forceinline__ bool visit(int start, int count) {
    if (start < 0 || start + count > B.n_slots) {
      *B.err = E_INDEX;
      return true;
    }
    for (int r = 0; r < count; ++r) {
      Pair p = pair_test(RowCoef{B.rows + (size_t)(start + r) * kRowLanes}, o, d, mo, tmin, true,
                         tmax, cull);
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
  __device__ __forceinline__ bool hit() const { return best_t < kBig; }
  __device__ __forceinline__ float u() const { return b_us * (1.0f / fmaxf(b_det, kDetEps)); }
  __device__ __forceinline__ float v() const { return b_vs * (1.0f / fmaxf(b_det, kDetEps)); }
};

// Occlusion leaf test: the walk ends at the first valid pair.
struct AnyLeaf {
  const FatBvh& B;
  V3 o, d, mo;
  float tmin, tmax;
  bool occluded;

  __device__ __forceinline__ AnyLeaf(const FatBvh& b, V3 o_, V3 d_, float tmin_, float tmax_)
      : B(b), o(o_), d(d_), mo(cross3(o_, d_)), tmin(tmin_), tmax(tmax_), occluded(false) {}
  __device__ __forceinline__ void set_ray(V3 o_, V3 d_) {
    o = o_;
    d = d_;
    mo = cross3(o_, d_);
  }
  __device__ __forceinline__ float far() const { return tmax; }
  __device__ __forceinline__ bool visit(int start, int count) {
    if (start < 0 || start + count > B.n_slots) {
      *B.err = E_INDEX;
      return true;
    }
    for (int r = 0; r < count; ++r) {
      if (pair_test(RowCoef{B.rows + (size_t)(start + r) * kRowLanes}, o, d, mo, tmin, true, tmax,
                    false).valid) {
        occluded = true;
        return true;
      }
    }
    return false;
  }
};

// ---------------------------------------------------------------------------
// The per-pixel ray tree
// ---------------------------------------------------------------------------

// The environment: kind 0 constant and 1 gradient (colours in the const
// pack), 2 lat-long texture tex [h][w][3], 3 cubemap tex [6][w][w][3]
// (w == h), float32 in device memory.
struct Env {
  const float* tex;
  int kind, w, h;
};

// The launch arguments of an env: kinds 0-3, a texture kind with its
// texture and non-empty dimensions (a cubemap's faces square).
inline bool env_args_ok(int kind, const void* tex, int w, int h) {
  if (kind == 0 || kind == 1) return true;
  if (kind != 2 && kind != 3) return false;
  return tex != nullptr && w >= 1 && h >= 1 && (kind == 2 || w == h);
}

__device__ __forceinline__ V3 texel(const float* tex, int i) {
  const float* p = tex + 3 * (size_t)i;
  return v3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

// envmap._bilinear_mix: c00 (1-fx)(1-fy) + c10 fx (1-fy) + c01 (1-fx) fy + c11 fx fy
__device__ __forceinline__ float mix4(float c00, float c10, float c01, float c11, float fx,
                                      float fy) {
  return c00 * (1.0f - fx) * (1.0f - fy) + c10 * fx * (1.0f - fy) + c01 * (1.0f - fx) * fy +
         c11 * fx * fy;
}

__device__ __forceinline__ V3 bilinear(const float* tex, int i00, int i10, int i01, int i11,
                                       float fx, float fy) {
  V3 a = texel(tex, i00), b = texel(tex, i10), c = texel(tex, i01), d = texel(tex, i11);
  return v3(mix4(a.x, b.x, c.x, d.x, fx, fy), mix4(a.y, b.y, c.y, d.y, fx, fy),
            mix4(a.z, b.z, c.z, d.z, fx, fy));
}

// envmap.dir_to_latlong_uv + _bilinear_wrap_u: u wraps (a floor mod: at
// u * w < 0.5 the left tap is texel w - 1), v clamps. At the seam atan2f
// gives +pi or -pi, u = 1 or 0, and both give taps (w - 1, 0) at fx = 0.5.
__device__ V3 env_latlong(const Env& e, V3 d) {
  float u = (1.0f + atan2f(d.x, -d.z) * kInvPi) * 0.5f;
  float v = acosf(fminf(fmaxf(d.y, -1.0f), 1.0f)) * kInvPi;
  float x = u * (float)e.w - 0.5f, y = v * (float)e.h - 0.5f;
  float x0 = floorf(x), y0 = floorf(y);
  int xi = (int)x0 % e.w;
  xi = xi < 0 ? xi + e.w : xi;
  int yi = min(max((int)y0, 0), e.h - 1);
  int x1 = xi + 1 == e.w ? 0 : xi + 1, y1 = min(yi + 1, e.h - 1);
  return bilinear(e.tex, yi * e.w + xi, yi * e.w + x1, y1 * e.w + xi, y1 * e.w + x1, x - x0,
                  y - y0);
}

// envmap.dir_to_cube_face_uv + _bilinear_cube: D3D face selection (ties to
// x with >=, then y with > x and >= z, then z), taps clamped inside the face
// and weights from the unclamped position.
__device__ V3 env_cube(const Env& e, V3 d) {
  float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  bool is_x = (ax >= ay) && (ax >= az);
  bool is_y = (ay > ax) && (ay >= az);
  int face = is_x ? (d.x >= 0.0f ? 0 : 1) : (is_y ? (d.y >= 0.0f ? 2 : 3) : (d.z >= 0.0f ? 4 : 5));
  float ma = fmaxf(is_x ? ax : (is_y ? ay : az), 1e-12f);
  float sc = is_x ? (d.x >= 0.0f ? -d.z : d.z) : (is_y ? d.x : (d.z >= 0.0f ? d.x : -d.x));
  float tc = is_x ? -d.y : (is_y ? (d.y >= 0.0f ? d.z : -d.z) : -d.y);
  float u = (sc / ma + 1.0f) * 0.5f, v = (tc / ma + 1.0f) * 0.5f;
  const int s = e.w;
  float x = u * (float)s - 0.5f, y = v * (float)s - 0.5f;
  float x0 = floorf(x), y0 = floorf(y);
  int xi = min(max((int)x0, 0), s - 1), yi = min(max((int)y0, 0), s - 1);
  int x1 = min(xi + 1, s - 1), y1 = min(yi + 1, s - 1);
  int base = face * s * s;
  return bilinear(e.tex, base + yi * s + xi, base + yi * s + x1, base + y1 * s + xi,
                  base + y1 * s + x1, x - x0, y - y0);
}

// Albedo textures: the flat texel table [n_texels][3] and the per-material
// (base, width, height) meta [n_meta][3] (scene/textures.py).
struct AlbedoTex {
  const float* texels;
  const int* meta;
  int n_texels, n_meta;
};

// scene/textures.sample_albedo: the bilinear texture of material `mid` at
// uv, WRAP on both axes (a floor mod: C's % truncates, so a negative
// remainder takes + w); (1, 1, 1) for an untextured material. A meta row
// outside the table sets the error flag.
__device__ V3 sample_albedo(const AlbedoTex& t, int mid, float u, float v, int* err) {
  if (mid < 0 || mid >= t.n_meta) {
    *err = E_INDEX;
    return v3(1.0f, 1.0f, 1.0f);
  }
  const int base = __ldg(t.meta + 3 * mid), w = __ldg(t.meta + 3 * mid + 1),
            h = __ldg(t.meta + 3 * mid + 2);
  if (w <= 0) return v3(1.0f, 1.0f, 1.0f);
  if (h <= 0 || base < 0 || (long long)base + (long long)w * h > (long long)t.n_texels) {
    *err = E_INDEX;
    return v3(1.0f, 1.0f, 1.0f);
  }
  float x = u * (float)w - 0.5f, y = v * (float)h - 0.5f;
  float x0 = floorf(x), y0 = floorf(y);
  int xi = (int)x0 % w, yi = (int)y0 % h;
  xi = xi < 0 ? xi + w : xi;
  yi = yi < 0 ? yi + h : yi;
  int x1 = xi + 1 == w ? 0 : xi + 1, y1 = yi + 1 == h ? 0 : yi + 1;
  return bilinear(t.texels, base + yi * w + xi, base + yi * w + x1, base + y1 * w + xi,
                  base + y1 * w + x1, x - x0, y - y0);
}

// Radiance of direction d, times the strength.
__device__ V3 env_color(V3 d, const float* cst, const Env& env) {
  float strength = cst[C_STRENGTH];
  if (env.kind >= 2) {
    V3 c = env.kind == 2 ? env_latlong(env, d) : env_cube(env, d);
    return v3(c.x * strength, c.y * strength, c.z * strength);
  }
  if (env.kind == 0) {
    return v3(cst[C_ENV0] * strength, cst[C_ENV0 + 1] * strength, cst[C_ENV0 + 2] * strength);
  }
  float t = saturate(d.y * 0.5f + 0.5f);
  return v3((cst[C_ENV0] * (1.0f - t) + cst[F_ENV1] * t) * strength,
            (cst[C_ENV0 + 1] * (1.0f - t) + cst[F_ENV1 + 1] * t) * strength,
            (cst[C_ENV0 + 2] * (1.0f - t) + cst[F_ENV1 + 2] * t) * strength);
}

__device__ __forceinline__ uint32_t lcg_next(uint32_t s) { return s * 1664525u + 1013904223u; }
__device__ __forceinline__ float lcg_unit(uint32_t s) {
  return (float)(s & 0x00FFFFFFu) / 16777216.0f;
}

// The area light's soft-shadowed irradiance at (pos, normal):
// L * area * mean_j(NoL * |cos at the light| / d_j^2 * vis_j) over
// kAreaSamples points drawn from the pixel's TEA seed (aseed =
// initRand(seed, 0x9E3779B9), then LCG pairs stratified on the 2 x 2 grid:
// scene/lights.area_light_draws). Both faces emit. A sample whose
// NoL * |cos| is 0 adds 0 whatever its visibility, so its shadow walk is
// skipped.
template <class Tr>
__device__ V3 area_light_term(const Tr& T, V3 pos, V3 normal, uint32_t seed) {
  const float* A = T.area;
  uint32_t aseed = tea_init(seed, 0x9E3779B9u);
  float geo = 0.0f;
#pragma unroll 1
  for (int j = 0; j < kAreaSamples; ++j) {
    aseed = lcg_next(aseed);
    float r0 = lcg_unit(aseed);
    aseed = lcg_next(aseed);
    float r1 = lcg_unit(aseed);
    r0 = ((float)(j % 2) + r0) / 2.0f;
    r1 = ((float)(j / 2 % 2) + r1) / 2.0f;
    V3 apath = v3(A[AC_CORNER] + r0 * A[AC_EU] + r1 * A[AC_EV] - pos.x,
                  A[AC_CORNER + 1] + r0 * A[AC_EU + 1] + r1 * A[AC_EV + 1] - pos.y,
                  A[AC_CORNER + 2] + r0 * A[AC_EU + 2] + r1 * A[AC_EV + 2] - pos.z);
    float adist = sqrtf(fmaxf(dot3(apath, apath), 0.0f));
    V3 wi = normalize3(apath);
    float ad2 = fmaxf(adist * adist, 1e-12f);
    float w = saturate(dot3(normal, wi)) * fabsf(dot3(load3(A + AC_NL), wi));
    if (w != 0.0f && !T.occluded(pos, wi, kRayEps, true, fmaxf(adist - kRayEps, kRayEps))) {
      geo += w / ad2;
    }
  }
  geo = geo * (A[AC_AREA] / (float)kAreaSamples);
  return v3(A[AC_CI] * geo, A[AC_CI + 1] * geo, A[AC_CI + 2] * geo);
}

// Directional, point and (B5's area mode) area light with shadow rays, or,
// with two lights or more present, the debug==2 one-of-L MC estimator
// (pidx = min(int(pick * L), L - 1) over the lights present in the order
// directional, point, area; weight L); a rig of one light ignores the
// pick, as the one-of-one estimator equals the full sum. Without an area
// light the body is the one-of-two form (pick < 0.5 -> directional,
// weight 2; the same at L = 2), written out on its own: folded into the
// one-of-L form it took the base instantiation from 72 to 80 registers.
// `seed` is the pixel's TEA seed (the area draws'). Only for hit lanes.
template <class Tr>
__device__ V3 direct_lighting(const Tr& T, const float* cst, V3 pos, V3 normal, float pick,
                              uint32_t seed) {
  const bool has_d = (T.rig & 1) != 0, has_p = (T.rig & 2) != 0;
  V3 dl = load3(cst + C_DLDIR);
  V3 path = v3(cst[C_PLPOS] - pos.x, cst[C_PLPOS + 1] - pos.y, cst[C_PLPOS + 2] - pos.z);
  float dist = sqrtf(fmaxf(dot3(path, path), 0.0f));
  V3 lp = normalize3(path);
  float tmax_p = fmaxf(dist - kRayEps, kRayEps);
  if constexpr (!Tr::kArea) {
    bool is_mc = cst[F_IS_MC] > 0.5f && has_d && has_p;
    bool need_d = has_d && (!is_mc || pick < 0.5f);
    bool need_p = has_p && (!is_mc || !(pick < 0.5f));
    float d_vis = (need_d && !T.occluded(pos, dl, kRayEps, false, 0.0f)) ? 1.0f : 0.0f;
    float p_vis = (need_p && !T.occluded(pos, lp, kRayEps, true, tmax_p)) ? 1.0f : 0.0f;
    float nol_d = saturate(dot3(normal, dl));
    float nol_p = saturate(dot3(normal, lp));
    float falloff = 1.0f / (kTwoPi * fmaxf(dist * dist, 1e-12f));
    float dterm = nol_d * d_vis;
    float pterm = nol_p * p_vis * falloff;
    V3 d_c = v3(cst[C_DLCI] * dterm, cst[C_DLCI + 1] * dterm, cst[C_DLCI + 2] * dterm);
    V3 p_c = v3(cst[C_PLCI] * pterm, cst[C_PLCI + 1] * pterm, cst[C_PLCI + 2] * pterm);
    if (is_mc) {
      return pick < 0.5f ? v3(d_c.x * 2.0f, d_c.y * 2.0f, d_c.z * 2.0f)
                         : v3(p_c.x * 2.0f, p_c.y * 2.0f, p_c.z * 2.0f);
    }
    return v3(d_c.x + p_c.x, d_c.y + p_c.y, d_c.z + p_c.z);
  } else {
    const int n_lights = (int)has_d + (int)has_p + 1;
    const int pidx = min((int)(pick * (float)n_lights), n_lights - 1);
    bool is_mc = cst[F_IS_MC] > 0.5f && n_lights > 1;
    bool pick_d = has_d && pidx == 0, pick_p = has_p && pidx == (int)has_d;
    bool need_d = has_d && (!is_mc || pick_d);
    bool need_p = has_p && (!is_mc || pick_p);
    float d_vis = (need_d && !T.occluded(pos, dl, kRayEps, false, 0.0f)) ? 1.0f : 0.0f;
    float p_vis = (need_p && !T.occluded(pos, lp, kRayEps, true, tmax_p)) ? 1.0f : 0.0f;
    float nol_d = saturate(dot3(normal, dl));
    float nol_p = saturate(dot3(normal, lp));
    float falloff = 1.0f / (kTwoPi * fmaxf(dist * dist, 1e-12f));
    float dterm = nol_d * d_vis;
    float pterm = nol_p * p_vis * falloff;
    V3 d_c = v3(cst[C_DLCI] * dterm, cst[C_DLCI + 1] * dterm, cst[C_DLCI + 2] * dterm);
    V3 p_c = v3(cst[C_PLCI] * pterm, cst[C_PLCI + 1] * pterm, cst[C_PLCI + 2] * pterm);
    V3 a_c = v3(0.0f, 0.0f, 0.0f);
    if (!is_mc || !(pick_d || pick_p)) a_c = area_light_term(T, pos, normal, seed);
    if (is_mc) {
      const float l = (float)n_lights;
      V3 c = pick_d ? d_c : (pick_p ? p_c : a_c);
      return v3(c.x * l, c.y * l, c.z * l);
    }
    return v3(d_c.x + p_c.x + a_c.x, d_c.y + p_c.y + a_c.y, d_c.z + p_c.z + a_c.z);
  }
}

// Depth-1 radiance of an active bounce ray: albedo * direct / pi on a hit,
// plus emissive in progressive mode only (the realtime shader adds none);
// the environment on a miss. Depth-1 shading re-seeds: `seed` is the
// pixel's TEA seed, as at depth 0.
template <class Tr>
__device__ V3 secondary_radiance(const Tr& T, const float* cst, V3 o, V3 d, float pick,
                                 uint32_t seed, const Env& env, bool emissive) {
  Hit h = T.closest(o, d, kRayEps, false);
  if (!h.hit) return env_color(d, cst, env);
  V3 direct = direct_lighting(T, cst, h.pos, h.normal, pick, seed);
  float estr = T.a(A_ESTR, h.row);
  float out[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float shade = T.albedo(h, k) * comp(direct, k) / kPi;
    out[k] = emissive ? T.a(A_EMISSIVE + k, h.row) * estr + shade : shade;
  }
  return v3(out[0], out[1], out[2]);
}

// Cosine (flag > 0.5) or uniform hemisphere direction from draws r0, r1.
__device__ V3 hemisphere_dir(V3 n, float r0, float r1, bool cosine) {
  V3 tan, bit;
  onb(n, &tan, &bit);
  float phi = kTwoPi * r1;
  float cphi = cosf(phi), sphi = sinf(phi);
  float a, b, c;
  if (cosine) {
    float rr = sqrtf(r0);
    a = rr * cphi;
    b = sqrtf(fmaxf(1.0f - r0, 0.0f));
    c = rr * sphi;
  } else {
    float sin_t = sqrtf(fmaxf(1.0f - r0 * r0, 0.0f));
    a = sin_t * cphi;
    b = r0;
    c = sin_t * sphi;
  }
  return v3(a * tan.x + b * n.x + c * bit.x, a * tan.y + b * n.y + c * bit.y,
            a * tan.z + b * n.z + c * bit.z);
}

__device__ __forceinline__ float sanitize(float x) { return isnan(x) ? 0.0f : fmaxf(x, 0.0f); }

// Raygen (primary_ray_grid): origin (jitter folded in) and unit direction
// of pixel (px, py) from camera pack row cm. A row-block launch renders
// rows [py0, py0 + height) of a taller image: lane 12 holds py0, lane 13
// the full height (0: the launch's own height), so NDC is the full image's.
__device__ __forceinline__ void primary_ray(const float* cm, int px, int py, int width,
                                            int height, V3* o, V3* d) {
  float ndcx = ((float)px + 0.5f) / (float)width * 2.0f - 1.0f;
  float pyf = (float)py + cm[12];
  float full_h = cm[13] > 0.0f ? cm[13] : (float)height;
  float ndcy = (pyf + 0.5f) / full_h * 2.0f - 1.0f;
  V3 dun = v3(ndcx * cm[3] + (-ndcy) * cm[6] + cm[9], ndcx * cm[4] + (-ndcy) * cm[7] + cm[10],
              ndcx * cm[5] + (-ndcy) * cm[8] + cm[11]);
  float norm = sqrtf(dot3(dun, dun));
  *d = v3(dun.x / norm, dun.y / norm, dun.z / norm);
  *o = load3(cm);
}

// The TEA seed of the raster pixel index (rng.pixel_seeds) of pixel (px, py)
// of the launch: the global row py + py0 (camera lane 12), so a row-block
// launch draws the full image's seeds.
__device__ __forceinline__ uint32_t pixel_seed(const float* cm, int px, int py, int width,
                                               uint32_t frame) {
  return tea_init((uint32_t)((py + (int)cm[12]) * width + px), frame);
}

// 5 LCG draws u1..u5 from a pixel's TEA seed.
__device__ __forceinline__ void draws(uint32_t seed, float u[5]) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    seed = lcg_next(seed);
    u[k] = lcg_unit(seed);
  }
}

// Phong lobe around the mirror direction of d about normal (samplePhongLobe):
// the bounce direction and brdf / pdf, guarded against the 0/0 underflow.
struct Phong {
  V3 dir;
  float ratio;
};

__device__ __forceinline__ Phong phong_lobe(V3 d, V3 normal, float r0, float r1, float exponent) {
  float don = dot3(d, normal);
  V3 mirror = normalize3(v3(d.x - 2.0f * don * normal.x, d.y - 2.0f * don * normal.y,
                            d.z - 2.0f * don * normal.z));
  V3 tan, bit;
  onb(mirror, &tan, &bit);
  float cos_t = powf(r0, 1.0f / (exponent + 1.0f));
  float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  float phi = kTwoPi * r1;
  float powered_cos = powf(cos_t, exponent);
  float pdf = (exponent + 1.0f) / kTwoPi * powered_cos;
  float brdf = (exponent + 2.0f) / kTwoPi * powered_cos;
  float xs = sin_t * cosf(phi), zs = sin_t * sinf(phi);
  Phong p;
  p.dir = v3(xs * tan.x + cos_t * mirror.x + zs * bit.x,
             xs * tan.y + cos_t * mirror.y + zs * bit.y,
             xs * tan.z + cos_t * mirror.z + zs * bit.z);
  p.ratio = pdf > 1e-30f ? brdf / fmaxf(pdf, 1e-30f) : (exponent + 2.0f) / (exponent + 1.0f);
  return p;
}

// Material type 1 or 2 with reflectivity above 0.001 traces the Phong bounce.
template <class Tr>
__device__ __forceinline__ bool specular_active(const Tr& T, int r) {
  float mtype = T.a(A_TYPE, r);
  return ((fabsf(mtype - 1.0f) < 0.5f) || (fabsf(mtype - 2.0f) < 0.5f)) &&
         (T.a(A_REFL, r) > 0.001f);
}

// One progressive sample of pixel (px, py); adds its colour to acc.
template <class Tr>
__device__ void sample_pixel(const Tr& T, const float* cm, uint32_t frame, const float* cst,
                             int px, int py, int width, int height, const Env& env,
                             float acc[3]) {
  V3 o, d;
  primary_ray(cm, px, py, width, height, &o, &d);
  Hit h = T.closest(o, d, 0.0f, true);
  if (!h.hit) {
    V3 e = env_color(d, cst, env);
    acc[0] += sanitize(e.x);
    acc[1] += sanitize(e.y);
    acc[2] += sanitize(e.z);
    return;
  }

  float u[5];
  const uint32_t seed = pixel_seed(cm, px, py, width, frame);
  draws(seed, u);
  const bool is_mc = cst[F_IS_MC] > 0.5f;
  const bool no_ind = cst[F_NO_IND] > 0.5f;
  const bool cosine = cst[F_COSINE] > 0.5f;
  const int r = h.row;
  V3 pos = h.pos, normal = h.normal;

  // ---- direct lighting (draw u1 picks the light under debug==2) ------------
  V3 direct = direct_lighting(T, cst, pos, normal, u[0], seed);

  // ---- indirect diffuse direction: draws (u1, u2), or (u2, u3) after the pick
  V3 diff_dir = hemisphere_dir(normal, is_mc ? u[1] : u[0], is_mc ? u[2] : u[1], cosine);

  // ---- Phong lobe: the next two draws after the ones consumed above -------
  float r0_ph = no_ind ? (is_mc ? u[1] : u[0]) : (is_mc ? u[3] : u[2]);
  float r1_ph = no_ind ? (is_mc ? u[2] : u[1]) : (is_mc ? u[4] : u[3]);
  float refl = T.a(A_REFL, r);
  bool spec_active = specular_active(T, r);
  float exponent = expf((1.0f - T.a(A_ROUGH, r)) * 12.0f);
  Phong ph = phong_lobe(d, normal, r0_ph, r1_ph, exponent);

  // ---- bounces: depth-1 shading re-seeds, so both pick the light with u1 --
  V3 sec = no_ind ? v3(0.0f, 0.0f, 0.0f)
                  : secondary_radiance(T, cst, pos, diff_dir, u[0], seed, env, true);
  V3 spec_rad = spec_active ? secondary_radiance(T, cst, pos, ph.dir, u[0], seed, env, true)
                            : v3(0.0f, 0.0f, 0.0f);

  // ---- epilogue (trace_rays) -------------------------------------------------
  float nol = saturate(dot3(normal, diff_dir));
  float ratio = ph.ratio;
  float cosi = saturate(-dot3(d, normal));
  float pw5 = powf(1.0f - cosi, 5.0f);
  float estr = T.a(A_ESTR, r);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float indirect = no_ind ? 0.0f : (cosine ? comp(sec, k) * kPi : comp(sec, k) * (nol * kTwoPi));
    float specular = spec_active ? comp(spec_rad, k) * ratio : 0.0f;
    float f0 = T.a(A_SPECULAR + k, r);
    float fresnel = spec_active ? f0 + (1.0f - f0) * pw5 : 0.0f;
    float albedo = T.albedo(h, k);
    float dk = comp(direct, k);
    float diffuse_comp = (dk + indirect) / kPi;
    float emissive = T.a(A_EMISSIVE + k, r) * estr;
    float c = emissive + albedo * diffuse_comp + refl * specular * fresnel;
    if (cst[F_SHOW_DIRECT] > 0.5f) c = albedo * dk / kPi;
    if (cst[F_SHOW_ALBEDO] > 0.5f) c = albedo;
    if (cst[F_SHOW_FRESNEL] > 0.5f) c = fresnel;
    if (cst[F_SHOW_IND_SPEC] > 0.5f) c = refl * specular * fresnel;
    if (cst[F_SHOW_IND_DIFF] > 0.5f) c = albedo * indirect / kPi;
    acc[k] += sanitize(c);
  }
}

// One realtime frame of pixel (px, py): aov = direct (0:3), indirect
// specular (3:6), albedo (6:9), roughness (9). Phong draws take the
// no-diffuse slots: (u2, u3) under debug==2, else (u1, u2).
template <class Tr>
__device__ void realtime_pixel(const Tr& T, const float* cm, uint32_t frame, const float* cst,
                               int px, int py, int width, int height, const Env& env,
                               float aov[10]) {
  V3 o, d;
  primary_ray(cm, px, py, width, height, &o, &d);
  Hit h = T.closest(o, d, 0.0f, true);
#pragma unroll
  for (int k = 0; k < 10; ++k) aov[k] = 0.0f;
  if (!h.hit) {  // a miss routes the environment into the direct AOV
    V3 e = env_color(d, cst, env);
    aov[0] = sanitize(e.x);
    aov[1] = sanitize(e.y);
    aov[2] = sanitize(e.z);
    return;
  }

  float u[5];
  const uint32_t seed = pixel_seed(cm, px, py, width, frame);
  draws(seed, u);
  const bool is_mc = cst[F_IS_MC] > 0.5f;
  const int r = h.row;
  V3 direct = direct_lighting(T, cst, h.pos, h.normal, u[0], seed);
  float refl = T.a(A_REFL, r);
  bool spec_active = specular_active(T, r);
  float exponent = expf((1.0f - T.a(A_ROUGH, r)) * 12.0f);
  Phong ph = phong_lobe(d, h.normal, is_mc ? u[1] : u[0], is_mc ? u[2] : u[1], exponent);
  V3 spec_rad = spec_active ? secondary_radiance(T, cst, h.pos, ph.dir, u[0], seed, env, false)
                            : v3(0.0f, 0.0f, 0.0f);
  float cosi = saturate(-dot3(d, h.normal));
  float pw5 = powf(1.0f - cosi, 5.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float specular = spec_active ? comp(spec_rad, k) * ph.ratio : 0.0f;
    float f0 = T.a(A_SPECULAR + k, r);
    float fresnel = spec_active ? f0 + (1.0f - f0) * pw5 : 0.0f;
    float albedo = T.albedo(h, k);
    aov[k] = sanitize(albedo * comp(direct, k) / kPi);
    aov[3 + k] = sanitize(refl * specular * fresnel);
    aov[6 + k] = albedo;
  }
  aov[9] = T.a(A_ROUGH, r);
}

}  // namespace dxr
