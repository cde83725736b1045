// Progressive-sample megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel _fused_kernel
// (dxrexperiments_tpu/ops/fused_sample_pallas.py:640), progressive mode:
// one launch renders S jittered samples of the whole brute-force ray tree
// per pixel and writes their sum:
//   raygen, 5 LCG draws from the TEA pixel seed, the primary closest-hit
//   sweep (backfaces culled), 2 shadow sweeps, and a diffuse and a Phong
//   bounce, each with its closest sweep and 2 shadow sweeps (9 sweeps over
//   the C triangles in all), then the shading epilogue and the sum over S.
//
// What bounds it: compute and latency. A pixel-sample does about 9*C
// Möller–Trumbore pair tests (C = 40 padded triangles for the Cornell box),
// each ~20 FMAs, while the output is 12 bytes per pixel per dispatch (3 MB
// at 512^2). Design answer: every block stages the 19 used Möller–Trumbore
// coefficients and the 24 used attribute rows of every triangle into shared
// memory once (43 floats per triangle, 44 KB at C = 256); all threads of a
// warp read the same triangle at once, so the reads are broadcasts. The
// per-ray state lives in registers, one thread per pixel in raster order,
// and the S-sample sum stays in registers and is written once: no atomics,
// nothing carried across blocks. Work the reference masks out is skipped
// per thread (miss lanes, inactive bounces, the unpicked light of the
// debug==2 estimator), which changes no result.
//
// Arithmetic follows the TPU kernel: the same term sums, the same
// sign-multiplied validity windows, t = ts / max(|det|, 1e-12), ties to
// the lowest triangle index, and the same draw routing. Build without
// --use_fast_math (IEEE sqrtf, division, sinf, cosf, expf, powf).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTris = 256;
constexpr int kMtSlots = 19;   // used Möller–Trumbore coefficients per triangle
constexpr int kAttrRows = 24;  // used attr_pack rows
constexpr float kBig = 3.0e38f;
constexpr float kRayEps = 1.0e-4f;
constexpr float kDetEps = 1.0e-12f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// const pack [2, 16]: row 0 lights + env colour 0, row 1 flags + env colour 1
enum { C_DLDIR = 0, C_DLCI = 3, C_PLPOS = 6, C_PLCI = 9, C_ENV0 = 12, C_STRENGTH = 15 };
enum {
  F_COSINE = 16, F_NO_IND, F_IS_MC, F_SHOW_DIRECT, F_SHOW_ALBEDO,
  F_SHOW_FRESNEL, F_SHOW_IND_SPEC, F_SHOW_IND_DIFF, F_ENV1
};
// attr_pack rows
enum {
  A_N0 = 0, A_N1 = 3, A_N2 = 6, A_ALBEDO = 10, A_SPECULAR = 13,
  A_EMISSIVE = 16, A_ESTR = 19, A_REFL = 20, A_ROUGH = 21, A_TYPE = 23
};
// shared-memory coefficient slots: det = D.s[0:3]; u*det = D.s[3:6] + M.s[6:9];
// v*det = D.s[9:12] + M.s[12:15]; t*det = O.s[15:18] + s[18]
enum { S_DET = 0, S_U = 3, S_V = 9, S_T = 15 };

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

struct Tris {
  const float* mt;  // [kMtSlots][c]
  const float* at;  // [kAttrRows][c]
  int c;
  __device__ __forceinline__ float m(int slot, int i) const { return mt[slot * c + i]; }
  __device__ __forceinline__ float a(int row, int i) const { return at[row * c + i]; }
};

// Möller–Trumbore terms of one (triangle, ray) pair and its validity.
struct Pair {
  bool valid;
  float ts, us, vs, det_abs;
};

__device__ __forceinline__ Pair pair_test(const Tris& T, int i, V3 o, V3 d, V3 mo,
                                          float tmin, bool has_tmax, float tmax, bool cull) {
  float det = d.x * T.m(S_DET, i) + d.y * T.m(S_DET + 1, i) + d.z * T.m(S_DET + 2, i);
  float u_d = d.x * T.m(S_U, i) + d.y * T.m(S_U + 1, i) + d.z * T.m(S_U + 2, i) +
              mo.x * T.m(S_U + 3, i) + mo.y * T.m(S_U + 4, i) + mo.z * T.m(S_U + 5, i);
  float v_d = d.x * T.m(S_V, i) + d.y * T.m(S_V + 1, i) + d.z * T.m(S_V + 2, i) +
              mo.x * T.m(S_V + 3, i) + mo.y * T.m(S_V + 4, i) + mo.z * T.m(S_V + 5, i);
  float t_d = o.x * T.m(S_T, i) + o.y * T.m(S_T + 1, i) + o.z * T.m(S_T + 2, i) + T.m(S_T + 3, i);
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

// Occlusion: true when any triangle blocks (o + t d, t in (tmin, tmax)).
__device__ bool any_hit(const Tris& T, V3 o, V3 d, float tmin, bool has_tmax, float tmax) {
  V3 mo = cross3(o, d);
  for (int i = 0; i < T.c; ++i) {
    if (pair_test(T, i, o, d, mo, tmin, has_tmax, tmax, false).valid) return true;
  }
  return false;
}

struct Hit {
  bool hit;
  int row;
  float t;
  V3 pos, normal;
};

// Closest hit: ascending scan with a strict '<' keeps the lowest triangle
// index on ties (the TPU kernel's min-then-lowest-row rule).
__device__ Hit closest_hit(const Tris& T, V3 o, V3 d, float tmin, bool cull) {
  V3 mo = cross3(o, d);
  float best_t = kBig, b_us = 0.0f, b_vs = 0.0f, b_det = 0.0f;
  int best = 0;
  for (int i = 0; i < T.c; ++i) {
    Pair p = pair_test(T, i, o, d, mo, tmin, false, 0.0f, cull);
    if (p.valid) {
      float t = p.ts / fmaxf(p.det_abs, kDetEps);
      if (t < best_t) {
        best_t = t;
        best = i;
        b_us = p.us;
        b_vs = p.vs;
        b_det = p.det_abs;
      }
    }
  }
  Hit h;
  h.hit = best_t < kBig;
  h.row = best;
  h.t = h.hit ? best_t : -1.0f;
  float inv_det = 1.0f / fmaxf(b_det, kDetEps);
  float u = b_us * inv_det, v = b_vs * inv_det;
  float w = 1.0f - u - v;
  V3 n = v3(w * T.a(A_N0, best) + u * T.a(A_N1, best) + v * T.a(A_N2, best),
            w * T.a(A_N0 + 1, best) + u * T.a(A_N1 + 1, best) + v * T.a(A_N2 + 1, best),
            w * T.a(A_N0 + 2, best) + u * T.a(A_N1 + 2, best) + v * T.a(A_N2 + 2, best));
  float inv = 1.0f / sqrtf(fmaxf(dot3(n, n), 1e-24f));
  h.normal = v3(n.x * inv, n.y * inv, n.z * inv);
  h.pos = v3(o.x + h.t * d.x, o.y + h.t * d.y, o.z + h.t * d.z);
  return h;
}

// Constant (kind 0) or gradient (kind 1) environment, times the strength.
__device__ V3 env_color(V3 d, const float* cst, int env_kind) {
  float strength = cst[C_STRENGTH];
  if (env_kind == 0) {
    return v3(cst[C_ENV0] * strength, cst[C_ENV0 + 1] * strength, cst[C_ENV0 + 2] * strength);
  }
  float t = saturate(d.y * 0.5f + 0.5f);
  return v3((cst[C_ENV0] * (1.0f - t) + cst[F_ENV1] * t) * strength,
            (cst[C_ENV0 + 1] * (1.0f - t) + cst[F_ENV1 + 1] * t) * strength,
            (cst[C_ENV0 + 2] * (1.0f - t) + cst[F_ENV1 + 2] * t) * strength);
}

// Directional + point light with shadow rays, or the debug==2 one-of-two
// MC estimator (pick < 0.5 -> directional, weight 2). Only for hit lanes.
__device__ V3 direct_lighting(const Tris& T, const float* cst, V3 pos, V3 normal, float pick) {
  V3 dl = load3(cst + C_DLDIR);
  V3 path = v3(cst[C_PLPOS] - pos.x, cst[C_PLPOS + 1] - pos.y, cst[C_PLPOS + 2] - pos.z);
  float dist = sqrtf(fmaxf(dot3(path, path), 0.0f));
  V3 lp = normalize3(path);
  float tmax_p = fmaxf(dist - kRayEps, kRayEps);
  bool is_mc = cst[F_IS_MC] > 0.5f;
  bool need_d = !is_mc || pick < 0.5f;
  bool need_p = !is_mc || !(pick < 0.5f);
  float d_vis = (need_d && !any_hit(T, pos, dl, kRayEps, false, 0.0f)) ? 1.0f : 0.0f;
  float p_vis = (need_p && !any_hit(T, pos, lp, kRayEps, true, tmax_p)) ? 1.0f : 0.0f;
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
}

// Depth-1 radiance of an active bounce ray: emissive + albedo * direct / pi
// on a hit, the environment on a miss.
__device__ V3 secondary_radiance(const Tris& T, const float* cst, V3 o, V3 d, float pick,
                                 int env_kind) {
  Hit h = closest_hit(T, o, d, kRayEps, false);
  if (!h.hit) return env_color(d, cst, env_kind);
  V3 direct = direct_lighting(T, cst, h.pos, h.normal, pick);
  float estr = T.a(A_ESTR, h.row);
  float out[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float shade = T.a(A_ALBEDO + k, h.row) * comp(direct, k) / kPi;
    out[k] = T.a(A_EMISSIVE + k, h.row) * estr + shade;
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

// One progressive sample of pixel (px, py); adds its colour to acc.
__device__ void sample_pixel(const Tris& T, const float* cm, uint32_t frame, const float* cst,
                             int px, int py, int width, int height, int env_kind, float acc[3]) {
  // ---- raygen (primary_ray_grid) ------------------------------------------
  float ndcx = ((float)px + 0.5f) / (float)width * 2.0f - 1.0f;
  float pyf = (float)py + cm[12];
  float ndcy = (pyf + 0.5f) / (float)height * 2.0f - 1.0f;
  V3 dun = v3(ndcx * cm[3] + (-ndcy) * cm[6] + cm[9], ndcx * cm[4] + (-ndcy) * cm[7] + cm[10],
              ndcx * cm[5] + (-ndcy) * cm[8] + cm[11]);
  float norm = sqrtf(dot3(dun, dun));
  V3 d = v3(dun.x / norm, dun.y / norm, dun.z / norm);
  V3 o = load3(cm);

  Hit h = closest_hit(T, o, d, 0.0f, true);
  if (!h.hit) {
    V3 e = env_color(d, cst, env_kind);
    acc[0] += sanitize(e.x);
    acc[1] += sanitize(e.y);
    acc[2] += sanitize(e.z);
    return;
  }

  // ---- 5 LCG draws from the TEA pixel seed ----------------------------------
  uint32_t seed = tea_init((uint32_t)(py * width + px), frame);
  float u[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    seed = seed * 1664525u + 1013904223u;
    u[k] = (float)(seed & 0x00FFFFFFu) / 16777216.0f;
  }
  const bool is_mc = cst[F_IS_MC] > 0.5f;
  const bool no_ind = cst[F_NO_IND] > 0.5f;
  const bool cosine = cst[F_COSINE] > 0.5f;
  const int r = h.row;
  V3 pos = h.pos, normal = h.normal;

  // ---- direct lighting (draw u1 picks the light under debug==2) ------------
  V3 direct = direct_lighting(T, cst, pos, normal, u[0]);

  // ---- indirect diffuse direction: draws (u1, u2), or (u2, u3) after the pick
  V3 diff_dir = hemisphere_dir(normal, is_mc ? u[1] : u[0], is_mc ? u[2] : u[1], cosine);

  // ---- Phong lobe: the next two draws after the ones consumed above -------
  float r0_ph = no_ind ? (is_mc ? u[1] : u[0]) : (is_mc ? u[3] : u[2]);
  float r1_ph = no_ind ? (is_mc ? u[2] : u[1]) : (is_mc ? u[4] : u[3]);
  float mtype = T.a(A_TYPE, r);
  float refl = T.a(A_REFL, r);
  bool spec_active = ((fabsf(mtype - 1.0f) < 0.5f) || (fabsf(mtype - 2.0f) < 0.5f)) && (refl > 0.001f);
  float exponent = expf((1.0f - T.a(A_ROUGH, r)) * 12.0f);
  float don = dot3(d, normal);
  V3 mirror = normalize3(v3(d.x - 2.0f * don * normal.x, d.y - 2.0f * don * normal.y,
                            d.z - 2.0f * don * normal.z));
  V3 tan, bit;
  onb(mirror, &tan, &bit);
  float cos_t = powf(r0_ph, 1.0f / (exponent + 1.0f));
  float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  float phi = kTwoPi * r1_ph;
  float powered_cos = powf(cos_t, exponent);
  float pdf = (exponent + 1.0f) / kTwoPi * powered_cos;
  float brdf = (exponent + 2.0f) / kTwoPi * powered_cos;
  float xs = sin_t * cosf(phi), zs = sin_t * sinf(phi);
  V3 phong_dir = v3(xs * tan.x + cos_t * mirror.x + zs * bit.x,
                    xs * tan.y + cos_t * mirror.y + zs * bit.y,
                    xs * tan.z + cos_t * mirror.z + zs * bit.z);

  // ---- bounces: depth-1 shading re-seeds, so both pick the light with u1 --
  V3 sec = no_ind ? v3(0.0f, 0.0f, 0.0f) : secondary_radiance(T, cst, pos, diff_dir, u[0], env_kind);
  V3 spec_rad = spec_active ? secondary_radiance(T, cst, pos, phong_dir, u[0], env_kind)
                            : v3(0.0f, 0.0f, 0.0f);

  // ---- epilogue (trace_rays) -------------------------------------------------
  float nol = saturate(dot3(normal, diff_dir));
  float ratio = pdf > 1e-30f ? brdf / fmaxf(pdf, 1e-30f) : (exponent + 2.0f) / (exponent + 1.0f);
  float cosi = saturate(-dot3(d, normal));
  float pw5 = powf(1.0f - cosi, 5.0f);
  float estr = T.a(A_ESTR, r);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float indirect = no_ind ? 0.0f : (cosine ? comp(sec, k) * kPi : comp(sec, k) * (nol * kTwoPi));
    float specular = spec_active ? comp(spec_rad, k) * ratio : 0.0f;
    float f0 = T.a(A_SPECULAR + k, r);
    float fresnel = spec_active ? f0 + (1.0f - f0) * pw5 : 0.0f;
    float albedo = T.a(A_ALBEDO + k, r);
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

__global__ void __launch_bounds__(kThreads)
fused_progressive_kernel(const float* __restrict__ cam, const uint32_t* __restrict__ frames,
                         const float* __restrict__ cst, const float* __restrict__ mt,
                         const float* __restrict__ attr, float* __restrict__ out, int s_count,
                         int c, int width, int height, int env_kind) {
  extern __shared__ float smem[];
  float* s_mt = smem;                  // [kMtSlots][c]
  float* s_at = smem + kMtSlots * c;   // [kAttrRows][c]
  // mt_pack is [4, c, 16]: slot j reads group g, column col.
  for (int k = threadIdx.x; k < kMtSlots * c; k += blockDim.x) {
    int j = k / c, i = k - j * c;
    int g = j < S_U ? 0 : (j < S_V ? 1 : (j < S_T ? 2 : 3));
    int col = j < S_U ? j : (j < S_V ? j - S_U : (j < S_T ? j - S_V : 6 + j - S_T));
    s_mt[k] = mt[(g * c + i) * 16 + col];
  }
  // attr_pack is [32, c]; rows 0..23 are contiguous.
  for (int k = threadIdx.x; k < kAttrRows * c; k += blockDim.x) s_at[k] = attr[k];
  __syncthreads();

  int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= width * height) return;
  Tris T{s_mt, s_at, c};
  int px = pix % width, py = pix / width;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < s_count; ++s) {
    sample_pixel(T, cam + s * 16, frames[s], cst, px, py, width, height, env_kind, acc);
  }
  out[pix * 3 + 0] = acc[0];
  out[pix * 3 + 1] = acc[1];
  out[pix * 3 + 2] = acc[2];
}

}  // namespace

// Sum of S progressive samples into out [height, width, 3] float32.
//   cam [S, 16] f32 (pack_cameras), frames [S] u32, cst [2, 16] f32
//   (pack_consts), mt [4, c, 16] f32, attr [32, c] f32; env_kind 0 or 1.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dxr_fused_progressive_sum(const float* cam, const uint32_t* frames,
                                         const float* cst, const float* mt, const float* attr,
                                         float* out, int s_count, int c, int width, int height,
                                         int env_kind, void* stream) {
  if (c < 1 || c > kMaxTris || s_count < 1 || width < 1 || height < 1 ||
      (env_kind != 0 && env_kind != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  int n = width * height;
  int blocks = (n + kThreads - 1) / kThreads;
  size_t smem = (size_t)(kMtSlots + kAttrRows) * c * sizeof(float);  // <= 44 KB
  fused_progressive_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      cam, frames, cst, mt, attr, out, s_count, c, width, height, env_kind);
  return (int)cudaGetLastError();
}
