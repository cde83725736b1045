// Brute-force intersection kernels (B3a closest hit, B3b occlusion) for
// Hopper (sm_90a).
//
// Replace the TPU kernels _closest_kernel and _any_kernel
// (dxrexperiments_tpu/ops/intersect_pallas.py:130 and :207, launched by
// trace_closest and trace_any). The wavefront integrator launches them once
// per trace stage of a brute-force scene (one without a BVH or a TLAS):
// scenes the sample megakernel (B1) does not take, AO and refraction.
//
// - closest (B3a): the closest valid triangle of every ray, with t, u, v and
//   the hit attributes fused: the winner's interpolated unit normal, the hit
//   position o + t d and its material rows, read once per ray from attr_pack;
// - any (B3b): whether any triangle blocks the ray's window.
//
// What bounds it: operations. A launch tests every (ray, triangle) pair, ~50
// float32 operations each, and moves only 24 bytes in and 100 (closest) or 1
// (any) out per ray. Design answer: one thread per ray, in the caller's
// order; the block stages tiles of kTile triangles' 19 Möller–Trumbore
// coefficients into shared memory (five float4s per triangle), and every
// thread of a warp reads the same triangle at once, so the reads are
// broadcasts. Closest walks the triangles in index order and takes a strictly
// smaller t, which keeps the lowest index among equal t: the TPU kernel's
// rule (first minimal triangle within a chunk, strictly better across
// chunks). Occlusion stops testing at a ray's first blocker, and the block
// stops staging once every ray in it is done. Rays whose window is empty
// (t_max <= t_min, the integrator's inactive lanes) or whose direction is 0
// cannot hit and test nothing. What the TPU kernel does for Mosaic has no
// counterpart here: rays on lanes, the one-hot MXU gather of the attributes,
// the revisited output block that carries the best hit across the grid.
//
// Arithmetic is common.cuh's pair_test (shared with B1 and the BVH walks):
// the same term sums and sign-multiplied windows as the TPU kernel,
// t = ts / max(|det|, 1e-12), u = us / max(|det|, 1e-12).

#include "common.cuh"

namespace {

using namespace dxr;

constexpr int kThreads = 256;
constexpr int kTile = 256;  // triangles staged per tile: 20 KB of shared memory
constexpr int kQuads = 5;   // float4s per staged triangle: slots 0..18 and a zero
constexpr int kMatIdRow = 9;  // attr_pack row of the material id
// outputs of the closest kernel, each field a contiguous [n] or [n, 3]
// block (the integrator's elementwise ops then keep row-major layouts):
// scal [7, n] f32, vec [5, n, 3] f32 (normal, position, albedo, specular,
// emissive), ids [3, n] i64
enum { O_T = 0, O_U, O_V, O_ESTR, O_REFL, O_ROUGH, O_IOR };
enum { I_TRI = 0, I_MAT, I_TYPE };

struct ArrCoef {
  const float* c;
  __device__ __forceinline__ float operator()(int j) const { return c[j]; }
};

// Stage triangles [start, start + count) of mt_pack [4, t_pad, 16] as five
// float4s each: coefficient slot j of group g (S_DET .. S_T + 3) at float j.
__device__ __forceinline__ void stage_tile(float4* tile, const float* __restrict__ mt, int t_pad,
                                           int start, int count) {
  float* f = reinterpret_cast<float*>(tile);
  for (int k = threadIdx.x; k < count * 4 * kQuads; k += blockDim.x) {
    const int i = k / (4 * kQuads), j = k - i * (4 * kQuads);
    float v = 0.0f;
    if (j < kMtSlots) {
      const int g = j < S_U ? 0 : (j < S_V ? 1 : (j < S_T ? 2 : 3));
      const int col = j < S_U ? j : (j < S_V ? j - S_U : (j < S_T ? j - S_V : 6 + j - S_T));
      v = __ldg(mt + ((size_t)g * t_pad + start + i) * 16 + col);
    }
    f[k] = v;
  }
}

__device__ __forceinline__ void load_tri(const float4* tile, int i, float c[4 * kQuads]) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const float4 v = tile[i * kQuads + q];
    c[4 * q] = v.x;
    c[4 * q + 1] = v.y;
    c[4 * q + 2] = v.z;
    c[4 * q + 3] = v.w;
  }
}

struct Ray {
  V3 o, d;
  float tmin, tmax;
  bool live;  // can hit: an index below n, a non-empty window, a direction
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        const float* __restrict__ tmin_p,
                                        const float* __restrict__ tmax_p, float tmin_s,
                                        float tmax_s, int n, int i) {
  Ray r;
  r.o = r.d = v3(0.0f, 0.0f, 0.0f);
  r.tmin = tmin_s;
  r.tmax = tmax_s;
  r.live = false;
  if (i < n) {
    const size_t b = 3 * (size_t)i;
    r.o = v3(__ldg(o + b), __ldg(o + b + 1), __ldg(o + b + 2));
    r.d = v3(__ldg(d + b), __ldg(d + b + 1), __ldg(d + b + 2));
    if (tmin_p) r.tmin = __ldg(tmin_p + i);
    if (tmax_p) r.tmax = __ldg(tmax_p + i);
    r.live = r.tmax > r.tmin && fabsf(r.d.x) + fabsf(r.d.y) + fabsf(r.d.z) > 0.0f;
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin_p, const float* __restrict__ tmax_p, float tmin_s,
               float tmax_s, const float* __restrict__ mt, const float* __restrict__ attr, int n,
               int t_pad, int t_count, int cull, float* __restrict__ scal,
               float* __restrict__ vec, long long* __restrict__ ids) {
  __shared__ float4 tile[kTile * kQuads];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = load_ray(o, d, tmin_p, tmax_p, tmin_s, tmax_s, n, i);
  const V3 mo = cross3(r.o, r.d);
  float best_t = kBig, b_us = 0.0f, b_vs = 0.0f, b_det = 0.0f;
  int best = -1;
  if (__syncthreads_or(r.live)) {
    for (int start = 0; start < t_count; start += kTile) {
      const int count = min(kTile, t_count - start);
      __syncthreads();  // the previous tile is read
      stage_tile(tile, mt, t_pad, start, count);
      __syncthreads();
      if (!r.live) continue;
#pragma unroll 2
      for (int k = 0; k < count; ++k) {
        float c[4 * kQuads];
        load_tri(tile, k, c);
        const Pair p = pair_test(ArrCoef{c}, r.o, r.d, mo, r.tmin, true, r.tmax, cull != 0);
        if (p.valid) {
          const float t = p.ts / fmaxf(p.det_abs, kDetEps);
          if (t < best_t) {
            best_t = t;
            best = start + k;
            b_us = p.us;
            b_vs = p.vs;
            b_det = p.det_abs;
          }
        }
      }
    }
  }
  if (i >= n) return;
  const size_t ni = (size_t)n, ii = (size_t)i;
  const bool hit = best >= 0;
  const float t = hit ? best_t : -1.0f;
  const float inv_det = 1.0f / fmaxf(b_det, kDetEps);
  const float u = hit ? b_us * inv_det : 0.0f, v = hit ? b_vs * inv_det : 0.0f;
  const V3 nrm = hit ? interp_normal(attr + best, t_pad, u, v) : v3(0.0f, 0.0f, 0.0f);
  const V3 pos = v3(r.o.x + t * r.d.x, r.o.y + t * r.d.y, r.o.z + t * r.d.z);
  const float* a = attr + (hit ? best : 0);  // attr_pack column of the hit triangle
  auto row = [&](int k) { return hit ? __ldg(a + (size_t)k * t_pad) : 0.0f; };
  scal[O_T * ni + ii] = t;
  scal[O_U * ni + ii] = u;
  scal[O_V * ni + ii] = v;
  scal[O_ESTR * ni + ii] = row(A_ESTR);
  scal[O_REFL * ni + ii] = row(A_REFL);
  scal[O_ROUGH * ni + ii] = row(A_ROUGH);
  scal[O_IOR * ni + ii] = row(A_IOR);
  float* vr = vec + 3 * ii;
  const float vals[5][3] = {{nrm.x, nrm.y, nrm.z}, {pos.x, pos.y, pos.z},
                            {row(A_ALBEDO), row(A_ALBEDO + 1), row(A_ALBEDO + 2)},
                            {row(A_SPECULAR), row(A_SPECULAR + 1), row(A_SPECULAR + 2)},
                            {row(A_EMISSIVE), row(A_EMISSIVE + 1), row(A_EMISSIVE + 2)}};
#pragma unroll
  for (int f = 0; f < 5; ++f) {
#pragma unroll
    for (int c = 0; c < 3; ++c) vr[f * 3 * ni + c] = vals[f][c];
  }
  ids[I_TRI * ni + ii] = best;
  ids[I_MAT * ni + ii] = hit ? (long long)row(kMatIdRow) : 0;
  ids[I_TYPE * ni + ii] = hit ? (long long)row(A_TYPE) : 0;
}

__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ tmin_p, const float* __restrict__ tmax_p, float tmin_s,
           float tmax_s, const float* __restrict__ mt, int n, int t_pad, int t_count,
           unsigned char* __restrict__ occ) {
  __shared__ float4 tile[kTile * kQuads];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = load_ray(o, d, tmin_p, tmax_p, tmin_s, tmax_s, n, i);
  const V3 mo = cross3(r.o, r.d);
  bool occluded = false, done = !r.live;
  for (int start = 0; start < t_count; start += kTile) {
    // a barrier too: every thread has read the previous tile
    if (__syncthreads_and(done)) break;
    const int count = min(kTile, t_count - start);
    stage_tile(tile, mt, t_pad, start, count);
    __syncthreads();
    if (done) continue;
    for (int k = 0; k < count; ++k) {
      float c[4 * kQuads];
      load_tri(tile, k, c);
      if (pair_test(ArrCoef{c}, r.o, r.d, mo, r.tmin, true, r.tmax, false).valid) {
        occluded = done = true;
        break;
      }
    }
  }
  if (i < n) occ[i] = occluded ? 1 : 0;
}

bool bad_shape(int n, int t_pad, int t_count) {
  return n < 0 || t_pad < 1 || t_count < 0 || t_count > t_pad;
}

}  // namespace

// Closest hits of n rays against triangles [0, t_count) of the scene, on
// `stream`.
//   o, d [n, 3] f32; tmin_p, tmax_p [n] f32 or null (then tmin, tmax for
//   every ray); mt = mt_pack [4, t_pad, 16] f32, attr = attr_pack [32, t_pad]
//   f32; cull != 0 culls backfaces (det > 1e-12 only).
//   scal [7, n] f32: t (-1 on a miss), u, v, emissive strength,
//   reflectivity, roughness, ior; vec [5, n, 3] f32: normal, position,
//   albedo, specular, emissive; ids [3, n] i64: triangle (-1 on a miss),
//   material id, material type. A miss has zeros but for t, the position
//   o - d and the triangle.
// Returns cudaGetLastError() (0 on success).
extern "C" int dxr_intersect_closest(const float* o, const float* d, const float* tmin_p,
                                     const float* tmax_p, float tmin, float tmax, const float* mt,
                                     const float* attr, int n, int t_pad, int t_count, int cull,
                                     float* scal, float* vec, long long* ids, void* stream) {
  if (bad_shape(n, t_pad, t_count)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  closest_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      o, d, tmin_p, tmax_p, tmin, tmax, mt, attr, n, t_pad, t_count, cull, scal, vec, ids);
  return (int)cudaGetLastError();
}

// Occlusion of n rays: occ [n] (bool bytes) is 1 where a triangle of
// [0, t_count) blocks (t_min, t_max); other arguments as for
// dxr_intersect_closest. Returns cudaGetLastError() (0 on success).
extern "C" int dxr_intersect_any(const float* o, const float* d, const float* tmin_p,
                                 const float* tmax_p, float tmin, float tmax, const float* mt,
                                 int n, int t_pad, int t_count, unsigned char* occ,
                                 void* stream) {
  if (bad_shape(n, t_pad, t_count)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  any_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(o, d, tmin_p, tmax_p, tmin, tmax, mt,
                                                             n, t_pad, t_count, occ);
  return (int)cudaGetLastError();
}
