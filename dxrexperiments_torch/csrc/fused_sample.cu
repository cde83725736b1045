// Brute-force sample megakernels for Hopper (sm_90a).
//
// Replace the TPU kernel _fused_kernel
// (dxrexperiments_tpu/ops/fused_sample_pallas.py:640) in its two modes:
// - progressive: one launch renders S jittered samples of the whole
//   brute-force ray tree per pixel and writes their sum:
//     raygen, 5 LCG draws from the TEA pixel seed, the primary closest-hit
//     sweep (backfaces culled), 2 shadow sweeps, and a diffuse and a Phong
//     bounce, each with its closest sweep and 2 shadow sweeps (9 sweeps over
//     the C triangles in all), then the shading epilogue and the sum over S;
// - realtime (fused_sample_pallas.py:861-911): one launch renders S frames,
//   one sample each, on a (pixel blocks, S) grid; the tree has no diffuse
//   bounce (6 sweeps), the Phong bounce's shade drops the emissive term, and
//   each frame writes its own AOVs (direct, indirect specular, albedo,
//   roughness), so nothing is summed across frames.
//
// A miss, primary or bounce, takes the environment: constant, gradient, or
// a lat-long or cubemap texture looked up inside the kernel (common.cuh
// env_color; the TPU kernel's env-deferred mode wrote bounce directions and
// env weights out for a gather pass instead).
//
// What bounds it: instruction issue. A pixel-sample does about 9*N
// Möller–Trumbore pair tests (N = 36 triangles for the Cornell box), each
// ~20 FMAs, while the output is 12 bytes per pixel per dispatch (3 MB at
// 512^2). Design answer: every block stages each triangle's record (the 19
// used Möller–Trumbore coefficients and a pad, ops/traverse.tri_records,
// 80 bytes) and its 24 used attribute rows into shared memory once (44
// floats per triangle, 45 KB at C = 256); all threads of a warp read the
// same triangle at once, so the reads are broadcasts, and a pair test
// reads its record as five 16-byte loads instead of 19 scalar ones. The
// sweeps stop after the scene's n_live = num_tris rows (a pad row never
// hits). A block is 256 threads. The per-ray state lives in registers, one
// thread per pixel in raster order, and the S-sample sum stays in
// registers and is written once: no atomics, nothing carried across
// blocks. Work the reference masks out is skipped per thread (miss lanes,
// inactive bounces, the unpicked light of the debug==2 estimator), which
// changes no result.
//
// Two opt-ins of the TPU kernel are separate compile-time instantiations;
// the base one's code is unchanged by them:
// - CLUSTERED (FUSED_CLUSTERS, the TPU kernel's _any_hit_clustered,
//   fused_sample_pallas.py:360): every shadow sweep of the direct lighting
//   (both lights' sweeps, and the debug==2 pick's one) gates each
//   cluster_rows window of the triangles behind a slab test of the
//   window's box against the ray's [t_min, t_max] window; a thread skips the
//   window's rows where its ray misses the box, and its sweep ends at the
//   first blocker anyway. The boxes (ops/fused_sample.cluster_aabbs, with a
//   1e-4 margin) sit in shared memory beside the triangles. The gate only
//   skips rows that cannot block, so occlusion is the flat sweep's, bit for
//   bit. The TPU kernel gates a tile of lanes at once; here each thread
//   gates its own ray, so a skip needs no agreement across the block.
// - BLOCKED (FUSED_BLOCK_W, fused_sample_pallas.py:678-688): a block of
//   kThreads renders a block_w x (kThreads / block_w) pixel block, not
//   kThreads pixels of a raster row. Each pixel's computation depends only
//   on its coordinates and seed, so the image is the same.
//
// The ray tree itself is common.cuh's, shared with the fused-traversal
// kernel (B5); this file holds B1's brute-force trace backends (Tris,
// ClusteredTris), the shared-memory staging and the launches. Arithmetic
// follows the TPU kernel: the same term sums, the same sign-multiplied
// validity windows, t = ts / max(|det|, 1e-12), ties to the lowest triangle
// index, and the same draw routing. Build without --use_fast_math.

#include "common.cuh"

namespace {

using namespace dxr;

constexpr int kThreads = 256;
constexpr int kMaxTris = 256;
constexpr int kAttrRows = 24;  // used attr_pack rows

// The brute-force trace backend: every triangle staged in shared memory,
// records [c][kRecQuads] float4 and attribute rows [kAttrRows][c]; the
// sweeps run over the first n rows (the rest are padding).
struct Tris {
  const float4* rec;  // [c][kRecQuads]
  const float* at;    // [kAttrRows][c]
  int c, n;
  static constexpr int rig = 3;  // B1 takes the 1 directional + 1 point rig only
  static constexpr bool kArea = false;  // and no area light, no albedo texture

  __device__ __forceinline__ RecCoef coef(int i) const { return rec_coef(rec + i * kRecQuads); }
  __device__ __forceinline__ float a(int row, int i) const { return at[row * c + i]; }
  __device__ __forceinline__ float albedo(const Hit& h, int k) const {
    return a(A_ALBEDO + k, h.row);
  }

  // Occlusion: true when any triangle blocks (o + t d, t in (tmin, tmax)).
  __device__ bool occluded(V3 o, V3 d, float tmin, bool has_tmax, float tmax) const {
    V3 mo = cross3(o, d);
    for (int i = 0; i < n; ++i) {
      if (pair_test(coef(i), o, d, mo, tmin, has_tmax, tmax, false).valid) return true;
    }
    return false;
  }

  // Closest hit: ascending scan with a strict '<' keeps the lowest triangle
  // index on ties (the TPU kernel's min-then-lowest-row rule).
  __device__ Hit closest(V3 o, V3 d, float tmin, bool cull) const {
    V3 mo = cross3(o, d);
    float best_t = kBig, b_us = 0.0f, b_vs = 0.0f, b_det = 0.0f;
    int best = 0;
    for (int i = 0; i < n; ++i) {
      Pair p = pair_test(coef(i), o, d, mo, tmin, false, 0.0f, cull);
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
    h.normal = interp_normal(at + best, c, b_us * inv_det, b_vs * inv_det);
    h.pos = v3(o.x + h.t * d.x, o.y + h.t * d.y, o.z + h.t * d.z);
    return h;
  }
};

// CLUSTERED: Tris whose occlusion sweeps skip the clusters a ray misses.
struct ClusteredTris : Tris {
  const float* box;  // [k][6] lo xyz, hi xyz (shared memory)
  int k, rows;       // clusters, triangle rows per cluster

  __device__ bool occluded(V3 o, V3 d, float tmin, bool has_tmax, float tmax) const {
    V3 mo = cross3(o, d);
    // fused_sample_pallas._safe_inv: |x| < 1e-12 -> 1e-12
    V3 inv = v3(1.0f / (fabsf(d.x) < 1e-12f ? 1e-12f : d.x),
                1.0f / (fabsf(d.y) < 1e-12f ? 1e-12f : d.y),
                1.0f / (fabsf(d.z) < 1e-12f ? 1e-12f : d.z));
    const float far = has_tmax ? tmax : kBig;
    for (int q = 0; q < k; ++q) {
      const float* b = box + 6 * q;
      float tn;
      if (!slab(v3(b[0], b[1], b[2]), v3(b[3], b[4], b[5]), o, inv, tmin, far, &tn)) continue;
      const int end = min(q * rows + rows, n);
      for (int i = q * rows; i < end; ++i) {
        if (pair_test(coef(i), o, d, mo, tmin, has_tmax, tmax, false).valid) return true;
      }
    }
    return false;
  }
};

// The backend of an instantiation: Tris, or ClusteredTris with the boxes
// staged after the triangles in shared memory.
template <class T>
__device__ __forceinline__ T backend(const Tris& t, float* smem, const float* __restrict__ boxes,
                                     int k, int rows);
template <>
__device__ __forceinline__ Tris backend<Tris>(const Tris& t, float*, const float* __restrict__,
                                              int, int) {
  return t;
}
template <>
__device__ __forceinline__ ClusteredTris backend<ClusteredTris>(const Tris& t, float* smem,
                                                                const float* __restrict__ boxes,
                                                                int k, int rows) {
  float* s_box = smem + (kRecWords + kAttrRows) * t.c;
  for (int i = threadIdx.x; i < 6 * k; i += blockDim.x) s_box[i] = boxes[(i / 6) * 8 + i % 6];
  __syncthreads();
  ClusteredTris ct;
  static_cast<Tris&>(ct) = t;
  ct.box = s_box;
  ct.k = k;
  ct.rows = rows;
  return ct;
}

// The pixel of this thread: raster, or BLOCKED (block_w x kThreads /
// block_w blocks, the launch's blocks in raster order of the blocks).
template <bool kBlocked>
__device__ __forceinline__ int pixel_index(int width, int block_w) {
  if constexpr (kBlocked) {
    const int wb = width / block_w, bh = kThreads / block_w;
    const int px = (blockIdx.x % wb) * block_w + threadIdx.x % block_w;
    const int py = (blockIdx.x / wb) * bh + threadIdx.x / block_w;
    return py * width + px;
  }
  return blockIdx.x * blockDim.x + threadIdx.x;
}

// Every block stages the records and the used attribute rows of all c
// triangles into shared memory: [c][kRecQuads] float4, then [kAttrRows][c].
__device__ __forceinline__ Tris stage_tris(float* smem, const float4* __restrict__ rec,
                                           const float* __restrict__ attr, int c, int n) {
  float4* s_rec = reinterpret_cast<float4*>(smem);
  float* s_at = smem + kRecWords * c;
  for (int k = threadIdx.x; k < kRecQuads * c; k += blockDim.x) s_rec[k] = __ldg(rec + k);
  // attr_pack is [32, c]; rows 0..23 are contiguous.
  for (int k = threadIdx.x; k < kAttrRows * c; k += blockDim.x) s_at[k] = attr[k];
  __syncthreads();
  return Tris{s_rec, s_at, c, n};
}

template <class Tr, bool kBlocked>
__global__ void __launch_bounds__(kThreads)
fused_progressive_kernel(const float* __restrict__ cam, const uint32_t* __restrict__ frames,
                         const float* __restrict__ cst, const float4* __restrict__ rec,
                         const float* __restrict__ attr, float* __restrict__ out, int s_count,
                         int c, int n_live, int width, int height, Env env,
                         const float* __restrict__ boxes, int n_boxes, int cluster_rows,
                         int block_w) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Tr T = backend<Tr>(stage_tris(smem, rec, attr, c, n_live), smem, boxes, n_boxes,
                     cluster_rows);
  int pix = pixel_index<kBlocked>(width, block_w);
  if (pix >= width * height) return;
  int px = pix % width, py = pix / width;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < s_count; ++s) {
    sample_pixel(T, cam + s * 16, frames[s], cst, px, py, width, height, env, acc);
  }
  out[pix * 3 + 0] = acc[0];
  out[pix * 3 + 1] = acc[1];
  out[pix * 3 + 2] = acc[2];
}

// Grid (pixel blocks, S frames): block (x, s) renders frame s of its pixels.
template <class Tr, bool kBlocked>
__global__ void __launch_bounds__(kThreads)
fused_realtime_kernel(const float* __restrict__ cam, const uint32_t* __restrict__ frames,
                      const float* __restrict__ cst, const float4* __restrict__ rec,
                      const float* __restrict__ attr, float* __restrict__ direct,
                      float* __restrict__ ispec, float* __restrict__ albedo,
                      float* __restrict__ rough, int c, int n_live, int width, int height,
                      Env env, const float* __restrict__ boxes, int n_boxes, int cluster_rows,
                      int block_w) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Tr T = backend<Tr>(stage_tris(smem, rec, attr, c, n_live), smem, boxes, n_boxes,
                     cluster_rows);
  int n = width * height;
  int pix = pixel_index<kBlocked>(width, block_w);
  if (pix >= n) return;
  int s = blockIdx.y;
  float aov[10];
  realtime_pixel(T, cam + s * 16, frames[s], cst, pix % width, pix / width, width, height, env,
                 aov);
  size_t o = (size_t)s * n + pix;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    direct[o * 3 + k] = aov[k];
    ispec[o * 3 + k] = aov[3 + k];
    albedo[o * 3 + k] = aov[6 + k];
  }
  rough[o] = aov[9];
}

// The instantiation for the opt-ins: base, CLUSTERED, BLOCKED or both.
template <bool kRealtime, class Tr, bool kBlocked>
auto kernel_for() {
  if constexpr (kRealtime) {
    return fused_realtime_kernel<Tr, kBlocked>;
  } else {
    return fused_progressive_kernel<Tr, kBlocked>;
  }
}

template <bool kRealtime>
auto pick_kernel(bool clustered, bool blocked) {
  if (clustered) {
    return blocked ? kernel_for<kRealtime, ClusteredTris, true>()
                   : kernel_for<kRealtime, ClusteredTris, false>();
  }
  return blocked ? kernel_for<kRealtime, Tris, true>() : kernel_for<kRealtime, Tris, false>();
}

// The opt-in arguments are valid: no boxes (base), or n_boxes boxes of
// cluster_rows rows covering the c triangles; block_w 0 (raster), or a
// divisor of kThreads and of the width whose block height divides the height.
bool opt_ins_ok(int c, int width, int height, const float* boxes, int n_boxes, int cluster_rows,
                int block_w) {
  if (boxes != nullptr && (n_boxes < 1 || cluster_rows < 1 || n_boxes * cluster_rows < c ||
                           (n_boxes - 1) * cluster_rows >= c)) {
    return false;
  }
  if (block_w != 0 && (block_w < 0 || kThreads % block_w || width % block_w ||
                       height % (kThreads / block_w))) {
    return false;
  }
  return true;
}

// The records: 16-byte aligned (float4 loads), n_live of their c rows swept.
bool live_ok(const float* rec, int c, int n_live) {
  return rec != nullptr && reinterpret_cast<uintptr_t>(rec) % 16 == 0 && n_live >= 1 &&
         n_live <= c;
}

// shared memory: the triangles, then the cluster boxes (<= 45 KB + 6 KB)
size_t smem_bytes(int c, const float* boxes, int n_boxes) {
  return ((size_t)(kRecWords + kAttrRows) * c + (boxes != nullptr ? 6 * n_boxes : 0)) *
         sizeof(float);
}

// A launch above the default 48 KB of dynamic shared memory (the cluster
// boxes beside some 200 or more triangles) must raise the kernel's limit
// first. Returns the CUDA error code (0 on success).
template <class K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

// Sum of S progressive samples into out [height, width, 3] float32.
//   cam [S, 16] f32 (pack_cameras), frames [S] u32, cst [2, 16] f32
//   (pack_consts), rec [c, 20] f32 (tri_records, 16-byte aligned), attr
//   [32, c] f32; the sweeps test rows 0..n_live - 1 (1 <= n_live <= c; the
//   rows after the scene's triangles are padding); env_kind 0-3, and
//   for kind 2 env_tex the lat-long [env_h, env_w, 3] f32, for kind 3 the
//   cubemap [6, env_w, env_w, 3] f32 (env_h == env_w); ignored for 0 and 1.
//   Opt-ins: boxes [n_boxes, 8] f32 (ops/fused_sample.cluster_aabbs) with
//   cluster_rows rows each, or null for the flat sweeps; block_w > 0 for the
//   blocked pixel order, 0 for raster.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for bad arguments (a texture kind without its
// texture or with empty dimensions among them, or opt-ins that do not fit).
extern "C" int dxr_fused_progressive_sum(const float* cam, const uint32_t* frames,
                                         const float* cst, const float* rec, const float* attr,
                                         float* out, int s_count, int c, int n_live, int width,
                                         int height, int env_kind, const float* env_tex,
                                         int env_w, int env_h, const float* boxes, int n_boxes,
                                         int cluster_rows, int block_w, void* stream) {
  if (c < 1 || c > kMaxTris || !live_ok(rec, c, n_live) || s_count < 1 || width < 1 ||
      height < 1 ||
      !env_args_ok(env_kind, env_tex, env_w, env_h) ||
      !opt_ins_ok(c, width, height, boxes, n_boxes, cluster_rows, block_w)) {
    return (int)cudaErrorInvalidValue;
  }
  int n = width * height;
  int blocks = (n + kThreads - 1) / kThreads;
  auto kernel = pick_kernel<false>(boxes != nullptr, block_w > 0);
  const size_t smem = smem_bytes(c, boxes, n_boxes);
  if (int rc = allow_smem(kernel, smem)) return rc;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      cam, frames, cst, reinterpret_cast<const float4*>(rec), attr, out, s_count, c, n_live,
      width, height, Env{env_tex, env_kind, env_w, env_h}, boxes, n_boxes, cluster_rows,
      block_w);
  return (int)cudaGetLastError();
}

// S realtime frames: direct, ispec, albedo [S, height, width, 3] and rough
// [S, height, width] float32; the other arguments as for
// dxr_fused_progressive_sum, with the realtime jitter scale in cam.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dxr_fused_realtime_outputs(const float* cam, const uint32_t* frames,
                                          const float* cst, const float* rec, const float* attr,
                                          float* direct, float* ispec, float* albedo,
                                          float* rough, int s_count, int c, int n_live,
                                          int width, int height, int env_kind,
                                          const float* env_tex, int env_w, int env_h,
                                          const float* boxes, int n_boxes, int cluster_rows,
                                          int block_w, void* stream) {
  if (c < 1 || c > kMaxTris || !live_ok(rec, c, n_live) || s_count < 1 || s_count > 65535 ||
      width < 1 || height < 1 ||
      !env_args_ok(env_kind, env_tex, env_w, env_h) ||
      !opt_ins_ok(c, width, height, boxes, n_boxes, cluster_rows, block_w)) {
    return (int)cudaErrorInvalidValue;
  }
  int n = width * height;
  dim3 grid((n + kThreads - 1) / kThreads, s_count);
  auto kernel = pick_kernel<true>(boxes != nullptr, block_w > 0);
  const size_t smem = smem_bytes(c, boxes, n_boxes);
  if (int rc = allow_smem(kernel, smem)) return rc;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      cam, frames, cst, reinterpret_cast<const float4*>(rec), attr, direct, ispec, albedo,
      rough, c, n_live, width, height, Env{env_tex, env_kind, env_w, env_h}, boxes, n_boxes,
      cluster_rows, block_w);
  return (int)cudaGetLastError();
}
