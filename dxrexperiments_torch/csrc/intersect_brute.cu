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
// (any) out per ray. Design answer: the block stages tiles of kTile
// triangles' 19 Möller–Trumbore coefficients into shared memory, copied
// from the scene's tri_records (five float4s a triangle) by cp.async into
// two buffers, so the next tile's copy overlaps this tile's sweep; every
// thread of a warp reads the same triangle at once, so the reads are
// broadcasts. Closest walks the triangles in index
// order and takes a strictly smaller t, which keeps the lowest index among
// equal t: the TPU kernel's rule (first minimal triangle within a chunk,
// strictly better across chunks).
//
// The lanes that do no work. A batch's dead rays (an empty window, t_max <=
// t_min: the integrator's inactive lanes; or a zero direction) are
// scattered over it: a bounce's shadow rays exist only where the bounce
// hit. A thread per ray index then runs warps of a few live lanes, each as
// long as a full one. So a first kernel (queue_kernel) writes the dead
// rays' outputs (a miss; not occluded) and queues the live ones on the card
// (queue_push: one atomic a warp), and the sweeps read rays through the
// queue, whose count stays on the card (the host never waits): closest with
// a fixed grid whose blocks past the live count exit at once; occlusion
// with a persistent grid. An occlusion ray ends at its first blocker, and
// rays end at different tiles, so occlusion streams the tiles round-robin
// (a ring): a lane whose ray has found its blocker, or has tested one full
// ring, takes the next ray of the queue at the next tile boundary, which
// starts at that tile and ends one ring later. Occlusion is a boolean over
// all triangles, so the order changes no output bit. What the TPU kernel
// does for Mosaic has no counterpart here: rays on lanes, the one-hot MXU
// gather of the attributes, the revisited output block that carries the
// best hit across the grid.
//
// Arithmetic is common.cuh's pair_test (shared with B1 and the BVH walks):
// the same term sums and sign-multiplied windows as the TPU kernel,
// t = ts / max(|det|, 1e-12), u = us / max(|det|, 1e-12).

#include "common.cuh"

namespace {

using namespace dxr;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;  // triangles staged per tile: 20 KB of shared memory a buffer
constexpr int kQuads = 5;   // float4s per staged triangle: slots 0..18 and a zero
constexpr int kMatIdRow = 9;  // attr_pack row of the material id
// The live-ray queue's scratch q, int32 [kQueueHead + n]: the count of live
// rays, the cursor the occlusion kernel's persistent grid pulls from, then
// the live rays' indices. The entry points zero its head on their stream.
enum { Q_COUNT = 0, Q_CURSOR = 1, kQueueHead = 2 };
// outputs of the closest kernel, each field a contiguous [n] or [n, 3]
// block (the integrator's elementwise ops then keep row-major layouts):
// scal [7, n] f32, vec [5, n, 3] f32 (normal, position, albedo, specular,
// emissive), ids [3, n] i64
enum { O_T = 0, O_U, O_V, O_ESTR, O_REFL, O_ROUGH, O_IOR };
enum { I_TRI = 0, I_MAT, I_TYPE };

__device__ __forceinline__ unsigned lanes_below() { return (1u << (threadIdx.x & 31)) - 1u; }

// Append ray i to the queue if `live`: one atomicAdd per warp, the warp's
// live lanes at consecutive slots in lane order. Every lane of the warp
// calls it (one past the batch with live = false).
__device__ __forceinline__ void queue_push(int* q, bool live, int i) {
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if (mask == 0u) return;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if ((int)(threadIdx.x & 31) == leader) base = atomicAdd(q + Q_COUNT, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (live) q[kQueueHead + base + __popc(mask & lanes_below())] = i;
}

struct ArrCoef {
  const float* c;
  __device__ __forceinline__ float operator()(int j) const { return c[j]; }
};

// Stage the records [start, start + count) of tri_records [t_pad, 20] (the
// 19 slots in slot order and a zero): kQuads 16-byte copies each, issued
// with cp.async so that the next tile's copy overlaps this tile's sweep.
__device__ __forceinline__ void stage_tile(float4* tile, const float4* __restrict__ rec,
                                           int start, int count) {
  const float4* src = rec + (size_t)start * kQuads;
  for (int k = threadIdx.x; k < count * kQuads; k += blockDim.x) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(tile + k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src + k));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait for all but the newest copy group of this thread (the tile in use
// is the older one); a barrier then makes every thread's copies visible.
__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_group 1;\n" ::); }

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
  bool live;  // can hit: a non-empty window and a direction
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        const float* __restrict__ tmin_p,
                                        const float* __restrict__ tmax_p, float tmin_s,
                                        float tmax_s, int i) {
  Ray r;
  const size_t b = 3 * (size_t)i;
  r.o = v3(__ldg(o + b), __ldg(o + b + 1), __ldg(o + b + 2));
  r.d = v3(__ldg(d + b), __ldg(d + b + 1), __ldg(d + b + 2));
  r.tmin = tmin_p ? __ldg(tmin_p + i) : tmin_s;
  r.tmax = tmax_p ? __ldg(tmax_p + i) : tmax_s;
  r.live = r.tmax > r.tmin && fabsf(r.d.x) + fabsf(r.d.y) + fabsf(r.d.z) > 0.0f;
  return r;
}

// Ray i's closest-hit outputs; best < 0 writes a miss (t = -1, the position
// o - d, triangle -1, zeros elsewhere).
__device__ __forceinline__ void write_closest(const Ray& r, int i, int n, int t_pad,
                                              const float* __restrict__ attr, int best,
                                              float best_t, float b_us, float b_vs, float b_det,
                                              float* __restrict__ scal, float* __restrict__ vec,
                                              long long* __restrict__ ids) {
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

// One thread per ray index: a dead ray's outputs, a live ray's index queued.
// t_count = 0 leaves every ray dead.
template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
queue_kernel(const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ tmin_p, const float* __restrict__ tmax_p, float tmin_s,
             float tmax_s, const float* __restrict__ attr, int n, int t_pad, int t_count,
             int* __restrict__ q, float* __restrict__ scal, float* __restrict__ vec,
             long long* __restrict__ ids, unsigned char* __restrict__ occ) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = false;
  if (i < n) {
    const Ray r = load_ray(o, d, tmin_p, tmax_p, tmin_s, tmax_s, i);
    live = r.live && t_count > 0;
    if (!live) {
      if (kOcclusion) {
        occ[i] = 0;
      } else {
        write_closest(r, i, n, t_pad, attr, -1, kBig, 0.0f, 0.0f, 0.0f, scal, vec, ids);
      }
    }
  }
  queue_push(q, live, i);
}

// Closest hits of the queued rays: kThreads of them a block, in queue order;
// the blocks past the live count exit at once.
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin_p, const float* __restrict__ tmax_p, float tmin_s,
               float tmax_s, const float4* __restrict__ rec, const float* __restrict__ attr,
               int n, int t_pad, int t_count, int cull,
               const int* __restrict__ q, float* __restrict__ scal, float* __restrict__ vec,
               long long* __restrict__ ids) {
  __shared__ float4 tiles[2][kTile * kQuads];
  const int count = q[Q_COUNT];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if ((int)(blockIdx.x * blockDim.x) >= count) return;  // the whole block: no barrier skipped
  const bool live = j < count;
  const int i = live ? q[kQueueHead + j] : 0;
  const Ray r = load_ray(o, d, tmin_p, tmax_p, tmin_s, tmax_s, i);
  const V3 mo = cross3(r.o, r.d);
  float best_t = kBig, b_us = 0.0f, b_vs = 0.0f, b_det = 0.0f;
  int best = -1;
  stage_tile(tiles[0], rec, 0, min(kTile, t_count));
  for (int start = 0, buf = 0; start < t_count; start += kTile, buf ^= 1) {
    const int count_k = min(kTile, t_count - start);
    if (start + kTile < t_count) {  // the next tile's copy, into the other buffer
      stage_tile(tiles[buf ^ 1], rec, start + kTile, min(kTile, t_count - start - kTile));
    } else {
      asm volatile("cp.async.commit_group;\n" ::);  // an empty group keeps the count
    }
    stage_wait();
    __syncthreads();  // every thread's copies of this tile have landed
    if (live) {
      const float4* tile = tiles[buf];
#pragma unroll 2
      for (int k = 0; k < count_k; ++k) {
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
    __syncthreads();  // the tile is read before it is staged again
  }
  if (live) write_closest(r, i, n, t_pad, attr, best, best_t, b_us, b_vs, b_det, scal, vec, ids);
}

// Occlusion of the queued rays on a persistent grid: the block streams the
// tiles round-robin, and at each tile boundary its lanes without a ray
// take the next ones of the queue (one cursor atomic per block and tile).
// A ray starts at the tile it was taken at and ends at its first blocker or
// after n_tiles tiles.
__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ tmin_p, const float* __restrict__ tmax_p, float tmin_s,
           float tmax_s, const float4* __restrict__ rec, int t_count, int* __restrict__ q,
           unsigned char* __restrict__ occ) {
  __shared__ float4 tiles[2][kTile * kQuads];
  __shared__ int s_rank[kWarps];  // each warp's first rank in the block's pull
  __shared__ int s_base;          // the block's pull: queue slots s_base, s_base + 1, ...
  const int count = q[Q_COUNT];
  const int n_tiles = (t_count + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5;
  bool dry = false;  // thread 0: the cursor has passed the count
  int ray = -1, left = 0;
  Ray r;
  V3 mo;
  stage_tile(tiles[0], rec, 0, min(kTile, t_count));
  for (int tile = 0, buf = 0;; tile = tile + 1 == n_tiles ? 0 : tile + 1, buf ^= 1) {
    const bool need = ray < 0;
    const unsigned m = __ballot_sync(0xffffffffu, need);
    if ((threadIdx.x & 31) == 0) s_rank[warp] = __popc(m);
    __syncthreads();  // the ranks are in, and the last tile is read
    if (threadIdx.x == 0) {
      int total = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_rank[w];
        s_rank[w] = total;
        total += c;
      }
      int base = count;
      if (!dry && total > 0) {
        base = atomicAdd(q + Q_CURSOR, total);
        dry = base + total >= count;
      }
      s_base = base;
    }
    const int start = tile * kTile, count_k = min(kTile, t_count - start);
    const int next = tile + 1 == n_tiles ? 0 : tile + 1;  // its copy overlaps this tile's sweep
    stage_tile(tiles[buf ^ 1], rec, next * kTile, min(kTile, t_count - next * kTile));
    stage_wait();
    __syncthreads();  // the pull is known and the tile is staged
    if (need) {
      const int slot = s_base + s_rank[warp] + __popc(m & lanes_below());
      if (slot < count) {
        ray = q[kQueueHead + slot];
        r = load_ray(o, d, tmin_p, tmax_p, tmin_s, tmax_s, ray);
        mo = cross3(r.o, r.d);
        left = n_tiles;
      }
    }
    if (!__syncthreads_or(ray >= 0)) break;
    if (ray >= 0) {
      const float4* t = tiles[buf];
      bool hit = false;
      for (int k = 0; k < count_k; ++k) {
        float c[4 * kQuads];
        load_tri(t, k, c);
        if (pair_test(ArrCoef{c}, r.o, r.d, mo, r.tmin, true, r.tmax, false).valid) {
          hit = true;
          break;
        }
      }
      if (hit || --left == 0) {
        occ[ray] = hit ? 1 : 0;
        ray = -1;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

bool bad_shape(int n, int t_pad, int t_count, const void* rec) {
  return n < 0 || t_pad < 1 || t_count < 0 || t_count > t_pad || rec == nullptr ||
         reinterpret_cast<uintptr_t>(rec) % 16 != 0;
}

// Blocks of any_kernel resident on the whole card at once (its persistent
// grid), asked once per process.
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, any_kernel, kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

}  // namespace

// Closest hits of n rays against triangles [0, t_count) of the scene, on
// `stream`.
//   o, d [n, 3] f32; tmin_p, tmax_p [n] f32 or null (then tmin, tmax for
//   every ray); rec = tri_records [t_pad, 20] f32 (16-byte aligned: the 19
//   coefficient slots of each triangle and a zero), attr = attr_pack
//   [32, t_pad] f32;
//   cull != 0 culls backfaces (det > 1e-12 only); q int32 [2 + n] scratch
//   (the live-ray queue).
//   scal [7, n] f32: t (-1 on a miss), u, v, emissive strength,
//   reflectivity, roughness, ior; vec [5, n, 3] f32: normal, position,
//   albedo, specular, emissive; ids [3, n] i64: triangle (-1 on a miss),
//   material id, material type. A miss has zeros but for t, the position
//   o - d and the triangle.
// Returns cudaGetLastError() (0 on success).
extern "C" int dxr_intersect_closest(const float* o, const float* d, const float* tmin_p,
                                     const float* tmax_p, float tmin, float tmax, const float* rec,
                                     const float* attr, int n, int t_pad, int t_count, int cull,
                                     int* q, float* scal, float* vec, long long* ids,
                                     void* stream) {
  if (bad_shape(n, t_pad, t_count, rec)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaMemsetAsync(q, 0, kQueueHead * sizeof(int), s);
  queue_kernel<false><<<blocks, kThreads, 0, s>>>(o, d, tmin_p, tmax_p, tmin, tmax, attr, n, t_pad,
                                                  t_count, q, scal, vec, ids, nullptr);
  closest_kernel<<<blocks, kThreads, 0, s>>>(o, d, tmin_p, tmax_p, tmin, tmax,
                                             reinterpret_cast<const float4*>(rec), attr, n, t_pad,
                                             t_count, cull, q, scal, vec, ids);
  return (int)cudaGetLastError();
}

// Occlusion of n rays: occ [n] (bool bytes) is 1 where a triangle of
// [0, t_count) blocks (t_min, t_max); other arguments as for
// dxr_intersect_closest. Returns cudaGetLastError() (0 on success).
extern "C" int dxr_intersect_any(const float* o, const float* d, const float* tmin_p,
                                 const float* tmax_p, float tmin, float tmax, const float* rec,
                                 int n, int t_pad, int t_count, int* q, unsigned char* occ,
                                 void* stream) {
  if (bad_shape(n, t_pad, t_count, rec)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaMemsetAsync(q, 0, kQueueHead * sizeof(int), s);
  queue_kernel<true><<<blocks, kThreads, 0, s>>>(o, d, tmin_p, tmax_p, tmin, tmax, nullptr, n,
                                                 t_pad, t_count, q, nullptr, nullptr, nullptr,
                                                 occ);
  any_kernel<<<min(blocks, resident_blocks()), kThreads, 0, s>>>(
      o, d, tmin_p, tmax_p, tmin, tmax, reinterpret_cast<const float4*>(rec), t_count, q, occ);
  return (int)cudaGetLastError();
}
