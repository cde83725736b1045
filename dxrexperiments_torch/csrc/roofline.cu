// Roofline probes (B7) for Hopper (sm_90a).
//
// Replace the TPU probes of benchmarks/roofline.py, with its shapes and
// iteration counts (a and b are [8, 1024] blocks read by every grid block,
// each grid block writing its own [8, 1024] of the output):
// - fma_kernel (:68): the float32 FMA issue peak, 8 independent chains per
//   element, 16 steps per loop iteration: acc = acc * a + b;
// - mix_kernel (:88): the pair test's instruction mix, 19 FMAs and about
//   10 compare / min / select ops per step, 4 steps per loop iteration;
// - make_ov_kernel (:138): an FMA loop (8 chains, 8 steps per iteration)
//   beside a [1024, 16] x [16, 1024] float32 product issued every
//   vector_scale-th iteration, whose rows 0..7 feed back into the next
//   product's column scale, to see whether the vector and matrix units
//   overlap.
//
// What bounds them: operations, by design. The FMA probe's element does
// 8 x 16 x iters FMAs on two loaded values and writes one; the matrix probe
// runs on the tensor cores. Design answer: one thread per element for the
// first two (the chains in registers, the FMAs explicit fmaf so that the
// count is the source's). The overlap probe's product is split TF32 (float32
// split into a TF32 high part and a TF32 remainder, hi*hi + hi*lo + lo*hi),
// which keeps float32 accuracy as the TPU's HIGHEST precision does, on
// asynchronous warpgroup MMA (wgmma.mma_async m64nNk8 TF32): each block
// splits mt once into 128 KB of shared memory (wgmma's K-major core-matrix
// layout, hi and lo), and each of its two warpgroups walks 64-column tiles
// of the [8, 1024 * grid] outputs, one persistent block per SM. A product is
// taken transposed (columns as wgmma's M, mt's rows as its N), so the scaled
// rays are register fragments and a product writes no shared memory; its
// 64 x 1024 result is 42 wgmmas (rows 0..63 as n64, whose rows 0..7 feed
// tacc, then six n160 tiles), committed as one group. The FMA steps of the
// product's iteration and of the scale - 1 that follow run while the
// wgmmas are in flight; the warpgroup waits for them before the next
// product, whose column scale they feed, and the block's other warpgroup
// keeps the tensor cores busy meanwhile.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kLanes = 1024;      // roofline.LANES
constexpr int kSub = 8;           // roofline.SUB
constexpr int kChains = 8;        // roofline.CHAINS
constexpr int kUnroll = 16;       // roofline.UNROLL
constexpr int kMixUnroll = 4;     // roofline.py MIX_UNROLL
constexpr int kVUnroll = 8;       // roofline.py V_UNROLL
constexpr int kRows = 4 * 256;    // roofline.C_TRIS * 4: the product's rows
constexpr int kK = 16;            // the product's depth
constexpr int kThreads = 256;

// a and b of element (row, col) of the [8, 1024 * grid] output
__device__ __forceinline__ int ab_index(int row, int col) { return row * kLanes + col % kLanes; }

__global__ void __launch_bounds__(kThreads)
fma_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
           int iters, int n_cols) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= kSub * n_cols) return;
  const int i = ab_index(g / n_cols, g % n_cols);
  const float av = a[i], bv = b[i];
  float acc[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) acc[k] = av + (float)k;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) acc[k] = fmaf(acc[k], av, bv);
    }
  }
  float s = acc[0];
#pragma unroll
  for (int k = 1; k < kChains; ++k) s += acc[k];
  out[g] = s;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
mix_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
           int iters, int n_cols) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= kSub * n_cols) return;
  const int i = ab_index(g / n_cols, g % n_cols);
  const float av = a[i], bv = b[i];
  float det = av, u = av + 1.0f, v = av + 2.0f, t = av + 3.0f, best = bv + 30.0f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int step = 0; step < kMixUnroll; ++step) {
      const float m0 = fmaf(u, av, bv), m1 = fmaf(v, av, -bv), m2 = fmaf(t, av, bv);
      det = fmaf(det, av, m0);
      det = fmaf(det, av, m1);
      det = fmaf(det, av, m2);
      u = fmaf(u, av, m0);
      u = fmaf(u, av, m1);
      u = fmaf(u, av, m2);
      u = fmaf(u, av, bv);
      v = fmaf(v, av, m0);
      v = fmaf(v, av, m1);
      v = fmaf(v, av, m2);
      v = fmaf(v, av, bv);
      t = fmaf(t, av, m0);
      t = fmaf(t, av, m1);
      t = fmaf(t, av, m2);
      t = fmaf(t, av, bv);
      det = fmaf(det, av, bv);
      const float s = sign_of(det);
      const float da = det * s, us = u * s, vs = v * s;
      const float soft = fminf(fminf(us, vs), da - (us + vs));
      const float strict = t * s - da;
      const bool ok = (soft >= 0.0f) && (strict > 0.0f);
      best = (ok && t < best) ? t : best;
    }
  }
  out[g] = det + u + v + t + best;
}

// float32 -> TF32 (round to nearest, ties away: cvt.rna), as bits
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi and lo TF32 (lo is the remainder rounded to TF32)
__device__ __forceinline__ void split(float x, uint32_t* hi, uint32_t* lo) {
  *hi = tf32_bits(x);
  *lo = tf32_bits(x - __uint_as_float(*hi));
}

// ---- the overlap probe on warpgroup MMA (wgmma) ----
//
// The product is taken transposed, D^T [cols, rows] = B^T [cols, 16] x
// mt^T [16, rows], so that mt is wgmma's shared-memory operand (split once
// per block) and the operand that changes every product, the scaled rays
// B^T, lives in registers (wgmma's A fragments): a product writes no shared
// memory and needs no barrier. Tile layout: a warpgroup owns 64 columns
// (wgmma's M); its accumulator fragment holds, per thread, columns m = 16
// warp + group and m + 8 and product rows 8 j + 2 tig + {0, 1}, so rows
// 0..7 (j = 0) and tacc of those columns are the same four registers.

constexpr int kWarpgroup = 128;
constexpr int kOvGroups = 2;                         // warpgroups per block
constexpr int kOvThreads = kOvGroups * kWarpgroup;
constexpr int kTileCols = 64;                        // a warpgroup's columns: wgmma's M
constexpr int kZRows = 64;                           // mt rows 0..63 (rows 0..7 feed tacc)
constexpr int kXRows = 160;                          // rows 64..1023: six wgmma n160 tiles
constexpr int kXTiles = (kRows - kZRows) / kXRows;
static_assert(kZRows + kXTiles * kXRows == kRows, "the product's rows");
constexpr int kPart = kRows * kK;                    // floats of one TF32 part of mt
constexpr int kOvSmem = 2 * kPart * (int)sizeof(float);  // hi and lo: 128 KB
constexpr int kGridBlockTiles = kLanes / kTileCols;  // the tiles of grid block 0

// Float offset of mt[n][k] within one part: wgmma's K-major core matrices
// without swizzle (8 rows x 16 bytes = 4 TF32 each, 128 bytes contiguous),
// the 128 row groups of one 4-wide k chunk one after another (SBO = 128
// bytes), the four k chunks 16 KB apart (LBO).
__device__ __forceinline__ int mt_offset(int n, int k) {
  return ((k >> 2) * (kRows / 8) + (n >> 3)) * 32 + (n & 7) * 4 + (k & 3);
}
constexpr uint32_t kSBO = 128;
constexpr uint32_t kLBO = (kRows / 8) * kSBO;

// The descriptor of the 8 x N operand of mt rows n0.. and k 8 ks.. of the part at smem_part
__device__ __forceinline__ uint64_t mt_desc(uint32_t smem_part, int n0, int ks) {
  const uint32_t addr = smem_part + 4u * (uint32_t)mt_offset(n0, 8 * ks);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLBO >> 4) << 16) |
         ((uint64_t)(kSBO >> 4) << 32);  // layout type 0 (no swizzle), base offset 0
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of an accumulator across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d [64 x 64] (+)= a (64 x 8 TF32, registers) * b (8 x 64 TF32, shared memory: desc);
// scale_d 0 starts the sum afresh
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d [64 x 160] (+)= a (64 x 8 TF32, registers) * b (8 x 160 TF32, shared memory: desc)
__device__ __forceinline__ void wgmma(float (&d)[80], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), ACC8(64),
        ACC8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
#undef ACC8

// One product's split-TF32 passes on a tile of rows: per k step mt_lo * B_hi,
// mt_hi * B_lo, mt_hi * B_hi (the order of roofline.cu before wgmma). The
// first adds to d only if `accumulate`, which the caller sets to 0: a fresh
// sum. It is read at run time because ptxas removes a wgmma whose result
// nothing reads, and rows 64.. of every product but the stored last one
// reach no output: as the hardware may read d, every wgmma stays.
template <int N>
__device__ __forceinline__ void split_product(float (&d)[N], const uint32_t (&a_hi)[2][4],
                                              const uint32_t (&a_lo)[2][4], uint32_t smem_hi,
                                              uint32_t smem_lo, int n0, int accumulate) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    wgmma(d, a_hi[ks], mt_desc(smem_lo, n0, ks), ks > 0 ? 1 : accumulate);
    wgmma(d, a_lo[ks], mt_desc(smem_hi, n0, ks), 1);
    wgmma(d, a_hi[ks], mt_desc(smem_hi, n0, ks), 1);
  }
}

// Persistent blocks of two warpgroups; warpgroup slot s = 2 blockIdx.x + wg
// takes column tiles s, s + 2 gridDim.x, ... of the n_cols / 64 tiles
// (column c of the [8, n_cols] outputs is column c % 1024 of a, b and rays).
// mt [1024, 16], rays [16, 1024].
__global__ void __launch_bounds__(kOvThreads, 1)
overlap_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ mt, const float* __restrict__ rays,
               float* __restrict__ o_out, float* __restrict__ t_out,
               float* __restrict__ product, int n_cols, int m_iters, int scale, int do_vector,
               int do_matrix, int accumulate) {
  extern __shared__ float4 mt_s4[];  // [hi, lo][kPart / 4] in mt_offset order
  // split mt once: four k of one row a thread and step (the vector-alone
  // setting reads no mt, but keeps the same grid, block and shared memory)
  for (int c = threadIdx.x; do_matrix && c < kPart / 4; c += kOvThreads) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split(__ldg(mt + 4 * c + q), &hi[q], &lo[q]);
    const int off = mt_offset(c >> 2, 4 * (c & 3)) >> 2;
    mt_s4[off] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                             __uint_as_float(hi[2]), __uint_as_float(hi[3]));
    mt_s4[kPart / 4 + off] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                                         __uint_as_float(lo[2]), __uint_as_float(lo[3]));
  }
  if (do_matrix) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic writes -> wgmma
    __syncthreads();
  }
  const uint32_t smem_hi = (uint32_t)__cvta_generic_to_shared(mt_s4);
  const uint32_t smem_lo = smem_hi + kPart * (uint32_t)sizeof(float);

  const int wg = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  const int warp = tid >> 5, lane = tid & 31, group = lane >> 2, tig = lane & 3;
  const int m = 16 * warp + group;  // this thread's fragment columns: m and m + 8
  const int steps = scale > 1 ? scale : 1;
  const int n_tiles = n_cols / kTileCols;
  // the two warpgroups take the two tiles of a pair: every branch around a
  // wgmma depends on blockIdx and the arguments alone (n_tiles is even)
  for (int pair = blockIdx.x; pair < n_tiles / kOvGroups; pair += gridDim.x) {
    const int tile = pair * kOvGroups + wg;
    const int col0 = tile * kTileCols, lcol0 = col0 % kLanes;
    // the FMA loop: elements tid + 128 h of the tile's [8, 64]
    float av[4], bv[4], acc[4][kChains];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int e = tid + h * kWarpgroup;
      av[h] = a[(e / kTileCols) * kLanes + lcol0 + e % kTileCols];
      bv[h] = b[(e / kTileCols) * kLanes + lcol0 + e % kTileCols];
#pragma unroll
      for (int k = 0; k < kChains; ++k) acc[h][k] = av[h] + (float)k;
    }
    // tacc [i]: row 2 tig + (i & 1), column m + 8 (i >> 1), as accumulator entry i
    float tacc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tacc[i] = b[(2 * tig + (i & 1)) * kLanes + lcol0 + m + 8 * (i >> 1)];
    // the A fragment's rays [ks][r]: k = 8 ks + tig + 4 (r >> 1), column m + 8 (r & 1)
    float ray[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        ray[ks][r] = __ldg(rays + (8 * ks + tig + 4 * (r >> 1)) * kLanes + lcol0 + m + 8 * (r & 1));
    }
    float z[32], x[80];
    uint32_t a_hi[2][4], a_lo[2][4];  // [ks][r]: a product's B^T, split
    // One group of `steps` loop iterations: the product's wgmmas (do_matrix)
    // with the group's FMA steps (do_vector) in seven shares, one before each
    // row tile of six and one after (a warp stalls at a wgmma once the tensor
    // cores' queue is full, so the FMAs run while the tiles before them do),
    // then a wait for all of them and rows 0..7 into tacc. The wait is
    // unconditional and nothing stays in flight across the loop's back edge:
    // ptxas, which tracks the wgmma groups along every path, otherwise
    // serialises every wgmma. `store`: wait for each row tile and write it.
    const int units = do_vector ? steps * kVUnroll : 0;  // FMA steps of a group
    const auto fma_steps = [&](int n) {
#pragma unroll 2
      for (int u = 0; u < n; ++u) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
#pragma unroll
          for (int k = 0; k < kChains; ++k) acc[h][k] = fmaf(acc[h][k], av[h], bv[h]);
        }
      }
    };
    const auto iteration = [&](auto store) {
      constexpr bool kStore = decltype(store)::value;
      int done = 0;  // FMA steps so far
      if (do_matrix) {
        // B^T = rays[:, cols] * (1 + tacc[0, cols] * 1e-30): row 0 is tig 0's
        const float t0 = __shfl_sync(0xffffffffu, tacc[0], lane & ~3);
        const float t1 = __shfl_sync(0xffffffffu, tacc[2], lane & ~3);
        const float colscale[2] = {1.0f + t0 * 1e-30f, 1.0f + t1 * 1e-30f};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split(ray[ks][r] * colscale[r & 1], &a_hi[ks][r], &a_lo[ks][r]);
        }
        fence_operand(z);
        fence_operand(x);
        wgmma_fence();
        split_product(z, a_hi, a_lo, smem_hi, smem_lo, 0, accumulate);
#pragma unroll
        for (int xt = 0; xt < kXTiles; ++xt) {
          const int upto = units * (xt + 1) / (kXTiles + 1);  // the FMA steps' shares
          fma_steps(upto - done);
          done = upto;
          split_product(x, a_hi, a_lo, smem_hi, smem_lo, kZRows + xt * kXRows, accumulate);
          if constexpr (kStore) {
            wgmma_commit();
            wgmma_wait<0>();
            fence_operand(x);
#pragma unroll
            for (int e = 0; e < 80; ++e) {
              const int row = kZRows + xt * kXRows + 8 * (e >> 2) + 2 * tig + (e & 1);
              product[(size_t)row * kLanes + col0 + m + 8 * ((e >> 1) & 1)] = x[e];
            }
            fence_operand(x);
            wgmma_fence();  // the stores have read x before the next tile writes it
          }
        }
        wgmma_commit();
      }
      fma_steps(units - done);
      wgmma_wait<0>();
      if (do_matrix) {  // terms[0:8] feed tacc: rows 0..7 are entries 0..3
        fence_operand(z);
#pragma unroll
        for (int i = 0; i < 4; ++i) tacc[i] += z[i] * 1e-30f;
        if constexpr (kStore) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int row = 8 * (e >> 2) + 2 * tig + (e & 1);
            product[(size_t)row * kLanes + col0 + m + 8 * ((e >> 1) & 1)] = z[e];
          }
        }
      }
    };
    // grid block 0's tiles write their last product
    const bool keep = do_matrix && product != nullptr && pair < kGridBlockTiles / kOvGroups;
    const int n_fast = keep ? m_iters - 1 : m_iters;
    for (int p = 0; p < n_fast; ++p) iteration(std::false_type{});
    if (keep && m_iters > 0) iteration(std::true_type{});
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int e = tid + h * kWarpgroup;
      float s = acc[h][0];
#pragma unroll
      for (int k = 1; k < kChains; ++k) s += acc[h][k];
      o_out[(size_t)(e / kTileCols) * n_cols + col0 + e % kTileCols] = s;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      t_out[(size_t)(2 * tig + (i & 1)) * n_cols + col0 + m + 8 * (i >> 1)] = tacc[i];
  }
}

}  // namespace

// FMA peak (probe 0) or pair-test mix (probe 1): a, b [8, 1024] f32, out
// [8, 1024 * grid] f32, `iters` loop iterations. Returns cudaGetLastError().
extern "C" int dxr_roofline_vector(int probe, const float* a, const float* b, float* out,
                                   int iters, int grid, void* stream) {
  if ((probe != 0 && probe != 1) || iters < 0 || grid < 1) return (int)cudaErrorInvalidValue;
  const int n_cols = kLanes * grid;
  const int blocks = (kSub * n_cols + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (probe == 0) {
    fma_kernel<<<blocks, kThreads, 0, s>>>(a, b, out, iters, n_cols);
  } else {
    mix_kernel<<<blocks, kThreads, 0, s>>>(a, b, out, iters, n_cols);
  }
  return (int)cudaGetLastError();
}

// Overlap probe: a, b [8, 1024], mt [1024, 16], rays [16, 1024] f32; o and t
// [8, 1024 * grid] f32 (the FMA chains' sum and the product's accumulator);
// m_iters * max(scale, 1) loop iterations, the product every scale-th;
// product [1024, 1024] f32 or null: grid block 0's last product. One block
// of two warpgroups per SM (at most one per two column tiles), 128 KB of
// dynamic shared memory. Returns cudaGetLastError().
extern "C" int dxr_roofline_overlap(const float* a, const float* b, const float* mt,
                                    const float* rays, float* o, float* t, float* product,
                                    int m_iters, int grid, int scale, int do_vector,
                                    int do_matrix, void* stream) {
  if (m_iters < 0 || grid < 1 || grid > 65535) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(overlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kOvSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_cols = kLanes * grid, n_tiles = n_cols / kTileCols;
  const int blocks = std::min(sms, (n_tiles + kOvGroups - 1) / kOvGroups);
  overlap_kernel<<<blocks, kOvThreads, kOvSmem, (cudaStream_t)stream>>>(
      a, b, mt, rays, o, t, product, n_cols, m_iters, scale, do_vector, do_matrix, 0);
  return (int)cudaGetLastError();
}
