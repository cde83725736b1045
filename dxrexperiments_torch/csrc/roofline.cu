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
// count is the source's); for the overlap probe a block of 8 warps takes 64
// columns of one [8, 1024] grid block, each thread 2 elements of the FMA
// loop and each warp one 8-column tile of the product, which it computes
// as 64 x 2 mma.sync m16n8k8 TF32 tiles in the split form hi*hi + hi*lo +
// lo*hi (float32 split into a TF32 high part and a TF32 remainder), which
// keeps float32 accuracy as the TPU's HIGHEST precision does. The vector
// FMAs and the MMAs of a warp are independent instruction streams, so the
// schedulers may overlap the FP32 and tensor pipes. mt is read through the
// read-only cache (64 KB, every warp of the card reads it).

#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int kOvCols = 64;       // columns of a grid block per overlap block (8 warps x 8)

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

// d += a * b on one m16n8k8 tile: a [16 x 8] row-major, b [8 x 8] col-major
// TF32 fragments, d [16 x 8] float32 (PTX ISA fragment layouts)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo with hi and lo TF32 (lo is the remainder rounded to TF32)
__device__ __forceinline__ void split(float x, uint32_t* hi, uint32_t* lo) {
  *hi = tf32_bits(x);
  *lo = tf32_bits(x - __uint_as_float(*hi));
}

// Grid (kLanes / kOvCols, grid blocks): block (x, g) takes columns
// x * 64 .. x * 64 + 63 of grid block g. mt [1024, 16], rays [16, 1024].
__global__ void __launch_bounds__(kThreads)
overlap_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ mt, const float* __restrict__ rays,
               float* __restrict__ o_out, float* __restrict__ t_out,
               float* __restrict__ product, int n_cols, int loops, int scale, int do_vector,
               int do_matrix) {
  __shared__ float tacc[kSub][kOvCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane >> 2, tig = lane & 3;  // mma fragment row / column group
  const int col0 = blockIdx.x * kOvCols;        // first column within the grid block
  const int out_col0 = blockIdx.y * kLanes + col0;
  // the FMA loop: elements e = threadIdx.x and threadIdx.x + 256 of [8, 64]
  float av[2], bv[2], acc[2][kChains];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = threadIdx.x + h * kThreads, row = e / kOvCols, col = e % kOvCols;
    av[h] = a[row * kLanes + col0 + col];
    bv[h] = b[row * kLanes + col0 + col];
#pragma unroll
    for (int k = 0; k < kChains; ++k) acc[h][k] = av[h] + (float)k;
    tacc[row][col] = bv[h];
  }
  __syncthreads();
  const int wcol = warp * 8;  // this warp's 8 columns of the block's 64
  const int n_products = do_matrix ? (scale > 1 ? (loops + scale - 1) / scale : loops) : 0;
  int done_products = 0;
  for (int it = 0; it < loops; ++it) {
    if (do_vector) {
#pragma unroll
      for (int u = 0; u < kVUnroll; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int k = 0; k < kChains; ++k) acc[h][k] = fmaf(acc[h][k], av[h], bv[h]);
        }
      }
    }
    if (do_matrix && (scale <= 1 || it % scale == 0)) {
      // B = rays[:, cols] * (1 + tacc[0, cols] * 1e-30), split into TF32 parts
      const float colscale = 1.0f + tacc[0][wcol + group] * 1e-30f;
      uint32_t b_hi[2][2], b_lo[2][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k = ks * 8 + tig + 4 * r;
          split(__ldg(rays + k * kLanes + col0 + wcol + group) * colscale, &b_hi[ks][r],
                &b_lo[ks][r]);
        }
      }
      const bool last = ++done_products == n_products;
      float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // m-tile 0: rows 0..15
      for (int m = 0; m < kRows / 16; ++m) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a_hi[4], a_lo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = m * 16 + group + 8 * (r & 1), k = ks * 8 + tig + 4 * (r >> 1);
            split(__ldg(mt + row * kK + k), &a_hi[r], &a_lo[r]);
          }
          mma_tf32(c, a_lo, b_hi[ks]);
          mma_tf32(c, a_hi, b_lo[ks]);
          mma_tf32(c, a_hi, b_hi[ks]);
        }
        if (m == 0) {
#pragma unroll
          for (int r = 0; r < 4; ++r) c0[r] = c[r];
        }
        if (last && product != nullptr && blockIdx.y == 0) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = m * 16 + group + 8 * (r >> 1), col = col0 + wcol + 2 * tig + (r & 1);
            product[(size_t)row * kLanes + col] = c[r];
          }
        }
      }
      __syncwarp();
      // terms[0:8] feed tacc: rows 0..7 are fragment entries 0 and 1
      tacc[group][wcol + 2 * tig] += c0[0] * 1e-30f;
      tacc[group][wcol + 2 * tig + 1] += c0[1] * 1e-30f;
      __syncwarp();
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = threadIdx.x + h * kThreads, row = e / kOvCols, col = e % kOvCols;
    float s = acc[h][0];
#pragma unroll
    for (int k = 1; k < kChains; ++k) s += acc[h][k];
    o_out[(size_t)row * n_cols + out_col0 + col] = s;
    t_out[(size_t)row * n_cols + out_col0 + col] = tacc[row][col];
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
// product [1024, 1024] f32 or null: grid block 0's last product. Returns
// cudaGetLastError().
extern "C" int dxr_roofline_overlap(const float* a, const float* b, const float* mt,
                                    const float* rays, float* o, float* t, float* product,
                                    int m_iters, int grid, int scale, int do_vector,
                                    int do_matrix, void* stream) {
  if (m_iters < 0 || grid < 1 || grid > 65535) return (int)cudaErrorInvalidValue;
  const int loops = m_iters * (scale > 1 ? scale : 1);
  dim3 blocks(kLanes / kOvCols, grid);
  overlap_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, mt, rays, o, t, product, kLanes * grid, loops, scale, do_vector, do_matrix);
  return (int)cudaGetLastError();
}
