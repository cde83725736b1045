// Separable joint-bilateral filter pass for Hopper (sm_90a).
//
// Replaces the TPU kernel _make_pass_kernel / bilateral_pass
// (dxrexperiments_tpu/ops/bilateral_pallas.py:53, pallas_call at :155): one
// pass along axis 0 (vertical) or 1 (horizontal) over the interleaved
// [H, W, 3] float32 input, guided by a [H, W, 3] joint image, with the 51
// static taps i = -25..25 and a runtime radius <= 25:
//   w_i  = tap_weight(i, radius) * (1 - clamp(10 * L1(guide_c - guide_i), 0, 1))
//   out  = sum_i w_i * in_i / max(sum_i w_i, 1e-8)
// An out-of-image tap is not skipped: its sample and guide read as 0 and it
// still carries its weight against the zero guide (the D3D out-of-bounds read
// of the reference shader, and the plain version's zero-padded shifts).
//
// What bounds it: the unique bytes are 36 a pixel (75 MB a 1080p pass) and
// the float work 51 taps of ~12 instructions a pixel, so at the card's
// rates the floats (~0.02 ms a pass at 67 TFLOP/s counting each op once)
// and the bytes (0.022 ms) weigh about the same; what a thread per pixel
// reading its 51 taps from device memory loses is load instructions (6 a
// tap) and, in the vertical pass, 51 rows 3 * W floats apart a pixel.
// Design answer: a block filters a tile of 32 lanes across the axis (one
// warp's lanes: the vertical pass's columns, the horizontal pass's rows)
// and kSpan outputs along it. It stages the input and the guide of its tile
// and the +-25-pixel apron along the axis in shared memory, zero-filled
// outside the image, by cp.async (4-byte copies, source size 0 for a zero),
// each line of the tile read as consecutive floats by consecutive threads
// on both axes. Each thread then computes kPerThread consecutive outputs
// along the axis from a window of kPerThread staged pixels in registers:
// tap t of output k is staged pixel k + t, so each tap's weight (one
// shared-memory broadcast) serves all its outputs and each staged pixel is
// read from shared memory once a thread, not once an output. Walking the
// taps in ascending order gives every output its taps in ascending i, the
// order of the plain version, with the same expressions, so the sums are
// the same to the bit. The results go back through shared memory, so that
// the stores, too, are consecutive floats by consecutive threads. The
// layouts keep a warp's 32 lanes on 32 banks: lane stride 3 words
// (vertical) or an odd kLineWords (horizontal).
//
// The taps whose table weight is 0 (|i| past the radius's reach: 28 of the
// 51 at the denoiser's default radius 12) are skipped. Such a tap's weight
// is exactly +0 whatever the guide (the colour term lies in [0, 1], a NaN
// distance clamps to 0), so with a finite input sample it adds +-0 to sums
// that are never -0 and leaves them as they were, bit for bit. A
// non-finite input sample (inf or NaN) there is what differs: the plain
// version's sums turn NaN (0 x inf), this pass never reads it, so the
// output is what the plain version gives with that sample set to 0. The
// realtime AOVs reach the denoiser through sanitize (common.cuh), finite.
//
// Arithmetic follows models/denoise._bilateral_pass: taps summed in order
// i = -25..25, tap_weight in float32 as the reference's table lookup.
// Build without --use_fast_math (IEEE division).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kExtent = 25;  // MAX_EXTENT: the UI slider's maximum radius
constexpr int kTaps = 2 * kExtent + 1;
constexpr int kKernelTaps = 6;  // KERNEL_TAPS
constexpr int kLanes = 32;  // tile positions across the axis: a warp's lanes
constexpr int kPerThread = 8;  // consecutive outputs along the axis a thread
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kSpan = kPerThread * kWarps;  // outputs along the axis a tile
constexpr int kStaged = kSpan + 2 * kExtent;  // staged pixels along the axis

// Shared-memory layout of one staged image of a tile, 3 floats a pixel:
// vertical [kStaged][kLanes][3]; horizontal [kLanes][kLineWords], a lane's
// kStaged pixels then one pad word (an odd line keeps lanes on 32 banks).
// The results reuse the input's space: vertical [kSpan][kLanes][3],
// horizontal [kLanes][kOutLine].
template <int kAxis>
struct Tile {
  static constexpr int kLineWords = kAxis == 0 ? kLanes * 3 : kStaged * 3 + 1;
  static constexpr int kLaneStride = kAxis == 0 ? 3 : kLineWords;
  static constexpr int kPosStride = kAxis == 0 ? kLanes * 3 : 3;
  static constexpr int kWords = kAxis == 0 ? kStaged * kLineWords : kLanes * kLineWords;
  static constexpr int kOutLine = kAxis == 0 ? kLanes * 3 : kSpan * 3 + 1;
  static constexpr int kOutLaneStride = kAxis == 0 ? 3 : kOutLine;
  static constexpr int kOutPosStride = kAxis == 0 ? kLanes * 3 : 3;
  static constexpr size_t kBytes = 2 * kWords * sizeof(float);
};
static_assert(kSpan * kLanes * 3 <= Tile<0>::kWords && kLanes * Tile<1>::kOutLine <= Tile<1>::kWords,
              "the results fit in the input's space");

// Disk-like spatial weight (BilateralFilter.hlsli's precalculated table):
// idx = clamp(int(|i| * 5 / (0.001 + |radius * 0.8|)), 0, 6), each step
// rounded in float32 as the plain version does (the _rn intrinsics keep the
// compiler from contracting them into an FMA).
__device__ __forceinline__ float tap_weight(int i, float radius) {
  const float table[kKernelTaps + 1] = {1.0f, 1.0f, 0.9f, 0.75f, 0.6f, 0.5f, 0.0f};
  float x = __fdiv_rn(__fmul_rn(fabsf((float)i), (float)(kKernelTaps - 1)),
                      __fadd_rn(0.001f, fabsf(__fmul_rn(radius, 0.8f))));
  int idx = (int)x;
  idx = idx < 0 ? 0 : (idx > kKernelTaps ? kKernelTaps : idx);
  return table[idx];
}

// A 4-byte cp.async; a zero (source size 0) where `valid` is false.
__device__ __forceinline__ void copy4(float* dst, const float* src, const float* any, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(valid ? src : any), "r"(valid ? 4 : 0));
}

// One staged pixel (input and guide) in registers.
struct Px {
  float s0, s1, s2, j0, j1, j2;
};

// Tap of weight wt (its table weight) of sample p for an output with guide
// g and sums a: the plain version's expressions in its order.
__device__ __forceinline__ void tap(float a[4], const float g[3], const Px& p, float wt) {
  float dist = (fabsf(g[0] - p.j0) + fabsf(g[1] - p.j1) + fabsf(g[2] - p.j2)) * 10.0f;
  float w = wt * (1.0f - fminf(fmaxf(dist, 0.0f), 1.0f));
  a[0] += p.s0 * w;
  a[1] += p.s1 * w;
  a[2] += p.s2 * w;
  a[3] += w;
}

// Tile (blockIdx.x: 32 lanes across the axis, blockIdx.y: kSpan outputs
// along it) of one pass along kAxis.
template <int kAxis>
__global__ void __launch_bounds__(kThreads, 2)
bilateral_tile_kernel(const float* __restrict__ in, const float* __restrict__ joint,
                      float* __restrict__ out, int height, int width, float radius) {
  using T = Tile<kAxis>;
  extern __shared__ float smem[];
  __shared__ float s_w[kTaps];
  float* s_in = smem;
  float* s_g = smem + T::kWords;
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int c0 = blockIdx.x * kLanes;  // first lane's position across the axis
  const int a0 = blockIdx.y * kSpan;   // first output's position along it
  const int row_floats = 3 * width;

  // stage: each line of the tile as consecutive floats of the image
  if constexpr (kAxis == 0) {  // lines: the kStaged rows a0 - 25 ..
    const int gx0 = 3 * c0;
    for (int pos = warp; pos < kStaged; pos += kWarps) {
      const int y = a0 - kExtent + pos;
      const bool row_ok = y >= 0 && y < height;
      const size_t base = (size_t)(row_ok ? y : 0) * row_floats + gx0;
      for (int r = lane; r < T::kLineWords; r += kLanes) {
        const bool ok = row_ok && gx0 + r < row_floats;
        copy4(s_in + pos * T::kLineWords + r, in + base + r, in, ok);
        copy4(s_g + pos * T::kLineWords + r, joint + base + r, joint, ok);
      }
    }
  } else {  // lines: the 32 rows c0 .., their pixels a0 - 25 ..
    const int gx0 = 3 * (a0 - kExtent);
    for (int ln = warp; ln < kLanes; ln += kWarps) {
      const int y = c0 + ln;
      const bool row_ok = y < height;
      const size_t base = (size_t)(row_ok ? y : 0) * row_floats;
      for (int r = lane; r < 3 * kStaged; r += kLanes) {
        const int gx = gx0 + r;
        const bool ok = row_ok && gx >= 0 && gx < row_floats;
        copy4(s_in + ln * T::kLineWords + r, in + base + gx, in, ok);
        copy4(s_g + ln * T::kLineWords + r, joint + base + gx, joint, ok);
      }
    }
  }
  if (threadIdx.x < kTaps) s_w[threadIdx.x] = tap_weight((int)threadIdx.x - kExtent, radius);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // outputs kb .. kb + kPerThread - 1 of the tile along the axis, at `lane`;
  // staged pixel q of this lane is output q - 25's centre, tap t of output k
  // staged pixel kb + k + t
  const int kb = warp * kPerThread;
  const float* li = s_in + lane * T::kLaneStride;
  const float* lg = s_g + lane * T::kLaneStride;
  auto staged = [&](int q) {
    const int o = q * T::kPosStride;
    return Px{li[o], li[o + 1], li[o + 2], lg[o], lg[o + 1], lg[o + 2]};
  };
  float g[kPerThread][3], acc[kPerThread][4];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int o = (kb + k + kExtent) * T::kPosStride;
    g[k][0] = lg[o];
    g[k][1] = lg[o + 1];
    g[k][2] = lg[o + 2];
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
  }
  // the taps that can carry weight: t_lo .. t_lo + n_taps - 1, |i| <= reach
  int reach = 0;
  for (int i = 1; i <= kExtent; ++i) {
    if (s_w[kExtent + i] != 0.0f || s_w[kExtent - i] != 0.0f) reach = i;
  }
  const int t_lo = kExtent - reach, n_taps = 2 * reach + 1;
  // tap t_lo + u of output k is staged pixel q0 + k + u; window slot j holds
  // staged pixel q0 + u + ((j - u) mod kPerThread) at step u
  const int q0 = kb + t_lo;
  Px win[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) win[j] = staged(q0 + j);
#pragma unroll 1
  for (int u0 = 0; u0 < n_taps; u0 += kPerThread) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int u = u0 + i;
      if (u < n_taps) {
        const float wt = s_w[t_lo + u];
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) tap(acc[k], g[k], win[(i + k) % kPerThread], wt);
        // staged pixel q0 + u is done with; slot i takes the next one
        if (u < n_taps - 1) win[i] = staged(q0 + u + kPerThread);
      }
    }
  }
  __syncthreads();  // every thread is done with the staged tile

  // results through shared memory, then stored line by line
  float* s_out = smem;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    float den = fmaxf(acc[k][3], 1e-8f);
    float* p = s_out + lane * T::kOutLaneStride + (kb + k) * T::kOutPosStride;
    p[0] = acc[k][0] / den;
    p[1] = acc[k][1] / den;
    p[2] = acc[k][2] / den;
  }
  __syncthreads();
  if constexpr (kAxis == 0) {  // lines: the kSpan rows a0 ..
    const int gx0 = 3 * c0;
    for (int pos = warp; pos < kSpan; pos += kWarps) {
      const int y = a0 + pos;
      if (y >= height) break;
      float* dst = out + (size_t)y * row_floats + gx0;
      for (int r = lane; r < T::kOutLine && gx0 + r < row_floats; r += kLanes) {
        dst[r] = s_out[pos * T::kOutLine + r];
      }
    }
  } else {  // lines: the 32 rows c0 .., their pixels a0 ..
    const int gx0 = 3 * a0;
    for (int ln = warp; ln < kLanes; ln += kWarps) {
      const int y = c0 + ln;
      if (y >= height) break;
      float* dst = out + (size_t)y * row_floats + gx0;
      for (int r = lane; r < 3 * kSpan && gx0 + r < row_floats; r += kLanes) {
        dst[r] = s_out[ln * T::kOutLine + r];
      }
    }
  }
}

template <int kAxis>
int launch(const float* in, const float* joint, float* out, int height, int width, float radius,
           cudaStream_t stream) {
  const int across = kAxis == 0 ? width : height, along = kAxis == 0 ? height : width;
  const dim3 grid((across + kLanes - 1) / kLanes, (along + kSpan - 1) / kSpan);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int smem = (int)Tile<kAxis>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(bilateral_tile_kernel<kAxis>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bilateral_tile_kernel<kAxis><<<grid, kThreads, smem, stream>>>(in, joint, out, height, width,
                                                                  radius);
  return (int)cudaGetLastError();
}

}  // namespace

// One joint-bilateral pass: in, joint, out [height, width, 3] float32,
// contiguous, on the current device; axis 0 (vertical) or 1 (horizontal);
// radius the runtime kernel radius (<= 25 reaches every tap that can carry
// weight). Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dxr_bilateral_pass(const float* in, const float* joint, float* out, int height,
                                  int width, int axis, float radius, void* stream) {
  if (height < 1 || width < 1 || (axis != 0 && axis != 1) ||
      (size_t)3 * width > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return axis == 0 ? launch<0>(in, joint, out, height, width, radius, s)
                   : launch<1>(in, joint, out, height, width, radius, s);
}
