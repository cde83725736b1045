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
// What bounds it: memory and load throughput. Each output pixel reads 51 taps of
// 6 floats (input and guide) and does ~15 flops per tap; the unique bytes are
// 36 per pixel (75 MB per 1080p pass), the rest are re-reads. Design answer:
// one thread per output pixel in raster order, so the threads of a warp read
// neighbouring pixels on both axes (the vertical pass reads whole row
// segments 3*W floats apart) and the re-reads hit L1/L2; the axis is a stride
// argument, so the TPU's transpose round trip for the vertical pass (there
// for its VMEM budget) has no counterpart; the 51 tap weights are computed
// once per block into shared memory. Staging the tile with its +-25-pixel
// apron in shared memory is left for a later change.
//
// Arithmetic follows models/denoise._bilateral_pass: taps summed in order
// i = -25..25, tap_weight in float32 as the reference's table lookup.
// Build without --use_fast_math (IEEE division).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kExtent = 25;  // MAX_EXTENT: the UI slider's maximum radius
constexpr int kTaps = 2 * kExtent + 1;
constexpr int kKernelTaps = 6;  // KERNEL_TAPS

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

__global__ void __launch_bounds__(kThreads)
bilateral_pass_kernel(const float* __restrict__ in, const float* __restrict__ joint,
                      float* __restrict__ out, int height, int width, int axis, float radius) {
  __shared__ float s_w[kTaps];
  if (threadIdx.x < kTaps) s_w[threadIdx.x] = tap_weight((int)threadIdx.x - kExtent, radius);
  __syncthreads();

  int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= width * height) return;
  int x = pix % width, y = pix / width;
  int pos = axis == 1 ? x : y;          // coordinate along the filtered axis
  int n = axis == 1 ? width : height;   // its extent
  int stride = axis == 1 ? 3 : 3 * width;
  const float* ic = in + (size_t)pix * 3;
  const float* jc = joint + (size_t)pix * 3;
  float g0 = jc[0], g1 = jc[1], g2 = jc[2];
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, aw = 0.0f;
  for (int t = 0; t < kTaps; ++t) {
    int i = t - kExtent;
    int src = pos + i;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, j0 = 0.0f, j1 = 0.0f, j2 = 0.0f;
    if (src >= 0 && src < n) {
      ptrdiff_t off = (ptrdiff_t)i * stride;
      s0 = ic[off];
      s1 = ic[off + 1];
      s2 = ic[off + 2];
      j0 = jc[off];
      j1 = jc[off + 1];
      j2 = jc[off + 2];
    }
    float dist = (fabsf(g0 - j0) + fabsf(g1 - j1) + fabsf(g2 - j2)) * 10.0f;
    float w = s_w[t] * (1.0f - fminf(fmaxf(dist, 0.0f), 1.0f));
    a0 += s0 * w;
    a1 += s1 * w;
    a2 += s2 * w;
    aw += w;
  }
  float den = fmaxf(aw, 1e-8f);
  out[(size_t)pix * 3 + 0] = a0 / den;
  out[(size_t)pix * 3 + 1] = a1 / den;
  out[(size_t)pix * 3 + 2] = a2 / den;
}

}  // namespace

// One joint-bilateral pass: in, joint, out [height, width, 3] float32,
// contiguous, on the current device; axis 0 (vertical) or 1 (horizontal);
// radius the runtime kernel radius (<= 25 reaches every tap that can carry
// weight). Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dxr_bilateral_pass(const float* in, const float* joint, float* out, int height,
                                  int width, int axis, float radius, void* stream) {
  if (height < 1 || width < 1 || (axis != 0 && axis != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  int n = width * height;
  bilateral_pass_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      in, joint, out, height, width, axis, radius);
  return (int)cudaGetLastError();
}
