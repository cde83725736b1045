// Fused-traversal sample megakernels (B5) for Hopper (sm_90a).
//
// Replace the TPU kernel _make_ft_kernel
// (dxrexperiments_tpu/ops/fused_traverse_pallas.py:131, launched by
// _ft_dispatch) in its base and env-deferred modes (env kinds 0-3, the
// lat-long and cubemap textures looked up inside the kernel at every miss,
// common.cuh env_color) and rigs of at most one directional and one point
// light:
// - progressive: one launch renders S jittered samples of the whole ray
//   tree per pixel (primary closest hit with backfaces culled, 2 shadow
//   rays, the diffuse and Phong bounces with 2 shadow rays each) and writes
//   their sum;
// - realtime: one launch renders S frames on a (tiles, S) grid, without
//   the diffuse bounce and with the bounce's emissive term dropped, each
//   frame writing its own AOVs (direct, indirect specular, albedo,
//   roughness).
// The tree is common.cuh's, shared with the brute-force megakernel (B1);
// every trace here is the fat-node walk shared with kernel B4a.
//
// What bounds it: memory latency and divergence. A pixel-sample walks the
// BVH up to nine times (three closest hits, six shadow rays), each walk a
// chain of dependent node and leaf loads, on a triangle pack (mt_rows, 680
// MB at 983k triangles) far larger than the 50 MB L2; the bounce rays of
// neighbouring pixels diverge. Design answer: one thread per pixel with
// the per-ray state and the S-sample sum in registers (written once, no
// atomics); each block a compact 16 x 8 pixel tile, so the rays of a warp
// (16 x 2 pixels) share most of their primary walk and their shadow rays
// leave nearby points; one 96-entry stack per thread, reused by every walk;
// a closest hit fetches the winner's vertex normals and material id
// (mt_rows lanes 64..73) once, after its walk; material fields come from
// the [16, 128] material table staged in shared memory. Work the reference
// masks out is skipped per thread (misses, inactive bounces, the unpicked
// light of the debug==2 estimator), which changes no result. Seeds come
// from the raster pixel index and the output is raster order.

#include "common.cuh"

namespace {

using namespace dxr;

constexpr int kTileW = 16, kTileH = 8;  // a block's pixel tile
constexpr int kMatFields = A_TYPE - A_ALBEDO + 1;  // A_ALBEDO..A_TYPE
constexpr int kMaxMaterials = 128;

// The BVH trace backend of the ray tree: walks with a shared per-thread
// stack, material fields from the staged table [kMatFields][128].
struct BvhScene {
  FatBvh B;
  const float* mat;
  int* stack;
  int rig;

  __device__ __forceinline__ float a(int field, int row) const {
    return mat[(field - A_ALBEDO) * kMaxMaterials + row];
  }

  __device__ __forceinline__ bool occluded(V3 o, V3 d, float tmin, bool has_tmax,
                                           float tmax) const {
    AnyLeaf leaf(B, o, d, tmin, has_tmax ? tmax : kRayFar);
    fat_walk(B, o, safe_inv(d), tmin, leaf, stack);
    return leaf.occluded;
  }

  __device__ __forceinline__ Hit closest(V3 o, V3 d, float tmin, bool cull) const {
    ClosestLeaf leaf(B, o, d, tmin, kRayFar, cull);
    fat_walk(B, o, safe_inv(d), tmin, leaf, stack);
    Hit h;
    h.hit = leaf.hit();
    h.t = h.hit ? leaf.best_t : -1.0f;
    h.pos = v3(o.x + h.t * d.x, o.y + h.t * d.y, o.z + h.t * d.z);
    h.row = 0;
    h.normal = v3(0.0f, 0.0f, 0.0f);
    if (h.hit) {
      const float* attr = B.rows + (size_t)leaf.best_slot * kRowLanes + 64;
      h.normal = interp_normal(attr, 1, leaf.u(), leaf.v());
      h.row = min(max((int)attr[9], 0), kMaxMaterials - 1);
    }
    return h;
  }
};

// Stage the material table: material_pack rows are MP_ALBEDO..MP_ROUGH
// (0..11), MP_TYPE (12), MP_IOR (13); the staged rows follow A_* order,
// where IOR (22) precedes TYPE (23).
__device__ __forceinline__ void stage_materials(float* s_mat, const float* __restrict__ mat) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < kMatFields * kMaxMaterials; k += blockDim.x * blockDim.y) {
    int f = k / kMaxMaterials, m = k - f * kMaxMaterials;
    int src = f < 12 ? f : (f == A_IOR - A_ALBEDO ? 13 : 12);
    s_mat[k] = mat[src * kMaxMaterials + m];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kTileW * kTileH)
ft_progressive_kernel(const float* __restrict__ cam, const uint32_t* __restrict__ frames,
                      const float* __restrict__ cst, FatBvh B, const float* __restrict__ mat,
                      float* __restrict__ out, int s_count, int width, int height, Env env,
                      int rig) {
  __shared__ float s_mat[kMatFields * kMaxMaterials];
  stage_materials(s_mat, mat);
  const int px = blockIdx.x * kTileW + threadIdx.x, py = blockIdx.y * kTileH + threadIdx.y;
  if (px >= width || py >= height) return;
  int stack[kMaxStack];
  BvhScene T{B, s_mat, stack, rig};
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < s_count; ++s) {
    sample_pixel(T, cam + s * 16, frames[s], cst, px, py, width, height, env, acc);
  }
  const size_t pix = (size_t)py * width + px;
  out[pix * 3 + 0] = acc[0];
  out[pix * 3 + 1] = acc[1];
  out[pix * 3 + 2] = acc[2];
}

// Grid (tiles x, tiles y, S frames): block (x, y, s) renders frame s of its tile.
__global__ void __launch_bounds__(kTileW * kTileH)
ft_realtime_kernel(const float* __restrict__ cam, const uint32_t* __restrict__ frames,
                   const float* __restrict__ cst, FatBvh B, const float* __restrict__ mat,
                   float* __restrict__ direct, float* __restrict__ ispec,
                   float* __restrict__ albedo, float* __restrict__ rough, int width, int height,
                   Env env, int rig) {
  __shared__ float s_mat[kMatFields * kMaxMaterials];
  stage_materials(s_mat, mat);
  const int px = blockIdx.x * kTileW + threadIdx.x, py = blockIdx.y * kTileH + threadIdx.y;
  if (px >= width || py >= height) return;
  const int s = blockIdx.z;
  int stack[kMaxStack];
  BvhScene T{B, s_mat, stack, rig};
  float aov[10];
  realtime_pixel(T, cam + s * 16, frames[s], cst, px, py, width, height, env, aov);
  const size_t o = (size_t)s * width * height + (size_t)py * width + px;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    direct[o * 3 + k] = aov[k];
    ispec[o * 3 + k] = aov[3 + k];
    albedo[o * 3 + k] = aov[6 + k];
  }
  rough[o] = aov[9];
}

bool bad_args(int s_count, int n_nodes, int n_slots, int width, int height, int env_kind,
              int rig, const float* env_tex, int env_w, int env_h) {
  return s_count < 1 || n_nodes < 1 || n_slots < 1 || width < 1 || height < 1 ||
         !env_args_ok(env_kind, env_tex, env_w, env_h) || rig < 1 || rig > 3;
}

}  // namespace

// Sum of S progressive samples into out [height, width, 3] float32.
//   cam [S, 16] f32 (pack_cameras), frames [S] u32, cst [2, 16] f32
//   (pack_consts), nodes = bvhf_rows [n_nodes, 16] f32, rows = mt_rows
//   [n_slots, 128] f32, mat = material_pack [16, 128] f32; env_kind 0-3,
//   with env_tex, env_w and env_h as for dxr_fused_progressive_sum
//   (csrc/fused_sample.cu); rig: 1 directional, 2 point, 3 both. err [1]
//   i32 must be 0 on entry and is set to 1 (stack overflow) or 2 (index out
//   of range).
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for bad arguments.
extern "C" int dxr_fused_traverse_progressive_sum(
    const float* cam, const uint32_t* frames, const float* cst, const float* nodes,
    const float* rows, const float* mat, float* out, int s_count, int n_nodes, int n_slots,
    int width, int height, int env_kind, int rig, const float* env_tex, int env_w, int env_h,
    int* err, void* stream) {
  if (bad_args(s_count, n_nodes, n_slots, width, height, env_kind, rig, env_tex, env_w, env_h)) {
    return (int)cudaErrorInvalidValue;
  }
  FatBvh B{reinterpret_cast<const float4*>(nodes), rows, n_nodes, n_slots, err};
  dim3 block(kTileW, kTileH);
  dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  ft_progressive_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      cam, frames, cst, B, mat, out, s_count, width, height, Env{env_tex, env_kind, env_w, env_h},
      rig);
  return (int)cudaGetLastError();
}

// S realtime frames: direct, ispec, albedo [S, height, width, 3] and rough
// [S, height, width] float32; the other arguments as for
// dxr_fused_traverse_progressive_sum, with the realtime jitter scale in cam.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dxr_fused_traverse_realtime_outputs(
    const float* cam, const uint32_t* frames, const float* cst, const float* nodes,
    const float* rows, const float* mat, float* direct, float* ispec, float* albedo,
    float* rough, int s_count, int n_nodes, int n_slots, int width, int height, int env_kind,
    int rig, const float* env_tex, int env_w, int env_h, int* err, void* stream) {
  if (bad_args(s_count, n_nodes, n_slots, width, height, env_kind, rig, env_tex, env_w, env_h) ||
      s_count > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  FatBvh B{reinterpret_cast<const float4*>(nodes), rows, n_nodes, n_slots, err};
  dim3 block(kTileW, kTileH);
  dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, s_count);
  ft_realtime_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      cam, frames, cst, B, mat, direct, ispec, albedo, rough, width, height,
      Env{env_tex, env_kind, env_w, env_h}, rig);
  return (int)cudaGetLastError();
}
