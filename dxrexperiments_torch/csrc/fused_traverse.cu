// Fused-traversal sample megakernels (B5) for Hopper (sm_90a).
//
// Replace the TPU kernel _make_ft_kernel
// (dxrexperiments_tpu/ops/fused_traverse_pallas.py:131, launched by
// _ft_dispatch) in all its modes: env kinds 0-3 (the lat-long and cubemap
// textures looked up inside the kernel at every miss, common.cuh
// env_color, where the TPU kernel's env-deferred mode wrote bounce
// directions and weights out); rigs of at most one directional, one point
// and one area light (the area mode, both pipelines: kAreaSamples
// stratified soft-shadow rays, common.cuh area_light_term); and albedo
// textures (progressive only, as in JAX): at every closest hit on a
// textured material the hit's UV is interpolated from the corner UVs
// (ft_attr columns 10..15, mt_rows lanes 74..79) and the texture read with
// four taps (common.cuh sample_albedo),
// multiplying the albedo before any use of it. The TPU kernel's
// tex-deferred mode instead wrote A + B tex_p + C tex_p tex_d + D tex_s
// and each hit's UV and material id (a TEX_ROWS block per sample) for a
// host resolve, because gathers do not lower in Mosaic; here a texel is an
// ordinary load, so there is no resolve and no TEX_ROWS block. Each mode
// is a compile-time instantiation (area yes/no, textured yes/no), so the
// base and texture-env modes keep their code and registers:
// - progressive: one launch renders S jittered samples of the whole ray
//   tree per pixel (primary closest hit with backfaces culled, 2 shadow
//   rays, the diffuse and Phong bounces with 2 shadow rays each) and writes
//   their sum;
// - realtime: one launch renders S frames on a (tiles, S) grid, without
//   the diffuse bounce and with the bounce's emissive term dropped, each
//   frame writing its own AOVs (direct, indirect specular, albedo,
//   roughness).
// The tree is common.cuh's, shared with the brute-force megakernel (B1);
// every trace here is kernel B4a's fat-node walk with per-warp leaf
// postponement and its record leaf tests (rec_leaf.cuh postponed_fat_walk,
// ClosestRecLeaf, AnyRecLeaf), over the dense records below. The area
// light's shadow rays take one walk each (the TPU kernel shared one
// multi-direction walk among a packet's shadow rays, a packet design not
// carried over); their draws come from the pixel's TEA seed inside the
// kernel, nothing precomputed on the host.
//
// What bounds it: memory latency and divergence. A pixel-sample walks the
// BVH up to nine times (three closest hits, six shadow rays; an area light
// adds up to kAreaSamples shadow walks at each of its three shading
// points), each walk a chain of dependent node and leaf loads over the 50
// MB L2; the bounce rays of neighbouring pixels diverge. Design answer:
// the leaf slots are read from two dense arrays built once per BVH pack
// from mt_rows (ops/traverse.leaf_records), not from mt_rows itself, whose
// 512-byte rows follow the TPU's 128 lanes: ft_test [S, 20], each slot's 19
// coefficients in pair-test order and a pad (80 bytes, five 16-byte loads;
// a leaf of n slots is 80 n contiguous bytes, where mt_rows scattered each
// slot's 19 scalar loads over five 32-byte sectors), and ft_attr [S, 16],
// the lanes 64..79 (vertex normals, material id, corner UVs), read once per
// closest hit: 191 MB for instanced:32's 1.33 M slots against mt_rows' 680
// MB. One thread per pixel with the per-ray state and the S-sample sum in
// registers (written once, no atomics); each block a compact 16 x 16 pixel
// tile (16 x 8 took up to 9% longer), so the rays of a warp (16 x 2
// pixels) share most of their primary walk and their shadow rays leave
// nearby points; one 96-entry stack per thread, reused by every walk; a
// closest hit fetches the winner's vertex normals and material id (ft_attr)
// once, after its walk; leaf tests postponed per warp, so a warp's lanes
// test their leaves in one phase, not each in a turn of its own while the
// others wait (the lanes that vote together are those that make the walk:
// __activemask() at its entry, inside the ray tree's per-lane branches);
// material fields come from the [16, 128] material
// table staged in shared memory; a textured hit reads 4 texels (48 bytes)
// of a table the L2 usually holds. Work the reference masks out is skipped
// per thread (misses, inactive bounces, the unpicked light of the debug==2
// estimator, area samples of zero weight), which changes no result. Seeds
// come from the raster pixel index and the output is raster order.

#include "rec_leaf.cuh"

namespace {

using namespace dxr;

constexpr int kTileW = 16, kTileH = 16;  // a block's pixel tile
constexpr int kMatFields = A_TYPE - A_ALBEDO + 1;  // A_ALBEDO..A_TYPE
constexpr int kMaxMaterials = 128;

#ifdef DXR_LEAF_PHASE_COUNTS
// The opt-in counting build (nvcc -DDXR_LEAF_PHASE_COUNTS; kernel_ab.py's
// leaf_phase_counts, never the pipelines' build): per walk kind (0 closest
// hit, 1 occlusion), [0][k] the walks made by the k lanes of their mask
// and [1][k] the leaf phases in which k lanes test leaves, one count a warp.
__device__ unsigned long long g_leaf_counts[2][2][33];

template <int kKind>
struct LeafCounts {
  __device__ __forceinline__ static bool leader(unsigned mask) {
    const unsigned lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31u;
    return lane == (unsigned)(__ffs(mask) - 1);
  }
  __device__ __forceinline__ void walk(unsigned mask) const {
    if (leader(mask)) atomicAdd(&g_leaf_counts[kKind][0][__popc(mask)], 1ull);
  }
  __device__ __forceinline__ void phase(unsigned mask, bool holds) const {
    const unsigned testing = __ballot_sync(mask, holds);
    if (leader(mask)) atomicAdd(&g_leaf_counts[kKind][1][__popc(testing)], 1ull);
  }
};
using ClosestTally = LeafCounts<0>;
using AnyTally = LeafCounts<1>;
#else
using ClosestTally = NoTally;
using AnyTally = NoTally;
#endif

// The dense leaf arrays (ops/traverse.leaf_records): ft_test [S][kRecQuads]
// float4 and ft_attr [S][kAttrLanes], column k of ft_attr being mt_rows
// lane 64 + k.
constexpr int kAttrLanes = 16;
struct Leaves {
  const float4* test;
  const float* attr;
};

// The BVH trace backend of the ray tree: postponed walks with a shared
// per-thread stack, each over the lanes that make it (__activemask() at
// its entry: a lane that makes no walk never votes in it), B.rows unused
// (the leaves are read from L), material fields from
// the staged table [kMatFields][128]. A: one area light (`area` is its
// pack); X: albedo textures (`tex`).
template <bool A, bool X>
struct BvhScene {
  static constexpr bool kArea = A, kTex = X;
  FatBvh B;
  Leaves L;
  const float* mat;
  int* stack;
  int rig;
  const float* area;
  AlbedoTex tex;

  __device__ __forceinline__ float a(int field, int row) const {
    return mat[(field - A_ALBEDO) * kMaxMaterials + row];
  }

  __device__ __forceinline__ float albedo(const Hit& h, int k) const {
    if constexpr (kTex) return a(A_ALBEDO + k, h.row) * comp(h.tex, k);
    return a(A_ALBEDO + k, h.row);
  }

  __device__ __forceinline__ bool occluded(V3 o, V3 d, float tmin, bool has_tmax,
                                           float tmax) const {
    AnyRecLeaf leaf(B, L.test, o, d, tmin, has_tmax ? tmax : kRayFar);
    postponed_fat_walk(__activemask(), B, o, safe_inv(d), tmin, leaf, stack, true, AnyTally());
    return leaf.occluded;
  }

  __device__ __forceinline__ Hit closest(V3 o, V3 d, float tmin, bool cull) const {
    ClosestRecLeaf leaf(B, L.test, o, d, tmin, kRayFar, cull);
    postponed_fat_walk(__activemask(), B, o, safe_inv(d), tmin, leaf, stack, true,
                       ClosestTally());
    Hit h;
    h.hit = leaf.hit();
    h.t = h.hit ? leaf.best_t : -1.0f;
    h.pos = v3(o.x + h.t * d.x, o.y + h.t * d.y, o.z + h.t * d.z);
    h.row = 0;
    h.normal = v3(0.0f, 0.0f, 0.0f);
    if (h.hit) {
      const float* attr = L.attr + (size_t)leaf.best_slot * kAttrLanes;
      const float u = leaf.u(), v = leaf.v();
      h.normal = interp_normal(attr, 1, u, v);
      h.row = min(max((int)attr[9], 0), kMaxMaterials - 1);
      if constexpr (kTex) {  // the hit's UV from the corner UVs (lanes 74..79)
        const float w = 1.0f - u - v;
        h.tex = sample_albedo(tex, h.row, w * attr[10] + u * attr[12] + v * attr[14],
                              w * attr[11] + u * attr[13] + v * attr[15], B.err);
      }
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

template <bool A, bool X>
__global__ void __launch_bounds__(kTileW * kTileH)
ft_progressive_kernel(const float* __restrict__ cam, const uint32_t* __restrict__ frames,
                      const float* __restrict__ cst, const float* __restrict__ area, FatBvh B,
                      Leaves L, const float* __restrict__ mat, float* __restrict__ out,
                      int s_count, int width, int height, Env env, int rig, AlbedoTex tex) {
  __shared__ float s_mat[kMatFields * kMaxMaterials];
  stage_materials(s_mat, mat);
  const int px = blockIdx.x * kTileW + threadIdx.x, py = blockIdx.y * kTileH + threadIdx.y;
  if (px >= width || py >= height) return;
  int stack[kMaxStack];
  BvhScene<A, X> T{B, L, s_mat, stack, rig, area, tex};
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < s_count; ++s) {
    sample_pixel(T, cam + s * 16, frames[s], cst, px, py, width, height, env, acc);
  }
  const size_t pix = (size_t)py * width + px;
  out[pix * 3 + 0] = acc[0];
  out[pix * 3 + 1] = acc[1];
  out[pix * 3 + 2] = acc[2];
}

// Grid (tiles x, tiles y, S frames): block (x, y, s) renders frame s of its
// tile. No albedo textures: a textured scene's realtime frame takes the
// wavefront route, as in JAX.
template <bool A>
__global__ void __launch_bounds__(kTileW * kTileH)
ft_realtime_kernel(const float* __restrict__ cam, const uint32_t* __restrict__ frames,
                   const float* __restrict__ cst, const float* __restrict__ area, FatBvh B,
                   Leaves L, const float* __restrict__ mat, float* __restrict__ direct,
                   float* __restrict__ ispec, float* __restrict__ albedo,
                   float* __restrict__ rough, int width, int height, Env env, int rig) {
  __shared__ float s_mat[kMatFields * kMaxMaterials];
  stage_materials(s_mat, mat);
  const int px = blockIdx.x * kTileW + threadIdx.x, py = blockIdx.y * kTileH + threadIdx.y;
  if (px >= width || py >= height) return;
  const int s = blockIdx.z;
  int stack[kMaxStack];
  BvhScene<A, false> T{B, L, s_mat, stack, rig, area, AlbedoTex{nullptr, nullptr, 0, 0}};
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

// rig: bits 1 directional, 2 point, 4 area (with its pack `area`); the node
// rows and ft_test are read as float4s (16-byte aligned).
bool bad_args(int s_count, const float* nodes, int n_nodes, const float* test, const float* attr,
              int n_slots, int width, int height, int env_kind, int rig, const float* area,
              const float* env_tex, int env_w, int env_h) {
  return s_count < 1 || nodes == nullptr || reinterpret_cast<uintptr_t>(nodes) % 16 ||
         test == nullptr || reinterpret_cast<uintptr_t>(test) % 16 || attr == nullptr ||
         n_nodes < 1 || n_slots < 1 || width < 1 || height < 1 ||
         !env_args_ok(env_kind, env_tex, env_w, env_h) || rig < 1 || rig > 7 ||
         ((rig & 4) && area == nullptr);
}

template <bool A, bool X>
void launch_progressive(dim3 grid, dim3 block, cudaStream_t stream, const float* cam,
                        const uint32_t* frames, const float* cst, const float* area, FatBvh B,
                        Leaves L, const float* mat, float* out, int s_count, int width,
                        int height, Env env, int rig, AlbedoTex tex) {
  ft_progressive_kernel<A, X><<<grid, block, 0, stream>>>(cam, frames, cst, area, B, L, mat, out,
                                                          s_count, width, height, env, rig, tex);
}

}  // namespace

// Sum of S progressive samples into out [height, width, 3] float32.
//   cam [S, 16] f32 (pack_cameras), frames [S] u32, cst [2, 16] f32
//   (pack_consts), area [16] f32 (pack_area_consts; read when rig & 4),
//   nodes = bvhf_rows [n_nodes, 16] f32, test = ft_test [n_slots, 20] f32
//   and attr = ft_attr [n_slots, 16] f32 (ops/traverse.leaf_records; columns
//   10..15 the corner UVs of a textured scene), mat = material_pack
//   [16, 128] f32; env_kind 0-3, with env_tex, env_w and env_h as for
//   dxr_fused_progressive_sum (csrc/fused_sample.cu); rig: bits 1
//   directional, 2 point, 4 area; texels [n_texels, 3] f32 and meta
//   [n_meta, 3] i32 (scene/textures.py), or texels null for an untextured
//   scene. err [1] i32 must be 0 on entry and is set to 1 (stack overflow)
//   or 2 (index out of range).
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for bad arguments.
extern "C" int dxr_fused_traverse_progressive_sum(
    const float* cam, const uint32_t* frames, const float* cst, const float* area,
    const float* nodes, const float* test, const float* attr, const float* mat, float* out,
    int s_count, int n_nodes, int n_slots, int width, int height, int env_kind, int rig,
    const float* env_tex, int env_w, int env_h, const float* texels, const int* meta,
    int n_texels, int n_meta, int* err, void* stream) {
  if (bad_args(s_count, nodes, n_nodes, test, attr, n_slots, width, height, env_kind, rig, area,
               env_tex, env_w, env_h) ||
      (texels != nullptr && (meta == nullptr || n_texels < 1 || n_meta < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  FatBvh B{reinterpret_cast<const float4*>(nodes), nullptr, n_nodes, n_slots, err};
  Leaves L{reinterpret_cast<const float4*>(test), attr};
  dim3 block(kTileW, kTileH);
  dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  Env env{env_tex, env_kind, env_w, env_h};
  AlbedoTex tex{texels, meta, n_texels, n_meta};
  cudaStream_t st = (cudaStream_t)stream;
  const bool a = (rig & 4) != 0, x = texels != nullptr;
  if (a && x) {
    launch_progressive<true, true>(grid, block, st, cam, frames, cst, area, B, L, mat, out, s_count,
                                   width, height, env, rig, tex);
  } else if (a) {
    launch_progressive<true, false>(grid, block, st, cam, frames, cst, area, B, L, mat, out, s_count,
                                    width, height, env, rig, tex);
  } else if (x) {
    launch_progressive<false, true>(grid, block, st, cam, frames, cst, area, B, L, mat, out, s_count,
                                    width, height, env, rig, tex);
  } else {
    launch_progressive<false, false>(grid, block, st, cam, frames, cst, area, B, L, mat, out,
                                     s_count, width, height, env, rig, tex);
  }
  return (int)cudaGetLastError();
}

// S realtime frames: direct, ispec, albedo [S, height, width, 3] and rough
// [S, height, width] float32; the other arguments as for
// dxr_fused_traverse_progressive_sum (no albedo textures), with the
// realtime jitter scale in cam.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dxr_fused_traverse_realtime_outputs(
    const float* cam, const uint32_t* frames, const float* cst, const float* area,
    const float* nodes, const float* test, const float* attr, const float* mat, float* direct,
    float* ispec, float* albedo, float* rough, int s_count, int n_nodes, int n_slots, int width,
    int height, int env_kind, int rig, const float* env_tex, int env_w, int env_h, int* err,
    void* stream) {
  if (bad_args(s_count, nodes, n_nodes, test, attr, n_slots, width, height, env_kind, rig, area,
               env_tex, env_w, env_h) ||
      s_count > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  FatBvh B{reinterpret_cast<const float4*>(nodes), nullptr, n_nodes, n_slots, err};
  Leaves L{reinterpret_cast<const float4*>(test), attr};
  dim3 block(kTileW, kTileH);
  dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, s_count);
  Env env{env_tex, env_kind, env_w, env_h};
  cudaStream_t st = (cudaStream_t)stream;
  if (rig & 4) {
    ft_realtime_kernel<true><<<grid, block, 0, st>>>(cam, frames, cst, area, B, L, mat, direct,
                                                     ispec, albedo, rough, width, height, env,
                                                     rig);
  } else {
    ft_realtime_kernel<false><<<grid, block, 0, st>>>(cam, frames, cst, area, B, L, mat, direct,
                                                      ispec, albedo, rough, width, height, env,
                                                      rig);
  }
  return (int)cudaGetLastError();
}

#ifdef DXR_LEAF_PHASE_COUNTS
// The counting build's tallies (g_leaf_counts) into out [2 * 2 * 33] u64
// (host memory), then zeroed when reset != 0. Waits for the device.
// Returns the CUDA error code (0 on success).
extern "C" int dxr_fused_traverse_leaf_counts(unsigned long long* out, int reset) {
  static const unsigned long long zeros[2 * 2 * 33] = {};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_leaf_counts, sizeof(zeros));
  if (e == cudaSuccess && reset) e = cudaMemcpyToSymbol(g_leaf_counts, zeros, sizeof(zeros));
  return (int)e;
}
#endif
