// Pieces shared by the window refinement's forward (window_refinement_fwd.cu)
// and backward (window_refinement_bwd.cu): their domain, the tiles of pixels
// both walk (ops/window_refinement.py's TILE and tile_count) and the box of f
// both stage for a tile (BOX), torch's cubic convolution weights and their
// derivative, lane reductions over the lanes of one pixel, channel loads that
// read rows of any width, and on the host the box's tensor map and the grid
// of persistent CTAs.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90_async.cuh"

namespace ufm {

constexpr int kTileW = 32;  // a warp's pixels (8, 16 or 32) never cross a tile row
constexpr int kTileH = 8;
constexpr int kTilePx = kTileW * kTileH;
// The box of f a tile stages when the taps of all its pixels fit it, in
// pixels along x and y (two boxes of 16 channels stay under the 227 KB a
// block may use). The fit rule, and so the staged tiles, are the same in
// both kernels (ops/window_refinement.py::staged_tiles).
constexpr int kBoxW = 64;
constexpr int kBoxH = 22;
constexpr float kCubicA = -0.75f;  // torch's cubic convolution constant
constexpr unsigned kFull = 0xffffffffu;

// The kernels' domain (ops/window_refinement.py's MAX_CHANNELS, MAX_PATCH):
// 1 <= C <= 64 and odd 1 <= P <= 9.
constexpr int kMaxChannels = 64;
constexpr int kMaxPatch = 9;
inline bool in_domain(int c, int p) { return c >= 1 && c <= kMaxChannels && p >= 1 && p <= kMaxPatch && p % 2 == 1; }

// Cubic-convolution weights of the taps at [-1, 0, 1, 2] from the floor tap.
__device__ __forceinline__ void cubic_weights(float t, float (&wgt)[4]) {
  const float a = kCubicA;
  const float x0 = t + 1.0f, x3 = 2.0f - t, x2 = 1.0f - t;
  wgt[0] = (((x0 - 5.0f) * x0 + 8.0f) * x0 - 4.0f) * a;
  wgt[1] = ((a + 2.0f) * t - (a + 3.0f)) * t * t + 1.0f;
  wgt[2] = ((a + 2.0f) * x2 - (a + 3.0f)) * x2 * x2 + 1.0f;
  wgt[3] = (((x3 - 5.0f) * x3 + 8.0f) * x3 - 4.0f) * a;
}

// Their derivatives in t (grid_sample.py::cubic_weights_derivative).
__device__ __forceinline__ void cubic_weights_derivative(float t, float (&dw)[4]) {
  const float a = kCubicA;
  const float x0 = t + 1.0f, x3 = 2.0f - t, x2 = 1.0f - t;
  dw[0] = ((3.0f * x0 - 10.0f) * x0 + 8.0f) * a;
  dw[1] = (3.0f * (a + 2.0f) * t - 2.0f * (a + 3.0f)) * t;
  dw[2] = -(3.0f * (a + 2.0f) * x2 - 2.0f * (a + 3.0f)) * x2;
  dw[3] = -((3.0f * x3 - 10.0f) * x3 + 8.0f) * a;
}

// Max and sum over the L consecutive lanes of one pixel (every lane gets it).
template <int L>
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int L>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Channels ch .. ch + 3 of one pixel's row `px` (C floats), zeros past C:
// one 16-byte load where rows are 16-byte aligned (`vec`: C % 4 == 0, so
// ch < C means all four are in the row), else one load per channel.
__device__ __forceinline__ float4 load_channels(const float* __restrict__ px, int ch, int c, bool vec) {
  float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (ch >= c) return t;
  if (vec) return __ldg(reinterpret_cast<const float4*>(px + ch));
  t.x = __ldg(px + ch);
  if (ch + 1 < c) t.y = __ldg(px + ch + 1);
  if (ch + 2 < c) t.z = __ldg(px + ch + 2);
  if (ch + 3 < c) t.w = __ldg(px + ch + 3);
  return t;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// A tile of pixels: its image and its top-left pixel. Tiles run row-major
// within an image, images one after another.
struct Tile {
  int img, x0, y0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_per_image) {
  const int r = t % tiles_per_image;
  return {t / tiles_per_image, (r % tiles_x) * kTileW, (r / tiles_x) * kTileH};
}

// ---- host side

// Rank-4 map of a contiguous (B, H, W, C) fp32 map: dimensions (C, W, H, B)
// innermost first, boxes of (C, kBoxW, kBoxH, 1), no swizzle; a load reads
// coordinates outside the tensor as zeros, a reduce-add drops them. Returns
// 0 or a kErr* code.
inline int encode_box_map(CUtensorMap* map, const void* base, int batch, int h, int w, int c) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kErrNoTensorMapEncoder;
  const cuuint64_t row = static_cast<cuuint64_t>(c) * 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * w, row * w * h};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(c), kBoxW, kBoxH, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(r);
}

// The grid of persistent CTAs of `kernel` (`threads` a CTA, `smem` bytes of
// dynamic shared memory, at most `smem_max`, which is allowed once per
// device: `smem_set` is the caller's record) over `num_tiles` tiles: as many
// as fit the card at once, at most one a tile. Returns 0 or a cudaError_t.
inline int persistent_grid(const void* kernel, int threads, int smem_max, int smem, int& smem_set, int num_tiles,
                           int& grid) {
  cudaError_t e = allow_smem(kernel, smem_max, smem_set);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  grid = num_tiles < sms * per_sm ? num_tiles : sms * per_sm;
  return static_cast<int>(e);
}

}  // namespace ufm
