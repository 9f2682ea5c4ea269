// Window refinement forward for Hopper (sm_90a), fp32 in / fp32 out.
//
// Replaces: the Pallas window-dots kernels of ufm_tpu/ops/window_dots.py,
// `_dots16` (:280, pallas_call :314, body `_dots_kernel` :93) and `_dots8`
// (:238, pallas_call :267, body `_dots8_kernel` :165), together with the XLA
// code around them in ufm_tpu/ops/refinement.py::_fused_refinement_pallas
// (:224): the bicubic combination (window_dots.py:541-557) and `_scores_tail`
// (refinement.py:210). One launch computes, for every pixel p of a
// (B, H, W, C) pair of feature maps q, f:
//
//   pos        = clamp(flow(p) + p, [-(r+4), W+r+4] x [-(r+4), H+r+4])
//   dots[v][u] = <q(p), f[yb + v, xb + u]>   for the (P+3)^2 integer taps,
//                (xb, yb) = floor(pos) - r - 1, zero outside the image
//   scores     = separable cubic (A = -0.75) combination of dots, P x P
//   s          = scores / temperature + bias   (as one FMA with 1 / temperature)
//   log_softmax(s), residual = sum softmax(s)[i][j] * (j - r, i - r)
//
// The clamp cannot change a score (a window wholly outside the image stays
// all zero) and keeps the float -> int conversion defined for any flow.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores), at
// the main path's shape (1, 420, 560, C = 16), P = 5:
//   bytes: q + f read once, flow read, residual + log_softmax written,
//          4 * (2 * 16 + 2 + 2 + 25) B * 235,200 px = 57 MB -> 17 us;
//   operations: 2 * 64 * 16 dot FLOPs + ~520 cubic + the softmax tail,
//          ~2.7 kFLOP a pixel = 0.63 GFLOP -> 9 us.
// So it is bound by bytes, but what sets its pace is the delivery of the taps
// into registers: 64 taps x 64 B a pixel, 0.96 GB, at most 128 B a clock per
// SM from L1 or shared memory (~30 us on 132 SMs).
//
// Design. The TPU kernels keep the padded target map in VMEM (or a row-shifted
// stack in HBM), align every window to 128 lanes and reduce the channel axis
// with a 0/1 selection matmul: all of that exists for Mosaic. Here:
//   * Channel split. C / 4 lanes work on one pixel (4 at C = 16, 1 at C = 4);
//     each holds one float4 of q(p) and reads the same float4 of every tap, so
//     one warp load fetches the whole 64-byte taps of 8 pixels (512 B) instead
//     of 16 bytes of 32 pixels scattered over up to 32 lines. The x and y
//     cubic passes are linear in the dots, so each lane combines its partial
//     dots into P x P partial scores, and the lanes of a pixel then
//     reduce-scatter them with __shfl_xor_sync: each lane ends with the whole
//     scores k = L * i + lane (7 of 25 at C = 16) and runs the softmax tail on
//     those only (max, sum and residual reduced over the lanes again).
//   * Tiles, staged by TMA. A persistent CTA walks over tiles of 32 x 8
//     pixels. For each tile it reads the flow, keeps the clamped positions in
//     shared memory and reduces the least and greatest tap origin. If the
//     taps of the whole tile fit one box of kBoxW x kBoxH pixels of f (C
//     channels each), one thread loads that box with one TMA load through a
//     rank-4 map over (C, W, H, B), starting at the tile's least tap: TMA's
//     zero fill outside the tensor is the zero padding, so the lanes read
//     their taps from shared memory with no bounds check. A tile whose taps
//     do not fit (a flow discontinuity, or a flow as wild as independent
//     noise) reads them from global memory with bounds checks: the direct
//     path, in the same kernel. Two stages: the next tile's positions, fit
//     test and TMA load are issued before this tile is computed.
//   * log_softmax (P^2 floats a pixel) goes through a per-warp staging buffer
//     so that each warp writes its pixels' rows as one contiguous run.
//   * 512 threads, one CTA an SM (193 KB of shared memory at C = 16), so at
//     most 128 registers a thread; more warps hide more latency (256 threads
//     at 255 registers ran 14% slower on a smooth flow). No IEEE division in
//     the kernel (its slow-path call made ptxas spill): the host passes
//     1 / temperature, fused with the bias into one FMA, and the residual is
//     normalised with __fdividef. ptxas builds this file at -O1
//     (ops/_build.py: at -O3 it spills).
// fp32 FMA throughout; tensor cores have nothing to do (each pixel gathers its
// own taps, no operand is shared across a tile).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "sm90_async.cuh"

namespace {

using namespace ufm;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 32;  // a warp's pixels (8, 16 or 32) never cross a tile row
constexpr int kTileH = 8;
constexpr int kTilePx = kTileW * kTileH;
static_assert(kThreads >= kTilePx, "one thread plans each pixel of a tile");
constexpr int kBoxW = 64;  // the staged box of f, in pixels along x
constexpr int kBoxH = 22;  // and along y (two boxes stay under the 196 KB carveout step: L1 keeps ~60 KB)
constexpr int kStages = 2;
constexpr float kCubicA = -0.75f;  // torch's cubic convolution constant
constexpr unsigned kFull = 0xffffffffu;

template <int C, int P>
struct Cfg {
  static constexpr int L = C / 4;  // lanes per pixel, one float4 of channels each
  static constexpr int K = P + 3;  // integer tap span per axis
  static constexpr int R = (P - 1) / 2;
  static constexpr int PP = P * P;
  static constexpr int kOwn = (PP + L - 1) / L;  // scores each lane finishes
  static constexpr int kPxPerWarp = 32 / L;
  static constexpr int kPasses = (kTilePx * L + kThreads - 1) / kThreads;
  static constexpr int kBoxBytes = kBoxW * kBoxH * C * 4;
  static constexpr int kStageFloats = kPxPerWarp * PP;  // log_softmax staging per warp
  // shared memory (128-byte aligned: the TMA boxes)
  static constexpr int kPosOff = kStages * kBoxBytes;                 // float2 [kStages][kTilePx]
  static constexpr int kLsOff = kPosOff + kStages * kTilePx * 8;      // float [kWarps][kStageFloats]
  static constexpr int kRedOff = kLsOff + kWarps * kStageFloats * 4;  // int4 [kWarps]
  static constexpr int kPlanOff = kRedOff + kWarps * 16;              // int4 [kStages]: see finish_plan
  static constexpr int kBarOff = kPlanOff + kStages * 16;             // uint64 [kStages]
  static constexpr int kSmemBytes = kBarOff + kStages * 8;
  static_assert(kSmemBytes <= 232448, "shared memory over the 227 KB a block may use");
  static_assert(kBoxBytes % 128 == 0 && kRedOff % 16 == 0, "TMA destinations and int4 slots need alignment");
};

// Cubic-convolution weights of the taps at [-1, 0, 1, 2] from the floor tap.
__device__ __forceinline__ void cubic_weights(float t, float (&wgt)[4]) {
  const float a = kCubicA;
  const float x0 = t + 1.0f, x3 = 2.0f - t, x2 = 1.0f - t;
  wgt[0] = (((x0 - 5.0f) * x0 + 8.0f) * x0 - 4.0f) * a;
  wgt[1] = ((a + 2.0f) * t - (a + 3.0f)) * t * t + 1.0f;
  wgt[2] = ((a + 2.0f) * x2 - (a + 3.0f)) * x2 * x2 + 1.0f;
  wgt[3] = (((x3 - 5.0f) * x3 + 8.0f) * x3 - 4.0f) * a;
}

struct Tile {
  int img, x0, y0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_per_image) {
  const int r = t % tiles_per_image;
  return {t / tiles_per_image, (r % tiles_x) * kTileW, (r / tiles_x) * kTileH};
}

// Every thread (thread i < kTilePx: pixel i): the sample positions of the
// tile's pixels, clamped to [-m, hi.x] x [-m, hi.y] (m = R + 4, hi = (W, H)
// + m), into `pos` ((0, 0) for a pixel outside the image), and this warp's
// least and greatest tap origin into red[warp] = (x min, y min, x max,
// y max).
template <int C, int P>
__device__ __forceinline__ void plan_pixels(const Tile& tl, const float2* __restrict__ flow, float2* pos, int4* red,
                                            int h, int w, float2 hi) {
  using G = Cfg<C, P>;
  const float m = static_cast<float>(G::R + 4);
  const int i = threadIdx.x;
  const int x = tl.x0 + i % kTileW, y = tl.y0 + i / kTileW;
  int xmin = INT_MAX, ymin = INT_MAX, xmax = INT_MIN, ymax = INT_MIN;
  if (i < kTilePx) {
    float2 p = make_float2(0.0f, 0.0f);
    if (x < w && y < h) {
      const float2 fl = __ldg(flow + (static_cast<long long>(tl.img) * h + y) * w + x);
      p.x = fminf(fmaxf(fl.x + static_cast<float>(x), -m), hi.x);
      p.y = fminf(fmaxf(fl.y + static_cast<float>(y), -m), hi.y);
      xmin = xmax = static_cast<int>(floorf(p.x)) - G::R - 1;
      ymin = ymax = static_cast<int>(floorf(p.y)) - G::R - 1;
    }
    pos[i] = p;
  }
  xmin = __reduce_min_sync(kFull, xmin);
  ymin = __reduce_min_sync(kFull, ymin);
  xmax = __reduce_max_sync(kFull, xmax);
  ymax = __reduce_max_sync(kFull, ymax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = make_int4(xmin, ymin, xmax, ymax);
}

// One thread, after plan_pixels and a barrier: the tile's plan into plan[s]
// = (staged?, box origin x, box origin y, staged loads of stage s so far,
// mod 2) and, if its taps fit the box, the TMA load of the box into stage s;
// the box has landed when bars[s] completes the phase of parity w ^ 1. (The
// parity lives here and not in a register: ptxas fills every register with
// tap loads and spills what stays live across them.)
template <int C, int P>
__device__ __forceinline__ void finish_plan(int img, int s, const int4* red, int4* plan, uint8_t* boxes,
                                            uint64_t* bars, const CUtensorMap* tm_f, int* staged_count) {
  using G = Cfg<C, P>;
  int4 a = red[0];
  for (int i = 1; i < kWarps; ++i) {
    const int4 b = red[i];
    a = make_int4(min(a.x, b.x), min(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
  }
  const bool fits = a.z - a.x + G::K <= kBoxW && a.w - a.y + G::K <= kBoxH;
  plan[s] = make_int4(fits, a.x, a.y, plan[s].w ^ fits);
  if (fits) {
    fence_proxy_async_smem();  // the last tile's reads of this stage come first
    mbar_arrive_expect_tx(&bars[s], G::kBoxBytes);
    tma_load_4d(boxes + s * G::kBoxBytes, tm_f, &bars[s], 0, a.x, a.y, img);
    if (staged_count != nullptr) atomicAdd(staged_count, 1);
  }
}

// This lane's partial P x P scores: its float4 of channels of every tap,
// combined by the x pass row by row as the taps arrive and accumulated into
// the y pass (each tap row v feeds the score rows i with 0 <= v - i < 4).
template <int P, class Fetch>
__device__ __forceinline__ void partial_scores(const float4& qv, const float (&wx)[4], const float (&wy)[4],
                                               Fetch fetch, float (&sc)[P * P]) {
  constexpr int K = P + 3;
#pragma unroll
  for (int k = 0; k < P * P; ++k) sc[k] = 0.0f;
#pragma unroll
  for (int v = 0; v < K; ++v) {
    float d[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const float4 t = fetch(v, u);
      d[u] = fmaf(qv.w, t.w, fmaf(qv.z, t.z, fmaf(qv.y, t.y, qv.x * t.x)));
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) s = fmaf(wx[mm], d[j + mm], s);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (v - i >= 0 && v - i < 4) sc[i * P + j] = fmaf(wy[v - i], s, sc[i * P + j]);
      }
    }
  }
}

// Sum the partial scores over a pixel's L lanes (L consecutive lanes, c4 =
// lane % L) so that each lane ends with the whole scores k = L * i + c4:
// own[i]. One exchange step per lane bit; the entries past P * P are zeros.
template <int L, int PP>
__device__ __forceinline__ void reduce_scatter(const float (&sc)[PP], float (&own)[(PP + L - 1) / L], int c4) {
  constexpr int kOwn = (PP + L - 1) / L;
  if constexpr (L == 1) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i) own[i] = sc[i];
  } else if constexpr (L == 2) {
    const bool hi = c4 & 1;
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const float a = sc[2 * i], b = 2 * i + 1 < PP ? sc[2 * i + 1] : 0.0f;
      own[i] = (hi ? b : a) + __shfl_xor_sync(kFull, hi ? a : b, 1);
    }
  } else {
    static_assert(L == 4, "C / 4 lanes: C in {4, 8, 16}");
    const bool b1 = c4 & 2, b0 = c4 & 1;
    float half[2 * kOwn];  // half[m]: k = 4 * (m / 2) + m % 2 + 2 * b1, summed over lanes c4 and c4 ^ 2
#pragma unroll
    for (int m = 0; m < 2 * kOwn; ++m) {
      const int k = 4 * (m / 2) + m % 2;
      const float a = k < PP ? sc[k] : 0.0f, b = k + 2 < PP ? sc[k + 2] : 0.0f;
      half[m] = (b1 ? b : a) + __shfl_xor_sync(kFull, b1 ? a : b, 2);
    }
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const float a = half[2 * i], b = half[2 * i + 1];
      own[i] = (b0 ? b : a) + __shfl_xor_sync(kFull, b0 ? a : b, 1);
    }
  }
}

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

// Every thread: the tile's pixels, kPasses rounds of kThreads / L pixels;
// the taps come from the staged box (kStaged, origin (pl.y, pl.z)) or from
// global memory.
template <int C, int P, bool kStaged>
__device__ __forceinline__ void refine_tile(const Tile& tl, const float2* pos, const float4* box, int4 pl,
                                            float* ls_warp, const float4* __restrict__ q4,
                                            const float4* __restrict__ f4, const float* __restrict__ bias,
                                            float2* __restrict__ residual, float* __restrict__ log_softmax, int h,
                                            int w, float inv_temperature) {
  using G = Cfg<C, P>;
  constexpr int L = G::L, R = G::R, PP = G::PP;
  const int lane = threadIdx.x & 31;
  const int c4 = lane % L;
#pragma unroll 1
  for (int pass = 0; pass < G::kPasses; ++pass) {
    const int u0 = pass * kThreads + (threadIdx.x & ~31);  // this warp's first (pixel, lane) unit
    if (u0 >= kTilePx * L) break;
    const int pix = (u0 + lane) / L;
    const int x = tl.x0 + pix % kTileW, y = tl.y0 + pix / kTileW;
    const bool valid = x < w && y < h;
    const long long n = (static_cast<long long>(tl.img) * h + y) * w + x;
    const float4 qv = valid ? __ldg(q4 + n * L + c4) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float2 p = pos[pix];
    const float fx = floorf(p.x), fy = floorf(p.y);
    float wx[4], wy[4];
    cubic_weights(p.x - fx, wx);
    cubic_weights(p.y - fy, wy);
    const int xb = static_cast<int>(fx) - R - 1;  // leftmost tap
    const int yb = static_cast<int>(fy) - R - 1;  // topmost tap

    float sc[PP];
    if constexpr (kStaged) {
      // the box covers every valid pixel's taps; a pixel outside the image
      // reads the box's corner and is never stored
      const float4* tap0 = box + (valid ? ((yb - pl.z) * kBoxW + xb - pl.y) * L : 0) + c4;
      partial_scores<P>(qv, wx, wy, [&](int v, int u) { return tap0[(v * kBoxW + u) * L]; }, sc);
    } else {
      const float4* fimg = f4 + static_cast<long long>(tl.img) * h * w * L + c4;
      partial_scores<P>(qv, wx, wy, [&](int v, int u) {
        const int iy = yb + v, ix = xb + u;
        const float4* row = fimg + static_cast<long long>(iy) * w * L;
        return (iy >= 0 && iy < h && ix >= 0 && ix < w) ? __ldg(row + ix * L) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }, sc);
    }

    // temperature, bias and the softmax tail on this lane's scores k = L * i + c4
    float own[G::kOwn];
    reduce_scatter<L, PP>(sc, own, c4);
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < G::kOwn; ++i) {
      const int k = L * i + c4;
      if (k < PP) {
        own[i] = fmaf(own[i], inv_temperature, __ldg(bias + k));
        mx = fmaxf(mx, own[i]);
      }
    }
    mx = lanes_max<L>(mx);
    float sum = 0.0f, rx = 0.0f, ry = 0.0f;
#pragma unroll
    for (int i = 0; i < G::kOwn; ++i) {
      const int k = L * i + c4;
      if (k < PP) {
        const float e = expf(own[i] - mx);
        sum += e;
        rx = fmaf(e, static_cast<float>(k % P - R), rx);
        ry = fmaf(e, static_cast<float>(k / P - R), ry);
      }
    }
    sum = lanes_sum<L>(sum);
    rx = lanes_sum<L>(rx);
    ry = lanes_sum<L>(ry);
    const float lse = logf(sum);
#pragma unroll
    for (int i = 0; i < G::kOwn; ++i) {
      const int k = L * i + c4;
      if (k < PP) ls_warp[(lane / L) * PP + k] = own[i] - mx - lse;
    }
    // no IEEE division in the kernel: its slow-path call makes ptxas spill
    if (valid && c4 == 0) residual[n] = make_float2(__fdividef(rx, sum), __fdividef(ry, sum));
    __syncwarp();
    // the warp's pixels lie in one tile row; those in the image are a prefix
    const int pix0 = u0 / L;
    const int x_first = tl.x0 + pix0 % kTileW, y_row = tl.y0 + pix0 / kTileW;
    const int count = y_row < h ? min(max(w - x_first, 0), G::kPxPerWarp) : 0;
    float* out = log_softmax + ((static_cast<long long>(tl.img) * h + y_row) * w + x_first) * PP;
    for (int e = lane; e < count * PP; e += 32) out[e] = ls_warp[e];
    __syncwarp();
  }
}

// 512 threads: at most 128 registers a thread.
template <int C, int P>
__global__ void __launch_bounds__(kThreads, 1)
    window_refinement_fwd_kernel(const __grid_constant__ CUtensorMap tm_f, const float* __restrict__ q,
                                 const float* __restrict__ f, const float* __restrict__ flow,
                                 const float* __restrict__ bias, float* __restrict__ residual,
                                 float* __restrict__ log_softmax, int* __restrict__ staged_count, int h, int w,
                                 float2 clamp_hi, int tiles_x, int tiles_per_image, int num_tiles,
                                 float inv_temperature) {
  using G = Cfg<C, P>;
  // Indexed from the array itself, so that the compiler keeps these shared
  // (LDS / STS, not generic loads)
  extern __shared__ __align__(128) uint8_t smem[];  // stage s's box at s * kBoxBytes
  float2* pos = reinterpret_cast<float2*>(smem + G::kPosOff);
  float* ls_warp = reinterpret_cast<float*>(smem + G::kLsOff) + (threadIdx.x / 32) * G::kStageFloats;
  int4* red = reinterpret_cast<int4*>(smem + G::kRedOff);
  int4* plan = reinterpret_cast<int4*>(smem + G::kPlanOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::kBarOff);
  const float2* flow2 = reinterpret_cast<const float2*>(flow);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* f4 = reinterpret_cast<const float4*>(f);
  float2* res2 = reinterpret_cast<float2*>(residual);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars[s], 1);
      plan[s].w = 0;
    }
    fence_mbar_init();
    prefetch_tensor_map(&tm_f);
  }
  // The grid is at most num_tiles CTAs: every CTA has a first tile.
  plan_pixels<C, P>(tile_at(blockIdx.x, tiles_x, tiles_per_image), flow2, pos, red, h, w, clamp_hi);
  __syncthreads();
  if (threadIdx.x == 0) {
    finish_plan<C, P>(blockIdx.x / tiles_per_image, 0, red, plan, smem, bars, &tm_f, staged_count);
  }
  __syncthreads();

  for (int t = blockIdx.x, k = 0; t < num_tiles; t += gridDim.x, ++k) {
    const int s = k & 1;
    const int t_next = t + gridDim.x;
    if (t_next < num_tiles) {
      plan_pixels<C, P>(tile_at(t_next, tiles_x, tiles_per_image), flow2, pos + (s ^ 1) * kTilePx, red, h, w,
                        clamp_hi);
    }
    __syncthreads();  // red of the next tile; plan[s] was published by the last barrier
    if (t_next < num_tiles && threadIdx.x == 0) {
      finish_plan<C, P>(t_next / tiles_per_image, s ^ 1, red, plan, smem, bars, &tm_f, staged_count);
    }
    const Tile tl = tile_at(t, tiles_x, tiles_per_image);
    const int4 pl = plan[s];
    if (pl.x) {
      mbar_wait(&bars[s], pl.w ^ 1);
      refine_tile<C, P, true>(tl, pos + s * kTilePx, reinterpret_cast<const float4*>(smem + s * G::kBoxBytes), pl,
                              ls_warp, q4, f4, bias, res2, log_softmax, h, w, inv_temperature);
    } else {
      refine_tile<C, P, false>(tl, pos + s * kTilePx, nullptr, pl, ls_warp, q4, f4, bias, res2, log_softmax, h, w,
                               inv_temperature);
    }
    __syncthreads();  // stage s, pos[s] and plan[s] are free; plan[s ^ 1] is published
  }
}

// Rank-4 map of the contiguous (B, H, W, C) fp32 target map: dimensions
// (C, W, H, B) innermost first, boxes of (C, kBoxW, kBoxH, 1), no swizzle,
// coordinates outside the tensor read as zeros. Returns 0 or a kErr* code.
int encode_f_map(CUtensorMap* map, const void* f, int batch, int h, int w, int c) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kErrNoTensorMapEncoder;
  const cuuint64_t row = static_cast<cuuint64_t>(c) * 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * w, row * w * h};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(c), kBoxW, kBoxH, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(f), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(r);
}

template <int C, int P>
int launch(const CUtensorMap& tm_f, const void* q, const void* f, const void* flow, const void* bias, void* residual,
           void* log_softmax, int* staged_count, int batch, int h, int w, float temperature, cudaStream_t stream) {
  using G = Cfg<C, P>;
  static int smem_set = 0;  // devices on which this instance may use kSmemBytes
  const void* kernel = reinterpret_cast<const void*>(window_refinement_fwd_kernel<C, P>);
  cudaError_t e = allow_smem(kernel, G::kSmemBytes, smem_set);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, G::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_per_image = tiles_x * ((h + kTileH - 1) / kTileH);
  const int num_tiles = batch * tiles_per_image;
  const int grid = num_tiles < sms * per_sm ? num_tiles : sms * per_sm;  // persistent CTAs
  const float m = static_cast<float>(Cfg<C, P>::R + 4);
  window_refinement_fwd_kernel<C, P><<<grid, kThreads, G::kSmemBytes, stream>>>(
      tm_f, static_cast<const float*>(q), static_cast<const float*>(f), static_cast<const float*>(flow),
      static_cast<const float*>(bias), static_cast<float*>(residual), static_cast<float*>(log_softmax), staged_count,
      h, w, make_float2(static_cast<float>(w) + m, static_cast<float>(h) + m), tiles_x, tiles_per_image, num_tiles,
      1.0f / temperature);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_p(int p, const CUtensorMap& tm_f, const void* q, const void* f, const void* flow, const void* bias,
             void* residual, void* log_softmax, int* staged_count, int batch, int h, int w, float temperature,
             cudaStream_t stream) {
  switch (p) {
    case 1: return launch<C, 1>(tm_f, q, f, flow, bias, residual, log_softmax, staged_count, batch, h, w, temperature, stream);
    case 3: return launch<C, 3>(tm_f, q, f, flow, bias, residual, log_softmax, staged_count, batch, h, w, temperature, stream);
    case 5: return launch<C, 5>(tm_f, q, f, flow, bias, residual, log_softmax, staged_count, batch, h, w, temperature, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, f: (B, H, W, C) fp32 contiguous, 16-byte aligned; flow: (B, H, W, 2);
// bias: (P * P,); residual: (B, H, W, 2); log_softmax: (B, H, W, P, P).
// C in {4, 8, 16}, P in {1, 3, 5}. `staged_count` is null or one device int
// to which the kernel adds the number of tiles whose taps it staged through
// TMA (the rest took the direct path). Launches on `stream`; returns 0, a
// cudaError_t (cudaErrorInvalidValue for an unsupported C or P), or a kErr*
// code of sm90_async.cuh when the tensor map of f cannot be made.
extern "C" int ufm_window_refinement_fwd_f32(const void* q, const void* f, const void* flow, const void* bias,
                                             void* residual, void* log_softmax, void* staged_count, int batch, int h,
                                             int w, int c, int p, float temperature, void* stream) {
  if (static_cast<long long>(batch) * h * w == 0) return 0;
  if (c != 4 && c != 8 && c != 16) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_f;
  const int err = encode_f_map(&tm_f, f, batch, h, w, c);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* count = static_cast<int*>(staged_count);
  switch (c) {
    case 4: return launch_p<4>(p, tm_f, q, f, flow, bias, residual, log_softmax, count, batch, h, w, temperature, s);
    case 8: return launch_p<8>(p, tm_f, q, f, flow, bias, residual, log_softmax, count, batch, h, w, temperature, s);
    default: return launch_p<16>(p, tm_f, q, f, flow, bias, residual, log_softmax, count, batch, h, w, temperature, s);
  }
}
