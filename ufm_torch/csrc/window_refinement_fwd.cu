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
//
// The rest of the domain (1 <= C <= 64, odd P <= 9: the shapes the JAX
// package answers through its XLA path) runs two more kernels, the same
// tiles and tail:
//   * window_refinement_fwd_any_kernel<NQ, P>, C <= 16: the lanes of a pixel
//     split the taps, not the channels. Each of its L lanes (2, 4 at P = 9,
//     twice that at NQ = 4 from P = 7, where shared memory is short) holds
//     the pixel's whole q in NQ = ceil(C / 4) float4s (channels past C zero;
//     one load a channel where C % 4 != 0) and takes whole tap rows v = lane,
//     lane + L, ...: their full dot products, and the x pass of each row,
//     which goes to the warp's stage in shared memory (K x P floats a pixel).
//     After one __syncwarp each lane runs the y pass of its share of the P^2
//     scores from the stage, then the tail: the pixel's partial scores meet
//     once, through shared memory, instead of after every tap row through
//     shuffles, and no lane idles for want of channels (a channel split ran 16
//     lanes a pixel at P = 9, 12 of them idle at C = 12). Lanes reading the same tap
//     column of neighbouring rows read different float4s of it (the box's
//     rows are a multiple of 128 bytes apart: the same banks). The tap loop
//     keeps a sliding window of three dots; at NQ = 3, and NQ = 2 with P = 9,
//     it unrolls two taps at a time (a whole row's hoisted loads spilled).
//     Staged as above where C % 4 == 0 (a box of C channels a pixel).
//   * window_refinement_fwd_wide_kernel<L, P>, C > 16: L = 8 or 16 lanes a
//     pixel (16 at P = 9, where 8 spill), one float4 of channels each, the
//     lanes reduce-scatter each tap row's x-passed partial scores as it
//     arrives (reduce_scatter_lanes), so a lane keeps only its columns j = L t
//     + c4 of every score row; every tap from global memory (two boxes of C >
//     16 channels outgrow shared memory), so its CTAs take little shared
//     memory and leave L1 its room.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>
#include <cstring>

#include "sm90_async.cuh"
#include "window_refinement.cuh"

namespace {

using namespace ufm;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads >= kTilePx, "one thread plans each pixel of a tile");
constexpr int kStages = 2;

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

// Every thread (thread i < kTilePx: pixel i): the sample positions of the
// tile's pixels, clamped to [-m, hi.x] x [-m, hi.y] (m = R + 4, hi = (W, H)
// + m), into `pos` ((0, 0) for a pixel outside the image), and this warp's
// least and greatest tap origin into red[warp] = (x min, y min, x max,
// y max).
template <int R>
__device__ __forceinline__ void plan_pixels(const Tile& tl, const float2* __restrict__ flow, float2* pos, int4* red,
                                            int h, int w, float2 hi) {
  const float m = static_cast<float>(R + 4);
  const int i = threadIdx.x;
  const int x = tl.x0 + i % kTileW, y = tl.y0 + i / kTileW;
  int xmin = INT_MAX, ymin = INT_MAX, xmax = INT_MIN, ymax = INT_MIN;
  if (i < kTilePx) {
    float2 p = make_float2(0.0f, 0.0f);
    if (x < w && y < h) {
      const float2 fl = __ldg(flow + (static_cast<long long>(tl.img) * h + y) * w + x);
      p.x = fminf(fmaxf(fl.x + static_cast<float>(x), -m), hi.x);
      p.y = fminf(fmaxf(fl.y + static_cast<float>(y), -m), hi.y);
      xmin = xmax = static_cast<int>(floorf(p.x)) - R - 1;
      ymin = ymax = static_cast<int>(floorf(p.y)) - R - 1;
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
// mod 2) and, if the kernel stages (`stage`) and the taps fit the box, the
// TMA load of the box (`box_bytes` of it land, at stride `stage_bytes`) into
// stage s; the box has landed when bars[s] completes the phase of parity
// w ^ 1. (The parity lives here and not in a register: ptxas fills every
// register with tap loads and spills what stays live across them.)
template <int K>
__device__ __forceinline__ void finish_plan(int img, int s, const int4* red, int4* plan, uint8_t* boxes,
                                            uint64_t* bars, const CUtensorMap* tm_f, int* staged_count, bool stage,
                                            int box_bytes, int stage_bytes) {
  int4 a = red[0];
  for (int i = 1; i < kWarps; ++i) {
    const int4 b = red[i];
    a = make_int4(min(a.x, b.x), min(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
  }
  const bool fits = stage && a.z - a.x + K <= kBoxW && a.w - a.y + K <= kBoxH;
  plan[s] = make_int4(fits, a.x, a.y, plan[s].w ^ fits);
  if (fits) {
    fence_proxy_async_smem();  // the last tile's reads of this stage come first
    mbar_arrive_expect_tx(&bars[s], box_bytes);
    tma_load_4d(boxes + s * stage_bytes, tm_f, &bars[s], 0, a.x, a.y, img);
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
    static_assert(L == 4, "1, 2 or 4 lanes a pixel");
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
  plan_pixels<G::R>(tile_at(blockIdx.x, tiles_x, tiles_per_image), flow2, pos, red, h, w, clamp_hi);
  __syncthreads();
  if (threadIdx.x == 0) {
    finish_plan<G::K>(blockIdx.x / tiles_per_image, 0, red, plan, smem, bars, &tm_f, staged_count, true,
                      G::kBoxBytes, G::kBoxBytes);
  }
  __syncthreads();

  for (int t = blockIdx.x, k = 0; t < num_tiles; t += gridDim.x, ++k) {
    const int s = k & 1;
    const int t_next = t + gridDim.x;
    if (t_next < num_tiles) {
      plan_pixels<G::R>(tile_at(t_next, tiles_x, tiles_per_image), flow2, pos + (s ^ 1) * kTilePx, red, h, w,
                        clamp_hi);
    }
    __syncthreads();  // red of the next tile; plan[s] was published by the last barrier
    if (t_next < num_tiles && threadIdx.x == 0) {
      finish_plan<G::K>(t_next / tiles_per_image, s ^ 1, red, plan, smem, bars, &tm_f, staged_count, true,
                        G::kBoxBytes, G::kBoxBytes);
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


// ---- C <= 16 off the fixed instances: the lanes of a pixel split the taps

// NQ float4s of q a lane (C <= 4 NQ); L lanes a pixel, each taking the tap
// rows v = c4, c4 + L, ...: 2 (4 at P = 9), and twice that at NQ = 4 from P
// = 7, where the warps' stages and two 16-channel boxes would outgrow shared
// memory.
template <int NQ, int P>
struct AnyCfg {
  static constexpr int K = P + 3;
  static constexpr int R = (P - 1) / 2;
  static constexpr int PP = P * P;
  static constexpr int L = (P == 9 ? 4 : P == 7 && NQ == 4 ? 4 : 2) * (P == 9 && NQ == 4 ? 2 : 1);
  static constexpr int kRows = (K + L - 1) / L;  // tap rows a lane takes
  // taps of a row unrolled together: all of them where ptxas keeps their
  // loads in registers, else 2 (at NQ = 3, or NQ = 2 with P = 9, the whole
  // row's hoisted loads spilled)
  static constexpr int kUnrollTaps = NQ * K >= 24 && NQ < 4 ? 2 : K;
  static constexpr int J = (PP + L - 1) / L;     // scores a lane finishes: k = L t + c4
  static constexpr int kPxPerWarp = 32 / L;
  static constexpr int kPasses = kTilePx * L / kThreads;
  // a warp's stage: its pixels' x-passed tap rows (K x P floats a pixel),
  // then their log_softmax rows (P x P a pixel)
  static constexpr int kStageFloats = kPxPerWarp * K * P;
  // shared memory after the two boxes (2 x box_bytes, a multiple of 128):
  static constexpr int kPosOff = 0;                                    // float2 [kStages][kTilePx]
  static constexpr int kStageOff = kPosOff + kStages * kTilePx * 8;    // float [kWarps][kStageFloats]
  static constexpr int kRedOff = kStageOff + kWarps * kStageFloats * 4;  // int4 [kWarps]
  static constexpr int kPlanOff = kRedOff + kWarps * 16;               // int4 [kStages]: see finish_plan
  static constexpr int kBarOff = kPlanOff + kStages * 16;              // uint64 [kStages]
  static constexpr int kFixedBytes = kBarOff + kStages * 8;
  static constexpr int kMaxSmemBytes = 2 * kBoxW * kBoxH * 4 * NQ * 4 + kFixedBytes;
  static_assert(kMaxSmemBytes <= 232448, "shared memory over the 227 KB a block may use");
  static_assert(kRedOff % 16 == 0 && kPasses * kThreads == kTilePx * L, "int4 slots, whole passes");
};

// Every thread: the tile's pixels, L lanes a pixel. Each lane holds the
// pixel's whole q (slot s: channels 4 ((s + rot) % NQ) .. + 3, zero past C)
// and takes whole tap rows: their dots, from the staged box (kStaged:
// origin (pl.y, pl.z), C channels a pixel) or from global memory, then the x
// pass of each row into the warp's stage. After one __syncwarp the lanes
// split the P x P scores (k = L t + c4): the y pass from the stage, then the
// temperature, bias and softmax tail.
template <int NQ, int P, bool kStaged>
__device__ __forceinline__ void refine_tile_any(const Tile& tl, const float2* pos, const float* box, int4 pl,
                                                float* stage, const float* __restrict__ q,
                                                const float* __restrict__ f, const float* __restrict__ bias,
                                                float2* __restrict__ residual, float* __restrict__ log_softmax, int h,
                                                int w, int c, bool vec, float inv_temperature) {
  using G = AnyCfg<NQ, P>;
  constexpr int L = G::L, R = G::R, PP = G::PP, K = G::K, J = G::J;
  const int lane = threadIdx.x & 31;
  const int c4 = lane % L, px_local = lane / L;
  // the slot order: lanes reading the same tap column of neighbouring rows
  // (the box's rows are 128-byte multiples apart: the same banks) read
  // different float4s of it
  const int rot = (c4 + L * (px_local >> 1)) % NQ;
  int chs[NQ];
#pragma unroll
  for (int s = 0; s < NQ; ++s) chs[s] = 4 * ((s + rot) % NQ);
  float* st = stage + px_local * K * P;  // this pixel's x-passed rows
#pragma unroll 1
  for (int pass = 0; pass < G::kPasses; ++pass) {
    const int u0 = pass * kThreads + (threadIdx.x & ~31);  // this warp's first (pixel, lane) unit
    const int pix = (u0 + lane) / L;
    const int x = tl.x0 + pix % kTileW, y = tl.y0 + pix / kTileW;
    const bool valid = x < w && y < h;
    const long long n = (static_cast<long long>(tl.img) * h + y) * w + x;
    float4 qv[NQ];
#pragma unroll
    for (int s = 0; s < NQ; ++s) {
      qv[s] = valid ? load_channels(q + n * c, chs[s], c, vec) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    const float2 p = pos[pix];
    const float fx = floorf(p.x), fy = floorf(p.y);
    float wx[4], wy[4];
    cubic_weights(p.x - fx, wx);
    cubic_weights(p.y - fy, wy);
    const int xb = static_cast<int>(fx) - R - 1;  // leftmost tap
    const int yb = static_cast<int>(fy) - R - 1;  // topmost tap
    const float* fimg = f + static_cast<long long>(tl.img) * h * w * c;
    // the box covers every valid pixel's taps; a pixel outside the image
    // reads the box's corner and is never stored
    const float* tap0 = box + (kStaged && valid ? ((yb - pl.z) * kBoxW + xb - pl.y) * c : 0);

#pragma unroll 1
    for (int r = 0; r < G::kRows; ++r) {
      const int v = c4 + L * r;
      if (v < K) {
        // the row's whole dots, tap by tap; the x pass of column j = u - 3
        // once its last tap u has arrived (d0 .. d2: the three before it)
        float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
#pragma unroll(G::kUnrollTaps)
        for (int u = 0; u < K; ++u) {
          float dot = 0.0f;
#pragma unroll
          for (int s = 0; s < NQ; ++s) {
            float4 t;
            if constexpr (kStaged) {
              t = *reinterpret_cast<const float4*>(tap0 + (v * kBoxW + u) * c + chs[s]);
            } else {
              const int iy = yb + v, ix = xb + u;
              t = (iy >= 0 && iy < h && ix >= 0 && ix < w)
                      ? load_channels(fimg + (static_cast<long long>(iy) * w + ix) * c, chs[s], c, vec)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
            dot = dot4(qv[s], t, dot);
          }
          if (u >= 3) st[v * P + u - 3] = fmaf(wx[3], dot, fmaf(wx[2], d2, fmaf(wx[1], d1, wx[0] * d0)));
          d0 = d1;
          d1 = d2;
          d2 = dot;
        }
      }
    }
    __syncwarp();  // every row of the warp's pixels is in the stage

    // the y pass of this lane's scores k = L t + c4, then the tail
    float sc[J];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < J; ++t) {
      const int k = L * t + c4;
      float s = 0.0f;
      if (k < PP) {  // score (i, j) = (k / P, k % P) from rows i .. i + 3 of column j: st[k + l P]
#pragma unroll
        for (int l = 0; l < 4; ++l) s = fmaf(wy[l], st[k + l * P], s);
        s = fmaf(s, inv_temperature, __ldg(bias + k));
        mx = fmaxf(mx, s);
      }
      sc[t] = s;
    }
    mx = lanes_max<L>(mx);
    float sum = 0.0f, rx = 0.0f, ry = 0.0f;
#pragma unroll
    for (int t = 0; t < J; ++t) {
      const int k = L * t + c4;
      if (k < PP) {
        const float e = expf(sc[t] - mx);
        sum += e;
        rx = fmaf(e, static_cast<float>(k % P - R), rx);
        ry = fmaf(e, static_cast<float>(k / P - R), ry);
      }
    }
    sum = lanes_sum<L>(sum);
    rx = lanes_sum<L>(rx);
    ry = lanes_sum<L>(ry);
    const float lse = logf(sum);
    __syncwarp();  // the stage is read: it takes the warp's log_softmax rows
#pragma unroll
    for (int t = 0; t < J; ++t) {
      const int k = L * t + c4;
      if (k < PP) stage[px_local * PP + k] = sc[t] - mx - lse;
    }
    if (valid && c4 == 0) residual[n] = make_float2(__fdividef(rx, sum), __fdividef(ry, sum));
    __syncwarp();
    // the warp's pixels lie in one tile row; those in the image are a prefix
    const int pix0 = u0 / L;
    const int x_first = tl.x0 + pix0 % kTileW, y_row = tl.y0 + pix0 / kTileW;
    const int count = y_row < h ? min(max(w - x_first, 0), G::kPxPerWarp) : 0;
    float* out = log_softmax + ((static_cast<long long>(tl.img) * h + y_row) * w + x_first) * PP;
    for (int e = lane; e < count * PP; e += 32) out[e] = stage[e];
    __syncwarp();
  }
}

// The fixed kernel's persistent loop with its two stages, over
// refine_tile_any; `box_bytes` is one box's size where this launch stages
// (C % 4 == 0), else 0 (the boxes then take no shared memory).
template <int NQ, int P>
__global__ void __launch_bounds__(kThreads, 1)
    window_refinement_fwd_any_kernel(const __grid_constant__ CUtensorMap tm_f, const float* __restrict__ q,
                                     const float* __restrict__ f, const float* __restrict__ flow,
                                     const float* __restrict__ bias, float* __restrict__ residual,
                                     float* __restrict__ log_softmax, int* __restrict__ staged_count, int h, int w,
                                     int c, int box_bytes, float2 clamp_hi, int tiles_x, int tiles_per_image,
                                     int num_tiles, float inv_temperature) {
  using G = AnyCfg<NQ, P>;
  extern __shared__ __align__(128) uint8_t smem[];  // stage s's box at s * box_bytes
  uint8_t* fixed = smem + 2 * box_bytes;
  float2* pos = reinterpret_cast<float2*>(fixed + G::kPosOff);
  float* stage = reinterpret_cast<float*>(fixed + G::kStageOff) + (threadIdx.x / 32) * G::kStageFloats;
  int4* red = reinterpret_cast<int4*>(fixed + G::kRedOff);
  int4* plan = reinterpret_cast<int4*>(fixed + G::kPlanOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(fixed + G::kBarOff);
  const float2* flow2 = reinterpret_cast<const float2*>(flow);
  float2* res2 = reinterpret_cast<float2*>(residual);
  const bool vec = c % 4 == 0;
  const bool staging = box_bytes != 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars[s], 1);
      plan[s].w = 0;
    }
    fence_mbar_init();
    if (staging) prefetch_tensor_map(&tm_f);
  }
  plan_pixels<G::R>(tile_at(blockIdx.x, tiles_x, tiles_per_image), flow2, pos, red, h, w, clamp_hi);
  __syncthreads();
  if (threadIdx.x == 0) {
    finish_plan<G::K>(blockIdx.x / tiles_per_image, 0, red, plan, smem, bars, &tm_f, staged_count, staging,
                      box_bytes, box_bytes);
  }
  __syncthreads();

  for (int t = blockIdx.x, k = 0; t < num_tiles; t += gridDim.x, ++k) {
    const int s = k & 1;
    const int t_next = t + gridDim.x;
    if (t_next < num_tiles) {
      plan_pixels<G::R>(tile_at(t_next, tiles_x, tiles_per_image), flow2, pos + (s ^ 1) * kTilePx, red, h, w,
                        clamp_hi);
    }
    __syncthreads();
    if (t_next < num_tiles && threadIdx.x == 0) {
      finish_plan<G::K>(t_next / tiles_per_image, s ^ 1, red, plan, smem, bars, &tm_f, staged_count, staging,
                        box_bytes, box_bytes);
    }
    const Tile tl = tile_at(t, tiles_x, tiles_per_image);
    const int4 pl = plan[s];
    if (pl.x) {
      mbar_wait(&bars[s], pl.w ^ 1);
      refine_tile_any<NQ, P, true>(tl, pos + s * kTilePx, reinterpret_cast<const float*>(smem + s * box_bytes), pl,
                                   stage, q, f, bias, res2, log_softmax, h, w, c, vec, inv_temperature);
    } else {
      refine_tile_any<NQ, P, false>(tl, pos + s * kTilePx, reinterpret_cast<const float*>(smem), pl, stage, q, f,
                                    bias, res2, log_softmax, h, w, c, vec, inv_temperature);
    }
    __syncthreads();
  }
}

// ---- C > 16: L = 8 or 16 lanes a pixel split the channels (no staging)

template <int L, int P>
struct WideCfg {
  static_assert(L == 8 || L == 16, "8 or 16 lanes a pixel");
  static constexpr int K = P + 3;
  static constexpr int R = (P - 1) / 2;
  static constexpr int PP = P * P;
  static constexpr int J = (P + L - 1) / L;  // columns of each score row a lane finishes
  static constexpr int kPxPerWarp = 32 / L;
  static constexpr int kPasses = (kTilePx * L + kThreads - 1) / kThreads;
  static constexpr int kStageFloats = kPxPerWarp * PP;
  static constexpr int kPosOff = 0;                                  // float2 [kTilePx]
  static constexpr int kLsOff = kPosOff + kTilePx * 8;               // float [kWarps][kStageFloats]
  static constexpr int kRedOff = kLsOff + kWarps * kStageFloats * 4;  // int4 [kWarps]
  static constexpr int kSmemBytes = kRedOff + kWarps * 16;
  static_assert(kRedOff % 16 == 0, "int4 slots need alignment");
};

// One step of reduce_scatter_lanes and the steps after it: of the live
// entries buf[t L + r], r < 2 Half, the lane keeps those whose r has its own
// bit Half (moved to r - Half) plus the partner lane's, lane ^ Half. Half is
// a template argument so that every index is a constant (buf stays in
// registers).
template <int J, int L, int Half>
__device__ __forceinline__ void halve(float (&buf)[J * L], int c4) {
  if constexpr (Half >= 1) {
    const bool hi = c4 & Half;
#pragma unroll
    for (int t = 0; t < J; ++t) {
#pragma unroll
      for (int r = 0; r < Half; ++r) {
        const float a = buf[t * L + r], b = buf[t * L + r + Half];
        buf[t * L + r] = (hi ? b : a) + __shfl_xor_sync(kFull, hi ? a : b, Half);
      }
    }
    halve<J, L, Half / 2>(buf, c4);
  }
}

// reduce_scatter for any power-of-two L (recursive halving): own[t] = the
// sum over the pixel's L lanes of sc[L t + c4] (zero past N). One exchange
// step per lane bit, N values in all.
template <int L, int N>
__device__ __forceinline__ void reduce_scatter_lanes(const float (&sc)[N], float (&own)[(N + L - 1) / L], int c4) {
  constexpr int J = (N + L - 1) / L;
  float buf[J * L];
#pragma unroll
  for (int i = 0; i < J * L; ++i) buf[i] = i < N ? sc[i] : 0.0f;
  halve<J, L, L / 2>(buf, c4);
#pragma unroll
  for (int t = 0; t < J; ++t) own[t] = buf[t * L];
}

// Every thread: the tile's pixels, L lanes a pixel, one float4 of channels
// each; the taps from global memory.
template <int L, int P>
__device__ __forceinline__ void refine_tile_wide(const Tile& tl, const float2* pos, float* ls_warp,
                                                 const float* __restrict__ q, const float* __restrict__ f,
                                                 const float* __restrict__ bias, float2* __restrict__ residual,
                                                 float* __restrict__ log_softmax, int h, int w, int c, bool vec,
                                                 float inv_temperature) {
  using G = WideCfg<L, P>;
  constexpr int R = G::R, PP = G::PP, K = G::K, J = G::J;
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
    const int ch = 4 * c4;  // this lane's channels
    const float4 qv = valid ? load_channels(q + n * c, ch, c, vec) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float2 p = pos[pix];
    const float fx = floorf(p.x), fy = floorf(p.y);
    float wx[4], wy[4];
    cubic_weights(p.x - fx, wx);
    cubic_weights(p.y - fy, wy);
    const int xb = static_cast<int>(fx) - R - 1;  // leftmost tap
    const int yb = static_cast<int>(fy) - R - 1;  // topmost tap

    // sc[i * J + t]: score (i, j = L t + c4), summed over the lanes
    float sc[P * J];
#pragma unroll
    for (int k = 0; k < P * J; ++k) sc[k] = 0.0f;
    const float* fimg = f + static_cast<long long>(tl.img) * h * w * c;
    // one tap row at a time: unrolled over the rows, ptxas hoists the tap
    // loads of many rows and spills (L = 16, P = 3 did)
#pragma unroll 1
    for (int v = 0; v < K; ++v) {
      float d[K];  // this lane's partial dots of tap row v
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int iy = yb + v, ix = xb + u;
        const float4 t = (iy >= 0 && iy < h && ix >= 0 && ix < w)
                             ? load_channels(fimg + (static_cast<long long>(iy) * w + ix) * c, ch, c, vec)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        d[u] = dot4(qv, t, 0.0f);
      }
      float sx[P];  // x pass of the row, partial over the lanes
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) s = fmaf(wx[mm], d[j + mm], s);
        sx[j] = s;
      }
      float own[J];  // own[t]: the row's column L t + c4, summed over the lanes
      reduce_scatter_lanes<L, P>(sx, own, c4);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int l = v - i;  // the row's y weight in score row i
        if (l >= 0 && l < 4) {
          const float wl = l == 0 ? wy[0] : l == 1 ? wy[1] : l == 2 ? wy[2] : wy[3];
#pragma unroll
          for (int t = 0; t < J; ++t) sc[i * J + t] = fmaf(wl, own[t], sc[i * J + t]);
        }
      }
    }

    // temperature, bias and the softmax tail on this lane's scores
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int t = 0; t < J; ++t) {
        const int j = L * t + c4;
        if (j < P) {
          sc[i * J + t] = fmaf(sc[i * J + t], inv_temperature, __ldg(bias + i * P + j));
          mx = fmaxf(mx, sc[i * J + t]);
        }
      }
    }
    mx = lanes_max<L>(mx);
    float sum = 0.0f, rx = 0.0f, ry = 0.0f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int t = 0; t < J; ++t) {
        const int j = L * t + c4;
        if (j < P) {
          const float e = expf(sc[i * J + t] - mx);
          sum += e;
          rx = fmaf(e, static_cast<float>(j - R), rx);
          ry = fmaf(e, static_cast<float>(i - R), ry);
        }
      }
    }
    sum = lanes_sum<L>(sum);
    rx = lanes_sum<L>(rx);
    ry = lanes_sum<L>(ry);
    const float lse = logf(sum);
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int t = 0; t < J; ++t) {
        const int j = L * t + c4;
        if (j < P) ls_warp[(lane / L) * PP + i * P + j] = sc[i * J + t] - mx - lse;
      }
    }
    if (valid && c4 == 0) residual[n] = make_float2(__fdividef(rx, sum), __fdividef(ry, sum));
    __syncwarp();
    const int pix0 = u0 / L;
    const int x_first = tl.x0 + pix0 % kTileW, y_row = tl.y0 + pix0 / kTileW;
    const int count = y_row < h ? min(max(w - x_first, 0), G::kPxPerWarp) : 0;
    float* out = log_softmax + ((static_cast<long long>(tl.img) * h + y_row) * w + x_first) * PP;
    for (int e = lane; e < count * PP; e += 32) out[e] = ls_warp[e];
    __syncwarp();
  }
}

// Persistent CTAs over the tiles, no staging (two boxes of C > 16 channels
// outgrow shared memory): each tile's positions, then its pixels.
template <int L, int P>
__global__ void __launch_bounds__(kThreads, 1)
    window_refinement_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ f,
                                      const float* __restrict__ flow, const float* __restrict__ bias,
                                      float* __restrict__ residual, float* __restrict__ log_softmax, int h, int w,
                                      int c, float2 clamp_hi, int tiles_x, int tiles_per_image, int num_tiles,
                                      float inv_temperature) {
  using G = WideCfg<L, P>;
  extern __shared__ __align__(128) uint8_t smem[];
  float2* pos = reinterpret_cast<float2*>(smem + G::kPosOff);
  float* ls_warp = reinterpret_cast<float*>(smem + G::kLsOff) + (threadIdx.x / 32) * G::kStageFloats;
  int4* red = reinterpret_cast<int4*>(smem + G::kRedOff);  // plan_pixels' bounds, unused here
  const bool vec = c % 4 == 0;
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, tiles_x, tiles_per_image);
    plan_pixels<G::R>(tl, reinterpret_cast<const float2*>(flow), pos, red, h, w, clamp_hi);
    __syncthreads();
    refine_tile_wide<L, P>(tl, pos, ls_warp, q, f, bias, reinterpret_cast<float2*>(residual), log_softmax, h, w, c,
                           vec, inv_temperature);
    __syncthreads();
  }
}

// Tiles of an (B, H, W) map and the clamp's upper corner (W, H) + R + 4.
struct Grid {
  int tiles_x, tiles_per_image, num_tiles;
  float2 clamp_hi;
};

Grid grid_of(int batch, int h, int w, int r) {
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_per_image = tiles_x * ((h + kTileH - 1) / kTileH);
  const float m = static_cast<float>(r + 4);
  return {tiles_x, tiles_per_image, batch * tiles_per_image,
          make_float2(static_cast<float>(w) + m, static_cast<float>(h) + m)};
}

// One call's arguments (see ufm_window_refinement_fwd_f32).
struct Args {
  const void *q, *f, *flow, *bias;
  void *residual, *log_softmax;
  int* staged_count;
  int batch, h, w, c;
  float temperature;
  cudaStream_t stream;
};

template <int C, int P>
int launch(const CUtensorMap& tm_f, const Args& a) {
  using G = Cfg<C, P>;
  static int smem_set = 0;  // devices on which this instance may use kSmemBytes
  const void* kernel = reinterpret_cast<const void*>(window_refinement_fwd_kernel<C, P>);
  const Grid g = grid_of(a.batch, a.h, a.w, G::R);
  int grid = 0;
  const int e = persistent_grid(kernel, kThreads, G::kSmemBytes, G::kSmemBytes, smem_set, g.num_tiles, grid);
  if (e != 0) return e;
  window_refinement_fwd_kernel<C, P><<<grid, kThreads, G::kSmemBytes, a.stream>>>(
      tm_f, static_cast<const float*>(a.q), static_cast<const float*>(a.f), static_cast<const float*>(a.flow),
      static_cast<const float*>(a.bias), static_cast<float*>(a.residual), static_cast<float*>(a.log_softmax),
      a.staged_count, a.h, a.w, g.clamp_hi, g.tiles_x, g.tiles_per_image, g.num_tiles, 1.0f / a.temperature);
  return static_cast<int>(cudaGetLastError());
}

template <int NQ, int P>
int launch_any(const CUtensorMap& tm_f, const Args& a) {
  using G = AnyCfg<NQ, P>;
  static int smem_set = 0;  // devices on which this instance may use kMaxSmemBytes
  const void* kernel = reinterpret_cast<const void*>(window_refinement_fwd_any_kernel<NQ, P>);
  const Grid g = grid_of(a.batch, a.h, a.w, G::R);
  const int box_bytes = a.c % 4 == 0 ? kBoxW * kBoxH * a.c * 4 : 0;  // the launches that stage
  const int smem = 2 * box_bytes + G::kFixedBytes;
  int grid = 0;
  const int e = persistent_grid(kernel, kThreads, G::kMaxSmemBytes, smem, smem_set, g.num_tiles, grid);
  if (e != 0) return e;
  window_refinement_fwd_any_kernel<NQ, P><<<grid, kThreads, smem, a.stream>>>(
      tm_f, static_cast<const float*>(a.q), static_cast<const float*>(a.f), static_cast<const float*>(a.flow),
      static_cast<const float*>(a.bias), static_cast<float*>(a.residual), static_cast<float*>(a.log_softmax),
      a.staged_count, a.h, a.w, a.c, box_bytes, g.clamp_hi, g.tiles_x, g.tiles_per_image, g.num_tiles,
      1.0f / a.temperature);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int P>
int launch_wide(const Args& a) {
  using G = WideCfg<L, P>;
  static int smem_set = 0;  // devices on which this instance may use kSmemBytes
  const void* kernel = reinterpret_cast<const void*>(window_refinement_fwd_wide_kernel<L, P>);
  const Grid g = grid_of(a.batch, a.h, a.w, G::R);
  int grid = 0;
  const int e = persistent_grid(kernel, kThreads, G::kSmemBytes, G::kSmemBytes, smem_set, g.num_tiles, grid);
  if (e != 0) return e;
  window_refinement_fwd_wide_kernel<L, P><<<grid, kThreads, G::kSmemBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.f), static_cast<const float*>(a.flow),
      static_cast<const float*>(a.bias), static_cast<float*>(a.residual), static_cast<float*>(a.log_softmax), a.h,
      a.w, a.c, g.clamp_hi, g.tiles_x, g.tiles_per_image, g.num_tiles, 1.0f / a.temperature);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_p(int p, const CUtensorMap& tm_f, const Args& a) {
  switch (p) {
    case 1: return launch<C, 1>(tm_f, a);
    case 3: return launch<C, 3>(tm_f, a);
    case 5: return launch<C, 5>(tm_f, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int NQ>
int launch_any_p(int p, const CUtensorMap& tm_f, const Args& a) {
  switch (p) {
    case 1: return launch_any<NQ, 1>(tm_f, a);
    case 3: return launch_any<NQ, 3>(tm_f, a);
    case 5: return launch_any<NQ, 5>(tm_f, a);
    case 7: return launch_any<NQ, 7>(tm_f, a);
    case 9: return launch_any<NQ, 9>(tm_f, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int L>
int launch_wide_p(int p, const Args& a) {
  switch (p) {
    case 1: return launch_wide<L, 1>(a);
    case 3: return launch_wide<L, 3>(a);
    case 5: return launch_wide<L, 5>(a);
    case 7: return launch_wide<L, 7>(a);
    case 9:  // fewer lanes a pixel spill at P = 9: every C takes 16
      if constexpr (L == 16) return launch_wide<L, 9>(a);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, f: (B, H, W, C) fp32 contiguous, 16-byte aligned; flow: (B, H, W, 2);
// bias: (P * P,); residual: (B, H, W, 2); log_softmax: (B, H, W, P, P).
// 1 <= C <= 64, P odd in 1 .. 9: C in {4, 8, 16} with P <= 5 runs
// window_refinement_fwd_kernel, the rest of C <= 16
// window_refinement_fwd_any_kernel, C > 16 window_refinement_fwd_wide_kernel.
// `any_kernel` nonzero sends C in {4, 8, 16} with P <= 5 to
// window_refinement_fwd_any_kernel too (to time the two designs on the same
// shapes). `staged_count` is null or one device int to which the kernel adds
// the number of tiles whose taps it staged through TMA (the rest took the
// direct path; none are staged at C > 16 or C % 4 != 0, where f gets no
// tensor map). Launches on `stream`; returns 0, a cudaError_t
// (cudaErrorInvalidValue for an unsupported C or P), or a kErr* code of
// sm90_async.cuh when the tensor map of f cannot be made.
extern "C" int ufm_window_refinement_fwd_f32(const void* q, const void* f, const void* flow, const void* bias,
                                             void* residual, void* log_softmax, void* staged_count, int batch, int h,
                                             int w, int c, int p, float temperature, int any_kernel, void* stream) {
  if (static_cast<long long>(batch) * h * w == 0) return 0;
  if (!in_domain(c, p)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_f;
  memset(&tm_f, 0, sizeof(tm_f));
  if (c <= 16 && c % 4 == 0) {  // the widths whose tiles may be staged
    const int err = encode_box_map(&tm_f, f, batch, h, w, c);
    if (err != 0) return err;
  }
  const Args a{q, f, flow, bias, residual, log_softmax, static_cast<int*>(staged_count), batch, h, w, c,
               temperature, static_cast<cudaStream_t>(stream)};
  if (!any_kernel && (c == 4 || c == 8 || c == 16) && p <= 5) {
    switch (c) {
      case 4: return launch_p<4>(p, tm_f, a);
      case 8: return launch_p<8>(p, tm_f, a);
      default: return launch_p<16>(p, tm_f, a);
    }
  }
  if (c <= 16) {
    switch ((c + 3) / 4) {
      case 1: return launch_any_p<1>(p, tm_f, a);
      case 2: return launch_any_p<2>(p, tm_f, a);
      case 3: return launch_any_p<3>(p, tm_f, a);
      default: return launch_any_p<4>(p, tm_f, a);
    }
  }
  if (c <= 32 && p < 9) return launch_wide_p<8>(p, a);
  return launch_wide_p<16>(p, a);
}
