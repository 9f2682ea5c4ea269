// Window refinement backward for Hopper (sm_90a), fp32 in / fp32 out.
//
// Replaces: ufm_tpu/ops/refinement.py::_fused_refinement_pallas_bwd (:242),
// the XLA VJP of `_fused_refinement_xla` (:257) that the JAX package runs as
// the backward of its Pallas window kernel (no pallas_call of its own). Given
// the forward's inputs q, f (B, H, W, C), flow (B, H, W, 2), its
// log_softmax (B, H, W, P, P) and the cotangents g_residual (B, H, W, 2),
// g_log_softmax (B, H, W, P, P), one call computes per pixel
// (ops/window_refinement.py::window_refinement_backward_reference, term by
// term):
//
//   a          = exp(log_softmax), residual = sum a * offs
//   g_s        = a ((offs - residual) . g_residual) + g_ls - a sum g_ls
//   dbias      = sum over pixels of g_s;  dscores = g_s / temperature
//   ddots[v][u]   = sum_{l,m} wy[l] wx[m] dscores[v - l][u - m]
//   ddots_x, _y   = the same with wx' for wx, wy' for wy (cubic derivatives)
//   for the (P+3)^2 taps inside the image:
//     dq += ddots F[tap];  df[tap] += ddots q;
//     dflow += (q . F[tap]) (ddots_x, ddots_y)
//
// (positions, clamp and taps exactly as the forward kernel computes them).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32) at UFM-Refine's training
// shape (2, 420, 560, C = 16), P = 5: q, f, dq, df (64 B a pixel each),
// flow, g_residual, dflow (8 B), log_softmax and g_log_softmax (100 B):
// 480 B a pixel, 226 MB -> 67 us; operations ~8 kFLOP a pixel (the dot, dq
// and df updates, 6C a tap, and the three tap gradients, 24 a tap) -> ~56 us.
// What sets its pace is df: every tap of every pixel adds C floats to a row
// of f that 16-64 other pixels' windows also cover, a scatter with
// collisions. Sent to L2 as one 16-byte atomic a tap and lane, that is
// 470,400 px x 64 taps x 4 float4s, ~120 M atomics and 1.9 GB of atomic
// traffic a call at this shape (0.75-0.84 ms with the direct kernel below
// alone on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
//
// Design. The forward's 32 x 8 tiles, 4 lanes a pixel (NV float4 slots of
// channels each; zero past C; single floats where C % 4 != 0), in two
// kernels:
//   * The staged kernel (C <= 16 with C % 4 == 0): persistent CTAs take the
//     tiles whose taps all fit the forward's kBoxW x kBoxH box (the same fit
//     rule, so the same tiles: ops/window_refinement.py::staged_tiles). The
//     box of f comes by one TMA load, and the taps are read from it with no
//     bounds check (TMA's zero fill is the zero padding).
//   * At P <= 5 the staged kernel turns df from a scatter into a gather.
//     Each tap origin of the tile gets an owner, its least pixel (an int
//     atomicMin in a table of the box's pixels). The tap loop writes each
//     owner's (P+3)^2 tap gradients ddots, and its q, to shared memory; then
//     each thread owns float4s of box pixels and sums, over the owned origins
//     whose window covers its pixel, ddots x q: no float atomics in shared
//     memory (the card has none: the compare-and-swap loop that stands in for
//     them took 1.2 ms here on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md),
//     and one 16-byte global atomic a touched float4 of a box pixel in the
//     image, about 44 x 21 box pixels a tile at P = 5 instead of 256 px x 64
//     taps. A pixel whose origin another pixel owns (flows that compress,
//     noise) adds its df terms by global atomics as the direct kernel does.
//     Shared memory: the box of f (up to 88 KB), ddots (65 KB at P = 5), q,
//     the table and the warps' rows: one persistent CTA of 512 threads an SM
//     (at most 128 registers a thread). At P = 7 / 9 the ddots outgrow shared
//     memory beside the box: one CTA of 256 threads a tile, two an SM, reads
//     f from the box and adds df by global atomics.
//   * The direct kernel takes the other tiles (a flow discontinuity or noise:
//     the taps do not fit; C > 16; C % 4 != 0): one tile a CTA of 256
//     threads, two CTAs an SM, little shared memory, so that L1 keeps the
//     taps neighbouring windows share (in one kernel with the staged path's
//     200 KB of shared memory it ran slower: PERF.md); taps from global
//     memory with bounds checks, df by one global 16-byte atomic a tap and
//     slot.
//   * Per pass of 128 (or 64) pixels, each warp copies its 8 pixels'
//     log_softmax and g_log_softmax rows into shared memory in one coalesced
//     run; the lanes of a pixel split its P^2 scores (k = 4 t + lane),
//     compute g_s, write dscores back over log_softmax for the tap loop, and
//     sum g_s over the warp's pixels into the warp's dbias slots (shuffles,
//     then one lane per k).
//   * One pass over the tap rows: the y pass of dscores (with wy and wy') for
//     the row, then for each tap the x pass (ddots, ddots_x, ddots_y), the
//     tap read once for the dot, the dq and dflow sums, and df's term.
//   * dbias: each tile's warps' slots summed in a fixed order into one
//     partial a tile, then a third kernel sums the tiles' partials in a fixed
//     order.
// dq, dflow and dbias are therefore the same bits on every call (which
// kernel takes a tile depends on its flow alone); df is summed by atomics in
// an order that changes from run to run.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cstring>

#include "sm90_async.cuh"
#include "window_refinement.cuh"

namespace {

using namespace ufm;

constexpr int kLanes = 4;  // lanes per pixel
constexpr int kPxPerWarp = 32 / kLanes;
constexpr int kReduceThreads = 256;

// The two kernels of a call. The direct kernel (S = false) takes one tile a
// CTA of 256 threads, two CTAs an SM (one at P >= 7 with several slots,
// which spill at 128 registers), and little shared memory, so L1 keeps the
// taps that neighbouring windows share; it leaves the tiles that stage to
// the staged kernel (S = true, C <= 16 only): at P <= 5 persistent CTAs of
// 512 threads, one an SM, the f box and the gather's buffers in shared
// memory; at P = 7 / 9 one CTA of 256 threads a tile with the f box.
template <int NV, int P, bool S>
struct Cfg {
  static constexpr int K = P + 3;  // integer tap span per axis
  static constexpr int R = (P - 1) / 2;
  static constexpr int PP = P * P;
  static constexpr int T = (PP + kLanes - 1) / kLanes;  // scores each lane of a pixel owns
  static_assert(!S || NV == 1, "only C <= 16 stages");
  static constexpr bool kGather = S && P <= 5;  // df of a staged tile by the gather
  static constexpr int kThreads = kGather ? 512 : 256;
  // 512 threads: at most 128 registers a thread; 256: two CTAs an SM (also
  // 128 registers), one with several slots at P >= 7, which spill at 128
  static constexpr int kMinBlocks = kGather || (NV > 1 && P >= 7) ? 1 : 2;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kPassPx = kThreads / kLanes;  // pixels a pass
  static constexpr int kPasses = kTilePx / kPassPx;
  static constexpr int kRowFloats = kPxPerWarp * PP;  // one warp's log_softmax (then dscores) or g_log_softmax rows
  static constexpr int kDdStride = K * K + 1;         // floats a pixel's ddots take (odd: neighbouring pixels
                                                      // store to other banks)
  static constexpr int kCells = kBoxW * kBoxH;        // the owner table: one cell a box pixel
  // shared memory, bytes: rows [kWarps][2][kRowFloats], dbias slots
  // [kWarps][PP], red int4 [kWarps], an mbarrier; in the staged kernel its
  // tile list int [kThreads + 1], and with the gather each tile pixel's
  // ddots [kTilePx][kDdStride] and q [kTilePx][16] and the owner table int
  // [kCells]; then the f box (C channels a pixel)
  static constexpr int kBiasOff = kWarps * 2 * kRowFloats * 4;
  static constexpr int kRedOff = kBiasOff + kWarps * PP * 4;
  static constexpr int kBarOff = kRedOff + kWarps * 16;
  static constexpr int kListOff = kBarOff + 8;
  static constexpr int kDdOff = (kListOff + (S ? (kThreads + 1) * 4 : 0) + 15) / 16 * 16;
  static constexpr int kQsOff = kDdOff + (kGather ? kTilePx * kDdStride * 4 : 0);
  static constexpr int kOwnerOff = kQsOff + (kGather ? kTilePx * 16 * 4 : 0);
  static constexpr int kBoxOff = (kOwnerOff + (kGather ? kCells * 4 : 0) + 127) / 128 * 128;
  static constexpr int kMaxSmemBytes = kBoxOff + (S ? kBoxW * kBoxH * 16 * 4 : 0);
  static_assert(kMaxSmemBytes <= 232448, "shared memory over the 227 KB a block may use");
  static_assert(kRedOff % 16 == 0 && kQsOff % 16 == 0, "int4 and float4 slots need 16-byte alignment");
  static_assert(kPasses * kPassPx == kTilePx, "whole passes");
};

// Add dd * q (channels ch .. ch + 3, those below C) to one pixel's row of df.
__device__ __forceinline__ void add_channels(float* __restrict__ px, int ch, int c, bool vec, float dd,
                                             const float4& q) {
  if (ch >= c) return;
  if (vec) {
    atomicAdd(reinterpret_cast<float4*>(px + ch), make_float4(dd * q.x, dd * q.y, dd * q.z, dd * q.w));
    return;
  }
  atomicAdd(px + ch, dd * q.x);
  if (ch + 1 < c) atomicAdd(px + ch + 1, dd * q.y);
  if (ch + 2 < c) atomicAdd(px + ch + 2, dd * q.z);
  if (ch + 3 < c) atomicAdd(px + ch + 3, dd * q.w);
}

__device__ __forceinline__ void store_channels(float* __restrict__ px, int ch, int c, bool vec, const float4& v) {
  if (ch >= c) return;
  if (vec) {
    *reinterpret_cast<float4*>(px + ch) = v;
    return;
  }
  px[ch] = v.x;
  if (ch + 1 < c) px[ch + 1] = v.y;
  if (ch + 2 < c) px[ch + 2] = v.z;
  if (ch + 3 < c) px[ch + 3] = v.w;
}

// Every thread (thread i < kTilePx: pixel i of the tile): the least and
// greatest tap origin of this warp's pixels in the image into red[warp] =
// (x min, y min, x max, y max); positions clamped as the forward clamps them.
template <int R>
__device__ __forceinline__ void tap_bounds(const Tile& tl, const float2* __restrict__ flow, int4* red, int h, int w) {
  const float m = static_cast<float>(R + 4);
  const int i = threadIdx.x;
  int xmin = INT_MAX, ymin = INT_MAX, xmax = INT_MIN, ymax = INT_MIN;
  const int x = tl.x0 + i % kTileW, y = tl.y0 + i / kTileW;
  if (i < kTilePx && x < w && y < h) {
    const float2 fl = __ldg(flow + (static_cast<long long>(tl.img) * h + y) * w + x);
    const float px = fminf(fmaxf(fl.x + static_cast<float>(x), -m), static_cast<float>(w) + m);
    const float py = fminf(fmaxf(fl.y + static_cast<float>(y), -m), static_cast<float>(h) + m);
    xmin = xmax = static_cast<int>(floorf(px)) - R - 1;
    ymin = ymax = static_cast<int>(floorf(py)) - R - 1;
  }
  xmin = __reduce_min_sync(kFull, xmin);
  ymin = __reduce_min_sync(kFull, ymin);
  xmax = __reduce_max_sync(kFull, xmax);
  ymax = __reduce_max_sync(kFull, ymax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = make_int4(xmin, ymin, xmax, ymax);
}

// Every thread, a pass's first step: the warp's 8 pixels' log_softmax and
// g_log_softmax rows into shared memory, then g_s on this lane's scores k =
// 4 t + c4: dscores written back over log_softmax for the tap loop, and g_s
// summed over the warp's pixels into the warp's dbias slots (shuffles, then
// one lane per k). `valid`: this lane's pixel lies in the image.
template <int P, int T>
__device__ __forceinline__ void pass_scores(float* rows, float* grows, float* wbias, const float* __restrict__ log_softmax,
                                            const float2* __restrict__ g_residual,
                                            const float* __restrict__ g_log_softmax, long long n0, int count,
                                            float inv_temperature) {
  constexpr int R = (P - 1) / 2, PP = P * P;
  const int lane = threadIdx.x & 31;
  const int c4 = lane % kLanes, px_local = lane / kLanes;
  __syncwarp();  // the last pass's reads of rows are done
  for (int e = lane; e < count * PP; e += 32) {
    rows[e] = __ldg(log_softmax + n0 * PP + e);
    grows[e] = __ldg(g_log_softmax + n0 * PP + e);
  }
  __syncwarp();
  const bool valid = px_local < count;
  const float2 gr = valid ? __ldg(g_residual + n0 + px_local) : make_float2(0.0f, 0.0f);
  float a[T], gl[T];
  float rx = 0.0f, ry = 0.0f, gsum = 0.0f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int k = kLanes * t + c4;
    const bool own = valid && k < PP;
    a[t] = own ? expf(rows[px_local * PP + k]) : 0.0f;
    gl[t] = own ? grows[px_local * PP + k] : 0.0f;
    rx = fmaf(a[t], static_cast<float>(k % P - R), rx);
    ry = fmaf(a[t], static_cast<float>(k / P - R), ry);
    gsum += gl[t];
  }
  rx = lanes_sum<kLanes>(rx);
  ry = lanes_sum<kLanes>(ry);
  gsum = lanes_sum<kLanes>(gsum);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int k = kLanes * t + c4;
    const float ox = static_cast<float>(k % P - R) - rx, oy = static_cast<float>(k / P - R) - ry;
    float gs = fmaf(a[t], fmaf(ox, gr.x, oy * gr.y), gl[t]) - a[t] * gsum;
    if (valid && k < PP) rows[px_local * PP + k] = gs * inv_temperature;
    gs += __shfl_xor_sync(kFull, gs, 4);
    gs += __shfl_xor_sync(kFull, gs, 8);
    gs += __shfl_xor_sync(kFull, gs, 16);
    if (lane < kLanes && k < PP) wbias[k] += gs;
  }
  __syncwarp();  // dscores of every pixel of the warp are in rows
}

// This pixel's clamped sample position (as the forward clamps it) and the
// cubic weights and derivatives of its fractional part; returns its tap
// origin (xb, yb).
template <int R>
__device__ __forceinline__ int2 pixel_weights(const float2* __restrict__ flow, long long n, int x, int y, int h,
                                              int w, bool valid, float (&wx)[4], float (&wy)[4], float (&dwx)[4],
                                              float (&dwy)[4]) {
  const float m = static_cast<float>(R + 4);
  float2 pos = make_float2(0.0f, 0.0f);
  if (valid) {
    const float2 fl = __ldg(flow + n);
    pos.x = fminf(fmaxf(fl.x + static_cast<float>(x), -m), static_cast<float>(w) + m);
    pos.y = fminf(fmaxf(fl.y + static_cast<float>(y), -m), static_cast<float>(h) + m);
  }
  const float fx = floorf(pos.x), fy = floorf(pos.y);
  cubic_weights(pos.x - fx, wx);
  cubic_weights(pos.y - fy, wy);
  cubic_weights_derivative(pos.x - fx, dwx);
  cubic_weights_derivative(pos.y - fy, dwy);
  return make_int2(static_cast<int>(fx) - R - 1, static_cast<int>(fy) - R - 1);
}

// The y pass of tap row v: ryw[j] = sum_l wy[l] dscores[v - l][j], ryd with wy'.
template <int P>
__device__ __forceinline__ void row_y_pass(const float* dsc, int v, const float (&wy)[4], const float (&dwy)[4],
                                           float (&ryw)[P], float (&ryd)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) ryw[j] = ryd[j] = 0.0f;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int i = v - l;
    if (i >= 0 && i < P) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float d = dsc[i * P + j];
        ryw[j] = fmaf(wy[l], d, ryw[j]);
        ryd[j] = fmaf(dwy[l], d, ryd[j]);
      }
    }
  }
}

// The x pass of tap u from a row's y pass: ddots, ddots_x, ddots_y.
template <int P>
__device__ __forceinline__ void tap_x_pass(int u, const float (&ryw)[P], const float (&ryd)[P], const float (&wx)[4],
                                           const float (&dwx)[4], float& dd, float& ddx, float& ddy) {
  dd = ddx = ddy = 0.0f;
#pragma unroll
  for (int mm = 0; mm < 4; ++mm) {
    if (u - mm >= 0 && u - mm < P) {
      dd = fmaf(wx[mm], ryw[u - mm], dd);
      ddx = fmaf(dwx[mm], ryw[u - mm], ddx);
      ddy = fmaf(wx[mm], ryd[u - mm], ddy);
    }
  }
}

// A tile of the direct kernel, or of the staged kernel at P >= 7 (S: the taps
// from the f box at origin (pl.y, pl.z)), every thread: kPasses rounds of
// kPassPx pixels, 4 lanes a pixel (NV float4 slots of channels each); taps
// from global memory with bounds checks, or from the box without; df by one
// global 16-byte atomic a tap and slot.
template <int NV, int P, bool S>
__device__ __forceinline__ void refine_tile_bwd(
    const Tile& tl, int4 pl, const float* fbox, float* rows, float* grows, float* wbias, const float* __restrict__ q,
    const float* __restrict__ f, const float2* __restrict__ flow, const float* __restrict__ log_softmax,
    const float2* __restrict__ g_residual, const float* __restrict__ g_log_softmax, float* __restrict__ dq,
    float* __restrict__ df, float2* __restrict__ dflow, int h, int w, int c, float inv_temperature) {
  using G = Cfg<NV, P, S>;
  constexpr int K = G::K, R = G::R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int c4 = lane % kLanes, px_local = lane / kLanes;
  const bool vec = c % 4 == 0;
  const float* fimg = f + static_cast<long long>(tl.img) * h * w * c;
  float* dfimg = df + static_cast<long long>(tl.img) * h * w * c;

#pragma unroll 1
  for (int pass = 0; pass < G::kPasses; ++pass) {
    const int pix0 = pass * G::kPassPx + warp * kPxPerWarp;  // the warp's first pixel of the tile
    const int x_first = tl.x0 + pix0 % kTileW, y = tl.y0 + pix0 / kTileW;
    const int count = y < h ? min(max(w - x_first, 0), kPxPerWarp) : 0;  // the warp's pixels in the image
    const long long n0 = (static_cast<long long>(tl.img) * h + y) * w + x_first;
    pass_scores<P, G::T>(rows, grows, wbias, log_softmax, g_residual, g_log_softmax, n0, count, inv_temperature);
    const bool valid = px_local < count;
    const int x = x_first + px_local;
    const long long n = n0 + px_local;

    float4 qv[NV], dqv[NV];
#pragma unroll
    for (int sl = 0; sl < NV; ++sl) {
      qv[sl] = valid ? load_channels(q + n * c, 4 * (c4 + kLanes * sl), c, vec) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dqv[sl] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float wx[4], wy[4], dwx[4], dwy[4];
    const int2 ob = pixel_weights<R>(flow, n, x, y, h, w, valid, wx, wy, dwx, dwy);
    const float* dsc = rows + px_local * G::PP;
    float gfx = 0.0f, gfy = 0.0f;  // this lane's part of dflow
    // staged: this lane's channels of the pixel's first tap in the box
    const int box0 = S && valid ? ((ob.y - pl.z) * kBoxW + ob.x - pl.y) * c + 4 * c4 : 0;
    const bool has = 4 * c4 < c;

#pragma unroll 1
    for (int v = 0; v < K; ++v) {
      float ryw[P], ryd[P];
      row_y_pass<P>(dsc, v, wy, dwy, ryw, ryd);
      const int iy = ob.y + v;
      const bool row_ok = valid && iy >= 0 && iy < h;
      const float* frow = fimg + static_cast<long long>(iy) * w * c;
      float* dfrow = dfimg + static_cast<long long>(iy) * w * c;
      const int box_row = box0 + v * kBoxW * c;
#pragma unroll
      for (int u = 0; u < K; ++u) {
        float dd, ddx, ddy;
        tap_x_pass<P>(u, ryw, ryd, wx, dwx, dd, ddx, ddy);
        const int ix = ob.x + u;
        if (row_ok && ix >= 0 && ix < w) {  // (a tap outside the image adds nothing, staged or not)
          float dot = 0.0f;
#pragma unroll
          for (int sl = 0; sl < NV; ++sl) {
            const int ch = 4 * (c4 + kLanes * sl);
            float4 t;
            if constexpr (S) {  // NV = 1
              t = has ? *reinterpret_cast<const float4*>(fbox + box_row + u * c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            } else {
              t = load_channels(frow + static_cast<long long>(ix) * c, ch, c, vec);
            }
            dot = dot4(qv[sl], t, dot);
            dqv[sl].x = fmaf(dd, t.x, dqv[sl].x);
            dqv[sl].y = fmaf(dd, t.y, dqv[sl].y);
            dqv[sl].z = fmaf(dd, t.z, dqv[sl].z);
            dqv[sl].w = fmaf(dd, t.w, dqv[sl].w);
            add_channels(dfrow + static_cast<long long>(ix) * c, ch, c, vec, dd, qv[sl]);
          }
          gfx = fmaf(dot, ddx, gfx);
          gfy = fmaf(dot, ddy, gfy);
        }
      }
    }
    gfx = lanes_sum<kLanes>(gfx);
    gfy = lanes_sum<kLanes>(gfy);
    if (valid) {
      if (c4 == 0) dflow[n] = make_float2(gfx, gfy);
#pragma unroll
      for (int sl = 0; sl < NV; ++sl) store_channels(dq + n * c, 4 * (c4 + kLanes * sl), c, vec, dqv[sl]);
    }
  }
}

constexpr int kNoOwner = 0x7fffffff;

// The gather's shared memory: each tile pixel's ddots ([kTilePx][kDdStride])
// and q ([kTilePx][C]), written in the tap loop by the pixels that own their
// tap origin, and the owner table ([kCells]: box pixel -> the least tile
// pixel at that origin, kNoOwner where none).
struct GatherBufs {
  float* dd;
  float* qs;
  int* owner;
};

// Every thread, after the tap loop of a staged tile: df over the box pixels
// the tile's taps reach (`span` of them from the box origin (pl.y, pl.z)),
// each float4 of them summed by one thread over the owned origins whose
// window covers it, in a fixed order (tap rows, then columns), then added
// to df by one 16-byte atomic where it lies in the image and is not zero.
template <int P>
__device__ __forceinline__ void gather_df(const Tile& tl, int4 pl, int2 span, GatherBufs gb, float* __restrict__ df,
                                          int h, int w, int c, int threads) {
  constexpr int K = P + 3, kDdStride = K * K + 1;
  const int nq = c / 4;
  float* dfimg = df + static_cast<long long>(tl.img) * h * w * c;
  for (int i = threadIdx.x; i < span.x * span.y * nq; i += threads) {
    const int px = i / nq, ch = 4 * (i % nq);
    const int bx = px % span.x, by = px / span.x;  // the box pixel, from the box origin
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
    for (int dv = 0; dv < K; ++dv) {
      const int oy = by - dv;  // the origin row whose tap row dv is this row
      if (oy < 0) break;
      int own[K];
#pragma unroll
      for (int du = 0; du < K; ++du) own[du] = bx - du >= 0 ? gb.owner[oy * kBoxW + bx - du] : kNoOwner;
#pragma unroll
      for (int du = 0; du < K; ++du) {
        if (own[du] != kNoOwner) {
          const float d = gb.dd[own[du] * kDdStride + dv * K + du];
          const float4 qv = *reinterpret_cast<const float4*>(gb.qs + own[du] * c + ch);
          acc.x = fmaf(d, qv.x, acc.x);
          acc.y = fmaf(d, qv.y, acc.y);
          acc.z = fmaf(d, qv.z, acc.z);
          acc.w = fmaf(d, qv.w, acc.w);
        }
      }
    }
    const int gx = pl.y + bx, gy = pl.z + by;
    if (gx >= 0 && gx < w && gy >= 0 && gy < h && (acc.x != 0.0f || acc.y != 0.0f || acc.z != 0.0f || acc.w != 0.0f)) {
      atomicAdd(reinterpret_cast<float4*>(dfimg + (static_cast<long long>(gy) * w + gx) * c + ch), acc);
    }
  }
}

// The staged kernel's tile at P <= 5 (every thread; C <= 16, C % 4 == 0;
// the f box at origin (pl.y, pl.z) in shared memory, the owner table built):
// kPasses rounds of kPassPx pixels, the 4 lanes of a pixel splitting its tap
// rows (v = lane, lane + 4) instead of its channels: each lane holds the
// pixel's whole q (slot s: channels 4 ((s + lane) & 3) .., so that the lanes
// reading the same column of four rows, 128-byte multiples apart in the box,
// read four different float4s of it) and computes each of its taps' x pass
// once (the channel split computes it on all four lanes). An owner writes
// its ddots and q for the gather; any other pixel adds its df terms by
// global atomics. dq's partial sums meet at the end, three shuffles a
// float4.
template <int P>
__device__ __forceinline__ void refine_tile_bwd_staged(
    const Tile& tl, int4 pl, const float* fbox, GatherBufs gb, float* rows, float* grows, float* wbias,
    const float* __restrict__ q, const float2* __restrict__ flow, const float* __restrict__ log_softmax,
    const float2* __restrict__ g_residual, const float* __restrict__ g_log_softmax, float* __restrict__ dq,
    float* __restrict__ df, float2* __restrict__ dflow, int h, int w, int c, float inv_temperature) {
  using G = Cfg<1, P, true>;
  constexpr int K = G::K, R = G::R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int c4 = lane % kLanes, px_local = lane / kLanes;
  const int nq = c / 4;  // float4s a pixel
  float* dfimg = df + static_cast<long long>(tl.img) * h * w * c;

#pragma unroll 1
  for (int pass = 0; pass < G::kPasses; ++pass) {
    const int pix0 = pass * G::kPassPx + warp * kPxPerWarp;  // the warp's first pixel of the tile
    const int px_tile = pix0 + px_local;                      // this pixel, in the tile
    const int x_first = tl.x0 + pix0 % kTileW, y = tl.y0 + pix0 / kTileW;
    const int count = y < h ? min(max(w - x_first, 0), kPxPerWarp) : 0;  // the warp's pixels in the image
    const long long n0 = (static_cast<long long>(tl.img) * h + y) * w + x_first;
    pass_scores<P, G::T>(rows, grows, wbias, log_softmax, g_residual, g_log_softmax, n0, count, inv_temperature);
    const bool valid = px_local < count;
    const int x = x_first + px_local;
    const long long n = n0 + px_local;
    float wx[4], wy[4], dwx[4], dwy[4];
    const int2 ob = pixel_weights<R>(flow, n, x, y, h, w, valid, wx, wy, dwx, dwy);
    const int bx = ob.x - pl.y, by = ob.y - pl.z;  // the origin, from the box origin
    const bool owns = valid && gb.owner[by * kBoxW + bx] == px_tile;

    // the pixel's q, slot s = channels 4 ((s + c4) & 3) .. + 3 (zero past C)
    float4 qr[4], dqr[4];
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      const int k = (sl + c4) & 3;
      qr[sl] = valid && k < nq ? __ldg(reinterpret_cast<const float4*>(q + n * c) + k)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dqr[sl] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if (owns && c4 < nq) *reinterpret_cast<float4*>(gb.qs + px_tile * c + 4 * c4) = qr[0];
    float* dd_px = gb.dd + px_tile * G::kDdStride;
    const float* dsc = rows + px_local * G::PP;
    const float* tap0 = fbox + (valid ? (by * kBoxW + bx) * c : 0);
    float gfx = 0.0f, gfy = 0.0f;  // this lane's part of dflow

#pragma unroll 1
    for (int r = 0; r < (K + kLanes - 1) / kLanes; ++r) {
      const int v = c4 + kLanes * r;  // this lane's tap row
      if (!valid || v >= K) continue;
      float ryw[P], ryd[P];
      row_y_pass<P>(dsc, v, wy, dwy, ryw, ryd);
      const int iy = ob.y + v;
      const bool row_ok = iy >= 0 && iy < h;
      const float* frow = tap0 + v * kBoxW * c;
      float* dfrow = dfimg + static_cast<long long>(iy) * w * c;
#pragma unroll
      for (int u = 0; u < K; ++u) {
        float dd, ddx, ddy;
        tap_x_pass<P>(u, ryw, ryd, wx, dwx, dd, ddx, ddy);
        if (owns) dd_px[v * K + u] = dd;
        float dot = 0.0f;
        const int ix = ob.x + u;
        const bool direct = !owns && row_ok && ix >= 0 && ix < w;
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {
          const int k = (sl + c4) & 3;
          if (k < nq) {  // no bounds check: the box holds the zero padding
            const float4 t = *reinterpret_cast<const float4*>(frow + u * c + 4 * k);
            dot = dot4(qr[sl], t, dot);
            dqr[sl].x = fmaf(dd, t.x, dqr[sl].x);
            dqr[sl].y = fmaf(dd, t.y, dqr[sl].y);
            dqr[sl].z = fmaf(dd, t.z, dqr[sl].z);
            dqr[sl].w = fmaf(dd, t.w, dqr[sl].w);
            if (direct) {
              atomicAdd(reinterpret_cast<float4*>(dfrow + static_cast<long long>(ix) * c + 4 * k),
                        make_float4(dd * qr[sl].x, dd * qr[sl].y, dd * qr[sl].z, dd * qr[sl].w));
            }
          }
        }
        gfx = fmaf(dot, ddx, gfx);
        gfy = fmaf(dot, ddy, gfy);
      }
    }
    // dq's float4 c4: this lane's slot 0, then the other lanes' partial sums
    // of it (lane c4 + o holds it in slot (4 - o) & 3)
    const int base = lane & ~(kLanes - 1);
    float4 acc = dqr[0];
#pragma unroll
    for (int o = 1; o < kLanes; ++o) {
      const float4 sv = dqr[(kLanes - o) & 3];
      const int src = base + ((c4 + o) & 3);
      acc.x += __shfl_sync(kFull, sv.x, src);
      acc.y += __shfl_sync(kFull, sv.y, src);
      acc.z += __shfl_sync(kFull, sv.z, src);
      acc.w += __shfl_sync(kFull, sv.w, src);
    }
    gfx = lanes_sum<kLanes>(gfx);
    gfy = lanes_sum<kLanes>(gfy);
    if (valid) {
      if (c4 == 0) dflow[n] = make_float2(gfx, gfy);
      if (c4 < nq) *reinterpret_cast<float4*>(dq + n * c + 4 * c4) = acc;
    }
  }
}

// The fit test of one tile (every thread; two barriers): its tap origins'
// bounds in red, reduced by every thread in the same order.
template <int R, int K, int kWarps>
__device__ __forceinline__ int4 plan_tile(const Tile& tl, const float2* __restrict__ flow, int4* red, int h, int w) {
  tap_bounds<R>(tl, flow, red, h, w);
  __syncthreads();
  int4 a = red[0];
  for (int i = 1; i < kWarps; ++i) {
    const int4 b = red[i];
    a = make_int4(min(a.x, b.x), min(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
  }
  __syncthreads();  // red is free again
  // x: fits?; y, z: the box origin; w: the origins' spans a.z - a.x and
  // a.w - a.y (the taps reach span + K pixels), packed
  return make_int4(a.z - a.x + K <= kBoxW && a.w - a.y + K <= kBoxH, a.x, a.y, ((a.z - a.x) << 16) | (a.w - a.y));
}

// This tile's dbias partial (every thread; then a barrier): the warps' slots
// in a fixed order, then zeroed for the next tile.
template <int PP, int kWarps, int kThreads>
__device__ __forceinline__ void bias_partial(float* slots, float* __restrict__ partials, int t) {
  for (int k = threadIdx.x; k < PP; k += kThreads) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) {
      s += slots[i * PP + k];
      slots[i * PP + k] = 0.0f;
    }
    partials[static_cast<long long>(t) * PP + k] = s;
  }
  __syncthreads();
}

// The direct kernel: one tile a CTA, taps and df in global memory. With
// `plans` (C <= 16, C % 4 == 0) it writes each tile's plan_tile there for
// the staged kernel, and leaves the tiles that fit the box to it.
template <int NV, int P>
__global__ void __launch_bounds__(Cfg<NV, P, false>::kThreads, Cfg<NV, P, false>::kMinBlocks)
    window_refinement_bwd_kernel(const float* __restrict__ q, const float* __restrict__ f,
                                 const float2* __restrict__ flow, const float* __restrict__ log_softmax,
                                 const float2* __restrict__ g_residual, const float* __restrict__ g_log_softmax,
                                 float* __restrict__ dq, float* __restrict__ df, float2* __restrict__ dflow,
                                 float* __restrict__ partials, int4* __restrict__ plans, int h, int w, int c,
                                 int tiles_x, int tiles_per_image, float inv_temperature) {
  using G = Cfg<NV, P, false>;
  extern __shared__ __align__(128) uint8_t smem[];
  float* rows = reinterpret_cast<float*>(smem) + (threadIdx.x / 32) * 2 * G::kRowFloats;
  float* slots = reinterpret_cast<float*>(smem + G::kBiasOff);
  int4* red = reinterpret_cast<int4*>(smem + G::kRedOff);
  const Tile tl = tile_at(blockIdx.x, tiles_x, tiles_per_image);
  if (plans != nullptr) {
    const int4 pl = plan_tile<G::R, G::K, G::kWarps>(tl, flow, red, h, w);
    if (threadIdx.x == 0) plans[blockIdx.x] = pl;
    if (pl.x) return;  // the staged kernel's
  }
  for (int i = threadIdx.x; i < G::kWarps * G::PP; i += G::kThreads) slots[i] = 0.0f;
  __syncthreads();
  refine_tile_bwd<NV, P, false>(tl, make_int4(0, 0, 0, 0), nullptr, rows, rows + G::kRowFloats,
                                slots + (threadIdx.x / 32) * G::PP, q, f, flow, log_softmax, g_residual, g_log_softmax,
                                dq, df, dflow, h, w, c, inv_temperature);
  __syncthreads();
  bias_partial<G::PP, G::kWarps, G::kThreads>(slots, partials, blockIdx.x);
}

// The staged kernel at P <= 5 (every thread): persistent over its tiles that
// fit (kThreads of them listed at a time), each with its f box, owner
// table, tap loop and gather.
template <int P>
__device__ __forceinline__ void persistent_gather_tiles(
    const CUtensorMap& tm_f, uint8_t* smem, const float* __restrict__ q, const float2* __restrict__ flow,
    const float* __restrict__ log_softmax, const float2* __restrict__ g_residual,
    const float* __restrict__ g_log_softmax, float* __restrict__ dq, float* __restrict__ df, float2* __restrict__ dflow,
    float* __restrict__ partials, const int4* __restrict__ plans, int* __restrict__ staged_count, int h, int w, int c,
    int box_bytes, int tiles_x, int tiles_per_image, int num_tiles, float inv_temperature) {
  using G = Cfg<1, P, true>;
  constexpr int PP = G::PP;
  float* rows = reinterpret_cast<float*>(smem) + (threadIdx.x / 32) * 2 * G::kRowFloats;
  float* slots = reinterpret_cast<float*>(smem + G::kBiasOff);  // [kWarps][PP]
  int* list = reinterpret_cast<int*>(smem + G::kListOff);       // [kThreads] tiles, then their count
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + G::kBarOff);
  const GatherBufs gb{reinterpret_cast<float*>(smem + G::kDdOff), reinterpret_cast<float*>(smem + G::kQsOff),
                      reinterpret_cast<int*>(smem + G::kOwnerOff)};
  const float* fbox = reinterpret_cast<const float*>(smem + G::kBoxOff);

  for (int i = threadIdx.x; i < G::kWarps * PP; i += G::kThreads) slots[i] = 0.0f;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    prefetch_tensor_map(&tm_f);
  }

  uint32_t phase = 0;  // the mbarrier's phase: the tiles this CTA staged so far, mod 2
  for (int k0 = 0; blockIdx.x + k0 * gridDim.x < num_tiles; k0 += G::kThreads) {
    if (threadIdx.x == 0) list[G::kThreads] = 0;
    __syncthreads();
    const int mine = blockIdx.x + (k0 + threadIdx.x) * gridDim.x;
    if (mine < num_tiles && plans[mine].x) list[atomicAdd(&list[G::kThreads], 1)] = mine;
    __syncthreads();
    const int n = list[G::kThreads];
    for (int i = 0; i < n; ++i) {
      const int t = list[i];
      const int4 pl = plans[t];
      const Tile tl = tile_at(t, tiles_x, tiles_per_image);
      if (threadIdx.x == 0) {
        fence_proxy_async_smem();  // the last tile's reads of the f box come first
        mbar_arrive_expect_tx(bar, box_bytes);
        tma_load_4d(reinterpret_cast<void*>(smem + G::kBoxOff), &tm_f, bar, 0, pl.y, pl.z, tl.img);
        if (staged_count != nullptr) atomicAdd(staged_count, 1);
      }
      {
        // the owner table: each tap origin's least tile pixel in the image
        const int px = threadIdx.x;  // thread i < kTilePx: pixel i of the tile
        const int x = tl.x0 + px % kTileW, y = tl.y0 + px / kTileW;
        const bool in = px < kTilePx && x < w && y < h;
        int cell = 0;
        if (in) {
          const float mm = static_cast<float>(G::R + 4);
          const float2 fl = __ldg(flow + (static_cast<long long>(tl.img) * h + y) * w + x);
          const float fx = fminf(fmaxf(fl.x + static_cast<float>(x), -mm), static_cast<float>(w) + mm);
          const float fy = fminf(fmaxf(fl.y + static_cast<float>(y), -mm), static_cast<float>(h) + mm);
          cell = (static_cast<int>(floorf(fy)) - G::R - 1 - pl.z) * kBoxW + static_cast<int>(floorf(fx)) - G::R - 1 -
                 pl.y;
        }
        for (int j = threadIdx.x; j < G::kCells; j += G::kThreads) gb.owner[j] = kNoOwner;
        __syncthreads();
        if (in) atomicMin(&gb.owner[cell], px);
        __syncthreads();
      }
      mbar_wait(bar, phase);
      phase ^= 1;
      refine_tile_bwd_staged<P>(tl, pl, fbox, gb, rows, rows + G::kRowFloats, slots + (threadIdx.x / 32) * PP, q,
                                flow, log_softmax, g_residual, g_log_softmax, dq, df, dflow, h, w, c, inv_temperature);
      __syncthreads();  // every pixel of the tile is done: the gather's buffers
      gather_df<P>(tl, pl, make_int2((pl.w >> 16) + G::K, (pl.w & 0xffff) + G::K), gb, df, h, w, c, G::kThreads);
      bias_partial<PP, G::kWarps, G::kThreads>(slots, partials, t);  // its barrier: the f box is free
    }
    __syncthreads();  // every thread has read the list before the next one is made
  }
}

// The staged kernel (C <= 16, C % 4 == 0), after the direct kernel: CTAs
// over the tiles whose plan (written by the direct kernel) says their taps
// fit the box (persistent at P <= 5, one a tile at P >= 7): the f box by one
// TMA load (`box_bytes` of it; tm_f maps f in boxes of (C, kBoxW, kBoxH,
// 1)); at P <= 5 the owner table, the tap loop and the gather, at P >= 7 the
// channel-split tap loop with df by global atomics. Each CTA first lists its
// tiles that fit, kThreads of its tiles at a time, so that a flow with none
// costs it a load a thread.
template <int P>
__global__ void __launch_bounds__(Cfg<1, P, true>::kThreads, Cfg<1, P, true>::kMinBlocks)
    window_refinement_bwd_staged_kernel(const __grid_constant__ CUtensorMap tm_f, const float* __restrict__ q,
                                        const float* __restrict__ f, const float2* __restrict__ flow,
                                        const float* __restrict__ log_softmax,
                                        const float2* __restrict__ g_residual,
                                        const float* __restrict__ g_log_softmax, float* __restrict__ dq,
                                        float* __restrict__ df, float2* __restrict__ dflow,
                                        float* __restrict__ partials, const int4* __restrict__ plans,
                                        int* __restrict__ staged_count, int h, int w, int c, int box_bytes,
                                        int tiles_x, int tiles_per_image, int num_tiles, float inv_temperature) {
  using G = Cfg<1, P, true>;
  constexpr int PP = G::PP;
  // Indexed from the array itself, so that the compiler keeps these shared
  // (LDS / STS, not generic accesses)
  extern __shared__ __align__(128) uint8_t smem[];
  if constexpr (!G::kGather) {  // one tile a CTA (no state kept across tiles: none spills)
    float* rows = reinterpret_cast<float*>(smem) + (threadIdx.x / 32) * 2 * G::kRowFloats;
    float* slots = reinterpret_cast<float*>(smem + G::kBiasOff);  // [kWarps][PP]
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + G::kBarOff);
    const float* fbox = reinterpret_cast<const float*>(smem + G::kBoxOff);
    const int4 pl = plans[blockIdx.x];
    if (!pl.x) return;  // the direct kernel's
    const Tile tl = tile_at(blockIdx.x, tiles_x, tiles_per_image);
    for (int i = threadIdx.x; i < G::kWarps * PP; i += G::kThreads) slots[i] = 0.0f;
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      fence_mbar_init();
      mbar_arrive_expect_tx(bar, box_bytes);
      tma_load_4d(reinterpret_cast<void*>(smem + G::kBoxOff), &tm_f, bar, 0, pl.y, pl.z, tl.img);
      if (staged_count != nullptr) atomicAdd(staged_count, 1);
    }
    __syncthreads();
    mbar_wait(bar, 0);
    refine_tile_bwd<1, P, true>(tl, pl, fbox, rows, rows + G::kRowFloats, slots + (threadIdx.x / 32) * PP, q, f, flow,
                                log_softmax, g_residual, g_log_softmax, dq, df, dflow, h, w, c, inv_temperature);
    __syncthreads();
    bias_partial<PP, G::kWarps, G::kThreads>(slots, partials, blockIdx.x);
  } else {
    persistent_gather_tiles<P>(tm_f, smem, q, flow, log_softmax, g_residual, g_log_softmax, dq, df, dflow, partials,
                               plans, staged_count, h, w, c, box_bytes, tiles_x, tiles_per_image, num_tiles,
                               inv_temperature);
  }
}

// dbias[k] = the sum of the tiles' partials[t][k], in a fixed order: one
// block a score, each thread a strided run of tiles, then a tree.
__global__ void __launch_bounds__(kReduceThreads)
    window_refinement_bias_kernel(const float* __restrict__ partials, int num_tiles, int pp, float* __restrict__ dbias) {
  __shared__ float part[kReduceThreads];
  const int k = blockIdx.x;
  float s = 0.0f;
  for (int t = threadIdx.x; t < num_tiles; t += kReduceThreads) s += partials[static_cast<long long>(t) * pp + k];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int o = kReduceThreads / 2; o > 0; o >>= 1) {
    if (static_cast<int>(threadIdx.x) < o) part[threadIdx.x] += part[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) dbias[k] = part[0];
}

// One call's arguments (see ufm_window_refinement_bwd_f32).
struct Args {
  const void *q, *f, *flow, *log_softmax, *g_residual, *g_log_softmax;
  void *dq, *df, *dflow, *dbias, *partials, *plans;
  int* staged_count;
  int batch, h, w, c;
  float temperature;
  cudaStream_t stream;
};

template <int NV, int P>
int launch(const CUtensorMap& tm_f, bool stage, const Args& a) {
  using D = Cfg<NV, P, false>;
  const int tiles_x = (a.w + kTileW - 1) / kTileW;
  const int tiles_per_image = tiles_x * ((a.h + kTileH - 1) / kTileH);
  const int num_tiles = a.batch * tiles_per_image;
  const float inv_t = 1.0f / a.temperature;
  int4* plans = stage ? static_cast<int4*>(a.plans) : nullptr;
  window_refinement_bwd_kernel<NV, P><<<num_tiles, D::kThreads, D::kBoxOff, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.f), static_cast<const float2*>(a.flow),
      static_cast<const float*>(a.log_softmax), static_cast<const float2*>(a.g_residual),
      static_cast<const float*>(a.g_log_softmax), static_cast<float*>(a.dq), static_cast<float*>(a.df),
      static_cast<float2*>(a.dflow), static_cast<float*>(a.partials), plans, a.h, a.w, a.c, tiles_x, tiles_per_image,
      inv_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (NV == 1) {
    if (stage) {
      using G = Cfg<1, P, true>;
      static int smem_set = 0;  // devices on which the staged kernel may use kMaxSmemBytes
      const void* kernel = reinterpret_cast<const void*>(window_refinement_bwd_staged_kernel<P>);
      const int box_bytes = kBoxW * kBoxH * a.c * 4;
      const int smem = G::kBoxOff + box_bytes;
      // persistent CTAs with the gather (one an SM); else one a tile, so
      // that the two CTAs an SM overlap each other's box loads
      int grid = num_tiles;
      const int e = G::kGather ? persistent_grid(kernel, G::kThreads, G::kMaxSmemBytes, smem, smem_set, num_tiles, grid)
                               : static_cast<int>(allow_smem(kernel, G::kMaxSmemBytes, smem_set));
      if (e != 0) return e;
      window_refinement_bwd_staged_kernel<P><<<grid, G::kThreads, smem, a.stream>>>(
          tm_f, static_cast<const float*>(a.q), static_cast<const float*>(a.f), static_cast<const float2*>(a.flow),
          static_cast<const float*>(a.log_softmax), static_cast<const float2*>(a.g_residual),
          static_cast<const float*>(a.g_log_softmax), static_cast<float*>(a.dq), static_cast<float*>(a.df),
          static_cast<float2*>(a.dflow), static_cast<float*>(a.partials), plans, a.staged_count, a.h, a.w, a.c,
          box_bytes, tiles_x, tiles_per_image, num_tiles, inv_t);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  window_refinement_bias_kernel<<<D::PP, kReduceThreads, 0, a.stream>>>(static_cast<const float*>(a.partials),
                                                                        num_tiles, D::PP, static_cast<float*>(a.dbias));
  return static_cast<int>(cudaGetLastError());
}

template <int NV>
int launch_p(int p, const CUtensorMap& tm_f, bool stage, const Args& a) {
  switch (p) {
    case 1: return launch<NV, 1>(tm_f, stage, a);
    case 3: return launch<NV, 3>(tm_f, stage, a);
    case 5: return launch<NV, 5>(tm_f, stage, a);
    case 7: return launch<NV, 7>(tm_f, stage, a);
    case 9: return launch<NV, 9>(tm_f, stage, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, f, dq, df: (B, H, W, C) fp32 contiguous, 16-byte aligned (df zeroed by
// the caller: the kernel adds into it); flow, g_residual, dflow: (B, H, W,
// 2); log_softmax, g_log_softmax: (B, H, W, P, P); dbias: (P * P,);
// partials: scratch of one row of P * P floats per 32 x 8 tile; plans:
// scratch of one int4 per tile;
// `staged_count` null or one device int to which the kernel adds the number
// of tiles it staged (none at C > 16 or C % 4 != 0, where f gets no tensor
// map). 1 <= C <= 64, P odd in 1 .. 9. Launches two or three kernels on
// `stream`; returns 0, a cudaError_t (cudaErrorInvalidValue for an
// unsupported C or P), or a kErr* code of sm90_async.cuh when the tensor map
// of f cannot be made.
extern "C" int ufm_window_refinement_bwd_f32(const void* q, const void* f, const void* flow, const void* log_softmax,
                                             const void* g_residual, const void* g_log_softmax, void* dq, void* df,
                                             void* dflow, void* dbias, void* partials, void* plans,
                                             void* staged_count, int batch, int h, int w, int c, int p,
                                             float temperature, void* stream) {
  if (static_cast<long long>(batch) * h * w == 0) return 0;
  if (!in_domain(c, p)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_f;
  memset(&tm_f, 0, sizeof(tm_f));
  const bool stage = c <= 16 && c % 4 == 0;
  if (stage) {
    const int err = encode_box_map(&tm_f, f, batch, h, w, c);
    if (err != 0) return err;
  }
  const Args a{q, f, flow, log_softmax, g_residual, g_log_softmax, dq, df, dflow, dbias, partials, plans,
               static_cast<int*>(staged_count), batch, h, w, c, temperature, static_cast<cudaStream_t>(stream)};
  if (c <= 16) return launch_p<1>(p, tm_f, stage, a);
  if (c <= 32) return launch_p<2>(p, tm_f, stage, a);
  return launch_p<4>(p, tm_f, stage, a);
}
