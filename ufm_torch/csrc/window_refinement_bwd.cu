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
// What sets its pace instead is df: every tap of every pixel adds C floats
// to a row of f that 16-64 other pixels' windows also cover, a scatter with
// collisions that only atomics in L2 resolve.
//
// Design (a simple one; see PERF.md). A CTA of 256 threads takes one 32 x 8
// tile of pixels (the forward's tiles), 4 lanes a pixel as in the forward's
// wide instances (NV float4 slots of channels each; zero past C; single
// floats where C % 4 != 0), in 4 passes of 64 pixels:
//   * each warp copies its 8 pixels' log_softmax and g_log_softmax rows into
//     shared memory in one coalesced run; the lanes of a pixel split its P^2
//     scores (k = 4 t + lane), compute g_s, write dscores back over
//     log_softmax for the tap loop, and sum g_s over the warp's pixels into
//     the warp's dbias slots (shuffles, then one lane per k);
//   * one pass over the tap rows: the y pass of dscores (with wy and wy') for
//     the row, then for each tap the x pass (ddots, ddots_x, ddots_y), the
//     tap read once from global memory for the dot, the dq and dflow sums,
//     and df's update as one 16-byte atomic add a slot (fp32 atomicAdd of a
//     float4, sm_90);
//   * dbias: the CTA's warps' slots summed in a fixed order into one partial
//     a tile, then a second kernel sums the tiles' partials in a fixed order.
// dq, dflow and dbias are therefore the same bits on every call; df is summed
// by atomics in an order that changes from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_refinement.cuh"

namespace {

using namespace ufm;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 4;  // lanes per pixel
constexpr int kPxPerWarp = 32 / kLanes;
constexpr int kPasses = kTilePx * kLanes / kThreads;
constexpr int kReduceThreads = 256;

template <int NV, int P>
struct Cfg {
  static constexpr int K = P + 3;  // integer tap span per axis
  static constexpr int R = (P - 1) / 2;
  static constexpr int PP = P * P;
  static constexpr int T = (PP + kLanes - 1) / kLanes;  // scores each lane of a pixel owns
  static constexpr int kRowFloats = kPxPerWarp * PP;   // one warp's log_softmax (or g) rows
  // shared memory, floats: [kWarps][2][kRowFloats] rows, then [kWarps][PP] dbias slots
  static constexpr int kBiasOff = kWarps * 2 * kRowFloats;
  static constexpr int kSmemBytes = (kBiasOff + kWarps * PP) * 4;
  static_assert(kSmemBytes <= 48 * 1024, "over the static shared memory a block gets without opting in");
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

// two CTAs an SM (128 registers a thread), one at P = 9 with several slots
// a lane, which spill at 128
template <int NV, int P>
__global__ void __launch_bounds__(kThreads, NV > 1 && P == 9 ? 1 : 2)
    window_refinement_bwd_kernel(const float* __restrict__ q, const float* __restrict__ f,
                                 const float2* __restrict__ flow, const float* __restrict__ log_softmax,
                                 const float2* __restrict__ g_residual, const float* __restrict__ g_log_softmax,
                                 float* __restrict__ dq, float* __restrict__ df, float2* __restrict__ dflow,
                                 float* __restrict__ partials, int h, int w, int c, int tiles_x, int tiles_per_image,
                                 float inv_temperature) {
  using G = Cfg<NV, P>;
  constexpr int K = G::K, R = G::R, PP = G::PP, T = G::T;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int c4 = lane % kLanes, px_local = lane / kLanes;
  float* rows = smem + warp * 2 * G::kRowFloats;  // log_softmax, then dscores, of the warp's pixels
  float* grows = rows + G::kRowFloats;             // g_log_softmax
  float* wbias = smem + G::kBiasOff + warp * PP;   // this warp's dbias slots
  for (int k = lane; k < PP; k += 32) wbias[k] = 0.0f;

  const int img = blockIdx.x / tiles_per_image, rt = blockIdx.x % tiles_per_image;
  const int tx0 = (rt % tiles_x) * kTileW, ty0 = (rt / tiles_x) * kTileH;
  const bool vec = c % 4 == 0;
  const float m = static_cast<float>(R + 4);
  const float* fimg = f + static_cast<long long>(img) * h * w * c;
  float* dfimg = df + static_cast<long long>(img) * h * w * c;

#pragma unroll 1
  for (int pass = 0; pass < kPasses; ++pass) {
    const int pix0 = pass * (kThreads / kLanes) + warp * kPxPerWarp;  // the warp's first pixel of the tile
    const int x_first = tx0 + pix0 % kTileW, y = ty0 + pix0 / kTileW;
    const int count = y < h ? min(max(w - x_first, 0), kPxPerWarp) : 0;  // the warp's pixels in the image
    const long long n0 = (static_cast<long long>(img) * h + y) * w + x_first;
    __syncwarp();  // the last pass's reads of rows are done
    for (int e = lane; e < count * PP; e += 32) {
      rows[e] = __ldg(log_softmax + n0 * PP + e);
      grows[e] = __ldg(g_log_softmax + n0 * PP + e);
    }
    __syncwarp();
    const bool valid = px_local < count;
    const int x = x_first + px_local;
    const long long n = n0 + px_local;

    // g_s on this lane's scores k = 4 t + c4, then dscores over log_softmax
    const float2 gr = valid ? __ldg(g_residual + n) : make_float2(0.0f, 0.0f);
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
      // dbias: this k summed over the warp's 8 pixels (lanes c4, c4 + 4, ...)
      gs += __shfl_xor_sync(kFull, gs, 4);
      gs += __shfl_xor_sync(kFull, gs, 8);
      gs += __shfl_xor_sync(kFull, gs, 16);
      if (lane < kLanes && k < PP) wbias[k] += gs;
    }
    __syncwarp();  // dscores of every pixel of the warp are in rows

    float4 qv[NV], dqv[NV];
#pragma unroll
    for (int sl = 0; sl < NV; ++sl) {
      qv[sl] = valid ? load_channels(q + n * c, 4 * (c4 + kLanes * sl), c, vec) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dqv[sl] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float2 pos = make_float2(0.0f, 0.0f);
    if (valid) {
      const float2 fl = __ldg(flow + n);
      pos.x = fminf(fmaxf(fl.x + static_cast<float>(x), -m), static_cast<float>(w) + m);
      pos.y = fminf(fmaxf(fl.y + static_cast<float>(y), -m), static_cast<float>(h) + m);
    }
    const float fx = floorf(pos.x), fy = floorf(pos.y);
    float wx[4], wy[4], dwx[4], dwy[4];
    cubic_weights(pos.x - fx, wx);
    cubic_weights(pos.y - fy, wy);
    cubic_weights_derivative(pos.x - fx, dwx);
    cubic_weights_derivative(pos.y - fy, dwy);
    const int xb = static_cast<int>(fx) - R - 1;  // leftmost tap
    const int yb = static_cast<int>(fy) - R - 1;  // topmost tap
    const float* dsc = rows + px_local * PP;
    float gfx = 0.0f, gfy = 0.0f;  // this lane's part of dflow

#pragma unroll 1
    for (int v = 0; v < K; ++v) {
      // y pass of the row: ry[j] = sum_l wy[l] dscores[v - l][j], ryd with wy'
      float ryw[P], ryd[P];
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
      const int iy = yb + v;
      const bool row_ok = valid && iy >= 0 && iy < h;
      const float* frow = fimg + static_cast<long long>(iy) * w * c;
      float* dfrow = dfimg + static_cast<long long>(iy) * w * c;
#pragma unroll
      for (int u = 0; u < K; ++u) {
        float dd = 0.0f, ddx = 0.0f, ddy = 0.0f;
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          if (u - mm >= 0 && u - mm < P) {
            dd = fmaf(wx[mm], ryw[u - mm], dd);
            ddx = fmaf(dwx[mm], ryw[u - mm], ddx);
            ddy = fmaf(wx[mm], ryd[u - mm], ddy);
          }
        }
        const int ix = xb + u;
        if (row_ok && ix >= 0 && ix < w) {
          float dot = 0.0f;
#pragma unroll
          for (int sl = 0; sl < NV; ++sl) {
            const int ch = 4 * (c4 + kLanes * sl);
            const float4 t = load_channels(frow + static_cast<long long>(ix) * c, ch, c, vec);
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
  __syncthreads();
  // this tile's dbias partial: the warps' slots in a fixed order
  for (int k = threadIdx.x; k < PP; k += kThreads) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += smem[G::kBiasOff + i * PP + k];
    partials[static_cast<long long>(blockIdx.x) * PP + k] = s;
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

template <int NV, int P>
int launch(const void* q, const void* f, const void* flow, const void* log_softmax, const void* g_residual,
           const void* g_log_softmax, void* dq, void* df, void* dflow, void* dbias, void* partials, int batch, int h,
           int w, int c, float temperature, cudaStream_t stream) {
  using G = Cfg<NV, P>;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_per_image = tiles_x * ((h + kTileH - 1) / kTileH);
  const int num_tiles = batch * tiles_per_image;
  window_refinement_bwd_kernel<NV, P><<<num_tiles, kThreads, G::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(f), static_cast<const float2*>(flow),
      static_cast<const float*>(log_softmax), static_cast<const float2*>(g_residual),
      static_cast<const float*>(g_log_softmax), static_cast<float*>(dq), static_cast<float*>(df),
      static_cast<float2*>(dflow), static_cast<float*>(partials), h, w, c, tiles_x, tiles_per_image,
      1.0f / temperature);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  window_refinement_bias_kernel<<<G::PP, kReduceThreads, 0, stream>>>(static_cast<const float*>(partials), num_tiles,
                                                                      G::PP, static_cast<float*>(dbias));
  return static_cast<int>(cudaGetLastError());
}

template <int NV>
int launch_p(int p, const void* q, const void* f, const void* flow, const void* ls, const void* gr, const void* gl,
             void* dq, void* df, void* dflow, void* dbias, void* partials, int batch, int h, int w, int c,
             float temperature, cudaStream_t s) {
  switch (p) {
    case 1: return launch<NV, 1>(q, f, flow, ls, gr, gl, dq, df, dflow, dbias, partials, batch, h, w, c, temperature, s);
    case 3: return launch<NV, 3>(q, f, flow, ls, gr, gl, dq, df, dflow, dbias, partials, batch, h, w, c, temperature, s);
    case 5: return launch<NV, 5>(q, f, flow, ls, gr, gl, dq, df, dflow, dbias, partials, batch, h, w, c, temperature, s);
    case 7: return launch<NV, 7>(q, f, flow, ls, gr, gl, dq, df, dflow, dbias, partials, batch, h, w, c, temperature, s);
    case 9: return launch<NV, 9>(q, f, flow, ls, gr, gl, dq, df, dflow, dbias, partials, batch, h, w, c, temperature, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, f, dq, df: (B, H, W, C) fp32 contiguous, 16-byte aligned (df zeroed by
// the caller: the kernel adds into it); flow, g_residual, dflow: (B, H, W,
// 2); log_softmax, g_log_softmax: (B, H, W, P, P); dbias: (P * P,);
// partials: scratch of one row of P * P floats per 32 x 8 tile. 1 <= C <=
// 64, P odd in 1 .. 9. Launches two kernels on `stream`; returns 0 or a
// cudaError_t (cudaErrorInvalidValue for an unsupported C or P).
extern "C" int ufm_window_refinement_bwd_f32(const void* q, const void* f, const void* flow, const void* log_softmax,
                                             const void* g_residual, const void* g_log_softmax, void* dq, void* df,
                                             void* dflow, void* dbias, void* partials, int batch, int h, int w, int c,
                                             int p, float temperature, void* stream) {
  if (static_cast<long long>(batch) * h * w == 0) return 0;
  if (!in_domain(c, p)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 16) {
    return launch_p<1>(p, q, f, flow, log_softmax, g_residual, g_log_softmax, dq, df, dflow, dbias, partials, batch,
                       h, w, c, temperature, s);
  }
  if (c <= 32) {
    return launch_p<2>(p, q, f, flow, log_softmax, g_residual, g_log_softmax, dq, df, dflow, dbias, partials, batch,
                       h, w, c, temperature, s);
  }
  return launch_p<4>(p, q, f, flow, log_softmax, g_residual, g_log_softmax, dq, df, dflow, dbias, partials, batch, h,
                     w, c, temperature, s);
}
