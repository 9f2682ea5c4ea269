// Flash-attention backward for Hopper (sm_90a) over the TPU kernel's whole
// domain: q, k, v, o, g in fp32, bf16 or fp16, any head dim from 1 to 256,
// any Sq >= 1 and Sk >= 1 (Sq != Sk allowed), all read in place through four
// element strides each.
//
// Replaces: ufm_tpu/ops/flash_attention.py::_flash_attention_bwd_impl (:452)
// and its TPU kernel body _attn_bwd_kernel (:351), for every dtype and head
// dim the port's wgmma backward (flash_attention_bwd.cu: bf16 with D = 64
// only) does not take. The TPU kernel passes (B*H, S, D) blocks of the
// input's dtype to one pallas_call whatever D is; here fp32 models
// (compute_dtype="float32", the trained tiny checkpoint at D = 32 / 24),
// bf16 models at D != 64 and fp16 take this kernel. Same function: with P
// recomputed from the scores and the forward's natural-log row log-sum-exp,
//   P = exp(s * scale - lse),  dP = g v^T,  delta = rowsum(g * o),
//   dS = P * (dP - delta),
//   dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T g,
// fp32 scores, P, dP and dS. For bf16 and fp16, P and dS are rounded to the
// input dtype as operands of the gradient products (the TPU kernel's p_c /
// ds_c, as the wgmma backward does); for fp32 they stay fp32. dq, dk and dv
// are accumulated in fp32 and written once in the input dtype.
//
// Arithmetic: every product is fp32 FMA on the CUDA cores (bf16 and fp16
// inputs are widened when a tile is staged), so an fp32 call keeps fp32's
// accuracy (no TF32). The scores are summed over D in the order the fp32-FMA
// forward (flash_attention_fwd_any.cu) sums them, so P is that forward's
// softmax to the last bit of exp.
//
// Design, simple first: the flash-attention-2 schedule of
// flash_attention_bwd.cu, in two launches and without atomics, so the result
// is deterministic and bitwise repeatable.
//   1. delta kernel: delta = rowsum(g * o) in fp32, one warp a row (equal to
//      rowsum(dP * P) up to the rounding of o);
//   2. one grid of two kinds of CTA, 128 threads each, the dK/dV CTAs first,
//      then the dQ CTAs (the two kinds are independent, so the dQ CTAs fill
//      the last wave of the dK/dV CTAs).
//      dK/dV: one CTA per (tile of kBlockR keys, batch * head) keeps its K
//      and V rows in shared memory and walks the queries in tiles of 64 rows
//      (Q, g, lse, delta staged each tile): S^T = K Q^T, then P^T;
//      dP^T = V g^T, then dS^T; dV += P^T g and dK += dS^T Q in registers.
//      dQ: one CTA per (tile of kBlockR queries, batch * head) keeps Q and g
//      and walks the keys in tiles of 64 rows (K, V staged each tile): S =
//      Q K^T, then P (keys past Sk give P = 0); dP = g V^T, then dS; dQ += dS
//      K in registers.
//   Both kinds share one body: a resident pair (A1, A2), a streamed pair
//   (B1, B2), X = A1 B1^T and Y = A2 B2^T, then products with B1 and B2.
//   Tiles are staged as fp32 with D zero-padded to DP (32, 64, 128 or 256, a
//   template argument), rows past S zero-filled; plain strided loads, no
//   TMA, so any layout is read in place. A thread owns R resident rows and 8
//   streamed rows of the score tiles (the forward's layout, rows padded to
//   DP + 4 floats so the 8 lanes of a row group read distinct banks), and R
//   resident rows x DP / 8 columns of each gradient accumulator. The
//   resident tile shrinks as DP grows (kBlockR = 64 / 64 / 32 / 16 rows, R =
//   4 / 4 / 2 / 1) so the two accumulators stay at 64 floats a thread at
//   DP 64 / 128 / 256 (32 at DP = 32). P (rounded) and dS (rounded) pass
//   through shared memory between the score and the gradient products.
//   Rows past Sq take lse = +inf (P = 0) and delta = 0 in the dK/dV CTAs;
//   rows past S are never written.
//
// Bound on an H100 SXM: 10 B H Sq Sk D operations (the TPU kernel's
// CostEstimate, five products) at 67 TFLOP/s of fp32 outside the tensor
// cores (989 for bf16 / fp16, the card's rate for those types), against q,
// k, v, o, g read once and dq, dk, dv written once at 3.35 TB/s. In fp32:
//   encoder      (4, 1201, 16, 64): 59.1 GFLOP -> 0.882 ms; 0.16 GB -> 0.05 ms
//   info sharing (2, 2400, 12, 64): 88.5 GFLOP -> 1.320 ms; 0.12 GB -> 0.04 ms
// so it is bound by operations. The two kinds of CTA each recompute S and
// dP: 7 products where the bound counts 5; a thread issues one 16-byte
// shared-memory load per 11-16 FMAs at R = 4, per ~4 at R = 1. Making it
// fast (3xTF32 or wgmma on the tensor cores, cp.async double buffering) is
// later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "sm90_async.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kColGroups = 8;                      // threads sharing a resident row
constexpr int kRowGroups = kThreads / kColGroups;  // 16
constexpr int kBlockS = 64;                        // streamed rows per tile
constexpr int kCols = kBlockS / kColGroups;        // streamed rows per thread in the score tiles: 8
constexpr int kSStride = kBlockS + 4;              // floats per row of the P / dS tiles in shared memory

template <int DP>
struct Tile {
  static constexpr int kRows = DP <= 64 ? 4 : DP == 128 ? 2 : 1;  // resident rows per thread
  static constexpr int kBlockR = kRowGroups * kRows;              // resident rows per CTA
  static constexpr int kStride = DP + 4;                          // floats per staged row
  static constexpr int kVec = DP / 32;  // 16-byte accumulator column groups per thread (cg * 4 + 32 c)
  static constexpr int kSmemFloats =
      2 * kBlockR * kStride + 2 * kBlockS * kStride + 2 * kBlockR * kSStride + 2 * kBlockS;
  static constexpr int kSmemBytes = kSmemFloats * 4;
};

// element strides: (B, S, H, D) for the inputs, (B, S, H) for the outputs
// (D contiguous: the wrapper allocates them)
struct Layout {
  long long q[4], k[4], v[4], g[4];
  long long dq[3], dk[3], dv[3];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

// x rounded to T's precision (the TPU kernel's p_c / ds_c), back in fp32
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float round_as(float x, __half) { return __half2float(__float2half_rn(x)); }

// delta[(b * H + h) * Sq + i] = sum_d g[b, i, h, d] * o[b, i, h, d] in fp32:
// one warp a row, lanes over d, reduced with shuffles in a fixed order
template <typename T>
__global__ void __launch_bounds__(256) attention_delta_any_kernel(
    const T* __restrict__ o, const T* __restrict__ g, float* __restrict__ delta, int num_heads, int sq, int d,
    long long rows, long long o_sb, long long o_ss, long long o_sh, long long o_sd, long long g_sb, long long g_ss,
    long long g_sh, long long g_sd) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  if (row < rows) {
    const long long bh = row / sq;
    const long long i = row - bh * sq;
    const long long b = bh / num_heads;
    const long long h = bh - b * num_heads;
    const T* orow = o + b * o_sb + i * o_ss + h * o_sh;
    const T* grow = g + b * g_sb + i * g_ss + h * g_sh;
    for (int c = lane; c < d; c += 32) acc = fmaf(to_float(grow[c * g_sd]), to_float(orow[c * o_sd]), acc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < rows && lane == 0) delta[row] = acc;
}

// rows [row0, row0 + rows) of one (batch, head) slice -> fp32 shared memory
// at `stride` floats a row; rows past `seq` and columns past `d` are zero
template <int DP, typename T>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src, long long s_s, long long s_d, int row0,
                                      int seq, int rows, int d) {
  for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx % DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < seq && c < d) x = to_float(src[row * s_s + c * s_d]);
    dst[r * stride + c] = x;
  }
}

// out[r][j] = sum_dd a[rg * R + r][dd] * b[cg + 8 j][dd] over the staged
// rows (fp32 FMA, dd in order: the forward's score order)
template <int DP, int R>
__device__ __forceinline__ void score_tile(float (&out)[R][kCols], const float* a, const float* b, int rg, int cg) {
  constexpr int stride = DP + 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < DP; dd += 4) {
    float4 av[R], bv[kCols];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = *reinterpret_cast<const float4*>(a + (rg * R + i) * stride + dd);
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (cg + kColGroups * j) * stride + dd);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = out[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        out[i][j] = x;
      }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& x) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}

// One CTA's gradients. kDq false: a dK/dV CTA (resident K, V; streamed Q, g),
// writing dV (out1) and dK (out2); true: a dQ CTA (resident Q, g; streamed K,
// V), writing dQ (out1).
template <typename T, int DP, bool kDq>
__device__ __forceinline__ void grads_block(float* smem, int tile, int bh, const T* __restrict__ q,
                                            const T* __restrict__ k, const T* __restrict__ v,
                                            const T* __restrict__ g, const float* __restrict__ lse,
                                            const float* __restrict__ delta, T* out1, T* out2, int num_heads,
                                            int sq, int sk, int d, const Layout& L, float scale) {
  using C = Tile<DP>;
  constexpr int R = C::kRows;
  float* a1 = smem;                            // resident: K (dK/dV) or Q (dQ)
  float* a2 = a1 + C::kBlockR * C::kStride;    // resident: V or g
  float* b1 = a2 + C::kBlockR * C::kStride;    // streamed: Q or K
  float* b2 = b1 + kBlockS * C::kStride;       // streamed: g or V
  float* ps = b2 + kBlockS * C::kStride;       // P (rounded), resident x streamed
  float* dss = ps + C::kBlockR * kSStride;     // dS (rounded), resident x streamed
  float* lse_s = dss + C::kBlockR * kSStride;  // the streamed rows' lse and delta (dK/dV)
  float* delta_s = lse_s + kBlockS;

  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int rg = tid / kColGroups;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int r0 = tile * C::kBlockR;
  const long long stat0 = static_cast<long long>(bh) * sq;  // this slice's lse / delta
  const T* qb = q + b * L.q[0] + h * L.q[2];
  const T* kb = k + b * L.k[0] + h * L.k[2];
  const T* vb = v + b * L.v[0] + h * L.v[2];
  const T* gb = g + b * L.g[0] + h * L.g[2];

  float row_lse[R], row_delta[R];  // the resident rows' (dQ)
  if constexpr (kDq) {
    stage<DP>(a1, C::kStride, qb, L.q[1], L.q[3], r0, sq, C::kBlockR, d);
    stage<DP>(a2, C::kStride, gb, L.g[1], L.g[3], r0, sq, C::kBlockR, d);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = r0 + rg * R + i;
      row_lse[i] = row < sq ? lse[stat0 + row] : 0.f;  // rows past Sq are never written
      row_delta[i] = row < sq ? delta[stat0 + row] : 0.f;
    }
  } else {
    stage<DP>(a1, C::kStride, kb, L.k[1], L.k[3], r0, sk, C::kBlockR, d);
    stage<DP>(a2, C::kStride, vb, L.v[1], L.v[3], r0, sk, C::kBlockR, d);
  }

  float4 acc1[R][C::kVec], acc2[R][C::kVec];  // dQ or dV; dK
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C::kVec; ++c) {
      acc1[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc2[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  const int streamed = kDq ? sk : sq;
  const int num_tiles = (streamed + kBlockS - 1) / kBlockS;
  for (int t = 0; t < num_tiles; ++t) {
    const int s0 = t * kBlockS;
    __syncthreads();  // the previous tile's B1, B2, P and dS are consumed
    if constexpr (kDq) {
      stage<DP>(b1, C::kStride, kb, L.k[1], L.k[3], s0, sk, kBlockS, d);
      stage<DP>(b2, C::kStride, vb, L.v[1], L.v[3], s0, sk, kBlockS, d);
    } else {
      stage<DP>(b1, C::kStride, qb, L.q[1], L.q[3], s0, sq, kBlockS, d);
      stage<DP>(b2, C::kStride, gb, L.g[1], L.g[3], s0, sq, kBlockS, d);
      for (int j = tid; j < kBlockS; j += kThreads) {
        const int row = s0 + j;
        lse_s[j] = row < sq ? lse[stat0 + row] : INFINITY;  // P = 0 past Sq
        delta_s[j] = row < sq ? delta[stat0 + row] : 0.f;
      }
    }
    __syncthreads();

    // P from the scores X = A1 B1^T (S^T or S)
    float p[R][kCols];
    score_tile<DP, R>(p, a1, b1, rg, cg);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = cg + kColGroups * j;
        if constexpr (kDq) {
          p[i][j] = s0 + c < sk ? expf(p[i][j] * scale - row_lse[i]) : 0.f;  // keys past Sk
        } else {
          p[i][j] = expf(p[i][j] * scale - lse_s[c]);
        }
      }
    // dS = P (Y - delta) with Y = A2 B2^T (dP^T or dP)
    float y[R][kCols];
    score_tile<DP, R>(y, a2, b2, rg, cg);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = cg + kColGroups * j;
        const float dl = kDq ? row_delta[i] : delta_s[c];
        const int at = (rg * R + i) * kSStride + c;
        dss[at] = round_as(p[i][j] * (y[i][j] - dl), T());
        if constexpr (!kDq) ps[at] = round_as(p[i][j], T());
      }
    __syncthreads();

    // dQ += dS K, or dV += P^T g and dK += dS^T Q
#pragma unroll 2
    for (int kk = 0; kk < kBlockS; kk += 4) {
      float4 dsv[R], pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        dsv[i] = *reinterpret_cast<const float4*>(dss + (rg * R + i) * kSStride + kk);
        if constexpr (!kDq) pv[i] = *reinterpret_cast<const float4*>(ps + (rg * R + i) * kSStride + kk);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < C::kVec; ++c) {
          const int col = cg * 4 + 32 * c;
          const float4 x1 = *reinterpret_cast<const float4*>(b1 + (kk + e) * C::kStride + col);
          if constexpr (kDq) {
#pragma unroll
            for (int i = 0; i < R; ++i) fma4(acc1[i][c], lane_of(dsv[i], e), x1);
          } else {
            const float4 x2 = *reinterpret_cast<const float4*>(b2 + (kk + e) * C::kStride + col);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              fma4(acc1[i][c], lane_of(pv[i], e), x2);
              fma4(acc2[i][c], lane_of(dsv[i], e), x1);
            }
          }
        }
      }
    }
  }

  // write the resident rows: dQ * scale; or dV, and dK * scale
  const long long o1_sb = kDq ? L.dq[0] : L.dv[0];
  const long long o1_ss = kDq ? L.dq[1] : L.dv[1];
  const long long o1_sh = kDq ? L.dq[2] : L.dv[2];
  const int res_len = kDq ? sq : sk;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = r0 + rg * R + i;
    if (row >= res_len) continue;
    T* o1 = out1 + b * o1_sb + row * o1_ss + h * o1_sh;
    T* o2 = out2 + b * L.dk[0] + row * L.dk[1] + h * L.dk[2];
#pragma unroll
    for (int c = 0; c < C::kVec; ++c) {
      const int col = cg * 4 + 32 * c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e >= d) continue;
        if constexpr (kDq) {
          store(o1 + col + e, lane_of(acc1[i][c], e) * scale);
        } else {
          store(o1 + col + e, lane_of(acc1[i][c], e));
          store(o2 + col + e, lane_of(acc2[i][c], e) * scale);
        }
      }
    }
  }
}

// The dK/dV CTAs of every (key tile, batch * head), then the dQ CTAs of every
// (query tile, batch * head), in one grid
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_any_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, int num_heads, int sq, int sk, int d, int kv_tiles, int q_tiles, int kv_blocks, Layout L,
    float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int x = static_cast<int>(blockIdx.x);
  if (x < kv_blocks) {
    grads_block<T, DP, false>(smem, x % kv_tiles, x / kv_tiles, q, k, v, g, lse, delta, dv, dk, num_heads, sq, sk,
                              d, L, scale);
  } else {
    const int i = x - kv_blocks;
    grads_block<T, DP, true>(smem, i % q_tiles, i / q_tiles, q, k, v, g, lse, delta, dq, dq, num_heads, sq, sk, d,
                             L, scale);
  }
}

template <typename T, int DP>
int launch_grads(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
                 void* dq, void* dk, void* dv, int batch, int num_heads, int sq, int sk, int d, const Layout& L,
                 float scale, cudaStream_t stream) {
  using C = Tile<DP>;
  static int smem_set = 0;  // devices on which this instance may use kSmemBytes
  const void* fn = reinterpret_cast<const void*>(flash_attention_bwd_any_kernel<T, DP>);
  const cudaError_t e = ufm::allow_smem(fn, C::kSmemBytes, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int kv_tiles = (sk + C::kBlockR - 1) / C::kBlockR;
  const int q_tiles = (sq + C::kBlockR - 1) / C::kBlockR;
  const int kv_blocks = kv_tiles * batch * num_heads;
  const dim3 grid(kv_blocks + q_tiles * batch * num_heads);
  flash_attention_bwd_any_kernel<T, DP><<<grid, kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), num_heads, sq, sk, d, kv_tiles, q_tiles, kv_blocks, L, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const void* o, const void* g, const void* lse,
                 void* delta, void* dq, void* dk, void* dv, int batch, int num_heads, int sq, int sk, int d,
                 const long long* o_st, const Layout& L, float scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * num_heads * sq;
  attention_delta_any_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(g), static_cast<float*>(delta), num_heads, sq, d, rows,
      o_st[0], o_st[1], o_st[2], o_st[3], L.g[0], L.g[1], L.g[2], L.g[3]);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto grads = d <= 32 ? &launch_grads<T, 32> : d <= 64 ? &launch_grads<T, 64>
                    : d <= 128 ? &launch_grads<T, 128> : &launch_grads<T, 256>;
  return grads(q, k, v, g, lse, delta, dq, dk, dv, batch, num_heads, sq, sk, d, L, scale, stream);
}

}  // namespace

// Plain C entry point for ctypes: the two kernels above, in order, on
// `stream`. `dtype` picks the element type of q, k, v, o, g, dq, dk, dv (0
// fp32, 1 bf16, 2 fp16). Input strides are in elements, any value (read
// element by element); dq, dk, dv are written through their B, S and H
// strides with D contiguous. lse (the forward's, natural log) and the scratch
// `delta` are contiguous fp32 (B, H, Sq). The wrapper checks 1 <= d <= 256,
// sq, sk >= 1 and batch * num_heads <= 65535. Returns 0 or a cudaError_t.
extern "C" int ufm_flash_attention_bwd_any(
    const void* q, const void* k, const void* v, const void* o, const void* g, const void* lse, void* delta,
    void* dq, void* dk, void* dv, int dtype, int batch, int num_heads, int sq, int sk, int d, long long q_sb,
    long long q_ss, long long q_sh, long long q_sd, long long k_sb, long long k_ss, long long k_sh, long long k_sd,
    long long v_sb, long long v_ss, long long v_sh, long long v_sd, long long o_sb, long long o_ss, long long o_sh,
    long long o_sd, long long g_sb, long long g_ss, long long g_sh, long long g_sd, long long dq_sb,
    long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss, long long dk_sh, long long dv_sb,
    long long dv_ss, long long dv_sh, float scale, void* stream) {
  if (d < 1 || d > 256 || sq < 1 || sk < 1 || dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{{q_sb, q_ss, q_sh, q_sd}, {k_sb, k_ss, k_sh, k_sd}, {v_sb, v_ss, v_sh, v_sd},
                 {g_sb, g_ss, g_sh, g_sd}, {dq_sb, dq_ss, dq_sh}, {dk_sb, dk_ss, dk_sh}, {dv_sb, dv_ss, dv_sh}};
  const long long o_st[4] = {o_sb, o_ss, o_sh, o_sd};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, o, g, lse, delta, dq, dk, dv, batch, num_heads, sq, sk, d, o_st, L,
                                       scale, s);
  if (dtype == 2)
    return launch_dtype<__half>(q, k, v, o, g, lse, delta, dq, dk, dv, batch, num_heads, sq, sk, d, o_st, L, scale,
                                s);
  return launch_dtype<float>(q, k, v, o, g, lse, delta, dq, dk, dv, batch, num_heads, sq, sk, d, o_st, L, scale, s);
}
