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
// Arithmetic: every product on the tensor cores, mma.sync.m16n8k8 with TF32
// operands under the term rule of attention_mma.cuh: fp32 operands (the
// inputs, and P and dS in fp32) take two terms and each fp32 product three
// mma a k-step (3xTF32, fp32's accuracy); bf16 / fp16 inputs and the
// rounded P and dS are exact in one term, so their products take one mma.
// The scores are recomputed in the forward's (flash_attention_fwd_any.cu)
// fragment and term order: S^T = K Q^T adds Q's small term, then K's, then
// hi x hi at each k-step of D in order, as S = Q K^T does there, and one
// mma gives an element the same bits in either operand order, so P is that
// forward's softmax to the last bit of exp.
//
// Design: the flash-attention-2 schedule of flash_attention_bwd.cu, in two
// launches and without atomics, so the result is deterministic and bitwise
// repeatable.
//   1. delta kernel: delta = rowsum(g * o) in fp32, one warp a row (equal to
//      rowsum(dP * P) up to the rounding of o);
//   2. one grid of two kinds of CTA, 4 warps each, the dK/dV CTAs first,
//      then the dQ CTAs (the two kinds are independent, so the dQ CTAs fill
//      the last wave of the dK/dV CTAs).
//      dK/dV: one CTA per (tile of kBlockR keys, batch * head) keeps its K
//      and V rows in shared memory and walks the queries in tiles of
//      kBlockS rows (Q, g, lse, delta staged each tile): S^T = K Q^T, then
//      P^T; dP^T = V g^T, then dS^T; dV += P^T g and dK += dS^T Q.
//      dQ: one CTA per (tile of kBlockR queries, batch * head) keeps Q and g
//      and walks the keys (K, V staged each tile): S = Q K^T, then P (keys
//      past Sk give P = 0); dP = g V^T, then dS; dQ += dS K.
//   Both kinds share one body: a resident pair (A1, A2), a streamed pair
//   (B1, B2), X = A1 B1^T and Y = A2 B2^T in mma accumulators (D summed in
//   groups of 64 columns, as the forward sums S), then the gradient
//   products with B1 and B2, whose A operands are X and Y's own accumulator
//   fragments (a_from_acc: B1 / B2 read in key order), so P and dS stay in
//   registers. A warp owns 16 resident rows; at DP = 128 / 256 two warps
//   share 16 rows and each keeps half of the gradient columns (each
//   computes the rows' X and Y whole): kBlockR = 64 / 64 / 32 / 32 rows at
//   DP = 32 / 64 / 128 / 256.
//   The resident tiles are staged once in the inputs' type (rows padded by
//   16 bytes) and their A fragments split as each warp reads them. Each
//   streamed tile (kBlockS = 32 / 32 / 16 / 16 rows; 64 for fp32 at DP = 32,
//   where the tiny models' short rows make the tile count the CTA's latency)
//   is copied raw (cp.async, 16 bytes where D is contiguous and the rows
//   aligned, else 4 bytes for fp32; plain loads for other bf16 / fp16
//   layouts), then prepared once into a ready tile (attention_mma.cuh) that
//   all four warps read with no split;
//   the next tile's copy overlaps this tile's products. Rows past S and
//   columns past D are zero. Rows past Sq give P = 0 in the dK/dV CTAs; rows
//   past S are never written.
//   fp32 gradients are summed in partial sums (attention_mma.cuh, Sums).
//
// Bound on an H100 SXM: 10 B H Sq Sk D operations (the TPU kernel's
// CostEstimate, five products) against q, k, v, o, g read once and dq, dk,
// dv written once at 3.35 TB/s: fp32 at 3xTF32 on the tensor cores (165
// TFLOP/s of fp32 work), bf16 / fp16 at 989 TFLOP/s. In fp32:
//   encoder      (4, 1201, 16, 64): 59.1 GFLOP -> 0.358 ms; 0.16 GB -> 0.05 ms
//   info sharing (2, 2400, 12, 64): 88.5 GFLOP -> 0.536 ms; 0.12 GB -> 0.04 ms
// so it is bound by operations. What holds it back (PERF.md, row 2b): the
// two kinds of CTA each recompute S and dP, 7 products where the bound
// counts 5 (more at DP = 128 / 256, where two warps each compute their rows'
// X and Y); mma.sync reaches the TF32 rate only in part; the resident A
// fragments are split again for every streamed tile (cvt.rna.tf32.f32 is
// four SASS instructions); 8 warps an SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "attention_mma.cuh"
#include "sm90_async.cuh"

namespace {

using namespace ufm_mma;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T, int DP>
struct Tile {
  using R = Ready<T>;
  static constexpr int kWarpsN = DP <= 64 ? 1 : 2;         // warps sharing 16 resident rows
  static constexpr int kBlockR = 16 * (kWarps / kWarpsN);  // resident rows a CTA
  static constexpr int kBlockS = DP <= 32 && kTwoTerms<T> ? 64 : DP <= 64 ? 32 : 16;  // streamed rows a tile
  static constexpr int kCols = DP / kWarpsN;               // gradient columns a warp
  static constexpr int kResStride = DP + kPad<T>;          // raw resident rows (fragments split as read)
  static constexpr int kStrStride = ready_stride_kmajor<DP>;  // ready streamed rows
  static constexpr int kRes = kBlockR * kResStride;
  static constexpr int kRaw = kBlockS * DP;
  static constexpr int kReady = kBlockS * kStrStride;
  // A1, A2 (T); ready B1, B2 (R); raw B1, B2 (T); raw and ready lse, delta
  static constexpr int kSmemBytes = (2 * kRes + 2 * kRaw) * static_cast<int>(sizeof(T)) +
                                    2 * kReady * static_cast<int>(sizeof(R)) + 4 * kBlockS * 4;
};

// element strides: (B, S, H, D) for the inputs, (B, S, H) for the outputs
// (D contiguous: the wrapper allocates them)
struct Layout {
  long long q[4], k[4], v[4], g[4];
  long long dq[3], dk[3], dv[3];
};

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

// One chunk c of 8 streamed rows of the gradient products into acc1 (dQ +=
// dS K, or dV += P^T g) and acc2 (dK += dS^T Q), the B operands read in key
// order from the ready tiles b1 (K or Q) and b2 (V or g). kFresh: each
// product is summed from zero and added to acc in fp32.
template <typename T, int kG, bool kDq, bool kFresh>
__device__ __forceinline__ void grad_chunk(float (&acc1)[kG][4], float (&acc2)[kG][4], const float (&x)[4],
                                           const float (&y)[4], const Ready<T>* b1, const Ready<T>* b2, int c,
                                           int stride, int col0, int gq, int tq) {
  constexpr bool k2 = kTwoTerms<T>;
  FragA fp, fd;
  a_from_acc<k2>(fd, y);
  if constexpr (!kDq) a_from_acc<k2>(fp, x);
  const int off = (8 * c + 2 * tq) * stride + col0 + gq;
#pragma unroll
  for (int n = 0; n < kG; ++n) {
    FragB fb;
    if constexpr (kDq) {
      load_b_ready(fb, b1 + off + 8 * n, stride);
      mma_add<kFresh, k2, k2>(acc1[n], fd, fb);
    } else {
      load_b_ready(fb, b2 + off + 8 * n, stride);
      mma_add<kFresh, k2, k2>(acc1[n], fp, fb);
      load_b_ready(fb, b1 + off + 8 * n, stride);
      mma_add<kFresh, k2, k2>(acc2[n], fd, fb);
    }
  }
}

// One CTA's gradients. kDq false: a dK/dV CTA (resident K, V; streamed Q, g),
// writing dV (out1) and dK (out2); true: a dQ CTA (resident Q, g; streamed K,
// V), writing dQ (out1). `staging` holds the Staging of q, k, v, g in 2-bit
// fields.
template <typename T, int DP, bool kDq>
__device__ __forceinline__ void grads_block(T* smem, int tile, int bh, const T* __restrict__ q,
                                            const T* __restrict__ k, const T* __restrict__ v,
                                            const T* __restrict__ g, const float* __restrict__ lse,
                                            const float* __restrict__ delta, T* out1, T* out2, int num_heads,
                                            int sq, int sk, int d, const Layout& L, int staging, float scale) {
  using C = Tile<T, DP>;
  using R = typename C::R;
  constexpr bool k2 = kTwoTerms<T>;
  constexpr int kN = C::kBlockS / 8;  // 8-row chunks of a streamed tile
  constexpr int kD = DP / 8;          // k-steps of the score products
  constexpr int kGroup = kD < 8 ? kD : 8;
  constexpr int kG = C::kCols / 8;    // 8-column tiles of a warp's gradients
  constexpr int kRS = C::kResStride;
  constexpr int kSS = C::kStrStride;
  T* a1 = smem;                     // resident: K (dK/dV) or Q (dQ)
  T* a2 = a1 + C::kRes;             // resident: V or g
  T* raw1 = a2 + C::kRes;           // raw streamed: Q or K
  T* raw2 = raw1 + C::kRaw;         // raw streamed: g or V
  R* b1 = reinterpret_cast<R*>(raw2 + C::kRaw);  // ready streamed: Q or K
  R* b2 = b1 + C::kReady;                        // ready streamed: g or V
  float* raw_stats = reinterpret_cast<float*>(b2 + C::kReady);  // the streamed rows' lse, delta (dK/dV)
  float* st_lse = raw_stats + 2 * C::kBlockS;
  float* st_delta = st_lse + C::kBlockS;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;  // the fragments' g and t
  const int tq = lane % 4;
  const int mg = warp / C::kWarpsN;  // the warp's 16 resident rows
  const int ng = warp % C::kWarpsN;  // and its gradient column slice
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int r0 = tile * C::kBlockR;
  const long long stat0 = static_cast<long long>(bh) * sq;  // this slice's lse / delta
  const T* qb = q + b * L.q[0] + h * L.q[2];
  const T* kb = k + b * L.k[0] + h * L.k[2];
  const T* vb = v + b * L.v[0] + h * L.v[2];
  const T* gb = g + b * L.g[0] + h * L.g[2];
  const int q_how = staging & 3;
  const int k_how = (staging >> 2) & 3;
  const int v_how = (staging >> 4) & 3;
  const int g_how = (staging >> 6) & 3;

  const auto stage_streamed = [&](int it) {
    const int s0 = it * C::kBlockS;
    if constexpr (kDq) {
      stage<DP, kThreads>(raw1, DP, kb, L.k[1], L.k[3], s0, sk, C::kBlockS, d, k_how);
      stage<DP, kThreads>(raw2, DP, vb, L.v[1], L.v[3], s0, sk, C::kBlockS, d, v_how);
    } else {
      stage<DP, kThreads>(raw1, DP, qb, L.q[1], L.q[3], s0, sq, C::kBlockS, d, q_how);
      stage<DP, kThreads>(raw2, DP, gb, L.g[1], L.g[3], s0, sq, C::kBlockS, d, g_how);
      for (int j = threadIdx.x; j < 2 * C::kBlockS; j += kThreads) {
        const int row = s0 + j % C::kBlockS;
        const float* src = (j < C::kBlockS ? lse : delta) + stat0 + row;
        cp_async4(raw_stats + j, row < sq ? src : lse, row < sq ? 4 : 0);  // rows past Sq: masked below
      }
    }
  };

  float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};  // the warp's resident rows g, g + 8 (dQ)
  if constexpr (kDq) {
    stage<DP, kThreads>(a1, kRS, qb, L.q[1], L.q[3], r0, sq, C::kBlockR, d, q_how);
    stage<DP, kThreads>(a2, kRS, gb, L.g[1], L.g[3], r0, sq, C::kBlockR, d, g_how);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 16 * mg + gq + 8 * i;
      if (row < sq) {  // rows past Sq are never written
        row_lse[i] = lse[stat0 + row];
        row_delta[i] = delta[stat0 + row];
      }
    }
  } else {
    stage<DP, kThreads>(a1, kRS, kb, L.k[1], L.k[3], r0, sk, C::kBlockR, d, k_how);
    stage<DP, kThreads>(a2, kRS, vb, L.v[1], L.v[3], r0, sk, C::kBlockR, d, v_how);
  }
  stage_streamed(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc1[kG][4], acc2[kG][4];  // dQ or dV; dK
#pragma unroll
  for (int n = 0; n < kG; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc1[n][e] = 0.f;
      acc2[n][e] = 0.f;
    }

  const T* a1w = a1 + 16 * mg * kRS;
  const T* a2w = a2 + 16 * mg * kRS;
  const int col0 = ng * C::kCols;
  const int streamed = kDq ? sk : sq;
  const int num_tiles = (streamed + C::kBlockS - 1) / C::kBlockS;
  for (int it = 0; it < num_tiles; ++it) {
    prepare<DP, kThreads>(b1, kSS, raw1, C::kBlockS);
    prepare<DP, kThreads>(b2, kSS, raw2, C::kBlockS);
    if constexpr (!kDq) {
      for (int j = threadIdx.x; j < 2 * C::kBlockS; j += kThreads) st_lse[j] = raw_stats[j];
    }
    __syncthreads();  // the ready tiles are written and the raw ones read
    if (it + 1 < num_tiles) {
      stage_streamed(it + 1);  // lands while this tile's products run
      cp_async_commit();
    }
    const int s0 = it * C::kBlockS;

    // X = A1 B1^T (S^T or S) and Y = A2 B2^T (dP^T or dP); the dK/dV CTA's
    // transposed products add B's small term first (the forward's order)
    float x[kN][4], y[kN][4];
#pragma unroll
    for (int kk0 = 0; kk0 < kD; kk0 += kGroup) {  // D in groups of 64 columns, as the forward sums S
      float px[kN][4], py[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          px[j][e] = 0.f;
          py[j][e] = 0.f;
        }
#pragma unroll
      for (int kk = kk0; kk < kk0 + kGroup; ++kk) {
        FragA fa1, fa2;
        load_a<T>(fa1, a1w + 8 * kk, kRS, gq, tq);
        load_a<T>(fa2, a2w + 8 * kk, kRS, gq, tq);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          FragB fb;
          load_b_ready(fb, b1 + (8 * j + gq) * kSS + 8 * kk + tq, 4);
          mma_terms<k2, k2, !kDq>(px[j], fa1, fb);
          load_b_ready(fb, b2 + (8 * j + gq) * kSS + 8 * kk + tq, 4);
          mma_terms<k2, k2, !kDq>(py[j], fa2, fb);
        }
      }
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[j][e] = kk0 == 0 ? px[j][e] : x[j][e] + px[j][e];
          y[j][e] = kk0 == 0 ? py[j][e] : y[j][e] + py[j][e];
        }
    }

    // P into x, dS into y: element e of chunk j is resident row g + 8 (e / 2),
    // streamed row s0 + 8 j + 2 t + e % 2
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tq + e % 2;
        float p, dl;
        if constexpr (kDq) {
          p = s0 + c < sk ? expf(x[j][e] * scale - row_lse[e / 2]) : 0.f;  // keys past Sk
          dl = row_delta[e / 2];
        } else {
          p = s0 + c < sq ? expf(x[j][e] * scale - st_lse[c]) : 0.f;  // queries past Sq
          dl = st_delta[c];
        }
        x[j][e] = p;
        y[j][e] = p * (y[j][e] - dl);
        if constexpr (!k2) {  // bf16 / fp16: the gradient products' operands in the input dtype
          x[j][e] = round_as(x[j][e], T());
          y[j][e] = round_as(y[j][e], T());
        }
      }

    // dQ += dS K, or dV += P^T g and dK += dS^T Q, the streamed rows in key
    // order. fp32 sums them in partial sums (attention_mma.cuh, Sums): two
    // chunks of 8 rows at a time for a slice of 64 columns, each product
    // alone for a wider one (DP = 256), whose partial sums would not fit in
    // registers; bf16 / fp16 chain them. Chunk by chunk, the 8-column tiles'
    // mma are independent of each other.
    if constexpr (k2 && kG <= 8) {
#pragma unroll
      for (int c0 = 0; c0 < kN; c0 += 2) {
        float part1[kG][4], part2[kG][4];
#pragma unroll
        for (int n = 0; n < kG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            part1[n][e] = 0.f;
            part2[n][e] = 0.f;
          }
#pragma unroll
        for (int c = c0; c < c0 + 2; ++c)
          grad_chunk<T, kG, kDq, false>(part1, part2, x[c], y[c], b1, b2, c, kSS, col0, gq, tq);
#pragma unroll
        for (int n = 0; n < kG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc1[n][e] += part1[n][e];
            if constexpr (!kDq) acc2[n][e] += part2[n][e];
          }
      }
    } else {
#pragma unroll
      for (int c = 0; c < kN; ++c) grad_chunk<T, kG, kDq, k2>(acc1, acc2, x[c], y[c], b1, b2, c, kSS, col0, gq, tq);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ready tiles are read; the next raw tiles have landed
  }

  // write the resident rows: dQ * scale; or dV, and dK * scale
  const long long o1_sb = kDq ? L.dq[0] : L.dv[0];
  const long long o1_ss = kDq ? L.dq[1] : L.dv[1];
  const long long o1_sh = kDq ? L.dq[2] : L.dv[2];
  const int res_len = kDq ? sq : sk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 16 * mg + gq + 8 * i;
    if (row >= res_len) continue;
    T* o1 = out1 + b * o1_sb + row * o1_ss + h * o1_sh;
    T* o2 = out2 + b * L.dk[0] + row * L.dk[1] + h * L.dk[2];
#pragma unroll
    for (int n = 0; n < kG; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * n + 2 * tq + e;
        if (col >= d) continue;
        if constexpr (kDq) {
          store(o1 + col, acc1[n][2 * i + e] * scale);
        } else {
          store(o1 + col, acc1[n][2 * i + e]);
          store(o2 + col, acc2[n][2 * i + e] * scale);
        }
      }
    }
  }
}

// The dK/dV CTAs of every (key tile, batch * head), then the dQ CTAs of every
// (query tile, batch * head), in one grid
#define UFM_BWD_ANY_PARAMS                                                                                   \
  const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v, const T *__restrict__ g,         \
      const float *__restrict__ lse, const float *__restrict__ delta, T *__restrict__ dq, T *__restrict__ dk, \
      T *__restrict__ dv, int num_heads, int sq, int sk, int d, int kv_tiles, int q_tiles, int kv_blocks,     \
      Layout L, int staging, float scale
#define UFM_BWD_ANY_ARGS \
  q, k, v, g, lse, delta, dq, dk, dv, num_heads, sq, sk, d, kv_tiles, q_tiles, kv_blocks, L, staging, scale

template <typename T, int DP>
__device__ __forceinline__ void grads_grid(UFM_BWD_ANY_PARAMS) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int x = static_cast<int>(blockIdx.x);
  if (x < kv_blocks) {
    grads_block<T, DP, false>(smem, x % kv_tiles, x / kv_tiles, q, k, v, g, lse, delta, dv, dk, num_heads, sq, sk,
                              d, L, staging, scale);
  } else {
    const int i = x - kv_blocks;
    grads_block<T, DP, true>(smem, i % q_tiles, i / q_tiles, q, k, v, g, lse, delta, dq, dq, num_heads, sq, sk, d,
                             L, staging, scale);
  }
}

// Two entries of one body. fp32, and bf16 / fp16 at DP = 128 / 256: ptxas's
// own register target (255 at DP = 64 with no spill; any minimum of blocks
// makes it spill there). bf16 / fp16 at DP = 32 / 64: a minimum of 3 CTAs an
// SM, which gives them the ~160 registers they need (at ptxas's own target,
// 128, the DP = 32 instances spill).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_any_kernel(UFM_BWD_ANY_PARAMS) {
  grads_grid<T, DP>(UFM_BWD_ANY_ARGS);
}
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 3) flash_attention_bwd_any_half_kernel(UFM_BWD_ANY_PARAMS) {
  grads_grid<T, DP>(UFM_BWD_ANY_ARGS);
}
#undef UFM_BWD_ANY_PARAMS
#undef UFM_BWD_ANY_ARGS

template <typename T, int DP>
int launch_grads(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
                 void* dq, void* dk, void* dv, int batch, int num_heads, int sq, int sk, int d, const Layout& L,
                 int staging, float scale, cudaStream_t stream) {
  using C = Tile<T, DP>;
  const auto run = [&](auto kernel) {
    static int smem_set = 0;  // devices on which this instance may use kSmemBytes
    const cudaError_t e = ufm::allow_smem(reinterpret_cast<const void*>(kernel), C::kSmemBytes, smem_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int kv_tiles = (sk + C::kBlockR - 1) / C::kBlockR;
    const int q_tiles = (sq + C::kBlockR - 1) / C::kBlockR;
    const int kv_blocks = kv_tiles * batch * num_heads;
    const dim3 grid(kv_blocks + q_tiles * batch * num_heads);
    kernel<<<grid, kThreads, C::kSmemBytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), num_heads, sq, sk, d, kv_tiles, q_tiles, kv_blocks, L, staging, scale);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (!kTwoTerms<T> && DP <= 64) {  // only the entry taken is compiled
    return run(flash_attention_bwd_any_half_kernel<T, DP>);
  } else {
    return run(flash_attention_bwd_any_kernel<T, DP>);
  }
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
  const int size = static_cast<int>(sizeof(T));
  const int staging = staging_of(q, size, batch, sq, num_heads, L.q[0], L.q[1], L.q[2], L.q[3]) |
                      staging_of(k, size, batch, sk, num_heads, L.k[0], L.k[1], L.k[2], L.k[3]) << 2 |
                      staging_of(v, size, batch, sk, num_heads, L.v[0], L.v[1], L.v[2], L.v[3]) << 4 |
                      staging_of(g, size, batch, sq, num_heads, L.g[0], L.g[1], L.g[2], L.g[3]) << 6;
  const auto grads = d <= 32 ? &launch_grads<T, 32> : d <= 64 ? &launch_grads<T, 64>
                    : d <= 128 ? &launch_grads<T, 128> : &launch_grads<T, 256>;
  return grads(q, k, v, g, lse, delta, dq, dk, dv, batch, num_heads, sq, sk, d, L, staging, scale, stream);
}

}  // namespace

// Plain C entry point for ctypes: the two kernels above, in order, on
// `stream`. `dtype` picks the element type of q, k, v, o, g, dq, dk, dv (0
// fp32, 1 bf16, 2 fp16). Input strides are in elements, any value (each of
// q, k, v, g is staged by 16-byte copies where its layout allows, else
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
