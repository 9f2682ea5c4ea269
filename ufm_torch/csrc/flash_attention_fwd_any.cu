// Flash-attention forward for Hopper (sm_90a) over the TPU kernel's whole
// domain: q, k, v in fp32, bf16 or fp16, any head dim from 1 to 256, any Sq
// and Sk >= 1, read in place through four element strides each.
//
// Replaces: ufm_tpu/ops/flash_attention.py::_flash_attention_impl (:558) and
// its TPU kernel bodies, for every dtype and head dim the port's wgmma
// kernel (flash_attention_fwd.cu: bf16 with D = 64 only) does not take. The
// TPU kernel passes (B*H, S, D) blocks of the input's dtype to one
// pallas_call whatever D is; here the fp32 models (compute_dtype="float32",
// the repository's tiny anchors at D = 32 / 24, its trained checkpoint),
// bf16 models at D != 64 and fp16 take this kernel. Same function: out = softmax(q
// k^T * scale) v over (B, S, H, D), fp32 scores, fp32 online softmax
// statistics, the output in the input dtype, and each row's natural-log
// log-sum-exp in fp32 (B, H, Sq) when asked (the layout flash_attention_bwd
// reads).
//
// Arithmetic: both products on the tensor cores, mma.sync.m16n8k8 with TF32
// operands under the term rule of attention_mma.cuh. fp32: S = Q K^T and O
// += P V in 3xTF32 (three mma a k-step), fp32's accuracy. bf16 / fp16: S in
// one mma (both operands exact in TF32), P V in two (P in two terms against
// the exact V), so P keeps fp32's accuracy and each output element lies
// within one ulp of its type. The softmax is exp / log in fp32 (expf, logf).
//
// Design. One CTA per (block of query rows, batch * head), 16 rows a warp (8
// warps at DP <= 64, 4 above), walks the keys in tiles of kBlockK (64 / 64 /
// 32 / 16 keys at DP = 32 / 64 / 128 / 256, D zero-padded to DP, a template
// argument):
//   * the Q block and a ring of two K / V tiles live in shared memory in the
//     inputs' type; the next tile's copy (cp.async, 16 bytes a copy where D
//     is contiguous and the rows 16-byte aligned, else 4 bytes a copy for
//     fp32) is issued before this tile's products, so it overlaps them.
//     bf16 / fp16 layouts that cp.async cannot take are staged by plain
//     loads; rows past S and columns past D are zero;
//   * S for the warp's 16 rows x kBlockK keys stays in mma accumulators; the
//     online softmax runs on them (row max and sum over the 4 lanes of a
//     quad, keys past Sk score -inf, alpha = exp(m_old - m_new)), and P
//     feeds P V from the same registers (a_from_acc, V read in key order):
//     P never goes through shared memory;
//   * each tile's P V is summed in fresh accumulators and added to O in
//     fp32 (attention_mma.cuh, Sums), chunk by chunk so that consecutive
//     mma are independent;
//   * fragments are read from the staged tiles and split by the warp that
//     reads them.

// Bound on an H100 SXM: 4 B H Sq Sk D operations (two products) against q,
// k, v read once and the output written once at 3.35 TB/s. fp32's
// operations at 3xTF32 on the tensor cores (3 x 4 B H Sq Sk D at 495
// TFLOP/s, i.e. 165 TFLOP/s of fp32 work); bf16 / fp16 at the card's 989
// TFLOP/s for those types. The flagship in fp32:
//   encoder      (2, 1201, 16, 64): 11.8 GFLOP -> 71.6 us; 39.4 MB -> 12 us
//   info sharing (1, 2400, 12, 64): 17.7 GFLOP -> 107 us;  29.5 MB ->  9 us
// so it is bound by operations. What holds it back (PERF.md, row 1b):
// mma.sync reaches the TF32 rate only in part (wgmma alone reaches all of
// it, and its TF32 form needs V transposed as it is staged); every warp
// splits the K and V values it reads (cvt.rna.tf32.f32 is four SASS
// instructions); at DP = 64, 8 warps an SM (one 256-thread CTA by
// registers) leave the mma latency poorly hidden.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "attention_mma.cuh"
#include "sm90_async.cuh"

namespace {

using namespace ufm_mma;

template <typename T, int DP>
struct Tile {
  static constexpr int kThreads = DP <= 64 ? 256 : 128;               // 16 query rows a warp
  static constexpr int kBlockQ = kThreads / 2;
  static constexpr int kBlockK = DP <= 64 ? 64 : DP == 128 ? 32 : 16;  // keys a tile
  static constexpr int kStride = DP + kPad<T>;                         // elements a staged row
  static constexpr int kQElems = kBlockQ * kStride;
  static constexpr int kKvElems = kBlockK * kStride;
  static constexpr int kSmemBytes = (kQElems + 4 * kKvElems) * static_cast<int>(sizeof(T));  // Q, 2 x (K, V)
};

template <typename T, int DP>
__global__ void __launch_bounds__(Tile<T, DP>::kThreads) flash_attention_fwd_any_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, int num_heads, int sq, int sk, int d, long long q_sb, long long q_ss, long long q_sh,
    long long q_sd, long long k_sb, long long k_ss, long long k_sh, long long k_sd, long long v_sb, long long v_ss,
    long long v_sh, long long v_sd, long long o_sb, long long o_ss, long long o_sh, int staging, float scale) {
  using C = Tile<T, DP>;
  constexpr bool k2 = kTwoTerms<T>;
  constexpr int kThreads = C::kThreads;
  constexpr int kN = C::kBlockK / 8;  // 8-key chunks a tile
  constexpr int kD = DP / 8;          // k-steps of S, 8-column tiles of O
  constexpr int kGroup = kD < 8 ? kD : 8;
  constexpr int kS = C::kStride;
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* ring = qs + C::kQElems;  // stage s: K at ring + 2 s kKvElems, V after it

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int q0 = blockIdx.x * C::kBlockQ;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int q_how = staging & 3;
  const int k_how = (staging >> 2) & 3;
  const int v_how = (staging >> 4) & 3;

  const auto stage_kv = [&](int tile, int s) {
    T* ks = ring + 2 * s * C::kKvElems;
    stage<DP, kThreads>(ks, kS, kb, k_ss, k_sd, tile * C::kBlockK, sk, C::kBlockK, d, k_how);
    stage<DP, kThreads>(ks + C::kKvElems, kS, vb, v_ss, v_sd, tile * C::kBlockK, sk, C::kBlockK, d, v_how);
  };
  stage<DP, kThreads>(qs, kS, qb, q_ss, q_sd, q0, sq, C::kBlockQ, d, q_how);
  stage_kv(0, 0);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of the warp
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  float acc[kD][4];
#pragma unroll
  for (int n = 0; n < kD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const T* qw = qs + 16 * warp * kS;
  const int num_tiles = (sk + C::kBlockK - 1) / C::kBlockK;
  for (int it = 0; it < num_tiles; ++it) {
    if (it + 1 < num_tiles) {
      stage_kv(it + 1, (it + 1) & 1);  // its stage was consumed before the last barrier of tile it - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = ring + 2 * (it & 1) * C::kKvElems;
    const T* vs = ks + C::kKvElems;
    const int k0 = it * C::kBlockK;

    // S = Q K^T for the warp's 16 rows and the tile's keys, D summed in
    // groups of 64 columns (attention_mma.cuh, Sums)
    float s[kN][4];
#pragma unroll
    for (int kk0 = 0; kk0 < kD; kk0 += kGroup) {
      float part[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
      for (int kk = kk0; kk < kk0 + kGroup; ++kk) {
        FragA a;
        load_a<T>(a, qw + 8 * kk, kS, g, t);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          FragB bf;
          load_b<T>(bf, ks + (8 * j + g) * kS + 8 * kk + t, 4);
          mma_terms<k2, k2>(part[j], a, bf);
        }
      }
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = kk0 == 0 ? part[j][e] : s[j][e] + part[j][e];
    }

    // online softmax on the accumulators: element e of chunk j is row g + 8
    // (e / 2), key k0 + 8 j + 2 t + e % 2; only the last tile has keys past Sk
    const bool ragged = k0 + C::kBlockK > sk;
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[j][2 * i + c] * scale;
          if (ragged && k0 + 8 * j + 2 * t + c >= sk) x = -INFINITY;
          s[j][2 * i + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);  // finite: every tile has a key below sk
      alpha[i] = expf(m[i] - m_new);        // 0 on the first tile
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(s[j][2 * i + c] - m_new);
          s[j][2 * i + c] = p;
          sum += p;
        }
      l[i] = l[i] * alpha[i] + sum;
    }

    // O = O alpha + P V, P (two terms) from the accumulators, V's rows in key
    // order: the tile's keys summed in fresh accumulators, then added to O in
    // fp32 (round to nearest; see attention_mma.cuh, Sums). Chunk by chunk,
    // the 8-column tiles' mma are independent of each other.
    float part[kD][4];
#pragma unroll
    for (int n = 0; n < kD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
    const T* vrow = vs + 2 * t * kS + g;
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      FragA pa;
      a_from_acc<true>(pa, s[c]);
#pragma unroll
      for (int n = 0; n < kD; ++n) {
        FragB bf;
        load_b<T>(bf, vrow + 8 * c * kS + 8 * n, kS);
        mma_terms<true, k2>(part[n], pa, bf);
      }
    }
#pragma unroll
    for (int n = 0; n < kD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], alpha[e / 2], part[n][e]);
    __syncthreads();  // this stage is consumed: tile it + 2 may land in it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = q0 + 16 * warp + g + 8 * i;
    if (row >= sq) continue;
    if (lse != nullptr && t == 0) lse[static_cast<long long>(bh) * sq + row] = m[i] + logf(sum);
    T* orow = o + b * o_sb + h * o_sh + row * o_ss;
#pragma unroll
    for (int n = 0; n < kD; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < d) store(orow + col, acc[n][2 * i] / sum);
      if (col + 1 < d) store(orow + col + 1, acc[n][2 * i + 1] / sum);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int num_heads, int sq, int sk,
           int d, const long long* st, int staging, float scale, cudaStream_t stream) {
  using C = Tile<T, DP>;
  static int smem_set = 0;  // devices on which this instance may use kSmemBytes
  const void* fn = reinterpret_cast<const void*>(flash_attention_fwd_any_kernel<T, DP>);
  const cudaError_t e = ufm::allow_smem(fn, C::kSmemBytes, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sq + C::kBlockQ - 1) / C::kBlockQ, batch * num_heads);
  flash_attention_fwd_any_kernel<T, DP><<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), num_heads, sq, sk, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], staging, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int num_heads, int sq,
                 int sk, int d, const long long* st, float scale, cudaStream_t stream) {
  const int size = static_cast<int>(sizeof(T));
  const int staging = staging_of(q, size, batch, sq, num_heads, st[0], st[1], st[2], st[3]) |
                      staging_of(k, size, batch, sk, num_heads, st[4], st[5], st[6], st[7]) << 2 |
                      staging_of(v, size, batch, sk, num_heads, st[8], st[9], st[10], st[11]) << 4;
  const auto run = d <= 32 ? &launch<T, 32> : d <= 64 ? &launch<T, 64> : d <= 128 ? &launch<T, 128> : &launch<T, 256>;
  return run(q, k, v, o, lse, batch, num_heads, sq, sk, d, st, staging, scale, stream);
}

}  // namespace

// Plain C entry point for ctypes. `dtype` picks the element type of q, k, v
// and o (0 fp32, 1 bf16, 2 fp16). Strides are in elements, any value (each
// tensor is staged by 16-byte copies where its layout allows, else element by
// element); o is written through its B, S and H strides with D contiguous.
// `lse` is null or a contiguous fp32 (B, H, Sq) buffer. The wrapper checks
// 1 <= d <= 256, sq, sk >= 1 and batch * num_heads <= 65535. Launches on
// `stream`; returns 0 or a cudaError_t.
extern "C" int ufm_flash_attention_fwd_any(const void* q, const void* k, const void* v, void* o, void* lse,
                                           int dtype, int batch, int num_heads, int sq, int sk, int d,
                                           long long q_sb, long long q_ss, long long q_sh, long long q_sd,
                                           long long k_sb, long long k_ss, long long k_sh, long long k_sd,
                                           long long v_sb, long long v_ss, long long v_sh, long long v_sd,
                                           long long o_sb, long long o_ss, long long o_sh, float scale,
                                           void* stream) {
  if (d < 1 || d > 256 || sq < 1 || sk < 1 || dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[15] = {q_sb, q_ss, q_sh, q_sd, k_sb, k_ss, k_sh, k_sd, v_sb, v_ss, v_sh, v_sd, o_sb, o_ss, o_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_dtype<__nv_bfloat16>(q, k, v, o, lse, batch, num_heads, sq, sk, d, st, scale, s);
  if (dtype == 2) return launch_dtype<__half>(q, k, v, o, lse, batch, num_heads, sq, sk, d, st, scale, s);
  return launch_dtype<float>(q, k, v, o, lse, batch, num_heads, sq, sk, d, st, scale, s);
}
