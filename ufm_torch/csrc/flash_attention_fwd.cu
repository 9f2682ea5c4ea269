// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out, head_dim 64.
//
// Replaces: ufm_tpu/ops/flash_attention.py::_flash_attention_impl and its TPU
// kernel bodies (_attn_kernel_pipe, the TPU default; _attn_kernel, the plain
// body). Same function: out = softmax(q k^T * scale) v over (B, S, H, D)
// tensors, fp32 scores and softmax, bf16 P fed to the P.V product with fp32
// accumulation, the ragged key tail masked.
//
// Design. The TPU kernel keeps the whole K/V slice of one (batch, head) in
// VMEM. At this model's info-sharing shape that slice is 2 x 2400 x 64 x 2 B
// (about 0.6 MB), far above the 227 KB of shared memory a block may use, so
// this kernel walks over K/V in 64-row tiles with an online softmax (running
// row max, rescale by exp2(m_old - m_new), normalise once at the end): the
// kv_chunks > 1 math of _attn_kernel_opt. scale * log2(e) is folded into the
// fp32 scores, not into a bf16-rounded q, which removes one rounding.
//
//   * one CTA of 4 warps per (64-row Q tile, batch * head); each warp owns 16
//     query rows and keeps its Q fragments, scores, P and O in registers;
//   * K/V tiles of 64 rows are double-buffered in shared memory with
//     cp.async (rows past S are zero-filled, so masked columns multiply zeros);
//   * both products are mma.sync m16n8k16 bf16 -> fp32; the score
//     accumulators are re-packed in registers as the A operand of P.V;
//   * q, k, v are read through their batch / sequence / head strides (the
//     main path passes views of the fused qkv projection); only D must be
//     contiguous. The output is written with its own strides;
//   * for training, a second instance also writes each row's log-sum-exp
//     (fp32, (B, H, Sq)), which flash_attention_bwd.cu reads to recompute P.
//     Inference launches the instance without it.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the kernel does
// 4 * B * H * Sq * Sk * D FLOPs and moves (3 * S * H * D + S * H * D) * 2 B
// per batch row, so at the main path's shapes it is bound by operations:
//   encoder      (2, 1201, 16, 64): 11.8 GFLOP -> 12 us; 19.7 MB -> 6 us
//   info sharing (1, 2400, 12, 64): 17.7 GFLOP -> 18 us;  14.7 MB -> 4 us
// The design keeps every score in registers (no S x S tile ever reaches
// device memory) so the bytes stay at the floor above; what separates it from
// the operation bound is mma.sync's rate next to wgmma's and the softmax work
// between the two products. wgmma, TMA and warp specialisation are the next
// steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

#include "mma_sm90.cuh"

namespace {

using namespace ufm;

constexpr int kD = 64;          // head_dim, the main path's only value
constexpr int kBlockQ = 64;     // query rows per CTA (16 per warp)
constexpr int kBlockK = 64;     // key / value rows per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;     // padded shared row (144 B): conflict-free fragment loads

// kWriteLse: also write each row's log-sum-exp (natural log, fp32) for the
// backward. Inference instantiates the kernel without it.
template <bool kWriteLse>
__global__ void __launch_bounds__(kThreads) flash_attention_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int num_heads, int sq, int sk,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float* __restrict__ lse, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 k_tile[2][kBlockK * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_tile[2][kBlockK * kLd];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group

  const int b = blockIdx.y / num_heads;
  const int h = blockIdx.y % num_heads;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  // This thread's two query rows.
  const int r0 = blockIdx.x * kBlockQ + warp * 16 + g;
  const int r1 = r0 + 8;

  // Q as four A fragments (one per 16-wide slice of D), rows past S are zero.
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + t * 2;
    qf[kk][0] = r0 < sq ? load_u32(qb + r0 * q_ss + c) : 0u;
    qf[kk][1] = r1 < sq ? load_u32(qb + r1 * q_ss + c) : 0u;
    qf[kk][2] = r0 < sq ? load_u32(qb + r0 * q_ss + c + 8) : 0u;
    qf[kk][3] = r1 < sq ? load_u32(qb + r1 * q_ss + c + 8) : 0u;
  }

  auto load_tile = [&](int stage, int kv0) {
    // 64 rows x 8 chunks of 16 B for each of K and V.
#pragma unroll
    for (int it = 0; it < kBlockK * 8 / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int row = i >> 3;
      const int chunk = (i & 7) * 8;
      const int kv = kv0 + row;
      const bool valid = kv < sk;
      const long long src = valid ? kv : 0;  // keep the address in bounds
      cp_async_16(&k_tile[stage][row * kLd + chunk], kb + src * k_ss + chunk, valid);
      cp_async_16(&v_tile[stage][row * kLd + chunk], vb + src * v_ss + chunk, valid);
    }
    cp_async_commit();
  };

  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // this thread's partial sums; reduced at the end
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  const int num_tiles = (sk + kBlockK - 1) / kBlockK;
  load_tile(0, 0);

  for (int j = 0; j < num_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < num_tiles) {
      load_tile(stage ^ 1, (j + 1) * kBlockK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = k_tile[stage];
    const __nv_bfloat16* vs = v_tile[stage];

    // S = Q K^T for this warp's 16 rows x 64 keys (8 column blocks of 8).
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kp = ks + (n * 8 + g) * kLd + kk * 16 + t * 2;
        mma_bf16_16816(s[n], qf[kk], load_u32(kp), load_u32(kp + 8));
      }
    }

    // Scale into the log2 domain, mask the key tail, running max.
    const int kv0 = j * kBlockK;
    float new_max[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + n * 8 + t * 2 + (e & 1);
        const float x = col < sk ? s[n][e] * scale_log2 : -INFINITY;
        s[n][e] = x;
        new_max[e >> 1] = fmaxf(new_max[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      new_max[r] = fmaxf(new_max[r], __shfl_xor_sync(0xffffffffu, new_max[r], 1));
      new_max[r] = fmaxf(new_max[r], __shfl_xor_sync(0xffffffffu, new_max[r], 2));
      // The first tile always holds key 0, so new_max is finite from here on
      // and exp2(-inf) = 0 clears the empty accumulators.
      alpha[r] = exp2f(row_max[r] - new_max[r]);
      row_max[r] = new_max[r];
    }

    // P = exp2(S - max), packed straight into the A fragments of P.V.
    uint32_t pf[4][4];
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f(s[n][0] - new_max[0]);
      const float p1 = exp2f(s[n][1] - new_max[0]);
      const float p2 = exp2f(s[n][2] - new_max[1]);
      const float p3 = exp2f(s[n][3] - new_max[1]);
      tile_sum[0] += p0 + p1;
      tile_sum[1] += p2 + p3;
      // column block n covers keys 8n..8n+7: the low (n even) or high (n odd)
      // half of k-step n / 2
      pf[n >> 1][(n & 1) * 2 + 0] = pack_bf16x2(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) row_sum[r] = row_sum[r] * alpha[r] + tile_sum[r];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: B[k][n] = V[key k][dim n]; each B register joins two keys.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* vp = vs + (kk * 16 + t * 2) * kLd + n * 8 + g;
        const uint32_t b0 = join_u16(vp, vp + kLd);
        const uint32_t b1 = join_u16(vp + 8 * kLd, vp + 9 * kLd);
        mma_bf16_16816(acc[n], pf[kk], b0, b1);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_sum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    if (kWriteLse && t == 0) {
      // log sum_j exp(s_ij * scale) = (max + log2(sum)) * ln 2, in the
      // log2 domain of the scores above
      const int row = r == 0 ? r0 : r1;
      if (row < sq) lse[static_cast<long long>(blockIdx.y) * sq + row] = (row_max[r] + log2f(l)) * 0.6931471805599453f;
    }
  }
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + t * 2;
    if (r0 < sq) {
      *reinterpret_cast<uint32_t*>(ob + r0 * o_ss + c) = pack_bf16x2(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    }
    if (r1 < sq) {
      *reinterpret_cast<uint32_t*>(ob + r1 * o_ss + c) = pack_bf16x2(acc[n][2] * inv[1], acc[n][3] * inv[1]);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Strides are in elements; D (= 64) must be
// contiguous and every row 16-byte aligned (the wrapper checks both). `lse`
// is null (inference) or a contiguous fp32 (B, H, Sq) buffer that receives
// each row's log-sum-exp of the scaled scores (training: the backward's
// input). Launches on `stream` and returns cudaGetLastError().
extern "C" int ufm_flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                                            int batch, int num_heads, int sq, int sk, long long q_sb, long long q_ss,
                                            long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                            long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                                            long long o_ss, long long o_sh, float scale, void* stream) {
  const float kLog2e = 1.4426950408889634f;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * num_heads);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lp == nullptr) {
    flash_attention_fwd_kernel<false><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, num_heads, sq, sk, q_sb, q_ss, q_sh,
                                                                 k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                                                                 nullptr, scale * kLog2e);
  } else {
    flash_attention_fwd_kernel<true><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, num_heads, sq, sk, q_sb, q_ss, q_sh,
                                                                k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                                                                lp, scale * kLog2e);
  }
  return static_cast<int>(cudaGetLastError());
}
