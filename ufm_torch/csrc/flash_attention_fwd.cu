// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out, head_dim 64.
//
// Replaces: ufm_tpu/ops/flash_attention.py::_flash_attention_impl and its TPU
// kernel bodies (_attn_kernel_pipe, the TPU default; _attn_kernel, the plain
// body). Same function: out = softmax(q k^T * scale) v over (B, S, H, D)
// tensors, fp32 scores and softmax, bf16 P fed to the P.V product with fp32
// accumulation, the ragged key tail masked.
//
// Design. The TPU kernel keeps the whole K/V slice of one (batch, head) in
// VMEM (0.6 MB at S = 2400), far above the 227 KB a Hopper block may use, so
// this kernel walks over K/V in 128-row tiles with an online softmax (running
// row max, rescale by exp2(m_old - m_new), normalise once at the end): the
// kv_chunks > 1 math of _attn_kernel_opt. scale * log2(e) is folded into the
// fp32 scores, not into a bf16-rounded q.
//
// One CTA of three warpgroups per (128-row Q tile, batch * head):
//   * warpgroup 0 is the producer (setmaxnreg down to 40): one thread loads
//     the Q tile once, then walks the K/V tiles through a ring of kStages
//     shared-memory stages with TMA (full / empty mbarriers). The tensor maps
//     cover the strided q, k, v views in place (the main path passes views of
//     the fused qkv projection); rows past S arrive as zeros;
//   * warpgroups 1 and 2 are consumers (setmaxnreg up to 232), 64 query rows
//     each. S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//     (K-major); the softmax runs on the accumulator registers (row max and
//     sum over the 4 threads of a quad); P is packed to bf16 in registers and
//     is the register A operand of O += P V, wgmma m64n64k16 with V as
//     transposed B. Keys past Sk score -inf (a zero-filled K row scores 0);
//   * the output (and, for training, each row's natural-log log-sum-exp in
//     fp32 (B, H, Sq), read by flash_attention_bwd.cu) is written from the
//     registers, rows past Sq skipped.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * B * H * Sq *
// Sk * D FLOPs against q, k, v read once and the output written once:
//   encoder      (2, 1201, 16, 64): 11.8 GFLOP -> 12 us; 19.7 MB -> 6 us
//   info sharing (1, 2400, 12, 64): 17.7 GFLOP -> 18 us;  14.7 MB -> 4 us
// so it is bound by operations: the design keeps every score in registers
// and feeds the tensor cores with wgmma from TMA-filled tiles.
//
// Tiles and waves (132 SMs). A CTA holds Q (16 KB) and three K/V stages of
// 32 KB: 112 KB of shared memory and 384 threads at up to 168 registers, so
// one CTA per SM. Per call: encoder 10 x 32 = 320 CTAs (2.4 waves), info
// sharing 19 x 12 = 228 (1.7 waves). 64-row CTAs would halve the tail of the
// last wave but give each K/V tile to one consumer warpgroup only, twice the
// shared-memory and L2 traffic per product.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "sm90_async.cuh"

namespace {

using namespace ufm;

constexpr int kD = 64;                          // head_dim, the main path's only value
constexpr int kConsumers = 2;                   // consumer warpgroups, 64 query rows each
constexpr int kBlockQ = 64 * kConsumers;        // query rows per CTA
constexpr int kBlockK = 128;                    // key / value rows per stage
constexpr int kStages = 3;                      // K/V ring depth
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBox = 64;                        // rows per TMA box
constexpr int kBoxBytes = kBox * kD * 2;        // 8 KB
constexpr int kQBytes = kBlockQ * kD * 2;       // 16 KB
constexpr int kKvBytes = kBlockK * kD * 2;      // 16 KB for each of K and V
constexpr int kSmemBytes = 1024 + kQBytes + kStages * 2 * kKvBytes + (1 + 2 * kStages) * 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 40 * 128 + 232 * 256 = 168 * 384
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kKSteps = kBlockK / 16;  // k-steps of P V

// S = Q K^T for one stage: 64 query rows x 128 keys, both from shared memory.
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint64_t q_desc, uint64_t k_desc) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wgmma_ss_n128<0>(sc, q_desc + kk * kKStepKMajor, k_desc + kk * kKStepKMajor, kk > 0);
  }
  wgmma_commit();
}

// O = O * alpha + P V, P in registers, V as transposed B (rows are keys).
__device__ __forceinline__ void issue_pv(float (&acc)[32], const float (&alpha)[2], const uint32_t (&pa)[kKSteps][4],
                                         uint64_t v_desc) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) wgmma_rs_n64<1>(acc, pa[kk], v_desc + kk * kKStepMnMajor, 1);
  wgmma_commit();
}

// The online softmax of one score tile (keys kv0 .. kv0 + 127) on the
// accumulator registers: keys past Sk score -inf, the running max and sum
// of this thread's two rows move on, `alpha` is the rescale of O that must
// precede this tile's P V, and P = exp2(S * scale * log2 e - max) is packed
// to bf16 as the register A of P V.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], uint32_t (&pa)[kKSteps][4], float (&row_max)[2],
                                             float (&row_sum)[2], float (&alpha)[2], int kv0, int sk, int t,
                                             float scale_log2) {
  if (kv0 + kBlockK > sk) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (kv0 + 8 * (i / 4) + 2 * t + (i & 1) >= sk) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};  // of the raw scores: scale > 0
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float neg_max[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // The first tile always holds key 0, so the max is finite from there on
    // and exp2(-inf) = 0 clears the empty accumulators.
    const float m_new = fmaxf(row_max[r], mx[r] * scale_log2);
    alpha[r] = fast_exp2(row_max[r] - m_new);
    row_max[r] = m_new;
    neg_max[r] = -m_new;
  }
  float tile_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = fast_exp2(fmaf(sc[i], scale_log2, neg_max[r]));
    tile_sum[r] += sc[i];
  }
  pack_a_frags<kKSteps>(pa, sc);
#pragma unroll
  for (int r = 0; r < 2; ++r) row_sum[r] = row_sum[r] * alpha[r] + tile_sum[r];
}

// kWriteLse: also write each row's log-sum-exp (natural log, fp32) for the
// backward. Inference instantiates the kernel without it.
template <bool kWriteLse>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int num_heads, int sq, int sk,
    long long o_sb, long long o_ss, long long o_sh, float* __restrict__ lse, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_smem = align_1024(smem_raw);
  uint8_t* kv_smem = q_smem + kQBytes;  // stage s: K at s * 2 * kKvBytes, V right after
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_smem + kStages * 2 * kKvBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int wg = threadIdx.x / 128;
  const int b = blockIdx.y / num_heads;
  const int h = blockIdx.y % num_heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int num_tiles = (sk + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&tm_q);
      prefetch_tensor_map(&tm_k);
      prefetch_tensor_map(&tm_v);
      mbar_arrive_expect_tx(q_full, kQBytes);
      for (int r = 0; r < kBlockQ / kBox; ++r) tma_load_4d(q_smem + r * kBoxBytes, &tm_q, q_full, 0, h, q0 + r * kBox, b);
      for (int j = 0; j < num_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKvBytes);
        uint8_t* ks = kv_smem + s * 2 * kKvBytes;
        for (int r = 0; r < kBlockK / kBox; ++r) {
          const int row = j * kBlockK + r * kBox;
          tma_load_4d(ks + r * kBoxBytes, &tm_k, &full[s], 0, h, row, b);
          tma_load_4d(ks + kKvBytes + r * kBoxBytes, &tm_v, &full[s], 0, h, row, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int t = lane % 4;
    const int r0 = q0 + cw * 64 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
    const uint64_t q_desc = sw128_desc(q_smem + cw * 64 * kD * 2);

    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};
    float alpha[2];
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);
    for (int j = 0; j < num_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      const uint8_t* ks = kv_smem + s * 2 * kKvBytes;
      float sc[64];
      issue_scores(sc, q_desc, sw128_desc(ks));
      wgmma_wait<0>();
      fence_regs(sc);
      uint32_t pa[kKSteps][4];
      softmax_tile(sc, pa, row_max, row_sum, alpha, j * kBlockK, sk, t, scale_log2);
      issue_pv(acc, alpha, pa, sw128_desc(ks + kKvBytes));
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = row_sum[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / l;
      const int row = r0 + 8 * r;
      if (kWriteLse && t == 0 && row < sq) {
        // log sum_j exp(s_ij * scale) = (max + log2(sum)) * ln 2
        lse[static_cast<long long>(blockIdx.y) * sq + row] = (row_max[r] + log2f(l)) * kLn2;
      }
    }
    __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int c = 8 * n + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < sq) {
          *reinterpret_cast<uint32_t*>(ob + row * o_ss + c) =
              pack_bf16x2(acc[4 * n + 2 * r] * inv[r], acc[4 * n + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

int smem_set_fwd[2] = {0, 0};  // devices on which each instance may use kSmemBytes

}  // namespace

// Plain C entry point for ctypes. Strides are in elements; D (= 64) must be
// contiguous, the base 16-byte aligned and every other stride a multiple of
// 16 bytes (TMA's conditions; the wrapper checks them). `lse` is null
// (inference) or a contiguous fp32 (B, H, Sq) buffer that receives each row's
// log-sum-exp of the scaled scores (training: the backward's input).
// Launches on `stream`; returns 0, a cudaError_t, or a kErr* code of
// sm90_async.cuh when a tensor map cannot be made.
extern "C" int ufm_flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                                            int batch, int num_heads, int sq, int sk, long long q_sb, long long q_ss,
                                            long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                            long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                                            long long o_ss, long long o_sh, float scale, void* stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode_bshd_map(&tm_q, q, batch, sq, num_heads, q_sb, q_ss, q_sh, kBox);
  if (err == 0) err = encode_bshd_map(&tm_k, k, batch, sk, num_heads, k_sb, k_ss, k_sh, kBox);
  if (err == 0) err = encode_bshd_map(&tm_v, v, batch, sk, num_heads, v_sb, v_ss, v_sh, kBox);
  if (err != 0) return err;

  const float kLog2e = 1.4426950408889634f;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * num_heads);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lp == nullptr) {
    const cudaError_t e = allow_smem(reinterpret_cast<const void*>(flash_attention_fwd_kernel<false>), kSmemBytes,
                                     smem_set_fwd[0]);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_attention_fwd_kernel<false><<<grid, kThreads, kSmemBytes, st>>>(
        tm_q, tm_k, tm_v, op, num_heads, sq, sk, o_sb, o_ss, o_sh, nullptr, scale * kLog2e);
  } else {
    const cudaError_t e = allow_smem(reinterpret_cast<const void*>(flash_attention_fwd_kernel<true>), kSmemBytes,
                                     smem_set_fwd[1]);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_attention_fwd_kernel<true><<<grid, kThreads, kSmemBytes, st>>>(
        tm_q, tm_k, tm_v, op, num_heads, sq, sk, o_sb, o_ss, o_sh, lp, scale * kLog2e);
  }
  return static_cast<int>(cudaGetLastError());
}
