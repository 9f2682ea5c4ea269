// Flash-attention backward for Hopper (sm_90a), bf16 in / bf16 out, head_dim 64.
//
// Replaces: ufm_tpu/ops/flash_attention.py::_flash_attention_bwd_impl and its
// TPU kernel body _attn_bwd_kernel. Same function: from q, k, v, the forward's
// output o and the output gradient g (all (B, S, H, D)), with P recomputed
// from the scores,
//   dP = g v^T,  delta = rowsum(dP * P),  dS = P * (dP - delta),
//   dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T g,
// fp32 scores, P, dP and dS; P and dS rounded to bf16 as operands of the
// products (the TPU kernel's p_c / ds_c), fp32 accumulation.
//
// Design. The TPU kernel holds one (batch, head)'s whole K/V slice in VMEM per
// Q block and accumulates dk / dv across the sequential grid; neither fits a
// Hopper block (0.6 MB at S = 2400) nor carries between blocks that run in
// parallel. So this is the flash-attention-2 schedule, in two launches:
//
//   1. delta kernel: delta_i = sum_d g_id * o_id in fp32 (equal to
//      rowsum(dP * P) up to the bf16 rounding of o), one 8-thread group per row;
//   2. one grid of two kinds of CTA, the dK/dV CTAs first, then the dQ CTAs
//      (attention_grads_kernel). The two kinds are independent, so the dQ
//      CTAs fill the last wave of the dK/dV CTAs (as two launches, each left
//      up to half a wave of the card idle: at (2, 2400, 12, 64) the
//      backward took 15% longer).
//      dK/dV: one CTA per (128-row K/V tile, batch * head) walks over
//      all Q tiles. Its K and V rows stay in shared memory; the producer
//      warp streams Q and g tiles of 64 rows by TMA through a ring of kStages
//      stages, with each tile's lse and delta by plain loads that it issues
//      before it waits for the stage (so their latency hides behind the
//      wait; loaded after it, they held the kernel back by ~9%). Each consumer
//      warpgroup owns 64 keys: S^T = K Q^T and dP^T = V g^T are wgmma with
//      both operands in shared memory (K-major), P^T = exp2(S^T * scale *
//      log2 e - lse * log2 e) and dS^T = P^T (dP^T - delta) stay in registers
//      and are the register A operands of dV += P^T g and dK += dS^T Q (g and
//      Q as transposed B);
//      dQ: one CTA per (128-row Q tile, batch * head), the forward's
//      layout: Q and g stay in shared memory, K/V tiles of 64 rows stream
//      through the ring; S = Q K^T, dP = g V^T, and dQ += dS K with K as
//      transposed B.
// No atomics: each output element is written once by one thread, so the
// result is deterministic. Rows past S arrive as zeros from TMA (their lse is
// taken as +inf, so P = 0) and are never written; keys past Sk are masked in
// the dQ kernel.
//
// Warp specialisation: warpgroup 0 produces (setmaxnreg down to 40), the two
// consumer warpgroups go up to 232 registers (40 * 128 + 232 * 256 = 168 *
// 384), one CTA per SM. Tiles and waves (132 SMs): 128 rows per CTA give
// encoder (4, 1201, 16, 64) 10 x 64 = 640 CTAs of each kind (9.7 waves in
// all) and info sharing (2, 2400, 12, 64) 19 x 24 = 456 of each (6.9 waves).
// The streamed tiles are 64 rows because each consumer holds two 64 x 64
// fp32 products (S^T, dP^T or S, dP) beside one or two 64 x 64
// accumulators; 128-row K/V tiles in the dQ CTAs (m64n128 scores, 192 live
// registers) measured 20% slower on the whole backward.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 10 * B * H * Sq *
// Sk * D FLOPs (the TPU kernel's CostEstimate: five S x S x D products) against
// q, k, v, o, g read once, dq, dk, dv written once, plus lse and delta:
//   encoder      (4, 1201, 16, 64): 59.1 GFLOP -> 60 us; 79 MB -> 24 us
//   info sharing (2, 2400, 12, 64): 88.5 GFLOP -> 89 us; 59 MB -> 18 us
// so it is bound by operations. The dK/dV and the dQ CTAs each recompute S
// and dP: 7 products where the bound counts 5. One fused pass with fp32 atomics
// for dQ would drop those two, at the price of determinism.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "sm90_async.cuh"

namespace {

using namespace ufm;

constexpr int kD = 64;                      // head_dim, the main path's only value
constexpr int kConsumers = 2;               // consumer warpgroups, 64 resident rows each
constexpr int kBlockRes = 64 * kConsumers;  // resident rows per CTA (keys in dK/dV, queries in dQ)
constexpr int kBlockStream = 64;            // streamed rows per stage (one TMA box)
constexpr int kStages = 4;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kKSteps = kBlockStream / 16;  // k-steps of the gradient products
constexpr int kBox = 64;
constexpr int kBoxBytes = kBox * kD * 2;           // 8 KB
constexpr int kResBytes = kBlockRes * kD * 2;      // 16 KB for each resident operand
constexpr int kStreamBytes = kBlockStream * kD * 2;  // 8 KB for each streamed operand
constexpr int kRowStatBytes = kStages * 2 * kBlockStream * 4;  // lse and delta of each stage (dK/dV)
constexpr int kSmemBytes = 1024 + 2 * kResBytes + kStages * 2 * kStreamBytes + kRowStatBytes + (1 + 2 * kStages) * 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// delta[(b * H + h) * S + i] = sum_d g[b, i, h, d] * o[b, i, h, d]: eight
// threads per row, 8 bf16 (16 B) each, reduced with shuffles.
__global__ void __launch_bounds__(256) attention_delta_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ g, float* __restrict__ delta,
    int num_heads, int s, long long rows, long long o_sb, long long o_ss, long long o_sh, long long g_sb,
    long long g_ss, long long g_sh) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  float acc = 0.f;
  if (row < rows) {
    const long long bh = row / s;
    const int i = static_cast<int>(row - bh * s);
    const int b = static_cast<int>(bh / num_heads);
    const int h = static_cast<int>(bh - static_cast<long long>(b) * num_heads);
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * o_sb + i * o_ss + h * o_sh + part * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + b * g_sb + i * g_ss + h * g_sh + part * 8);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(op[e]);
      const float2 gf = __bfloat1622float2(gp[e]);
      acc += of.x * gf.x + of.y * gf.y;
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < rows && part == 0) delta[row] = acc;
}

// Shared-memory plan of both output kernels, carved from a 1024-byte aligned
// base: two resident 128-row operands, kStages pairs of streamed 64-row
// operands, the dK/dV kernel's per-stage lse / delta, then the barriers.
struct Plan {
  uint8_t* res_a;     // K (dK/dV) or Q (dQ)
  uint8_t* res_b;     // V (dK/dV) or g (dQ)
  uint8_t* stream;    // stage s: first operand at s * 2 * kStreamBytes, the second right after
  float* lse2;        // stage s: 64 values at s * 2 * kBlockStream, then delta
  uint64_t* res_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit Plan(uint8_t* raw) {
    res_a = align_1024(raw);
    res_b = res_a + kResBytes;
    stream = res_b + kResBytes;
    lse2 = reinterpret_cast<float*>(stream + kStages * 2 * kStreamBytes);
    res_full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(lse2) + kRowStatBytes);
    full = res_full + 1;
    empty = full + kStages;
  }
  __device__ uint8_t* first(int s) const { return stream + s * 2 * kStreamBytes; }
  __device__ uint8_t* second(int s) const { return stream + s * 2 * kStreamBytes + kStreamBytes; }
};

__device__ __forceinline__ void init_barriers(const Plan& p, uint32_t full_arrivals) {
  if (threadIdx.x == 0) {
    mbar_init(p.res_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&p.full[s], full_arrivals);
      mbar_init(&p.empty[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();
}

// The resident operands: rows row0 .. row0 + 127 of two maps, on res_full.
__device__ __forceinline__ void load_resident(const Plan& p, const CUtensorMap* ma, const CUtensorMap* mb, int h,
                                              int row0, int b) {
  mbar_arrive_expect_tx(p.res_full, 2 * kResBytes);
  for (int r = 0; r < kBlockRes / kBox; ++r) {
    tma_load_4d(p.res_a + r * kBoxBytes, ma, p.res_full, 0, h, row0 + r * kBox, b);
    tma_load_4d(p.res_b + r * kBoxBytes, mb, p.res_full, 0, h, row0 + r * kBox, b);
  }
}

// Rows row0, row0 + 8 of a 64 x 64 fp32 accumulator times `mul` as bf16 into
// a (B, S, H, D) tensor's (b, h) slice; rows past S are skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ss, const float (&acc)[32], float mul,
                                           int row0, int s, int t) {
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < s) {
        *reinterpret_cast<uint32_t*>(base + row * ss + c) =
            pack_bf16x2(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
      }
    }
  }
}

struct Strides {
  long long sb, ss, sh;
};

// dK and dV of one 128-row K/V tile: a loop over every 64-row Q tile.
__device__ __forceinline__ void dkdv_block(
    uint8_t* smem_raw, int tile, int bh, const CUtensorMap* tm_q, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const CUtensorMap* tm_g,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int num_heads, int sq, int sk, Strides dks, Strides dvs, float scale,
    float scale_log2) {
  const Plan p(smem_raw);
  const int wg = threadIdx.x / 128;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int k0 = tile * kBlockRes;
  const int num_tiles = (sq + kBlockStream - 1) / kBlockStream;
  init_barriers(p, 32);  // the producer warp's 32 lanes arrive on `full`

  if (wg == 0) {
    // ---- producer: warp 0; lane 0 issues the TMA loads, every lane copies lse / delta
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        prefetch_tensor_map(tm_q);
        prefetch_tensor_map(tm_g);
        load_resident(p, tm_k, tm_v, h, k0, b);
      }
      const float* lse_bh = lse + static_cast<long long>(bh) * sq;
      const float* delta_bh = delta + static_cast<long long>(bh) * sq;
      for (int j = 0; j < num_tiles; ++j) {
        const int s = j % kStages;
        // this tile's lse and delta, loaded before the wait for the stage so
        // that their latency hides behind it
        float l2[kBlockStream / 32], dl[kBlockStream / 32];
#pragma unroll
        for (int e = 0; e < kBlockStream / 32; ++e) {
          const int row = j * kBlockStream + 32 * e + lane;
          l2[e] = row < sq ? lse_bh[row] * kLog2e : INFINITY;  // queries past Sq: P = 0
          dl[e] = row < sq ? delta_bh[row] : 0.f;
        }
        if (j >= kStages) mbar_wait(&p.empty[s], ((j / kStages) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&p.full[s], 2 * kStreamBytes);
          tma_load_4d(p.first(s), tm_q, &p.full[s], 0, h, j * kBlockStream, b);
          tma_load_4d(p.second(s), tm_g, &p.full[s], 0, h, j * kBlockStream, b);
        }
        float* stat = p.lse2 + s * 2 * kBlockStream;
#pragma unroll
        for (int e = 0; e < kBlockStream / 32; ++e) {
          stat[32 * e + lane] = l2[e];
          stat[kBlockStream + 32 * e + lane] = dl[e];
        }
        mbar_arrive(&p.full[s]);  // after this lane's stores
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int t = lane % 4;
    const int kr0 = k0 + cw * 64 + warp * 16 + lane / 4;  // this thread's keys: kr0 and kr0 + 8
    const uint64_t k_desc = sw128_desc(p.res_a + cw * 64 * kD * 2);
    const uint64_t v_desc = sw128_desc(p.res_b + cw * 64 * kD * 2);

    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
    float st[32], dpt[32];                // S^T and dP^T of the newest Q tile
    uint32_t pa[kKSteps][4], da[kKSteps][4];  // P^T and dS^T of the tile before it

    // S^T = K Q^T and dP^T = V g^T: 64 keys x 64 queries each, A and B from
    // shared memory
    auto issue_scores = [&](int j) {
      const uint64_t q_desc = sw128_desc(p.first(j % kStages));
      const uint64_t g_desc = sw128_desc(p.second(j % kStages));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64<0>(st, k_desc + kk * kKStepKMajor, q_desc + kk * kKStepKMajor, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64<0>(dpt, v_desc + kk * kKStepKMajor, g_desc + kk * kKStepKMajor, kk > 0);
      }
      wgmma_commit();
    };
    // dV += P^T g and dK += dS^T Q, g and Q as transposed B (rows are queries)
    auto issue_grads = [&](int j) {
      const uint64_t q_desc = sw128_desc(p.first(j % kStages));
      const uint64_t g_desc = sw128_desc(p.second(j % kStages));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) wgmma_rs_n64<1>(dv_acc, pa[kk], g_desc + kk * kKStepMnMajor, 1);
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) wgmma_rs_n64<1>(dk_acc, da[kk], q_desc + kk * kKStepMnMajor, 1);
      wgmma_commit();
    };
    // this warp is done with Q tile j: its grads are in
    auto release_tile = [&](int j) {
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&p.empty[j % kStages]);
    };

    mbar_wait(p.res_full, 0);
    for (int j = 0; j < num_tiles; ++j) {
      mbar_wait(&p.full[j % kStages], (j / kStages) & 1);
      issue_scores(j);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      const float* stat = p.lse2 + (j % kStages) * 2 * kBlockStream;
#pragma unroll
      for (int n = 0; n < kBlockStream / 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(stat + 8 * n + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(stat + kBlockStream + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e;
          const float pv = fast_exp2(fmaf(st[i], scale_log2, -((e & 1) ? l2.y : l2.x)));
          st[i] = pv;
          dpt[i] = pv * (dpt[i] - ((e & 1) ? dl.y : dl.x));
        }
      }
      pack_a_frags<kKSteps>(pa, st);
      pack_a_frags<kKSteps>(da, dpt);
      issue_grads(j);
      release_tile(j);
    }

    store_rows(dk + b * dks.sb + h * dks.sh, dks.ss, dk_acc, scale, kr0, sk, t);
    store_rows(dv + b * dvs.sb + h * dvs.sh, dvs.ss, dv_acc, 1.f, kr0, sk, t);
  }
}

// dQ of one 128-row Q tile: a loop over every 64-row K/V tile.
__device__ __forceinline__ void dq_block(
    uint8_t* smem_raw, int tile, int bh, const CUtensorMap* tm_q, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const CUtensorMap* tm_g,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int num_heads,
    int sq, int sk, Strides dqs, float scale, float scale_log2) {
  const Plan p(smem_raw);
  const int wg = threadIdx.x / 128;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int q0 = tile * kBlockRes;
  const int num_tiles = (sk + kBlockStream - 1) / kBlockStream;
  init_barriers(p, 1);

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(tm_k);
      prefetch_tensor_map(tm_v);
      load_resident(p, tm_q, tm_g, h, q0, b);
      for (int j = 0; j < num_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&p.empty[s], ((j / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&p.full[s], 2 * kStreamBytes);
        tma_load_4d(p.first(s), tm_k, &p.full[s], 0, h, j * kBlockStream, b);
        tma_load_4d(p.second(s), tm_v, &p.full[s], 0, h, j * kBlockStream, b);
      }
    }
  } else {
    // ---- consumers: 64 queries per warpgroup
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int t = lane % 4;
    const int r0 = q0 + cw * 64 + warp * 16 + lane / 4;  // this thread's queries: r0 and r0 + 8
    const uint64_t q_desc = sw128_desc(p.res_a + cw * 64 * kD * 2);
    const uint64_t g_desc = sw128_desc(p.res_b + cw * 64 * kD * 2);
    float neg_lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const long long at = static_cast<long long>(bh) * sq + row;
      neg_lse2[r] = row < sq ? -lse[at] * kLog2e : -INFINITY;  // rows past Sq: P = 0
      dlt[r] = row < sq ? delta[at] : 0.f;
    }

    float dq_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
    float sc[32], dp[32];     // S and dP of the newest K/V tile
    uint32_t da[kKSteps][4];  // dS of the tile before it

    // S = Q K^T and dP = g V^T: 64 queries x 64 keys each
    auto issue_scores = [&](int j) {
      const uint64_t k_desc = sw128_desc(p.first(j % kStages));
      const uint64_t v_desc = sw128_desc(p.second(j % kStages));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64<0>(sc, q_desc + kk * kKStepKMajor, k_desc + kk * kKStepKMajor, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64<0>(dp, g_desc + kk * kKStepKMajor, v_desc + kk * kKStepKMajor, kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS K, K as transposed B (rows are keys)
    auto issue_grads = [&](int j) {
      const uint64_t k_desc = sw128_desc(p.first(j % kStages));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) wgmma_rs_n64<1>(dq_acc, da[kk], k_desc + kk * kKStepMnMajor, 1);
      wgmma_commit();
    };
    auto release_tile = [&](int j) {
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&p.empty[j % kStages]);
    };

    mbar_wait(p.res_full, 0);
    for (int j = 0; j < num_tiles; ++j) {
      mbar_wait(&p.full[j % kStages], (j / kStages) & 1);
      issue_scores(j);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const int kv0 = j * kBlockStream;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int col = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
        const float pv = col < sk ? fast_exp2(fmaf(sc[i], scale_log2, neg_lse2[r])) : 0.f;
        dp[i] = pv * (dp[i] - dlt[r]);
      }
      pack_a_frags<kKSteps>(da, dp);
      issue_grads(j);
      release_tile(j);
    }

    store_rows(dq + b * dqs.sb + h * dqs.sh, dqs.ss, dq_acc, scale, r0, sq, t);
  }
}

// The dK/dV blocks of every (K/V tile, batch * head), then the dQ blocks of
// every (Q tile, batch * head), in one grid: the dQ blocks fill the last wave
// of the dK/dV blocks.
__global__ void __launch_bounds__(kThreads, 1) attention_grads_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int num_heads, int sq, int sk, int kv_tiles,
    int q_tiles, int kv_blocks, Strides dqs, Strides dks, Strides dvs, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  if (static_cast<int>(blockIdx.x) < kv_blocks) {
    dkdv_block(smem_raw, blockIdx.x % kv_tiles, blockIdx.x / kv_tiles, &tm_q, &tm_k, &tm_v, &tm_g, lse, delta, dk, dv,
               num_heads, sq, sk, dks, dvs, scale, scale_log2);
  } else {
    const int i = blockIdx.x - kv_blocks;
    dq_block(smem_raw, i % q_tiles, i / q_tiles, &tm_q, &tm_k, &tm_v, &tm_g, lse, delta, dq, num_heads, sq, sk, dqs,
             scale, scale_log2);
  }
}

int smem_set_grads = 0;  // devices on which the kernel may use kSmemBytes

}  // namespace

// Plain C entry point for ctypes: the two kernels above, in order, on
// `stream`. q, k, v, o, g, dq, dk, dv are (B, S, H, 64) bf16 with strides in
// elements (D contiguous, every base 16-byte aligned and every other stride a
// multiple of 16 bytes; the wrapper checks them); lse (the forward's,
// natural log) and the scratch `delta` are contiguous fp32 (B, H, Sq).
// Returns 0, the first non-zero cudaGetLastError(), or a kErr* code of
// sm90_async.cuh when a tensor map cannot be made.
extern "C" int ufm_flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                            const void* g, const void* lse, void* delta, void* dq, void* dk,
                                            void* dv, int batch, int num_heads, int sq, int sk, long long q_sb,
                                            long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                                            long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                            long long o_sb, long long o_ss, long long o_sh, long long g_sb,
                                            long long g_ss, long long g_sh, long long dq_sb, long long dq_ss,
                                            long long dq_sh, long long dk_sb, long long dk_ss, long long dk_sh,
                                            long long dv_sb, long long dv_ss, long long dv_sh, float scale,
                                            void* stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_g;
  int err = encode_bshd_map(&tm_q, q, batch, sq, num_heads, q_sb, q_ss, q_sh, kBox);
  if (err == 0) err = encode_bshd_map(&tm_k, k, batch, sk, num_heads, k_sb, k_ss, k_sh, kBox);
  if (err == 0) err = encode_bshd_map(&tm_v, v, batch, sk, num_heads, v_sb, v_ss, v_sh, kBox);
  if (err == 0) err = encode_bshd_map(&tm_g, g, batch, sq, num_heads, g_sb, g_ss, g_sh, kBox);
  if (err != 0) return err;

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* op = static_cast<const __nv_bfloat16*>(o);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<float*>(delta);
  const float scale_log2 = scale * kLog2e;

  const long long rows = static_cast<long long>(batch) * num_heads * sq;
  const unsigned delta_blocks = static_cast<unsigned>((rows * 8 + 255) / 256);
  attention_delta_kernel<<<delta_blocks, 256, 0, st>>>(op, gp, dp, num_heads, sq, rows, o_sb, o_ss, o_sh, g_sb,
                                                       g_ss, g_sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  e = allow_smem(reinterpret_cast<const void*>(attention_grads_kernel), kSmemBytes, smem_set_grads);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int kv_tiles = (sk + kBlockRes - 1) / kBlockRes, q_tiles = (sq + kBlockRes - 1) / kBlockRes;
  const dim3 grid((kv_tiles + q_tiles) * batch * num_heads, 1);
  attention_grads_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      tm_q, tm_k, tm_v, tm_g, lp, dp, static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), num_heads, sq, sk, kv_tiles, q_tiles, kv_tiles * batch * num_heads,
      Strides{dq_sb, dq_ss, dq_sh},
      Strides{dk_sb, dk_ss, dk_sh}, Strides{dv_sb, dv_ss, dv_sh}, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
