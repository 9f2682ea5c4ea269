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
// parallel. So this is the flash-attention-2 schedule over 64-row tiles:
//
//   1. delta kernel: delta_i = sum_d g_id * o_id in fp32 (equal to
//      rowsum(dP * P) up to the bf16 rounding of o), one 8-thread group per row;
//   2. dK/dV kernel: one CTA of 4 warps per (64-row K/V tile, batch * head);
//      each warp owns 16 key rows, keeps their K and V as mma A fragments in
//      registers and walks over all Q tiles (q and g double-buffered in shared
//      memory with cp.async). It recomputes S^T = k q^T, P^T = exp2(S^T *
//      scale * log2 e - lse * log2 e) (query columns past S are exactly 0),
//      dP^T = v g^T and dS^T, and accumulates dV += P^T g and dK += dS^T q in
//      fp32 registers; both are written once, in bf16;
//   3. dQ kernel: one CTA per (64-row Q tile, batch * head), the forward's
//      layout: q and g as A fragments, K/V tiles double-buffered, dQ += dS k
//      accumulated in registers and written once.
// No atomics: each output element is written by one thread, so the result is
// deterministic. All products are mma.sync m16n8k16 bf16 -> fp32. q, k, v and
// g are read through their batch / sequence / head strides (the main path
// passes views of the fused qkv projection); only D must be contiguous. Rows
// past S are zero-filled in shared memory and never written.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 10 * B * H * Sq *
// Sk * D FLOPs (the TPU kernel's CostEstimate: five S x S x D products) against
// q, k, v, o, g read once, dq, dk, dv written once, plus lse and delta:
//   encoder      (4, 1201, 16, 64): 59.1 GFLOP -> 60 us; 79 MB -> 24 us
//   info sharing (2, 2400, 12, 64): 88.5 GFLOP -> 89 us; 59 MB -> 18 us
// so it is bound by operations. The kernels recompute S (twice: once per
// output kernel), which costs 2 of the 12 products they run; mma.sync's rate
// next to wgmma's and the 2-byte transposed shared-memory reads of the B
// operands of dV, dK and dQ are what separate it from the bound. wgmma, TMA,
// ldmatrix.trans and one fused pass with fp32 atomics for dQ are later steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

#include "mma_sm90.cuh"

namespace {

using namespace ufm;

constexpr int kD = 64;       // head_dim, the main path's only value
constexpr int kBlock = 64;   // rows per CTA and per shared-memory tile (16 per warp)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;  // padded shared row (144 B): conflict-free fragment loads
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

// Rows `row0`, `row0 + 8` of a (B, S, H, D) view as four A fragments (one per
// 16-wide slice of D); rows past S are zero.
__device__ __forceinline__ void load_a_frags(uint32_t f[4][4], const __nv_bfloat16* base, long long ss, int row0,
                                             int s, int t) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + t * 2;
    f[kk][0] = row0 < s ? load_u32(base + row0 * ss + c) : 0u;
    f[kk][1] = row1 < s ? load_u32(base + row1 * ss + c) : 0u;
    f[kk][2] = row0 < s ? load_u32(base + row0 * ss + c + 8) : 0u;
    f[kk][3] = row1 < s ? load_u32(base + row1 * ss + c + 8) : 0u;
  }
}

// Two 64-row tiles (64 x 64 bf16 each) into shared memory with cp.async,
// rows past S zero-filled; one commit group.
__device__ __forceinline__ void load_tile_pair(__nv_bfloat16* dst_a, __nv_bfloat16* dst_b,
                                               const __nv_bfloat16* src_a, long long ss_a,
                                               const __nv_bfloat16* src_b, long long ss_b, int row0, int s,
                                               int tid) {
#pragma unroll
  for (int it = 0; it < kBlock * 8 / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int row = i >> 3;
    const int chunk = (i & 7) * 8;
    const int r = row0 + row;
    const bool valid = r < s;
    const long long src = valid ? r : 0;  // keep the address in bounds
    cp_async_16(&dst_a[row * kLd + chunk], src_a + src * ss_a + chunk, valid);
    cp_async_16(&dst_b[row * kLd + chunk], src_b + src * ss_b + chunk, valid);
  }
  cp_async_commit();
}

// Zero a 16x64 fp32 accumulator (eight 16x8 C fragments).
__device__ __forceinline__ void zero_acc(float acc[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

// acc(16 x 64) += A(16 x 64, four k-steps of A fragments) * X^T, where X is a
// 64 x 64 shared tile with rows as the output columns: B[k][n] = X[n][k].
__device__ __forceinline__ void mma_a_xt(float acc[8][4], const uint32_t a[4][4], const __nv_bfloat16* xs, int g,
                                         int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* p = xs + (n * 8 + g) * kLd + kk * 16 + t * 2;
      mma_bf16_16816(acc[n], a[kk], load_u32(p), load_u32(p + 8));
    }
  }
}

// acc(16 x 64) += A(16 x 64) * X, X a 64 x 64 shared tile: B[k][n] = X[k][n],
// each B register joins two rows of one column.
__device__ __forceinline__ void mma_a_x(float acc[8][4], const uint32_t a[4][4], const __nv_bfloat16* xs, int g,
                                        int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* p = xs + (kk * 16 + t * 2) * kLd + n * 8 + g;
      mma_bf16_16816(acc[n], a[kk], join_u16(p, p + kLd), join_u16(p + 8 * kLd, p + 9 * kLd));
    }
  }
}

// C fragments of a 16 x 64 fp32 tile -> the A fragments of the same tile in
// bf16 (column block n is the low (n even) or high (n odd) half of k-step n/2).
__device__ __forceinline__ void pack_a(uint32_t a[4][4], const float c[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    a[n >> 1][(n & 1) * 2 + 0] = pack_bf16x2(c[n][0], c[n][1]);
    a[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(c[n][2], c[n][3]);
  }
}

// Write rows row0 and row0 + 8 of a 16 x 64 fp32 accumulator times `mul` as
// bf16 into a (B, S, H, D) tensor's (b, h) slice.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ss, const float acc[8][4], float mul,
                                           int row0, int s, int t) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + t * 2;
    if (row0 < s) *reinterpret_cast<uint32_t*>(base + row0 * ss + c) = pack_bf16x2(acc[n][0] * mul, acc[n][1] * mul);
    if (row1 < s) *reinterpret_cast<uint32_t*>(base + row1 * ss + c) = pack_bf16x2(acc[n][2] * mul, acc[n][3] * mul);
  }
}

struct Strides {
  long long sb, ss, sh;
};

// dK and dV of one 64-row K/V tile: a loop over every Q tile.
__global__ void __launch_bounds__(kThreads) attention_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int num_heads, int sq, int sk, Strides qs,
    Strides ks, Strides vs, Strides gs, Strides dks, Strides dvs, float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 q_tile[2][kBlock * kLd];
  __shared__ __align__(16) __nv_bfloat16 g_tile[2][kBlock * kLd];
  __shared__ float lse_tile[2][kBlock];    // log2 domain; +inf past Sq (P = 0)
  __shared__ float delta_tile[2][kBlock];  // 0 past Sq

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;  // fragment row group
  const int t = lane & 3;    // thread within the group

  const int b = blockIdx.y / num_heads;
  const int h = blockIdx.y % num_heads;
  const __nv_bfloat16* qb = q + b * qs.sb + h * qs.sh;
  const __nv_bfloat16* kb = k + b * ks.sb + h * ks.sh;
  const __nv_bfloat16* vb = v + b * vs.sb + h * vs.sh;
  const __nv_bfloat16* gb = g + b * gs.sb + h * gs.sh;
  const float* lse_bh = lse + static_cast<long long>(blockIdx.y) * sq;
  const float* delta_bh = delta + static_cast<long long>(blockIdx.y) * sq;

  // this thread's two key rows; their K and V as A fragments
  const int kr0 = blockIdx.x * kBlock + warp * 16 + gr;
  uint32_t kf[4][4], vf[4][4];
  load_a_frags(kf, kb, ks.ss, kr0, sk, t);
  load_a_frags(vf, vb, vs.ss, kr0, sk, t);

  auto load_stage = [&](int stage, int q0) {
    load_tile_pair(q_tile[stage], g_tile[stage], qb, qs.ss, gb, gs.ss, q0, sq, tid);
    if (tid < kBlock) {
      const int i = q0 + tid;
      lse_tile[stage][tid] = i < sq ? lse_bh[i] * kLog2e : INFINITY;
      delta_tile[stage][tid] = i < sq ? delta_bh[i] : 0.f;
    }
  };

  float dk_acc[8][4], dv_acc[8][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);

  const int num_tiles = (sq + kBlock - 1) / kBlock;
  load_stage(0, 0);
  for (int j = 0; j < num_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < num_tiles) {
      load_stage(stage ^ 1, (j + 1) * kBlock);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qsm = q_tile[stage];
    const __nv_bfloat16* gsm = g_tile[stage];

    // S^T = k q^T and dP^T = v g^T for this warp's 16 keys x 64 queries
    float st[8][4], dpt[8][4];
    zero_acc(st);
    zero_acc(dpt);
    mma_a_xt(st, kf, qsm, gr, t);
    mma_a_xt(dpt, vf, gsm, gr, t);

    // P^T and dS^T = P^T * (dP^T - delta); the query index is the column
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t * 2 + (e & 1);
        const float p = exp2f(st[n][e] * scale_log2 - lse_tile[stage][col]);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - delta_tile[stage][col]);
      }
    }
    uint32_t af[4][4];
    pack_a(af, st);  // P^T in bf16
    mma_a_x(dv_acc, af, gsm, gr, t);
    pack_a(af, dpt);  // dS^T in bf16
    mma_a_x(dk_acc, af, qsm, gr, t);
    __syncthreads();  // the next iteration's prefetch overwrites this stage
  }

  store_rows(dk + b * dks.sb + h * dks.sh, dks.ss, dk_acc, scale, kr0, sk, t);
  store_rows(dv + b * dvs.sb + h * dvs.sh, dvs.ss, dv_acc, 1.f, kr0, sk, t);
}

// dQ of one 64-row Q tile: a loop over every K/V tile.
__global__ void __launch_bounds__(kThreads) attention_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int num_heads, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides gs,
    Strides dqs, float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 k_tile[2][kBlock * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_tile[2][kBlock * kLd];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;
  const int t = lane & 3;

  const int b = blockIdx.y / num_heads;
  const int h = blockIdx.y % num_heads;
  const __nv_bfloat16* qb = q + b * qs.sb + h * qs.sh;
  const __nv_bfloat16* kb = k + b * ks.sb + h * ks.sh;
  const __nv_bfloat16* vb = v + b * vs.sb + h * vs.sh;
  const __nv_bfloat16* gb = g + b * gs.sb + h * gs.sh;

  // this thread's two query rows: q and g as A fragments, lse and delta
  const int r0 = blockIdx.x * kBlock + warp * 16 + gr;
  uint32_t qf[4][4], gf[4][4];
  load_a_frags(qf, qb, qs.ss, r0, sq, t);
  load_a_frags(gf, gb, gs.ss, r0, sq, t);
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const long long at = static_cast<long long>(blockIdx.y) * sq + row;
    lse2[r] = row < sq ? lse[at] * kLog2e : INFINITY;  // rows past Sq: P = 0
    dlt[r] = row < sq ? delta[at] : 0.f;
  }

  float dq_acc[8][4];
  zero_acc(dq_acc);

  const int num_tiles = (sk + kBlock - 1) / kBlock;
  load_tile_pair(k_tile[0], v_tile[0], kb, ks.ss, vb, vs.ss, 0, sk, tid);
  for (int j = 0; j < num_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < num_tiles) {
      load_tile_pair(k_tile[stage ^ 1], v_tile[stage ^ 1], kb, ks.ss, vb, vs.ss, (j + 1) * kBlock, sk, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ksm = k_tile[stage];
    const __nv_bfloat16* vsm = v_tile[stage];

    // S = q k^T and dP = g v^T for this warp's 16 queries x 64 keys
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    mma_a_xt(s, qf, ksm, gr, t);
    mma_a_xt(dp, gf, vsm, gr, t);

    const int kv0 = j * kBlock;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + n * 8 + t * 2 + (e & 1);
        const float p = col < sk ? exp2f(s[n][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dlt[e >> 1]);
      }
    }
    uint32_t af[4][4];
    pack_a(af, dp);  // dS in bf16
    mma_a_x(dq_acc, af, ksm, gr, t);
    __syncthreads();
  }

  store_rows(dq + b * dqs.sb + h * dqs.sh, dqs.ss, dq_acc, scale, r0, sq, t);
}

}  // namespace

// Plain C entry point for ctypes: the three kernels above, in order, on
// `stream`. q, k, v, o, g, dq, dk, dv are (B, S, H, 64) bf16 with strides in
// elements (D contiguous, every row 16-byte aligned; the wrapper checks both);
// lse (the forward's, natural log) and the scratch `delta` are contiguous fp32
// (B, H, Sq). Returns the first non-zero cudaGetLastError(), else 0.
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(o);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<float*>(delta);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh}, gs{g_sb, g_ss, g_sh};
  const Strides dqs{dq_sb, dq_ss, dq_sh}, dks{dk_sb, dk_ss, dk_sh}, dvs{dv_sb, dv_ss, dv_sh};
  const float scale_log2 = scale * kLog2e;

  const long long rows = static_cast<long long>(batch) * num_heads * sq;
  const unsigned delta_blocks = static_cast<unsigned>((rows * 8 + 255) / 256);
  attention_delta_kernel<<<delta_blocks, 256, 0, st>>>(op, gp, dp, num_heads, sq, rows, o_sb, o_ss, o_sh, g_sb,
                                                       g_ss, g_sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_kv((sk + kBlock - 1) / kBlock, batch * num_heads);
  attention_dkdv_kernel<<<grid_kv, kThreads, 0, st>>>(qp, kp, vp, gp, lp, dp, static_cast<__nv_bfloat16*>(dk),
                                                      static_cast<__nv_bfloat16*>(dv), num_heads, sq, sk, qs, ks, vs,
                                                      gs, dks, dvs, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q((sq + kBlock - 1) / kBlock, batch * num_heads);
  attention_dq_kernel<<<grid_q, kThreads, 0, st>>>(qp, kp, vp, gp, lp, dp, static_cast<__nv_bfloat16*>(dq),
                                                   num_heads, sq, sk, qs, ks, vs, gs, dqs, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
