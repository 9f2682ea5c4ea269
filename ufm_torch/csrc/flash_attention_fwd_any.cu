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
// Arithmetic: every product is fp32 FMA on the CUDA cores (bf16 and fp16
// inputs are widened when a tile is staged), so an fp32 call keeps fp32's accuracy; a
// single-pass TF32 product on the tensor cores would keep ~3 decimal digits.
// The softmax is exp / log in fp32 (expf, logf), P stays fp32 for P V.
//
// Design, simple first. One CTA of 128 threads per (block of query rows,
// batch * head) walks the keys in tiles of 64 rows:
//   * the Q block, then each K and V tile, is staged in shared memory as
//     fp32 with D zero-padded to DP (32, 64, 128 or 256, a template
//     argument), rows past S zero-filled; plain strided loads, no TMA, so
//     any layout is read in place;
//   * a thread owns R query rows (4, or 2 at DP = 256) and 8 keys of the
//     tile (key c = cg + 8 j): the 8 threads of a row are 8 neighbouring
//     lanes, which reduce the row max and sum with shuffles. Q and K rows
//     are padded to DP + 4 floats so the 8 lanes' 16-byte K reads hit
//     distinct banks;
//   * online softmax: the running max m, alpha = exp(m_old - m_new), each
//     thread's partial row sum rescaled by alpha, summed across the 8 lanes
//     once at the end; keys past Sk score -inf;
//   * P goes through shared memory ((BQ, 64 + 4) fp32), and each thread
//     accumulates its R rows x DP / 8 output columns (16-byte groups
//     cg * 4 + 32 c) of O += P V, normalised by the row sum at the end.
//
// Bound on an H100 SXM: 4 B H Sq Sk D operations (two products) at 67
// TFLOP/s of fp32 outside the tensor cores, against q, k, v read once and
// the output written once at 3.35 TB/s. The flagship in fp32:
//   encoder      (2, 1201, 16, 64): 11.8 GFLOP -> 176 us; 39.4 MB -> 12 us
//   info sharing (1, 2400, 12, 64): 17.7 GFLOP -> 264 us; 29.5 MB ->  9 us
// so it is bound by operations. Per 4 FMAs a thread issues 3 shared-memory
// loads of 16 bytes (R = 4), so the pace is set by FMA issue and
// shared-memory bandwidth together; making it faster (3xTF32 on the tensor
// cores, cp.async double buffering) is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "sm90_async.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kColGroups = 8;                        // threads sharing a query row
constexpr int kRowGroups = kThreads / kColGroups;    // 16
constexpr int kBlockK = 64;                          // keys per tile
constexpr int kKeys = kBlockK / kColGroups;          // keys per thread: 8
constexpr int kPStride = kBlockK + 4;                // floats per P row in shared memory

template <int DP>
struct Tile {
  static constexpr int kRows = DP <= 128 ? 4 : 2;    // query rows per thread
  static constexpr int kBlockQ = kRowGroups * kRows;
  static constexpr int kQkStride = DP + 4;           // floats per Q / K row in shared memory
  static constexpr int kCols = DP / 32;              // 16-byte output column groups per thread
  static constexpr int kSmemFloats = kBlockQ * kQkStride + kBlockK * kQkStride + kBlockK * DP + kBlockQ * kPStride;
  static constexpr int kSmemBytes = kSmemFloats * 4;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

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

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_fwd_any_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, int num_heads, int sq, int sk, int d, long long q_sb, long long q_ss, long long q_sh,
    long long q_sd, long long k_sb, long long k_ss, long long k_sh, long long k_sd, long long v_sb, long long v_ss,
    long long v_sh, long long v_sd, long long o_sb, long long o_ss, long long o_sh, float scale) {
  using C = Tile<DP>;
  constexpr int R = C::kRows;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + C::kBlockQ * C::kQkStride;
  float* vs = ks + kBlockK * C::kQkStride;
  float* ps = vs + kBlockK * DP;

  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int rg = tid / kColGroups;
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int q0 = blockIdx.x * C::kBlockQ;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  stage<DP>(qs, C::kQkStride, qb, q_ss, q_sd, q0, sq, C::kBlockQ, d);

  float m[R], l[R];
  float4 acc[R][C::kCols];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int num_tiles = (sk + kBlockK - 1) / kBlockK;
  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<DP>(ks, C::kQkStride, kb, k_ss, k_sd, k0, sk, kBlockK, d);
    stage<DP>(vs, DP, vb, v_ss, v_sd, k0, sk, kBlockK, d);
    __syncthreads();

    // S = Q K^T for this thread's R rows and 8 keys
    float s[R][kKeys];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; dd += 4) {
      float4 qv[R], kv[kKeys];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (rg * R + i) * C::kQkStride + dd);
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (cg + kColGroups * j) * C::kQkStride + dd);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          x = fmaf(qv[i].w, kv[j].w, x);
          s[i][j] = x;
        }
    }

    // online softmax over the tile; P to shared memory
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float x = (k0 + cg + kColGroups * j < sk) ? s[i][j] * scale : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);  // finite: every tile has a key below sk
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      m[i] = m_new;
      float sum = 0.f;
      float* prow = ps + (rg * R + i) * kPStride + cg;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        prow[kColGroups * j] = p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
    __syncthreads();

    // O += P V
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = *reinterpret_cast<const float4*>(ps + (rg * R + i) * kPStride + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + (kk + e) * DP + cg * 4 + 32 * c);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
            acc[i][c].x = fmaf(p, vv.x, acc[i][c].x);
            acc[i][c].y = fmaf(p, vv.y, acc[i][c].y);
            acc[i][c].z = fmaf(p, vv.z, acc[i][c].z);
            acc[i][c].w = fmaf(p, vv.w, acc[i][c].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    const int row = q0 + rg * R + i;
    if (row >= sq) continue;
    if (lse != nullptr && cg == 0) lse[static_cast<long long>(bh) * sq + row] = m[i] + logf(sum);
    T* orow = o + b * o_sb + h * o_sh + row * o_ss;
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) {
      const int col = cg * 4 + 32 * c;
      const float vals[4] = {acc[i][c].x, acc[i][c].y, acc[i][c].z, acc[i][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < d) store(orow + col + e, vals[e] / sum);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int num_heads, int sq, int sk,
           int d, const long long* st, float scale, cudaStream_t stream) {
  using C = Tile<DP>;
  static int smem_set = 0;  // devices on which this instance may use kSmemBytes
  const void* fn = reinterpret_cast<const void*>(flash_attention_fwd_any_kernel<T, DP>);
  const cudaError_t e = ufm::allow_smem(fn, C::kSmemBytes, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sq + C::kBlockQ - 1) / C::kBlockQ, batch * num_heads);
  flash_attention_fwd_any_kernel<T, DP><<<grid, kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), num_heads, sq, sk, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int num_heads, int sq,
                 int sk, int d, const long long* st, float scale, cudaStream_t stream) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, lse, batch, num_heads, sq, sk, d, st, scale, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, o, lse, batch, num_heads, sq, sk, d, st, scale, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, o, lse, batch, num_heads, sq, sk, d, st, scale, stream);
  return launch<T, 256>(q, k, v, o, lse, batch, num_heads, sq, sk, d, st, scale, stream);
}

}  // namespace

// Plain C entry point for ctypes. `dtype` picks the element type of q, k, v
// and o (0 fp32, 1 bf16, 2 fp16). Strides are in elements, any value (q, k, v are
// read element by element); o is written through its B, S and H strides with
// D contiguous. `lse` is null or a contiguous fp32 (B, H, Sq) buffer. The
// wrapper checks 1 <= d <= 256, sq, sk >= 1 and batch * num_heads <= 65535.
// Launches on `stream`; returns 0 or a cudaError_t.
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
