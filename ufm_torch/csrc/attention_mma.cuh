// Tensor-core building blocks shared by the attention kernels over the TPU
// kernel's whole domain (flash_attention_fwd_any.cu, flash_attention_bwd_any.cu):
// mma.sync.m16n8k8 with TF32 operands, the split of an fp32 operand into two
// TF32 terms, fragment loads from staged tiles, and the tile staging itself
// (cp.async where the layout allows it, plain loads where it does not).
//
// The term rule. TF32 keeps 10 of fp32's 23 fraction bits. An fp32 operand x
// takes two terms, hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and a
// product of two such operands sums lo x hi, hi x lo, then hi x hi (the small
// terms first, as CUTLASS's OpMultiplyAddFastF32 does), dropping lo x lo:
// 3xTF32, fp32's accuracy. A bf16 or fp16 value is exact in TF32 and takes
// one term; a product with one such operand takes two mma, with two such
// operands one.
//
// Fragment layouts of m16n8k8 (PTX ISA; g = lane / 4, t = lane % 4):
//   A (16 x 8, rows M, columns K): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, rows K, columns N):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):                    c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// An accumulator feeds the next product as its A operand with no shuffle
// (a_from_acc): the product's K index k-slot t stands for column 2t of the
// accumulator's 8-column chunk and k-slot t + 4 for column 2t + 1, so the B
// operand reads its rows in that order (rows 2t and 2t + 1 of the chunk,
// load_b with a step of one row). A sum over K does not depend on its order.
//
// Staged tiles hold the inputs' own type T, rows padded by 16 bytes
// (kPad<T>): the loads of A and B fragments above and of B in key order then
// fall on 32 distinct banks (fp32: 4g + t and 8t + g; bf16 / fp16: one
// 4-byte word per two lanes, 16 distinct words).
//
// Ready tiles (the backward's streamed tiles). prepare() turns a raw tile
// (T, DP elements a row) once into a ready one: each value as its TF32
// terms, an interleaved (hi, lo) float2 for fp32, the value widened to fp32
// for bf16 / fp16. Every warp then reads its fragments with one 64-bit
// (32-bit) load a value and no split. Ready rows are DP + 4 values apart
// (ready_stride_kmajor: A and K-major B loads on distinct banks; fp32 B
// loads in key order meet 2-way conflicts).
//
// Sums. An mma adds its products to the accumulator and truncates the sum;
// over a 1201-row reduction (the flagship's sequence) one chain of mma loses
// ~1e-5 of an fp32 result. Long fp32 sums are therefore cut into partial
// sums, added together in fp32 with round to nearest: the scores over D in
// groups of 64 columns (DP = 128 / 256), P V over each key tile, the
// backward's gradients over two chunks of 8 streamed rows (each product
// alone where the gradient slice is 128 columns wide).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ufm_mma {

// elements of T in the 16 bytes that pad each staged row
template <typename T>
constexpr int kPad = 16 / static_cast<int>(sizeof(T));

// fp32 operands take two TF32 terms; bf16 and fp16 are exact in one
template <typename T>
constexpr bool kTwoTerms = std::is_same<T, float>::value;

// how a tensor's tiles are staged (the host picks one per tensor)
enum Staging : int {
  kPlain = 0,   // plain element loads and stores (any strides; bf16 / fp16)
  kAsync16 = 1, // 16-byte cp.async (D contiguous, base and strides 16-byte aligned)
  kAsync4 = 2,  // 4-byte cp.async, one element each (fp32, any strides)
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

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x -> (hi, lo), the two TF32 terms
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// x -> its terms under the rule of T: two for fp32, else x itself (exact)
template <typename T>
__device__ __forceinline__ void terms(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kTwoTerms<T>) {
    split(x, hi, lo);
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// one A fragment: hi terms, and lo terms where the operand takes two
struct FragA {
  uint32_t hi[4], lo[4];
};

// one B fragment
struct FragB {
  uint32_t hi[2], lo[2];
};

// d += a b over one k-step of 8 (m16n8k8, TF32 in, fp32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b by the term rule: kA2 / kB2 say whether a / b has two terms. The
// small terms come first: a.lo x b.hi, then a.hi x b.lo (kBFirst swaps the
// two, so that a transposed product, S^T = K Q^T, adds its terms in the
// order of S = Q K^T), then a.hi x b.hi.
template <bool kA2, bool kB2, bool kBFirst = false>
__device__ __forceinline__ void mma_terms(float (&d)[4], const FragA& a, const FragB& b) {
  if constexpr (kBFirst && kB2) mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  if constexpr (kA2) mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  if constexpr (!kBFirst && kB2) mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// acc += a b by the term rule. kFresh: the product is summed from zero and
// added to acc in fp32 (round to nearest), so acc's long sum does not
// truncate at every mma (see Sums); else the mma add to acc directly.
template <bool kFresh, bool kA2, bool kB2>
__device__ __forceinline__ void mma_add(float (&acc)[4], const FragA& a, const FragB& b) {
  if constexpr (kFresh) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma_terms<kA2, kB2>(part, a, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += part[e];
  } else {
    mma_terms<kA2, kB2>(acc, a, b);
  }
}

// The A fragment of rows [0, 16) x columns [0, 8) of a staged tile (`p` at
// its row 0, column k0; `stride` elements a row), in T's terms.
template <typename T>
__device__ __forceinline__ void load_a(FragA& a, const T* p, int stride, int g, int t) {
  const T* r0 = p + g * stride + t;
  const T* r1 = r0 + 8 * stride;
  terms<T>(to_float(r0[0]), a.hi[0], a.lo[0]);
  terms<T>(to_float(r1[0]), a.hi[1], a.lo[1]);
  terms<T>(to_float(r0[4]), a.hi[2], a.lo[2]);
  terms<T>(to_float(r1[4]), a.hi[3], a.lo[3]);
}

// A B fragment from two elements of a staged tile, `step` elements apart:
// K-major (b0 at row n0 + g, column k0 + t, step 4) or, for a product over
// an accumulator's columns, in key order (b0 at row 2t, column n0 + g, step
// one row)
template <typename T>
__device__ __forceinline__ void load_b(FragB& b, const T* p, int step) {
  terms<T>(to_float(p[0]), b.hi[0], b.lo[0]);
  terms<T>(to_float(p[step]), b.hi[1], b.lo[1]);
}

// The A fragment of one 16 x 8 chunk of an accumulator (c0..c3 above), its
// K index in key order: two terms (kTwo) or the values as they are (exact).
template <bool kTwo>
__device__ __forceinline__ void a_from_acc(FragA& a, const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if constexpr (kTwo) {
      split(x[r], a.hi[r], a.lo[r]);
    } else {
      a.hi[r] = __float_as_uint(x[r]);
      a.lo[r] = 0u;
    }
  }
}

// The ready form of a T value: its (hi, lo) TF32 terms for fp32, the value
// itself (exact in TF32) for bf16 / fp16
template <typename T>
using Ready = typename std::conditional<kTwoTerms<T>, float2, float>::type;

// The row stride of a ready tile, in Ready<T> values (see Ready tiles above)
template <int DP>
constexpr int ready_stride_kmajor = DP + 4;

__device__ __forceinline__ void ready_terms(float2 x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x.x);
  lo = __float_as_uint(x.y);
}
__device__ __forceinline__ void ready_terms(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = 0u;
}

// A B fragment from two values of a ready tile, `step` apart (as load_b)
template <typename R>
__device__ __forceinline__ void load_b_ready(FragB& b, const R* p, int step) {
  ready_terms(p[0], b.hi[0], b.lo[0]);
  ready_terms(p[step], b.hi[1], b.lo[1]);
}

// four consecutive raw values as fp32
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u), __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// four ready values at `p` (16-byte aligned)
__device__ __forceinline__ void store4(float2* p, const float4& v) {
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  reinterpret_cast<uint4*>(p)[0] = make_uint4(h[0], l[0], h[1], l[1]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(h[2], l[2], h[3], l[3]);
}
__device__ __forceinline__ void store4(float* p, const float4& v) { *reinterpret_cast<float4*>(p) = v; }

// `rows` raw rows of DP values (`src`, DP elements a row) -> ready rows at
// `stride` (every thread of the CTA, kThreads, takes part)
template <int DP, int kThreads, typename T>
__device__ __forceinline__ void prepare(Ready<T>* dst, int stride, const T* src, int rows) {
  constexpr int kQuads = DP / 4;
  for (int idx = threadIdx.x; idx < rows * kQuads; idx += kThreads) {
    const int r = idx / kQuads;
    const int c = (idx % kQuads) * 4;
    store4(dst + r * stride + c, load4(src + r * DP + c));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory, of which the first `bytes` (0..16) come from
// `src` and the rest are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes to shared memory, from `src` when `bytes` is 4, zero when it is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The raw bits of T, for plain copies
template <typename T>
using Bits = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;

// Rows [row0, row0 + rows) x DP columns of one (batch, head) slice (`src` at
// its row 0, column 0; element strides s_s, s_d) into shared memory at
// `stride` elements a row, by `how`: rows past `seq` and columns past `d`
// are zero. The cp.async paths only issue the copies (the caller commits
// and waits); every thread of the CTA (kThreads) takes part.
template <int DP, int kThreads, typename T>
__device__ __forceinline__ void stage(T* dst, int stride, const T* src, long long s_s, long long s_d, int row0,
                                      int seq, int rows, int d, int how) {
  if (how == kAsync16) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a copy
    constexpr int kChunks = DP / kPer;
    for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * kPer;
      const int row = row0 + r;
      const bool in = row < seq && c < d;
      const int bytes = in ? min(kPer, d - c) * static_cast<int>(sizeof(T)) : 0;
      cp_async16(dst + r * stride + c, in ? src + row * s_s + c : src, bytes);
    }
  } else if (sizeof(T) == 4 && how == kAsync4) {
    for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
      const int r = idx / DP;
      const int c = idx % DP;
      const int row = row0 + r;
      const bool in = row < seq && c < d;
      cp_async4(dst + r * stride + c, in ? src + row * s_s + c * s_d : src, in ? 4 : 0);
    }
  } else {
    const Bits<T>* s = reinterpret_cast<const Bits<T>*>(src);
    Bits<T>* o = reinterpret_cast<Bits<T>*>(dst);
    for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
      const int r = idx / DP;
      const int c = idx % DP;
      const int row = row0 + r;
      o[r * stride + c] = (row < seq && c < d) ? s[row * s_s + c * s_d] : Bits<T>(0);
    }
  }
}

// The staging a (B, S, H, D) tensor's tiles can take: 16-byte copies when D
// is contiguous and the base and every stepped stride are 16-byte aligned
// (a dimension of size 1 is never stepped), else 4-byte copies for fp32 and
// plain loads for bf16 / fp16.
inline int staging_of(const void* base, int size, int b, int s, int h, long long sb, long long ss, long long sh,
                      long long sd) {
  const auto aligned = [size](int n, long long st) { return n <= 1 || (st * size) % 16 == 0; };
  if (sd == 1 && reinterpret_cast<uintptr_t>(base) % 16 == 0 && aligned(b, sb) && aligned(s, ss) && aligned(h, sh))
    return kAsync16;
  return size == 4 ? kAsync4 : kPlain;
}

}  // namespace ufm_mma
