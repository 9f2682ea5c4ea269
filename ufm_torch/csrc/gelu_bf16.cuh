// The JAX package's bf16 exact GELU as device functions, shared by the
// standalone kernel (gelu_bf16_fwd.cu) and the epilogue of the MLP's fc1
// product (linear_gelu_bf16_fwd.cu), so the two give the same bits, and its
// constants and flush rules, shared with the gradient (gelu_bf16_bwd.cu):
//
//   y = bf16(bf16(0.5 x) * bf16(erfc(bf16(-x * bf16(sqrt(0.5))))))
//
// with erfc by the polynomials of ufm_tpu/ops/gelu.py (fast_erfc_f32 :73,
// the constants :42-71) and every fp32 operand and result below 2^-126
// flushed to a zero of its sign, as XLA's CPU does. gelu() is the entry:
// bf16 in, bf16 out, each step an explicit round-to-nearest intrinsic.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ufm {

// fp32 constants of ufm_tpu/ops/gelu.py (as jnp.float32 rounds them), written
// exactly, in constant memory (an unrolled loop reads each as an operand of
// its instruction): erf(t) / t ~= P(t^2) on |t| <= 2.08, P's coefficients
// from t^0 up
__constant__ float kMain[9] = {
    0x1.20dd72p+0f, -0x1.812604p-2f, 0x1.ce1046p-4f, -0x1.b702c6p-6f, 0x1.5096aep-8f,
    -0x1.9f1afap-11f, 0x1.85390ap-14f, -0x1.e3feeap-18f, 0x1.229100p-22f,
};
// erfc(t) exp(t^2) ~= (1/t) Q(1/t) on [2.0, 9.45], Q's coefficients from 1/t^0 up
__constant__ float kTail[6] = {
    0x1.20d040p-1f, 0x1.5536fep-9f, -0x1.3b1846p-2f, 0x1.ddfc46p-4f, 0x1.bdac00p-3f, -0x1.801ecep-3f,
};
constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kLn2 = 0x1.62e430p-1f;  // log(2) in fp32: exp2'(v) = log(2) exp2(v)
constexpr float kSat = 2.046875f;         // the main / tail split; erfc rounds to 2 below -kSat
constexpr float kClamp = 32.0f;           // |t| clamp before squaring
constexpr float kSqrtHalfBf16 = 0.70703125f;  // bf16(sqrt(0.5)), exact in fp32
constexpr float kSmallestNormal = 0x1.0p-126f;

// v, or a zero of v's sign where v is subnormal (XLA's CPU flush)
__device__ __forceinline__ float flush(float v) { return fabsf(v) < kSmallestNormal ? copysignf(0.0f, v) : v; }

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// One fp32 operation as XLA's CPU does it: subnormal operands read as zeros
// of their sign, the result rounded to nearest, a subnormal result flushed
// to a zero of its sign (PTX .ftz), and never contracted with another
// operation (inline PTX: nvcc cannot fuse or reorder it). fma_ftz is one
// fused multiply-add, where XLA's CPU code contracts one.
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}
__device__ __forceinline__ float div_ftz(float a, float b) {
  float r;
  asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// erfc(t) = 1 - t P(t^2) on the main range (u = t^2)
__device__ __forceinline__ float erfc_main(float t, float u) {
  float p = kMain[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) p = __fmaf_rn(p, u, kMain[i]);
  return __fmaf_rn(-t, p, 1.0f);
}

// The chain with every flush, for any x.
__device__ __forceinline__ float gelu_general(float x) {
  const float t = round_bf16(flush(__fmul_rn(x, -kSqrtHalfBf16)));
  float e;
  if (t <= -kSat) {
    e = 2.0f;
  } else {
    const float ta = fminf(fabsf(t), kClamp);
    const float u = flush(__fmul_rn(ta, ta));
    if (t > kSat) {
      const float inv = __frsqrt_rn(u);
      float q = kTail[5];
#pragma unroll
      for (int i = 4; i >= 0; --i) q = __fmaf_rn(q, inv, kTail[i]);
      const float ex = flush(exp2f(__fmul_rn(u, -kLog2e)));
      e = round_bf16(flush(__fmul_rn(flush(__fmul_rn(ex, inv)), q)));
    } else {
      e = round_bf16(erfc_main(t, u));
    }
  }
  const float h = round_bf16(flush(__fmul_rn(x, 0.5f)));
  return flush(__fmul_rn(h, e));
}

__device__ __forceinline__ __nv_bfloat16 gelu(__nv_bfloat16 xb) {
  const float x = __bfloat162float(xb);
  const float t = round_bf16(__fmul_rn(x, -kSqrtHalfBf16));
  // The fast path: with |x| >= 2^-124 on the main range, no operand or
  // result of the chain is subnormal (|x c| > 2^-126, |0.5 x| >= 2^-125, and
  // |0.5 x| erfc(t) >= 0.005 or ~|0.5 x|), so nothing is flushed, 0.5 x is
  // exact, and so is the last product before its rounding.
  if (fabsf(x) >= 0x1.0p-124f && t > -kSat && t <= kSat)
    return __float2bfloat16_rn(__fmul_rn(__fmul_rn(x, 0.5f), round_bf16(erfc_main(t, __fmul_rn(t, t)))));
  return __float2bfloat16_rn(gelu_general(x));
}

// The GELU as a table over x's bf16 bits, for a kernel that applies it where
// instruction issue is scarce (an epilogue beside tensor-core products). The
// table holds gelu() of every x with 2^-9 <= |x| < 16 (exponent fields 118 to
// 130, both signs: 3,328 entries); a kernel fills it (gelu_table_entry) and
// reads it per element (gelu_table_lookup). Outside that range the chain
// reduces to closed forms on the bits: |x| < 2^-9 makes erfc round to 1, so y
// = 0.5 x, flushed where XLA flushes it; x >= 16 makes it round to 2, so y =
// x; x <= -16 makes it 0, so y = -0. (chip_smoke.py holds the lookup to the
// JAX package's table on every finite bf16 value.)
constexpr uint32_t kTableExpLo = 118;
constexpr uint32_t kTableExpHi = 131;
constexpr int kTableHalf = static_cast<int>(kTableExpHi - kTableExpLo) << 7;
constexpr int kTableEntries = 2 * kTableHalf;

__device__ __forceinline__ uint16_t gelu_table_entry(int i) {
  const uint32_t sign = i >= kTableHalf ? 0x8000u : 0u;
  const uint32_t u = sign | ((kTableExpLo << 7) + static_cast<uint32_t>(i % kTableHalf));
  return __bfloat16_as_ushort(gelu(__ushort_as_bfloat16(static_cast<unsigned short>(u))));
}

// y's bits for x's bits u (a bf16 in the low 16 bits), without a branch: only
// lanes inside the table's range read it.
__device__ __forceinline__ uint32_t gelu_table_lookup(uint32_t u, const uint16_t* table) {
  const uint32_t e = (u >> 7) & 0xFFu;
  const uint32_t neg = u >> 15;
  uint32_t y = 0;
  if (e - kTableExpLo < kTableExpHi - kTableExpLo) y = table[neg * kTableHalf + (u & 0x7FFFu) - (kTableExpLo << 7)];
  // |x| < 2^-9: 0.5 x is x with the exponent one lower; below 2^-125 it is
  // subnormal (or x is 0 or subnormal) and flushes to a zero of x's sign
  const uint32_t half = e >= 2 ? u - 0x80u : (u & 0x8000u);
  // |x| >= 16: x itself, or -0 below -16; -inf gives NaN (-inf * 0), NaN itself
  const uint32_t big = neg == 0 ? u : (e == 0xFFu ? ((u & 0x7Fu) != 0 ? u : 0x7FFFu) : 0x8000u);
  return e < kTableExpLo ? half : (e >= kTableExpHi ? big : y);
}

}  // namespace ufm
