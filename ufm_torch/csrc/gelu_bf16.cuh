// The JAX package's bf16 exact GELU and its gradient as device functions.
// The GELU is shared by the standalone kernel (gelu_bf16_fwd.cu) and the
// epilogue of the MLP's fc1 product (linear_gelu_bf16_fwd.cu), the gradient
// by the standalone gradient kernel (gelu_bf16_bwd.cu) and the epilogue of
// fc2's input-gradient product (linear_gelu_bf16_bwd.cu), so each pair gives
// the same bits. The forward:
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

// ---- the gradient: the JAX package's VJP of the chain above, bit for bit
// (gelu_bf16_bwd.cu's header says how), shared by the standalone gradient
// kernel (gelu_bf16_bwd.cu) and the epilogue of fc2's input-gradient product
// (linear_gelu_bf16_bwd.cu). gelu_grad(g, x) is the entry: the bf16 cotangent
// g at the bf16 input x, bf16 out.

// dx_h = bf16(0.5 bf16(g e)): 0.5 x's share of the gradient
__device__ __forceinline__ float half_share(float g, float e) {
  return round_bf16(mul_ftz(round_bf16(mul_ftz(g, e)), 0.5f));
}

// dx = bf16(dx_h - bf16(bf16(d_t) c)): t = -x c's share added
__device__ __forceinline__ __nv_bfloat16 finish(float dx_h, float d_t) {
  const float dx_t = -round_bf16(mul_ftz(round_bf16(d_t), kSqrtHalfBf16));
  return __float2bfloat16_rn(add_ftz(dx_h, dx_t));
}

// The tail (t > 2.046875): erfc = exp(-u) inv Q(inv), inv = u^-1/2. Out of
// line: ~0.2% of a normal pre-activation takes it, and inlined, its fp64 exp
// and division would be copied into each of the eight unrolled elements.
static __device__ __noinline__ __nv_bfloat16 tail_grad(float g, float h, float ta, float tc, float u) {
  const double ud = static_cast<double>(u);
  const float ex = flush(__double2float_rn(exp(-ud)));
  const float inv = __double2float_rn(__ddiv_rn(1.0, __dsqrt_rn(ud)));
  const float ex_inv = mul_ftz(ex, inv);
  float hq[6];
  hq[0] = kTail[5];
#pragma unroll
  for (int k = 1; k < 6; ++k) hq[k] = fma_ftz(hq[k - 1], inv, kTail[5 - k]);
  const float q = hq[5];
  const float dx_h = half_share(g, round_bf16(mul_ftz(ex_inv, q)));
  const float g_e = mul_ftz(h, g);
  const float g_ex_inv = mul_ftz(g_e, q);
  float g_q = mul_ftz(ex_inv, g_e);
  float g_inv = fma_ftz(ex, g_ex_inv, mul_ftz(hq[4], g_q));
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    g_q = mul_ftz(g_q, inv);
    g_inv = fma_ftz(hq[4 - k], g_q, g_inv);
  }
  const float d_exp = mul_ftz(mul_ftz(mul_ftz(g_ex_inv, inv), kLn2), ex);
  float g_u = fma_ftz(-d_exp, kLog2e, mul_ftz(g_inv, mul_ftz(div_ftz(inv, u), -0.5f)));
  if (g_u == 0.0f && signbit(g_u)) {
    // the main branch's zeros: -0 where P's partial is positive, +0 where negative
    float hp = kMain[8];
    bool negative = false;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      hp = fma_ftz(hp, u, kMain[8 - k]);
      negative |= hp < 0.0f;
    }
    if (negative) g_u = 0.0f;
  }
  const float g_tc = mul_ftz(tc, g_u);
  // min(|t|, 32)'s cotangent: whole below 32, half at the tie, none above
  const float clamp_share = ta < kClamp ? 1.0f : (ta == kClamp ? 0.5f : 0.0f);
  return finish(dx_h, mul_ftz(add_ftz(g_tc, g_tc), clamp_share));
}

// v_e rounded to bf16 for each e, two values a conversion where kN is even
template <int kN>
__device__ __forceinline__ void round_bf16_n(float (&v)[kN]) {
  if constexpr (kN % 2 == 0) {
#pragma unroll
    for (int e = 0; e < kN; e += 2) {
      __nv_bfloat162 r = __floats2bfloat162_rn(v[e], v[e + 1]);
      const uint32_t u = *reinterpret_cast<uint32_t*>(&r);
      v[e] = __uint_as_float(u << 16);
      v[e + 1] = __uint_as_float(u & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kN; ++e) v[e] = round_bf16(v[e]);
  }
}

// The main branch (|t| <= 2.046875, finite x), erfc = 1 - t P(u), for kN
// elements: dx before its last rounding to bf16. Each step runs across the
// kN elements, so that independent instructions sit side by side and a
// single warp keeps issuing (no branch: an element off the main branch
// gets a value its caller throws away).
template <int kN>
__device__ __forceinline__ void gelu_grad_main(const float (&g)[kN], const float (&x)[kN], float (&dx)[kN]) {
  float t[kN], h[kN], tc[kN], u[kN], a[kN], b[kN];
  float hp[9][kN];  // P's Horner partials, the top first (hp[0] = kMain[8])
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    t[e] = mul_ftz(-x[e], kSqrtHalfBf16);
    h[e] = mul_ftz(x[e], 0.5f);
    tc[e] = fminf(fabsf(t[e]), kClamp);
    u[e] = mul_ftz(tc[e], tc[e]);
    hp[0][e] = kMain[8];
  }
  round_bf16_n(h);
#pragma unroll
  for (int k = 1; k < 9; ++k) {
#pragma unroll
    for (int e = 0; e < kN; ++e) hp[k][e] = fma_ftz(hp[k - 1][e], u[e], kMain[8 - k]);
  }
  // dx_h = bf16(0.5 bf16(g e)), e = bf16(1 - t p): 0.5 x's share (in a)
#pragma unroll
  for (int e = 0; e < kN; ++e) a[e] = fma_ftz(-t[e], hp[8][e], 1.0f);
  round_bf16_n(a);
#pragma unroll
  for (int e = 0; e < kN; ++e) a[e] = mul_ftz(g[e], a[e]);
  round_bf16_n(a);
#pragma unroll
  for (int e = 0; e < kN; ++e) a[e] = mul_ftz(a[e], 0.5f);
  round_bf16_n(a);
  // the transposed chain: g_p = -h g (the cotangent of t P), then P's Horner
  // steps transposed into g_u (in b), g_t (in h)
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    const float g_p = -mul_ftz(h[e], g[e]);
    dx[e] = g_p;
    h[e] = mul_ftz(t[e], g_p);
    b[e] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      b[e] = fma_ftz(hp[7 - k][e], h[e], b[e]);
      h[e] = mul_ftz(h[e], u[e]);
    }
  }
  // d_t = g_p p + g_ta's share by t's sign (|t| < 32: the clamp passes g_ta
  // whole), then dx = bf16(dx_h - bf16(bf16(d_t) c)) before its rounding
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    const float g_tc = mul_ftz(tc[e], b[e]);
    const float g_ta = add_ftz(g_tc, g_tc);
    const bool nonneg = t[e] >= 0.0f;
    b[e] = add_ftz(fma_ftz(dx[e], hp[8][e], nonneg ? g_ta : 0.0f), nonneg ? -0.0f : -g_ta);
  }
  round_bf16_n(b);
#pragma unroll
  for (int e = 0; e < kN; ++e) b[e] = mul_ftz(b[e], kSqrtHalfBf16);
  round_bf16_n(b);
#pragma unroll
  for (int e = 0; e < kN; ++e) dx[e] = add_ftz(a[e], -b[e]);
}

// Whether gelu_grad leaves the main branch for x: the tail, the saturated
// side or an infinite x (a NaN x stays on it).
__device__ __forceinline__ bool gelu_grad_off_main(float x) { return fabsf(mul_ftz(-x, kSqrtHalfBf16)) > kSat; }

__device__ __forceinline__ __nv_bfloat16 gelu_grad(__nv_bfloat16 gb, __nv_bfloat16 xb) {
  const float x = __bfloat162float(xb);
  const float g = __bfloat162float(gb);
  const float nan = __int_as_float(0x7fc00000);
  const float t = mul_ftz(-x, kSqrtHalfBf16);  // NaN x: NaN through the main branch
  if (t <= -kSat)  // e = 2, no cotangent reaches t (x = +inf: inf * 0 in the chain)
    return __float2bfloat16_rn(isinf(x) ? nan : half_share(g, 2.0f));
  if (t > kSat) {
    const float ta = fabsf(t);
    const float tc = fminf(ta, kClamp);
    return isinf(x) ? __float2bfloat16_rn(nan) : tail_grad(g, round_bf16(mul_ftz(x, 0.5f)), ta, tc, mul_ftz(tc, tc));
  }
  float gv[1] = {g}, xv[1] = {x}, dx[1];
  gelu_grad_main(gv, xv, dx);
  return __float2bfloat16_rn(dx[0]);
}

// gelu_grad of 8 elements (one 16-byte vector each of g and x; g's
// replaced by the result), kN at a time, without a branch: the main
// branch's chains straight-line for all of them (gelu_grad_main). Returns
// the mask of the elements off the main branch (bit e), whose results are
// still to be computed by gelu_grad (~0.4% of a normal pre-activation), so
// that a caller can gather them and run them together. An epilogue with
// one warp a scheduler needs the chains' parallelism to keep issuing.
template <int kN>
__device__ __forceinline__ uint32_t gelu_grad8(uint4& gv, const uint4& xv) {
  static_assert(8 % kN == 0 && kN % 2 == 0, "kN divides the vector, in pairs");
  uint32_t* gw = reinterpret_cast<uint32_t*>(&gv);
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv);
  uint32_t off = 0;
#pragma unroll
  for (int e0 = 0; e0 < 8; e0 += kN) {
    float g[kN], x[kN], dx[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const uint32_t gb = gw[(e0 + e) / 2], xb = xw[(e0 + e) / 2];
      g[e] = __uint_as_float((e % 2) ? (gb & 0xFFFF0000u) : (gb << 16));
      x[e] = __uint_as_float((e % 2) ? (xb & 0xFFFF0000u) : (xb << 16));
      off |= static_cast<uint32_t>(gelu_grad_off_main(x[e])) << (e0 + e);
    }
    gelu_grad_main(g, x, dx);
#pragma unroll
    for (int e = 0; e < kN; e += 2) {
      __nv_bfloat162 r = __floats2bfloat162_rn(dx[e], dx[e + 1]);
      gw[(e0 + e) / 2] = *reinterpret_cast<uint32_t*>(&r);
    }
  }
  return off;
}

}  // namespace ufm
