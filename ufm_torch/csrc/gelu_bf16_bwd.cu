// The gradient of the JAX package's bf16 exact GELU for Hopper (sm_90a):
// bf16 cotangent g and input x in, bf16 dx out.
//
// Replaces: the VJP of ufm_tpu/ops/gelu.py::fast_exact_gelu (:106; its erfc
// `fast_erfc_f32` :73), which the JAX package trains through (the MLP's
// activation, ufm_tpu/nn/layers.py:36,51). JAX has no rule of its own for it:
// jax.vjp transposes the forward's chain, about 60 fp32 ops, and XLA compiles
// that into one fused elementwise pass. One launch computes, for every element,
// the program XLA's CPU runs for it (its order, its roundings, its fused
// multiply-adds, its flushes), as spelled out by the plain version
// ufm_torch/ops/gelu.py::fast_exact_gelu_vjp_reference:
//
//   t = -x c (fp32, exact), tc = min(|t|, 32), u = tc^2
//   main (|t| <= 2.046875):  erfc = 1 - t P(u)
//   tail (t > 2.046875):     erfc = exp(-u) u^-1/2 Q(u^-1/2)
//   sat (t <= -2.046875):    erfc = 2
//   dx = bf16(bf16(0.5 bf16(g e)) - bf16(bf16(d_t) c)),  e = bf16(erfc)
//
// where d_t is the transposed chain of the selected branch, fed h g with
// h = bf16(0.5 x). The JAX package's output on the CPU is the contract
// (tests/golden/gelu_bf16_vjp_table.npz: every bf16 x under unit and seeded
// normal cotangents).
//
// How the bits are kept: every fp32 operation is one PTX instruction with
// .ftz and explicit rounding (gelu_bf16.cuh's mul_ftz / add_ftz / fma_ftz /
// div_ftz): XLA's CPU reads subnormal operands as zeros and flushes
// subnormal results, and nvcc may neither contract nor reorder such an
// instruction. A multiply-add is one fma exactly where XLA's CPU code fuses
// one (LLVM contracts a product that has one use into the add that takes
// it): both polynomials' Horner steps, 1 - t P, the transposed steps'
// accumulations, and the exp term's first sum. The tail's u^-1/2 and exp(-u)
// are the fp32 roundings of IEEE fp64 1 / sqrt(u) and exp(-u) (the plain
// version's, on either device; XLA's CPU is within an ulp of them, which moves
// no bf16 gradient on the table). The division (u^-1/2) / u is IEEE.
//
// Branches: an element evaluates only the branch it selects. The JAX program
// also runs the other branches, on a zero cotangent; their only trace is the
// sign of a zero they add to the result, worked out once here: the main
// branch's transposed chain starts from +0 (the tail's zeros sum to +0 at
// u^-1/2 = 1), a saturated element's result is 0.5 g's share alone, and in
// the tail the main polynomial's zeros can only turn a -0 cotangent of u
// into +0 (where one of its odd Horner partials is negative), which is
// checked where the cotangent is zero. A non-finite x gives NaN (inf * 0 in
// the chain). The tail is out of line (tail_grad).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): 6 bytes an element (read
// g and x, write dx) against 55 fp32 operations on the main branch (an fma
// counted as 2): 9 operations a byte where the card has 20, so bound by
// bytes. At the encoder's (4, 1201, 4096) hidden activation, 118 MB ->
// 35.2 us. What sets the pace is instruction issue: ~60 instructions an
// element on the main branch (the 55 operations, each its own instruction
// where JAX's program keeps it apart, and six bf16 roundings), so the kernel
// runs at about half its bytes bound, behind aten.gelu_backward's one exact
// derivative (chip_smoke's gelu_backward phase; PERF.md row 5).
//
// Design: a pure streaming pass, as gelu_bf16_fwd.cu: each thread loads 16
// bytes (8 elements) of g and of x, computes in fp32 registers, stores 16
// bytes; a grid-stride loop over as many CTAs as fit on the card at once;
// the last n % 8 elements one by one in CTA 0. Base addresses that are not
// all 16-byte aligned take the scalar instance. No shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "gelu_bf16.cuh"

namespace {

using ufm::add_ftz;
using ufm::div_ftz;
using ufm::fma_ftz;
using ufm::mul_ftz;
using ufm::round_bf16;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 elements in a 16-byte vector
constexpr int kMaxDevices = 64;

// dx_h = bf16(0.5 bf16(g e)): 0.5 x's share of the gradient
__device__ __forceinline__ float half_share(float g, float e) {
  return round_bf16(mul_ftz(round_bf16(mul_ftz(g, e)), 0.5f));
}

// dx = bf16(dx_h - bf16(bf16(d_t) c)): t = -x c's share added
__device__ __forceinline__ __nv_bfloat16 finish(float dx_h, float d_t) {
  const float dx_t = -round_bf16(mul_ftz(round_bf16(d_t), ufm::kSqrtHalfBf16));
  return __float2bfloat16_rn(add_ftz(dx_h, dx_t));
}

// The tail (t > 2.046875): erfc = exp(-u) inv Q(inv), inv = u^-1/2. Out of
// line: ~0.2% of a normal pre-activation takes it, and inlined, its fp64 exp
// and division would be copied into each of the eight unrolled elements.
__device__ __noinline__ __nv_bfloat16 tail_grad(float g, float h, float ta, float tc, float u) {
  const double ud = static_cast<double>(u);
  const float ex = ufm::flush(__double2float_rn(exp(-ud)));
  const float inv = __double2float_rn(__ddiv_rn(1.0, __dsqrt_rn(ud)));
  const float ex_inv = mul_ftz(ex, inv);
  float hq[6];
  hq[0] = ufm::kTail[5];
#pragma unroll
  for (int k = 1; k < 6; ++k) hq[k] = fma_ftz(hq[k - 1], inv, ufm::kTail[5 - k]);
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
  const float d_exp = mul_ftz(mul_ftz(mul_ftz(g_ex_inv, inv), ufm::kLn2), ex);
  float g_u = fma_ftz(-d_exp, ufm::kLog2e, mul_ftz(g_inv, mul_ftz(div_ftz(inv, u), -0.5f)));
  if (g_u == 0.0f && signbit(g_u)) {
    // the main branch's zeros: -0 where P's partial is positive, +0 where negative
    float hp = ufm::kMain[8];
    bool negative = false;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      hp = fma_ftz(hp, u, ufm::kMain[8 - k]);
      negative |= hp < 0.0f;
    }
    if (negative) g_u = 0.0f;
  }
  const float g_tc = mul_ftz(tc, g_u);
  // min(|t|, 32)'s cotangent: whole below 32, half at the tie, none above
  const float clamp_share = ta < ufm::kClamp ? 1.0f : (ta == ufm::kClamp ? 0.5f : 0.0f);
  return finish(dx_h, mul_ftz(add_ftz(g_tc, g_tc), clamp_share));
}

__device__ __forceinline__ __nv_bfloat16 gelu_grad(__nv_bfloat16 gb, __nv_bfloat16 xb) {
  const float x = __bfloat162float(xb);
  const float g = __bfloat162float(gb);
  const float nan = __int_as_float(0x7fc00000);
  const float t = mul_ftz(-x, ufm::kSqrtHalfBf16);  // NaN x: NaN through the main branch
  if (t <= -ufm::kSat)  // e = 2, no cotangent reaches t (x = +inf: inf * 0 in the chain)
    return __float2bfloat16_rn(isinf(x) ? nan : half_share(g, 2.0f));
  const float h = round_bf16(mul_ftz(x, 0.5f));
  const float ta = fabsf(t);
  const float tc = fminf(ta, ufm::kClamp);
  const float u = mul_ftz(tc, tc);
  if (t > ufm::kSat) return isinf(x) ? __float2bfloat16_rn(nan) : tail_grad(g, h, ta, tc, u);
  // main: erfc = 1 - t P(u); P's Horner partials, the top first
  float hp[9];
  hp[0] = ufm::kMain[8];
#pragma unroll
  for (int k = 1; k < 9; ++k) hp[k] = fma_ftz(hp[k - 1], u, ufm::kMain[8 - k]);
  const float p = hp[8];
  const float dx_h = half_share(g, round_bf16(fma_ftz(-t, p, 1.0f)));
  const float g_p = -mul_ftz(h, g);  // the cotangent of P's product t P
  float g_t = mul_ftz(t, g_p);
  float g_u = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    g_u = fma_ftz(hp[7 - k], g_t, g_u);
    g_t = mul_ftz(g_t, u);
  }
  const float g_tc = mul_ftz(tc, g_u);
  const float g_ta = add_ftz(g_tc, g_tc);  // |t| < 32: the clamp passes it whole
  const bool nonneg = t >= 0.0f;
  const float d_t = add_ftz(fma_ftz(g_p, p, nonneg ? g_ta : 0.0f), nonneg ? -0.0f : -g_ta);
  return finish(dx_h, d_t);
}

// kVector: g, x and dx 16-byte aligned, n / 8 vectors then n % 8 scalars;
// otherwise n scalars.
template <bool kVector>
__global__ void __launch_bounds__(kThreads) gelu_bf16_bwd_kernel(const __nv_bfloat16* __restrict__ g,
                                                                  const __nv_bfloat16* __restrict__ x,
                                                                  __nv_bfloat16* __restrict__ dx, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (kVector) {
    const long long n_vec = n / kVec;
    const uint4* gv = reinterpret_cast<const uint4*>(g);
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* dv = reinterpret_cast<uint4*>(dx);
    for (long long i = first; i < n_vec; i += stride) {
      uint4 a = __ldg(gv + i);
      const uint4 b = __ldg(xv + i);
      __nv_bfloat16* ga = reinterpret_cast<__nv_bfloat16*>(&a);
      const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
      for (int k = 0; k < kVec; ++k) ga[k] = gelu_grad(ga[k], xb[k]);
      dv[i] = a;
    }
    const long long done = n_vec * kVec;
    if (blockIdx.x == 0 && done + threadIdx.x < n)
      dx[done + threadIdx.x] = gelu_grad(g[done + threadIdx.x], x[done + threadIdx.x]);
  } else {
    for (long long i = first; i < n; i += stride) dx[i] = gelu_grad(g[i], x[i]);
  }
}

template <bool kVector>
int launch(const __nv_bfloat16* g, const __nv_bfloat16* x, __nv_bfloat16* dx, long long n, cudaStream_t stream) {
  // CTAs resident on the card at once, per device (queried once: a captured
  // launch makes no query)
  static std::atomic<int> resident[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int cap = resident[dev].load(std::memory_order_relaxed);
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gelu_bf16_bwd_kernel<kVector>, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    cap = sms * per_sm;
    resident[dev].store(cap, std::memory_order_relaxed);
  }
  const long long work = kVector ? (n / kVec > 0 ? n / kVec : 1) : n;
  const long long blocks = (work + kThreads - 1) / kThreads;
  const int grid = blocks < cap ? static_cast<int>(blocks) : cap;
  gelu_bf16_bwd_kernel<kVector><<<grid, kThreads, 0, stream>>>(g, x, dx, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g, x, dx: n bf16 elements each, contiguous. Launches on `stream`; returns 0
// or a cudaError_t. n == 0 launches nothing.
extern "C" int ufm_gelu_bf16_bwd(const void* g, const void* x, void* dx, long long n, void* stream) {
  if (n <= 0) return 0;
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* db = static_cast<__nv_bfloat16*>(dx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dx)) % 16 == 0;
  return aligned ? launch<true>(gb, xb, db, n, s) : launch<false>(gb, xb, db, n, s);
}
