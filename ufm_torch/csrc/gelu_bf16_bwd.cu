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

using ufm::gelu_grad;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 elements in a 16-byte vector
constexpr int kMaxDevices = 64;

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
