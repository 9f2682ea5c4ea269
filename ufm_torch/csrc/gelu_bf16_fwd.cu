// Exact GELU on bf16 for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces: ufm_tpu/ops/gelu.py::fast_exact_gelu (:106; its erfc
// `fast_erfc_f32` :73, the constants :42-71), the activation of every
// backbone MLP (ufm_tpu/nn/layers.py:36). That is XLA code, not a Pallas
// kernel: one fused elementwise pass on the TPU. One launch computes, for
// every element x of a contiguous bf16 tensor,
//
//   y = bf16(bf16(0.5 x) * bf16(erfc(bf16(-x * bf16(sqrt(0.5))))))
//
// which is jax.nn.gelu(x, approximate=False) on bf16, op for op, with erfc
// evaluated by the JAX package's polynomial: erf(t) = t P(t^2) on
// |t| <= 2.046875, exp2(-t^2 log2 e) (1/t) Q(1/t) above, 2 below -2.046875.
// The JAX package's output on the CPU is the contract
// (tests/golden/gelu_bf16_table.npz, every bf16 bit pattern). XLA's CPU
// flushes fp32 operands and results below 2^-126 to a zero of the same sign;
// so does this kernel, at each rounding where a subnormal can arise (0.5 x,
// -x c, t^2, the tail's three products, the last product). Every step is an
// explicit round-to-nearest intrinsic, so nothing depends on whether nvcc
// contracts: the products and roundings of the plain version
// (ufm_torch/ops/gelu.py::fast_exact_gelu_reference), except that each
// Horner step is one fused multiply-add where the plain version rounds the
// product first. That moves the fp32 erfc by an ulp or so, far inside the
// polynomials' margin to a bf16 rounding boundary: the bf16 results are the
// table's on every finite input (chip_smoke.py's gelu phase).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): 4 bytes an element
// (read 2, write 2) against 22 fp32 operations on the main branch, 5.5
// operations a byte where the card has 20: bound by bytes. At the encoder's
// (2, 1201, 4096) hidden activation, 39.4 MB -> 11.75 us. What sets the pace
// is instruction throughput, ~35 instructions an element (conversions,
// compares and the 9-term polynomial, 10^7 elements): so the common case
// takes a fast path without the flushes' compares (they cannot fire
// there), and the Horner steps are fused multiply-adds (chip_smoke.py's gelu
// phase on an H100 80GB HBM3 at 700 W: 23.0 us at the encoder shape without
// the two, 17.2-17.8 us with them; F.gelu's erf takes 15.2-15.4).
//
// Design: a pure streaming pass. Each thread loads 16 bytes (8 elements)
// with one vector load, computes in fp32 registers and stores 16 bytes; a
// grid-stride loop over as many CTAs as fit on the card at once; the last
// n % 8 elements are done one by one by the first threads of CTA 0. A base
// address that is not 16-byte aligned takes the scalar instance for the
// whole tensor. No shared memory, no tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "gelu_bf16.cuh"

namespace {

using ufm::gelu;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 elements in a 16-byte vector
constexpr int kMaxDevices = 64;

// kVector: x and y 16-byte aligned, n / 8 vectors then n % 8 scalars;
// otherwise n scalars.
template <bool kVector>
__global__ void __launch_bounds__(kThreads) gelu_bf16_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                                                                  __nv_bfloat16* __restrict__ y, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if constexpr (kVector) {
    const long long n_vec = n / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (long long i = first; i < n_vec; i += stride) {
      uint4 v = __ldg(xv + i);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) e[k] = gelu(e[k]);
      yv[i] = v;
    }
    done = n_vec * kVec;
    if (blockIdx.x == 0 && done + threadIdx.x < n) y[done + threadIdx.x] = gelu(x[done + threadIdx.x]);
  } else {
    for (long long i = first; i < n; i += stride) y[i] = gelu(x[i]);
  }
}

template <bool kVector>
int launch(const __nv_bfloat16* x, __nv_bfloat16* y, long long n, cudaStream_t stream) {
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
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gelu_bf16_fwd_kernel<kVector>, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    cap = sms * per_sm;
    resident[dev].store(cap, std::memory_order_relaxed);
  }
  const long long work = kVector ? (n / kVec > 0 ? n / kVec : 1) : n;
  const long long blocks = (work + kThreads - 1) / kThreads;
  const int grid = blocks < cap ? static_cast<int>(blocks) : cap;
  gelu_bf16_fwd_kernel<kVector><<<grid, kThreads, 0, stream>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: n bf16 elements each, contiguous. Launches on `stream`; returns 0 or
// a cudaError_t. n == 0 launches nothing.
extern "C" int ufm_gelu_bf16_fwd(const void* x, void* y, long long n, void* stream) {
  if (n <= 0) return 0;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  return aligned ? launch<true>(xb, yb, n, s) : launch<false>(xb, yb, n, s);
}
