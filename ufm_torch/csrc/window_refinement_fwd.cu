// Window refinement forward for Hopper (sm_90a), fp32 in / fp32 out.
//
// Replaces: the Pallas window-dots kernels of ufm_tpu/ops/window_dots.py,
// `_dots16` (:280, pallas_call :314, body `_dots_kernel` :93) and `_dots8`
// (:238, pallas_call :267, body `_dots8_kernel` :165), together with the XLA
// code around them in ufm_tpu/ops/refinement.py::_fused_refinement_pallas
// (:224): the bicubic combination (window_dots.py:541-557) and `_scores_tail`
// (refinement.py:210). One launch computes, for every pixel p of a
// (B, H, W, C) pair of feature maps q, f:
//
//   pos        = clamp(flow(p) + p, [-(r+4), W+r+4] x [-(r+4), H+r+4])
//   dots[v][u] = <q(p), f[yb + v, xb + u]>   for the (P+3)^2 integer taps,
//                (xb, yb) = floor(pos) - r - 1, zero outside the image
//   scores     = separable cubic (A = -0.75) combination of dots, P x P
//   s          = scores / temperature + bias
//   log_softmax(s), residual = sum softmax(s)[i][j] * (j - r, i - r)
//
// The clamp cannot change a score (a window wholly outside the image stays
// all zero) and keeps the float -> int conversion defined for any flow.
//
// Design. The TPU kernels keep the padded target map in VMEM (or a row-shifted
// stack in HBM), align every window to 128 lanes and reduce the channel axis
// with a 0/1 selection matmul: all of that exists for Mosaic. Here each
// thread owns one pixel, and neighbouring threads own neighbouring x, so the
// tap reads of nearby pixels fall on the same L1 / L2 lines. q(p) sits in
// registers; each tap is C / 4 16-byte loads. The x pass of the cubic
// combination runs row by row as the taps arrive (K x P partial sums, not K x K
// dots, stay live), then the y pass, the max-subtracted softmax, log_softmax
// and the residual, all fp32 FMA. Tensor cores have nothing to do: each pixel
// gathers its own taps, so no operand is shared across a tile.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores), at
// the main path's shape (1, 420, 560, C = 16), P = 5:
//   bytes: q + f read once, flow read, residual + log_softmax written,
//          4 * (2 * 16 + 2 + 2 + 25) B * 235,200 px = 57 MB -> 17 us;
//   operations: 2 * 64 * 16 dot FLOPs + ~520 cubic + the softmax tail,
//          ~2.7 kFLOP a pixel = 0.63 GFLOP -> 9 us.
// So it is bound by bytes. Its real floor is the per-tap gather traffic
// (64 taps x 64 B a pixel, ~0.96 GB through L1 / L2), which a later version
// can cut by staging a tile of f in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr float kCubicA = -0.75f;  // torch's cubic convolution constant

// Cubic-convolution weights of the taps at [-1, 0, 1, 2] from the floor tap.
__device__ __forceinline__ void cubic_weights(float t, float wgt[4]) {
  const float a = kCubicA;
  const float x0 = t + 1.0f, x3 = 2.0f - t, x2 = 1.0f - t;
  wgt[0] = (((x0 - 5.0f) * x0 + 8.0f) * x0 - 4.0f) * a;
  wgt[1] = ((a + 2.0f) * t - (a + 3.0f)) * t * t + 1.0f;
  wgt[2] = ((a + 2.0f) * x2 - (a + 3.0f)) * x2 * x2 + 1.0f;
  wgt[3] = (((x3 - 5.0f) * x3 + 8.0f) * x3 - 4.0f) * a;
}

template <int C, int P>
__global__ void __launch_bounds__(kThreads)
    window_refinement_fwd_kernel(const float* __restrict__ q, const float* __restrict__ f,
                                 const float* __restrict__ flow, const float* __restrict__ bias,
                                 float* __restrict__ residual, float* __restrict__ log_softmax, int h, int w,
                                 long long total, float temperature) {
  constexpr int R = (P - 1) / 2;
  constexpr int K = P + 3;  // integer tap span per axis
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= total) return;
  const int x = static_cast<int>(n % w);
  const long long row = n / w;
  const int y = static_cast<int>(row % h);
  const long long img = row / h;

  float qr[C];
  const float4* qv = reinterpret_cast<const float4*>(q + n * C);
#pragma unroll
  for (int c4 = 0; c4 < C / 4; ++c4) {
    const float4 t = __ldg(qv + c4);
    qr[4 * c4] = t.x;
    qr[4 * c4 + 1] = t.y;
    qr[4 * c4 + 2] = t.z;
    qr[4 * c4 + 3] = t.w;
  }

  const float2 fl = __ldg(reinterpret_cast<const float2*>(flow) + n);
  const float m = static_cast<float>(R + 4);
  const float px = fminf(fmaxf(fl.x + static_cast<float>(x), -m), static_cast<float>(w) + m);
  const float py = fminf(fmaxf(fl.y + static_cast<float>(y), -m), static_cast<float>(h) + m);
  const float x0 = floorf(px), y0 = floorf(py);
  float wx[4], wy[4];
  cubic_weights(px - x0, wx);
  cubic_weights(py - y0, wy);
  const int xb = static_cast<int>(x0) - R - 1;  // leftmost tap
  const int yb = static_cast<int>(y0) - R - 1;  // topmost tap

  const float* fimg = f + img * h * w * C;
  float sx[K][P];  // x pass: sx[v][j] = sum_m wx[m] * dots[v][j + m]
#pragma unroll
  for (int v = 0; v < K; ++v) {
    const int iy = yb + v;
    const bool y_ok = iy >= 0 && iy < h;
    float d[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int ix = xb + u;
      float acc = 0.0f;
      if (y_ok && ix >= 0 && ix < w) {
        const float4* fv = reinterpret_cast<const float4*>(fimg + (static_cast<long long>(iy) * w + ix) * C);
#pragma unroll
        for (int c4 = 0; c4 < C / 4; ++c4) {
          const float4 t = __ldg(fv + c4);
          acc = fmaf(qr[4 * c4], t.x, acc);
          acc = fmaf(qr[4 * c4 + 1], t.y, acc);
          acc = fmaf(qr[4 * c4 + 2], t.z, acc);
          acc = fmaf(qr[4 * c4 + 3], t.w, acc);
        }
      }
      d[u] = acc;
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) s = fmaf(wx[mm], d[j + mm], s);
      sx[v][j] = s;
    }
  }

  // y pass, temperature and bias: s[i][j] = sum_l wy[l] * sx[i + l][j] / t + bias
  float s[P * P];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < 4; ++l) acc = fmaf(wy[l], sx[i + l][j], acc);
      const float v = acc / temperature + __ldg(bias + i * P + j);
      s[i * P + j] = v;
      mx = fmaxf(mx, v);
    }
  }

  float sum = 0.0f, rx = 0.0f, ry = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float e = expf(s[i * P + j] - mx);
      sum += e;
      rx = fmaf(e, static_cast<float>(j - R), rx);
      ry = fmaf(e, static_cast<float>(i - R), ry);
    }
  }
  const float lse = logf(sum);
  float* ls = log_softmax + n * (P * P);
#pragma unroll
  for (int k = 0; k < P * P; ++k) ls[k] = s[k] - mx - lse;
  reinterpret_cast<float2*>(residual)[n] = make_float2(rx / sum, ry / sum);
}

template <int C, int P>
int launch(const void* q, const void* f, const void* flow, const void* bias, void* residual, void* log_softmax,
           int h, int w, long long total, float temperature, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  window_refinement_fwd_kernel<C, P><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(f), static_cast<const float*>(flow),
      static_cast<const float*>(bias), static_cast<float*>(residual), static_cast<float*>(log_softmax), h, w, total,
      temperature);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_p(int p, const void* q, const void* f, const void* flow, const void* bias, void* residual,
             void* log_softmax, int h, int w, long long total, float temperature, cudaStream_t stream) {
  switch (p) {
    case 1: return launch<C, 1>(q, f, flow, bias, residual, log_softmax, h, w, total, temperature, stream);
    case 3: return launch<C, 3>(q, f, flow, bias, residual, log_softmax, h, w, total, temperature, stream);
    case 5: return launch<C, 5>(q, f, flow, bias, residual, log_softmax, h, w, total, temperature, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, f: (B, H, W, C) fp32 contiguous, 16-byte aligned; flow: (B, H, W, 2);
// bias: (P * P,); residual: (B, H, W, 2); log_softmax: (B, H, W, P, P).
// C in {4, 8, 16}, P in {1, 3, 5}. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported C or P).
extern "C" int ufm_window_refinement_fwd_f32(const void* q, const void* f, const void* flow, const void* bias,
                                             void* residual, void* log_softmax, int batch, int h, int w, int c,
                                             int p, float temperature, void* stream) {
  const long long total = static_cast<long long>(batch) * h * w;
  if (total == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 4: return launch_p<4>(p, q, f, flow, bias, residual, log_softmax, h, w, total, temperature, s);
    case 8: return launch_p<8>(p, q, f, flow, bias, residual, log_softmax, h, w, total, temperature, s);
    case 16: return launch_p<16>(p, q, f, flow, bias, residual, log_softmax, h, w, total, temperature, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
