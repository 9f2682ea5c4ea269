// The SwiGLU FFN's w12 product with the gate as its epilogue, for Hopper
// (sm_90a): bf16 in, bf16 out.
//
// Replaces no TPU kernel: the JAX package has no SwiGLU FFN. It runs the
// first half of DINOv2's SwiGLUFFNFused (dinov2/layers/swiglu_ffn.py), the FFN
// of every block of the ViT-g/14 encoder: w12 -> chunk -> silu(x1) * x2. For x
// (M, K) and w12 (2H, K) (nn.Linear's layout: both operands K-major, row-major
// in memory) with bias b12 (2H,), all bf16, W1 / b1 the first H rows of w12 /
// b12 (x1) and W2 / b2 the last H (x2):
//
//   h1[m, n] = bf16_rn(sum_k x[m, k] W1[n, k] (fp32 accumulate) + float(b1[n]))
//   h2[m, n] = bf16_rn(sum_k x[m, k] W2[n, k] (fp32 accumulate) + float(b2[n]))
//   y[m, n]  = bf16_rn(silu(float(h1)) * float(h2))      n < H
//
// h1 and h2 are each rounded once, as cuBLASLt's bias epilogue rounds
// F.linear's output; the gate is evaluated in fp32 and rounded once
// (ufm_torch/ops/linear_swiglu.py::linear_swiglu_reference is the same
// arithmetic in PyTorch; silu here is h1 * rcp(1 + 2^(-h1 log2 e)), within a
// few fp32 ulps of torch's, so y may differ from it by one bf16 ulp).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 2 M K (2H)
// operations against x, w12 and b12 read once and y written once. At the
// ViT-g/14 cell's shape (M = 2 x 1205 = 2410 rows a batch-1 forward, K =
// 1536, 2H = 8192): 60.7 GFLOP -> 61 us; 52 MB -> 16 us: bound by
// operations. Fusing the gate saves the (M, 2H) bf16 intermediate's write
// and read back (2 x 39.5 MB a block at M = 2410) and one elementwise launch
// a block; what it costs is the gate in the epilogue, ~64 elements a thread
// a tile against ~6.5 us of tensor-core work a 128 x 128 tile.
//
// Design (linear_gelu_bf16_fwd.cu's ping-pong schedule): a persistent grid
// (one CTA per SM walks the output tiles, hidden columns fastest) of three
// warpgroups.
//   * An output tile is 128 rows x 64 hidden columns n0..n0+63. Its B operand
//     is two TMA boxes of w12 as stored: rows n0..n0+63 of W1 and the same
//     rows of W2, stacked in shared memory into one 128-row tile, so one
//     m64n128k16 product per k-step and m64 half gives x1's columns in the
//     accumulator's first 64 columns and x2's in the last 64. In the wgmma
//     fragment (d[4j + 2i + c] is column 8j + 2t + c) a thread holds column c
//     of x1 in fragment j < 8 and the same column of x2 in fragment j + 8: the
//     gate needs no exchange between threads.
//   * W1 and W2 are two tensor maps of H rows each (the second based at row
//     H), so a box past H reads zeros and never the other half.
//   * Warpgroup 0 is the producer (setmaxnreg down to 40): one thread keeps
//     TMA loads of the x box (128 rows) and both w12 boxes (64 rows each; 64
//     K-columns, 128-byte swizzle, zero fill past the matrices, which covers
//     the M, H and K tails) in flight through a ring of kStages stages
//     (full / empty mbarriers).
//   * Warpgroups 1 and 2 are consumers (setmaxnreg up to 232) running wgmma
//     m64n128k16 on fp32 accumulators of 128 registers a thread. Each takes
//     every other tile of its CTA; an ordered pair of named barriers lets one
//     consumer issue its main loop only after the other has issued all of
//     its own, so the tensor cores run one tile's product while the other
//     consumer runs the previous tile's epilogue. No branch the compiler sees
//     as divergent lies between a consumer's first product and its wait for
//     the last (ptxas would serialize the products).
//   * Epilogue: h1, h2 = bf16(acc + bias), y = bf16(silu(h1) h2), packed into
//     a padded shared-memory tile of the consumer's own (conflict-free
//     stores), then stored as 16-byte vectors, rows >= M and columns >= H
//     predicated off.
//
// CUDA graphs: the SM count is queried once per device and the tensor maps
// are __grid_constant__ parameters, so a captured launch makes no host query.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90_async.cuh"

namespace {

using namespace ufm;

constexpr int kBK = 64;        // K per stage: one 128-byte swizzle row
constexpr int kBM = 128;       // rows of a tile, all of them one consumer's
constexpr int kBH = 64;        // hidden columns of a tile
constexpr int kBN = 2 * kBH;   // product columns of a tile: kBH of x1, then kBH of x2
constexpr int kThreads = 384;  // the producer warpgroup, then two consumer warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 40 * 128 + 232 * 256 <= 65536
constexpr int kMaxDevices = 64;
constexpr int kVec = 8;  // bf16 in a 16-byte vector
constexpr int kStages = 5;
constexpr int kABytes = kBM * kBK * 2;      // 16 KB
constexpr int kHalfBBytes = kBH * kBK * 2;  // 8 KB: one w12 box
constexpr int kStageBytes = kABytes + 2 * kHalfBBytes;
constexpr int kRowBytes = kBH * 2 + 16;     // padded y row: conflict-free stores
constexpr int kEpiBytes = kBM * kRowBytes;  // one consumer's y tile
constexpr int kAccRegs = 64 * kBN / 128;    // per m64 half, per thread
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kEpiBytes + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "shared memory");

// named barriers: 1 + w = "consumer w may issue its main loop",
// 3 + w = consumer w's own 128 threads
constexpr int kTurnBar = 1;
constexpr int kWgBar = 3;

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// silu(h1) * h2 of the rounded halves, in fp32 (1 / (1 + inf) = 0 where
// exp(-h1) overflows).
__device__ __forceinline__ float gate(float a1, float a2) {
  const float h1 = round_bf16(a1);
  const float h2 = round_bf16(a2);
  return h1 * __frcp_rn(1.f + exp2f(-1.4426950408889634f * h1)) * h2;
}

// y = bf16(silu(h1) h2) of a consumer's 128 rows x 64 hidden columns into its
// padded tile; the fragment's column 8j + 2t + c is x1's for j < 8, x2's for
// j >= 8 (the same hidden column 8(j - 8) + 2t + c).
__device__ __forceinline__ void stage_y(const float (&acc)[2][kAccRegs], const __nv_bfloat16* __restrict__ b1,
                                        const __nv_bfloat16* __restrict__ b2, uint8_t* tile, int col0, int hidden,
                                        int warp, int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < kBH / 8; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    float p0 = 0.f, p1 = 0.f, q0 = 0.f, q1 = 0.f;
    if (col < hidden) {
      const __nv_bfloat162 bb1 = *reinterpret_cast<const __nv_bfloat162*>(b1 + col);
      const __nv_bfloat162 bb2 = *reinterpret_cast<const __nv_bfloat162*>(b2 + col);
      p0 = __bfloat162float(bb1.x);
      p1 = __bfloat162float(bb1.y);
      q0 = __bfloat162float(bb2.x);
      q1 = __bfloat162float(bb2.y);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int row = 64 * h + 16 * warp + lane / 4 + 8 * i2;
        const int r1 = 4 * j + 2 * i2;
        const int r2 = 4 * (j + kBH / 8) + 2 * i2;
        const float y0 = gate(__fadd_rn(acc[h][r1], p0), __fadd_rn(acc[h][r2], q0));
        const float y1 = gate(__fadd_rn(acc[h][r1 + 1], p1), __fadd_rn(acc[h][r2 + 1], q1));
        *reinterpret_cast<uint32_t*>(tile + row * kRowBytes + (8 * j + 2 * t) * 2) = pack_bf16x2(y0, y1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) linear_swiglu_bf16_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w1,
    const __grid_constant__ CUtensorMap tm_w2, const __nv_bfloat16* __restrict__ b12, __nv_bfloat16* __restrict__ y,
    int m, int hidden, int k) {
  extern __shared__ uint8_t smem_raw[];
  // stage s: x box, then the W1 box and the W2 box; offsets from smem_raw keep
  // the pointers in the shared address space (ld.shared, not generic loads)
  uint8_t* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* epi = stages + kStages * kStageBytes;  // consumer w's y tile at w * kEpiBytes
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * kEpiBytes);
  uint64_t* empty = full + kStages;

  const int n_tiles = (hidden + kBH - 1) / kBH;
  const int tiles = ((m + kBM - 1) / kBM) * n_tiles;
  const int k_blocks = (k + kBK - 1) / kBK;
  // this CTA's tiles: blockIdx.x + i * gridDim.x, i < my_tiles
  const int my_tiles = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // the warpgroup, warp-uniform to the compiler (a value it sees as divergent
  // around the wgmma pipeline makes ptxas serialize the products)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per warp of the consumer that reads the stage
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load, tile after tile
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&tm_x);
      prefetch_tensor_map(&tm_w1);
      prefetch_tensor_map(&tm_w2);
      int q = 0;  // stage sequence number
      for (int i = 0; i < my_tiles; ++i) {
        const int tile = blockIdx.x + i * gridDim.x;
        const int m0 = (tile / n_tiles) * kBM;
        const int n0 = (tile % n_tiles) * kBH;
        for (int kb = 0; kb < k_blocks; ++kb, ++q) {
          const int s = q % kStages;
          if (q >= kStages) mbar_wait(&empty[s], ((q / kStages) - 1) & 1);
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          uint8_t* st = stages + s * kStageBytes;
          tma_load_2d(st, &tm_x, &full[s], kb * kBK, m0);
          tma_load_2d(st + kABytes, &tm_w1, &full[s], kb * kBK, n0);
          tma_load_2d(st + kABytes + kHalfBBytes, &tm_w2, &full[s], kb * kBK, n0);
        }
      }
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid / 32;
  const int lane = tid % 32;
  uint8_t* my_epi = epi + cw * kEpiBytes;
  constexpr int kTileVecs = kBM * kBH / kVec / 128;  // 16-byte vectors a thread stores a tile
  constexpr int kChunks = kBH / kVec;                // vectors a row

  // consumer cw takes the CTA's tiles i = cw, cw + 2, ...; before tile i > 0
  // it waits for its turn, which the other consumer hands over once tile
  // i - 1's products are issued
  for (int i = cw; i < my_tiles; i += 2) {
    const bool hand_over = i + 1 < my_tiles;
    if (i > 0) named_bar_sync(kTurnBar + cw, 256);

    float acc[2][kAccRegs];
    int q = i * k_blocks;
    for (int kb = 0; kb < k_blocks; ++kb, ++q) {
      const int s = q % kStages;
      mbar_wait(&full[s], (q / kStages) & 1);
      const uint8_t* st = stages + s * kStageBytes;
      const uint64_t desc_b = sw128_desc(st + kABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          wgmma_ss_n128<0>(acc[h], sw128_desc(st + h * 64 * kBK * 2) + kk * kKStepKMajor,
                           desc_b + kk * kKStepKMajor, (kb | kk) != 0);
        }
      }
      wgmma_commit();
      if (kb > 0) {  // the previous stage's products are done: hand it back
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(q - 1) % kStages]);
      }
    }
    if (hand_over) named_bar_arrive(kTurnBar + (1 - cw), 256);
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) fence_regs(acc[h]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(q - 1) % kStages]);

    // ---- epilogue: y = bf16(silu(h1) h2) into this consumer's tile, then
    // 16 bytes a thread and step to global memory
    const int tile = blockIdx.x + i * gridDim.x;
    const int row0 = (tile / n_tiles) * kBM;
    const int col0 = (tile % n_tiles) * kBH;
    named_bar_sync(kWgBar + cw, 128);  // the previous tile's reads of my_epi are done
    stage_y(acc, b12, b12 + hidden, my_epi, col0, hidden, warp, lane);
    named_bar_sync(kWgBar + cw, 128);
#pragma unroll
    for (int j = 0; j < kTileVecs; ++j) {
      const int v = tid + 128 * j;
      const int row = row0 + v / kChunks;
      const int col = col0 + (v % kChunks) * kVec;
      const uint4 yv = *reinterpret_cast<const uint4*>(my_epi + (v / kChunks) * kRowBytes + (v % kChunks) * 16);
      store16_if(y + static_cast<long long>(row) * hidden + col, yv, row < m && col < hidden);
    }
  }
}

int smem_set = 0;                        // devices on which the kernel may use its shared memory
std::atomic<int> sm_count[kMaxDevices];  // per device, queried once

}  // namespace

// x (m, k), w12 (2 hidden, k), b12 (2 hidden,), y (m, hidden): contiguous
// bf16, 16-byte aligned, k and hidden multiples of 8, m >= 1 (the wrapper
// checks all of it). Launches on `stream`; returns 0, a cudaError_t, or a
// kErr* code of sm90_async.cuh when a tensor map cannot be made.
extern "C" int ufm_linear_swiglu_bf16_fwd(const void* x, const void* w12, const void* b12, void* y, int m, int hidden,
                                          int k, void* stream) {
  CUtensorMap tm_x, tm_w1, tm_w2;
  int err = encode_rows_map(&tm_x, x, m, k, k, kBM);
  if (err == 0) err = encode_rows_map(&tm_w1, w12, hidden, k, k, kBH);
  if (err == 0) {
    const void* w2 = static_cast<const __nv_bfloat16*>(w12) + static_cast<long long>(hidden) * k;
    err = encode_rows_map(&tm_w2, w2, hidden, k, k, kBH);
  }
  if (err != 0) return err;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(linear_swiglu_bf16_fwd_kernel), kSmemBytes, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = sm_count[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    sm_count[dev].store(sms, std::memory_order_relaxed);
  }
  const long long tiles = static_cast<long long>((m + kBM - 1) / kBM) * ((hidden + kBH - 1) / kBH);
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  linear_swiglu_bf16_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_w1, tm_w2, static_cast<const __nv_bfloat16*>(b12), static_cast<__nv_bfloat16*>(y), m, hidden, k);
  return static_cast<int>(cudaGetLastError());
}
