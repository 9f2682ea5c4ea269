// The MLP's fc1 product with the bf16 exact GELU as its epilogue, for Hopper
// (sm_90a): bf16 in, bf16 out.
//
// Replaces: ufm_tpu/ops/gelu.py::fast_exact_gelu (:106) applied to the output
// of fc1 in ufm_tpu/nn/layers.py::Mlp (:50-51), i.e. the pair fc1 -> GELU of
// every backbone MLP. For x (M, K) and W (N, K) (nn.Linear's layout: both
// operands K-major, row-major in memory) and a bias b (N,), all bf16:
//
//   h[m, n] = bf16_rn(sum_k x[m, k] W[n, k] (fp32 accumulate) + float(b[n]))
//   y[m, n] = gelu(h[m, n])        (gelu_bf16.cuh: the JAX package's bits)
//
// h is rounded once, as cuBLASLt's bias epilogue rounds F.linear's output.
// The JAX package's nn.Dense rounds the product to bf16 and then adds the
// bf16 bias (a second rounding), so h may differ from the JAX package's by
// one bf16 ulp: a gap that already lies between the two packages' products
// and that the cross-backend golden tolerance (0.15) covers. The GELU of a
// given h is the JAX package's bit for bit. Training writes h through `pre`
// too (the GELU gradient's input, gelu_bf16_bwd.cu); the checks read it and
// hold y == gelu(h) on every element.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 2 M N K
// operations against x, W and b read once and y written once.
//   encoder      2402 x 1024 -> 4096: 20.1 GFLOP -> 20.4 us; 33 MB -> 9.9 us
//   info sharing 2400 x  768 -> 3072: 11.3 GFLOP -> 11.4 us; 23 MB -> 6.9 us
// so it is bound by operations. Fusing the GELU saves the standalone pass's
// read and write of the hidden activation (2 x 19.7 MB per encoder MLP) and
// one launch per MLP; what it costs is the GELU in the epilogue, against
// ~4.5 us (K = 1024) or ~3.4 us (K = 768) of tensor-core work per 128 x 128
// tile. The design hides most of the one under the other.
//
// Design: a persistent grid (one CTA per SM walks the output tiles, n
// fastest: the CTAs at work share a few row blocks of x while W stays in L2;
// m fastest re-reads all of a tiled forward's 79 MB x from memory for every
// column block) of three warpgroups.
//   * Warpgroup 0 is the producer (setmaxnreg down to 40): one thread keeps
//     TMA loads of x and W boxes (64 K-columns, 128-byte swizzle, zero fill
//     past the matrices, which covers the M, N and K tails) in flight
//     through a ring of kStages stages (full / empty mbarriers), in the order
//     the consumers take the tiles.
//   * Warpgroups 1 and 2 are consumers (setmaxnreg up to 232; ptxas still
//     fits them in the launch bound's 168 registers, without spills) running
//     wgmma m64nNk16 with fp32 accumulators of 128 registers a thread. Two
//     schedules:
//       - ping-pong (the default): 128 x 128 tiles, each consumer takes
//         every other tile of its CTA. An ordered pair of named barriers lets
//         one consumer issue its main loop only after the other has issued
//         all of its own, so the tensor cores run one tile's product while
//         the other consumer runs the previous tile's epilogue (as CUTLASS's
//         ping-pong schedule does). The order also keeps the shared ring
//         safe: a consumer never waits on a stage more than one mbarrier
//         phase ahead of the producer. The serial instance (kept to measure
//         the overlap) hands the turn over only after its epilogue, so
//         product and epilogue never overlap;
//       - cooperative: 128 x 256 tiles, each consumer 64 rows of every tile
//         (half the waves at M = 2402, no overlap of epilogue and product).
//     No branch that the compiler sees as divergent may lie between a
//     consumer's first product and its wait for the last: ptxas would
//     serialize the products (the warpgroup index is broadcast by a shuffle,
//     and a consumer's tile loop has no "no tile" case).
//   * Epilogue: acc + bias (the fragment's columns: d[4j + 2i + c] is column
//     8j + 2t + c), rounded to bf16 (h), written to a padded shared-memory
//     tile of the consumer's own (conflict-free); then each thread takes
//     16-byte vectors of h and stores 16 bytes of y (and of h, when asked),
//     rows >= M and columns >= N skipped. y comes from a 6.5 KB table of the
//     GELU over h's bf16 bits (gelu_bf16.cuh: the consumers fill it with
//     gelu() while the first stages load) and closed forms outside its
//     range: ~17 integer operations and one predicated shared-memory load an
//     element. Evaluating the chain in every lane instead (~35 fp32
//     operations and two conversions an element) slowed the other
//     consumer's products, whose accumulators live in the same register
//     file: on an H100 the kernel then took as long as F.linear followed by
//     F.gelu. The stores are predicated, not branched around.
//
// CUDA graphs: the SM count is queried once per device and the tensor maps
// are __grid_constant__ parameters, so a captured launch makes no host query.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "gelu_bf16.cuh"
#include "sm90_async.cuh"

namespace {

using namespace ufm;

constexpr int kBK = 64;    // K per stage: one 128-byte swizzle row
constexpr int kBM = 128;   // rows of a CTA tile
constexpr int kThreads = 384;  // the producer warpgroup, then two consumer warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 40 * 128 + 232 * 256 <= 65536
constexpr int kMaxDevices = 64;
constexpr int kVec = 8;  // bf16 in a 16-byte vector

// named barriers: 1 + w = "consumer w may issue its main loop" (ping-pong),
// 3 + w = consumer w's own 128 threads
constexpr int kTurnBar = 1;
constexpr int kWgBar = 3;
constexpr int kTableBar = 5;  // both consumers: the GELU table is filled

enum Schedule : int { kPingPong = 0, kSerial = 1, kCooperative = 2 };

template <int kSchedule>
struct Config {
  static constexpr bool kPing = kSchedule != kCooperative;  // consumers take alternate tiles, in turns
  static constexpr bool kSerial = kSchedule == Schedule::kSerial;  // the turn passes after the epilogue
  static constexpr int kBN = kPing ? 128 : 256;           // columns of a CTA tile
  static constexpr int kWgRows = kPing ? 128 : 64;        // rows a consumer owns in a tile
  static constexpr int kHalves = kWgRows / 64;            // m64 products per k-step
  static constexpr int kAccRegs = 64 * kBN / 128;         // per m64 half, per thread
  static constexpr int kStages = kPing ? 4 : 3;
  static constexpr int kABytes = kBM * kBK * 2;           // 16 KB
  static constexpr int kBBytes = kBN * kBK * 2;           // 16 or 32 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRowBytes = kBN * 2 + 16;          // padded h row: conflict-free stores
  static constexpr int kEpiBytes = kWgRows * kRowBytes;   // one consumer's h tile
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kEpiBytes + 2 * kStages * 8 + kTableEntries * 2;
  static_assert(kSmemBytes <= 232448, "shared memory");
};

template <int kN>
__device__ __forceinline__ void wgmma_tile(float (&d)[kN / 2], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  if constexpr (kN == 128) {
    wgmma_ss_n128<0>(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_ss_n256<0>(d, desc_a, desc_b, scale_d);
  }
}

// The GELU of 8 bf16 values (one 16-byte vector) from the table.
__device__ __forceinline__ uint4 gelu8(uint4 hv, const uint16_t* table) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&hv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = gelu_table_lookup(w[i] & 0xFFFFu, table) | (gelu_table_lookup(w[i] >> 16, table) << 16);
  }
  return hv;
}

// h = bf16(acc + bias) of a consumer's rows into its padded tile.
template <int kBN, int kHalves, int kAccRegs, int kRowBytes>
__device__ __forceinline__ void stage_h(const float (&acc)[kHalves][kAccRegs], const __nv_bfloat16* __restrict__ bias,
                                        uint8_t* tile, int col0, int n, int warp, int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if (col < n) {
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
      b0 = __bfloat162float(bb.x);
      b1 = __bfloat162float(bb.y);
    }
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int row = 64 * h + 16 * warp + lane / 4 + 8 * i2;
        *reinterpret_cast<uint32_t*>(tile + row * kRowBytes + (8 * j + 2 * t) * 2) =
            pack_bf16x2(__fadd_rn(acc[h][4 * j + 2 * i2], b0), __fadd_rn(acc[h][4 * j + 2 * i2 + 1], b1));
      }
    }
  }
}

// The v-th 16-byte vector of a staged tile (row-major, kBN / 8 vectors a
// row): y = gelu(h) to global memory, and h where kWritePre; rows >= M and
// columns >= N are not stored.
template <int kBN, int kRowBytes, bool kWritePre>
__device__ __forceinline__ void store_vector(const uint8_t* tile, const uint16_t* table, int v, int row0, int col0,
                                             int m, int n, __nv_bfloat16* __restrict__ y,
                                             __nv_bfloat16* __restrict__ pre) {
  constexpr int kChunks = kBN / kVec;
  const int row = row0 + v / kChunks;
  const int col = col0 + (v % kChunks) * kVec;
  const uint4 hv = *reinterpret_cast<const uint4*>(tile + (v / kChunks) * kRowBytes + (v % kChunks) * 16);
  const bool ok = row < m && col < n;
  const long long at = static_cast<long long>(row) * n + col;
  if (kWritePre) store16_if(pre + at, hv, ok);
  store16_if(y + at, gelu8(hv, table), ok);
}

template <int kSchedule, bool kWritePre>
__global__ void __launch_bounds__(kThreads, 1) linear_gelu_bf16_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, __nv_bfloat16* __restrict__ pre,
    int m, int n, int k) {
  using C = Config<kSchedule>;
  extern __shared__ uint8_t smem_raw[];
  // stage s: x box, then W box; offsets from smem_raw keep the pointers in the
  // shared address space (ld.shared, not generic loads)
  uint8_t* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* epi = stages + C::kStages * C::kStageBytes;  // consumer w's h tile at w * kEpiBytes
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * C::kEpiBytes);
  uint64_t* empty = full + C::kStages;
  uint16_t* table = reinterpret_cast<uint16_t*>(empty + C::kStages);

  const int n_tiles = (n + C::kBN - 1) / C::kBN;
  const int tiles = ((m + kBM - 1) / kBM) * n_tiles;
  const int k_blocks = (k + kBK - 1) / kBK;
  // this CTA's tiles: blockIdx.x + i * gridDim.x, i < my_tiles
  const int my_tiles = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // the warpgroup, warp-uniform to the compiler (a value it sees as divergent
  // around the wgmma pipeline makes ptxas serialize the products)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kPing ? 4 : 8);  // one arrival per consumer warp that reads the stage
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load, tile after tile
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&tm_x);
      prefetch_tensor_map(&tm_w);
      int q = 0;  // stage sequence number
      for (int i = 0; i < my_tiles; ++i) {
        const int tile = blockIdx.x + i * gridDim.x;
        const int m0 = (tile / n_tiles) * kBM;
        const int n0 = (tile % n_tiles) * C::kBN;
        for (int kb = 0; kb < k_blocks; ++kb, ++q) {
          const int s = q % C::kStages;
          if (q >= C::kStages) mbar_wait(&empty[s], ((q / C::kStages) - 1) & 1);
          mbar_arrive_expect_tx(&full[s], C::kStageBytes);
          uint8_t* st = stages + s * C::kStageBytes;
          tma_load_2d(st, &tm_x, &full[s], kb * kBK, m0);
          tma_load_2d(st + C::kABytes, &tm_w, &full[s], kb * kBK, n0);
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
  uint8_t* my_epi = epi + cw * C::kEpiBytes;
  // the GELU table, while the first stages are in flight
  for (int e = threadIdx.x - 128; e < kTableEntries; e += 256) table[e] = gelu_table_entry(e);
  named_bar_sync(kTableBar, 256);

  constexpr int kTileVecs = C::kWgRows * C::kBN / kVec / 128;  // 16-byte vectors a thread stores a tile

  // ping-pong: consumer cw takes the CTA's tiles i = cw, cw + 2, ...; before
  // tile i > 0 it waits for its turn, which the other consumer hands over
  // once tile i - 1's products are issued (serial: once its epilogue is done)
  for (int i = C::kPing ? cw : 0; i < my_tiles; i += C::kPing ? 2 : 1) {
    const bool hand_over = C::kPing && i + 1 < my_tiles;
    if (C::kPing && i > 0) named_bar_sync(kTurnBar + cw, 256);

    float acc[C::kHalves][C::kAccRegs];
    int q = i * k_blocks;
    for (int kb = 0; kb < k_blocks; ++kb, ++q) {
      const int s = q % C::kStages;
      mbar_wait(&full[s], (q / C::kStages) & 1);
      const uint8_t* st = stages + s * C::kStageBytes;
      const uint64_t desc_b = sw128_desc(st + C::kABytes);
      const uint8_t* a_rows = st + (C::kPing ? 0 : cw * 64 * kBK * 2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < C::kHalves; ++h) {
          wgmma_tile<C::kBN>(acc[h], sw128_desc(a_rows + h * 64 * kBK * 2) + kk * kKStepKMajor,
                             desc_b + kk * kKStepKMajor, (kb | kk) != 0);
        }
      }
      wgmma_commit();
      if (kb > 0) {  // the previous stage's products are done: hand it back
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(q - 1) % C::kStages]);
      }
    }
    if (hand_over && !C::kSerial) named_bar_arrive(kTurnBar + (1 - cw), 256);
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < C::kHalves; ++h) fence_regs(acc[h]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(q - 1) % C::kStages]);

    // ---- epilogue: h = bf16(acc + bias) into this consumer's tile, then
    // y = gelu(h) from the table, 16 bytes a thread and step
    const int tile = blockIdx.x + i * gridDim.x;
    const int row0 = (tile / n_tiles) * kBM + (C::kPing ? 0 : cw * 64);
    const int col0 = (tile % n_tiles) * C::kBN;
    named_bar_sync(kWgBar + cw, 128);  // the previous tile's reads of my_epi are done
    stage_h<C::kBN, C::kHalves, C::kAccRegs, C::kRowBytes>(acc, bias, my_epi, col0, n, warp, lane);
    named_bar_sync(kWgBar + cw, 128);
#pragma unroll 4
    for (int j = 0; j < kTileVecs; ++j) {
      store_vector<C::kBN, C::kRowBytes, kWritePre>(my_epi, table, tid + 128 * j, row0, col0, m, n, y, pre);
    }
    if (hand_over && C::kSerial) named_bar_arrive(kTurnBar + (1 - cw), 256);
  }
}

int smem_set[3][2] = {};                 // devices on which each instance may use its shared memory
std::atomic<int> sm_count[kMaxDevices];  // per device, queried once

template <int kSchedule, bool kWritePre>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const __nv_bfloat16* b, __nv_bfloat16* y,
           __nv_bfloat16* pre, int m, int n, int k, cudaStream_t stream) {
  using C = Config<kSchedule>;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(linear_gelu_bf16_fwd_kernel<kSchedule, kWritePre>),
                             C::kSmemBytes, smem_set[kSchedule][kWritePre]);
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
  const long long tiles = static_cast<long long>((m + kBM - 1) / kBM) * ((n + C::kBN - 1) / C::kBN);
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  linear_gelu_bf16_fwd_kernel<kSchedule, kWritePre><<<grid, kThreads, C::kSmemBytes, stream>>>(tm_x, tm_w, b, y, pre,
                                                                                               m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int kSchedule>
int launch_schedule(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const __nv_bfloat16* b, __nv_bfloat16* y,
                    __nv_bfloat16* pre, int m, int n, int k, cudaStream_t stream) {
  return pre != nullptr ? launch<kSchedule, true>(tm_x, tm_w, b, y, pre, m, n, k, stream)
                        : launch<kSchedule, false>(tm_x, tm_w, b, y, pre, m, n, k, stream);
}

}  // namespace

// x (m, k), w (n, k), b (n,), y and pre (m, n): contiguous bf16, 16-byte
// aligned, k and n multiples of 8, m >= 1 (the wrapper checks all of it).
// `pre` is null or receives h. `schedule`: 0 ping-pong 128 x 128 (the
// default), 1 the same without overlap (serial), 2 cooperative 128 x 256. Launches on `stream`; returns 0, a cudaError_t, or a kErr*
// code of sm90_async.cuh when a tensor map cannot be made.
extern "C" int ufm_linear_gelu_bf16_fwd(const void* x, const void* w, const void* b, void* y, void* pre, int m, int n,
                                        int k, int schedule, void* stream) {
  const int box_n = schedule == kCooperative ? 256 : 128;
  CUtensorMap tm_x, tm_w;
  int err = encode_rows_map(&tm_x, x, m, k, k, kBM);
  if (err == 0) err = encode_rows_map(&tm_w, w, n, k, k, box_n);
  if (err != 0) return err;
  const auto* bb = static_cast<const __nv_bfloat16*>(b);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* pb = static_cast<__nv_bfloat16*>(pre);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (schedule) {
    case kPingPong:
      return launch_schedule<kPingPong>(tm_x, tm_w, bb, yb, pb, m, n, k, s);
    case kSerial:
      return launch_schedule<kSerial>(tm_x, tm_w, bb, yb, pb, m, n, k, s);
    case kCooperative:
      return launch_schedule<kCooperative>(tm_x, tm_w, bb, yb, pb, m, n, k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
