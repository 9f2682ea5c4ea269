// The MLP's GELU gradient as the epilogue of fc2's input-gradient product,
// for Hopper (sm_90a): bf16 in, bf16 out.
//
// Replaces: the VJP of ufm_tpu/ops/gelu.py::fast_exact_gelu (:106) inside
// the backward of ufm_tpu/nn/layers.py::Mlp (:39-53), i.e. the pair "fc2's
// input gradient, then the GELU's gradient" of every backbone MLP in
// training. JAX computes the product as the transpose of a bf16 nn.Dense
// (rounded to bf16) and the VJP as one fused XLA pass; the port had cuBLAS's
// g.mm(w2) and then gelu_bf16_bwd.cu. For fc2's cotangent g (M, N2), fc2's
// weight w2 (N2, N) in nn.Linear's layout (N contiguous) and the saved
// pre-activation h (M, N), all bf16:
//
//   dy[m, n] = bf16_rn(sum_j g[m, j] w2[j, n])   (fp32 accumulate, rounded once)
//   dh[m, n] = gelu_grad(dy[m, n], h[m, n])      (gelu_bf16.cuh: the JAX package's VJP bits)
//
// dy never reaches memory (a check-only instance writes it through `dy_out`).
// dh is bit for bit gelu_bf16_bwd(dy, h) of the kernel's own dy; dy may
// differ from cuBLAS's product in the last bit where the fp32 sums round
// differently.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 2 M N N2
// operations against g, w2 and h read once and dh written once.
//   encoder      4804 x 1024 -> 4096: 40.3 GFLOP -> 40.7 us; 97 MB -> 29.0 us
//   info sharing 4800 x  768 -> 3072: 22.6 GFLOP -> 22.9 us; 71 MB -> 21.1 us
// so it is bound by operations. The epilogue has a floor of its own: the
// VJP chain is ~60 instructions an element (each fp32 operation one .ftz
// instruction, to keep the JAX package's bits), one warp instruction per
// scheduler a clock: ~43 / ~32 us at those shapes, as long as the product.
// It can only hide under other tiles' products.
//
// Design: a persistent grid (one CTA per SM walks the output tiles, n
// fastest) of a producer warpgroup and kConsumers consumer warpgroups.
//   * The producer (setmaxnreg down to 40) keeps TMA loads of g boxes
//     (K-major, 64 K-columns) and w2 boxes (64 K-rows x 64 N-columns: B is
//     MN-major, read by the wgmma descriptor's transpose; no copy of w2) in
//     flight through a ring of 5 stages (160 KB: 3 stages left the products
//     starved, ~25% slower alone), full / empty mbarriers, 128-byte swizzle,
//     zero fill past the matrices (the M, N and K tails).
//   * Consumers run wgmma m64nNk16 (fp32 accumulators), B transposed, and
//     take the CTA's tiles in a round robin: consumer c issues its products
//     only after consumer c - 1 has issued all of its own (an ordered ring
//     of named barriers, as the forward kernel's ping-pong), so the tensor
//     cores run one tile's product while the others run earlier tiles'
//     epilogues. Three schedules:
//       - pingpong (the op's): two consumers, 128 x 128 tiles;
//       - serial: the same, the turn handed over after the epilogue (no
//         overlap: what the overlap gains);
//       - rr3: three consumers, 128 x 64 tiles, 6 stages: each tile's
//         epilogue overlaps two other tiles' products.
//   * Epilogue: the accumulator rounded to bf16 (dy) into a swizzled tile
//     of the consumer's own (conflict-free 4-byte stores from the fragment,
//     16-byte reads by row); then each thread takes 16-byte vectors of dy,
//     loads the matching h from global memory one vector ahead, evaluates
//     the chain for the main branch on 8 elements, 4 interleaved at a time
//     and without a branch (gelu_bf16.cuh's gelu_grad8: one warp a scheduler
//     keeps issuing only on independent chains), and stores 16 bytes of dh.
//     An element off the main branch (the tail, the saturated side, an
//     infinite h: ~0.4% of a normal pre-activation, but in most warps'
//     vectors) goes to a queue of four in registers and runs through
//     gelu_grad at the tile's end, every lane's at once: run in place, each
//     one held its warp for the tail's fp64 work.
//   What the card showed (chip_smoke.py's linear_gelu_backward phase;
//   PERF.md row 5): the products alone run as fast as cuBLAS's g.mm(w2);
//   the epilogue, one warp a scheduler, issues at about half a warp
//   instruction a clock, and more slowly still while the other consumer's
//   products are in flight, so the kernel takes about as long as the
//   product and the standalone gradient together. Staging h in shared memory
//   (TMA or cp.async) cost ring stages and did not pay; the producer
//   warpgroup's idle warps sharing the epilogue spilled hundreds of bytes.
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

constexpr int kBK = 64;       // K (fc2's output width N2) per stage: one 128-byte swizzle row of g
constexpr int kBM = 128;      // rows of a tile
constexpr int kBoxCols = 64;  // columns of a w2 / h / dh box: one 128-byte swizzle row
constexpr int kProducerRegs = 40;
constexpr int kMaxDevices = 64;
constexpr int kVec = 8;  // bf16 in a 16-byte vector

// named barriers: kTurnBar + c = "consumer c may issue its products",
// kWgBar + c = consumer c's own 128 threads
constexpr int kTurnBar = 1;
constexpr int kWgBar = 5;

enum Schedule : int { kPingPong = 0, kSerial = 1, kRoundRobin3 = 2 };

template <int kSchedule>
struct Config {
  static constexpr int kConsumers = kSchedule == kRoundRobin3 ? 3 : 2;
  static constexpr bool kSerial = kSchedule == Schedule::kSerial;  // the turn passes after the epilogue
  static constexpr int kBN = kSchedule == kRoundRobin3 ? 64 : 128;
  static constexpr int kStages = kSchedule == kRoundRobin3 ? 6 : 5;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  // 40 * 128 + kConsumerRegs * 128 * kConsumers <= 65536
  static constexpr int kConsumerRegs = kConsumers == 2 ? 232 : 152;
  static constexpr int kBoxes = kBN / kBoxCols;
  static constexpr int kAccRegs = kBN / 2;                 // per m64 half, per thread
  static constexpr int kABytes = kBM * kBK * 2;            // 16 KB: the g box
  static constexpr int kBBox = kBK * kBoxCols * 2;         // 8 KB: one w2 box
  static constexpr int kStageBytes = kABytes + kBoxes * kBBox;
  static constexpr int kTileBox = kBM * kBoxCols * 2;      // 16 KB: one 64-column box of a dy tile
  static constexpr int kTileBytes = kBoxes * kTileBox;     // a consumer's dy tile
  static constexpr int kChains = 4;  // VJP chains interleaved by a thread (8 ran no faster and spilled more)
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kConsumers * kTileBytes + 2 * kStages * 8;
  static_assert(kSmemBytes <= 232448, "shared memory");
};

// Descriptor of an MN-major (transposed) B tile of kBoxes w2 boxes, each
// 64 K-rows x 64 N-columns (128-byte swizzle), kBBox bytes apart: 8 K-rows
// 1024 bytes apart (stride byte offset), 64-column blocks kBBox apart
// (leading byte offset).
template <int kBBox>
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t(kBBox >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

template <int kN>
__device__ __forceinline__ void wgmma_tile(float (&d)[kN / 2], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  if constexpr (kN == 128) {
    wgmma_ss_n128<1>(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_ss_n64<1>(d, desc_a, desc_b, scale_d);
  }
}

// Byte offset of (row, 16-byte chunk c of the row) in a tile of 64-column
// boxes of kBM rows, 128-byte swizzled (TMA's layout: chunk c ^ (row % 8)).
template <int kTileBox>
__device__ __forceinline__ int tile_offset(int row, int c) {
  return (c / 8) * kTileBox + row * 128 + (((c % 8) ^ (row % 8)) << 4);
}

// dy = bf16(acc) of a consumer's 128 x kBN tile into its dy tile (the
// fragment's columns: d[4j + 2i + c] is row 16 w + lane / 4 + 8 i, column
// 8j + 2t + c): 4-byte stores, conflict-free under the swizzle.
template <int kBN, int kAccRegs, int kTileBox>
__device__ __forceinline__ void stage_dy(const float (&acc)[2][kAccRegs], uint8_t* tile, int warp, int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int row = 64 * half + 16 * warp + lane / 4 + 8 * i2;
        *reinterpret_cast<uint32_t*>(tile + tile_offset<kTileBox>(row, j) + 4 * t) =
            pack_bf16x2(acc[half][4 * j + 2 * i2], acc[half][4 * j + 2 * i2 + 1]);
      }
    }
  }
}

// 16 bytes of a read-only input where `ok`, else zeros
__device__ __forceinline__ uint4 load16_if(const void* p, bool ok) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (ok) v = __ldg(reinterpret_cast<const uint4*>(p));
  return v;
}

// Elements whose gradient is off the VJP's main branch (the tail, the
// saturated side, an infinite h), gathered by a thread over a tile's vectors: kSlots (position in the
// tile, dy and h bits) in registers (fixed indices: no local memory), run
// when full and at the tile's end, every lane's at once.
template <int kSlots>
struct SlowQueue {
  uint32_t pos[kSlots], bits[kSlots];
  int n = 0;

  template <typename Flush>
  __device__ __forceinline__ void push(uint32_t p, uint32_t b, Flush&& flush) {
    if (n == kSlots) {
      flush(*this);
      n = 0;
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (k == n) {
        pos[k] = p;
        bits[k] = b;
      }
    }
    ++n;
  }
};

template <int kSchedule, bool kWriteDy>
__global__ void __launch_bounds__(Config<kSchedule>::kThreads, 1) linear_gelu_bf16_bwd_kernel(
    const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_w,
    const __nv_bfloat16* __restrict__ h, __nv_bfloat16* __restrict__ dh, __nv_bfloat16* __restrict__ dy_out, int m,
    int n, int k) {
  using C = Config<kSchedule>;
  extern __shared__ uint8_t smem_raw[];
  // offsets from smem_raw keep the pointers in the shared address space
  uint8_t* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* dy_tiles = stages + C::kStages * C::kStageBytes;  // consumer c's at c * kTileBytes
  uint64_t* full = reinterpret_cast<uint64_t*>(dy_tiles + C::kConsumers * C::kTileBytes);
  uint64_t* empty = full + C::kStages;

  const int n_tiles = (n + C::kBN - 1) / C::kBN;
  const int tiles = ((m + kBM - 1) / kBM) * n_tiles;
  const int k_blocks = (k + kBK - 1) / kBK;
  const int my_tiles = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // warp-uniform to the compiler (see linear_gelu_bf16_fwd.cu)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the four warps of the consumer that reads the stage
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load, tile after tile
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&tm_g);
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
          tma_load_2d(st, &tm_g, &full[s], kb * kBK, m0);
#pragma unroll
          for (int b = 0; b < C::kBoxes; ++b) tma_load_2d(st + C::kABytes + b * C::kBBox, &tm_w, &full[s],
                                                          n0 + b * kBoxCols, kb * kBK);
        }
      }
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<C::kConsumerRegs>();
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid / 32;
  const int lane = tid % 32;
  uint8_t* my_dy = dy_tiles + cw * C::kTileBytes;
  constexpr int kChunks = C::kBN / kVec;                    // 16-byte chunks of a tile row
  constexpr int kTileVecs = kBM * kChunks / 128;            // chunks a thread takes a tile
  const int next = (cw + 1) % C::kConsumers;

  for (int i = cw; i < my_tiles; i += C::kConsumers) {
    const bool hand_over = i + 1 < my_tiles;
    if (i > 0) named_bar_sync(kTurnBar + cw, 256);

    float acc[2][C::kAccRegs];
    int q = i * k_blocks;
    for (int kb = 0; kb < k_blocks; ++kb, ++q) {
      const int s = q % C::kStages;
      mbar_wait(&full[s], (q / C::kStages) & 1);
      const uint8_t* st = stages + s * C::kStageBytes;
      const uint64_t desc_b = sw128_mn_desc<C::kBBox>(st + C::kABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          wgmma_tile<C::kBN>(acc[half], sw128_desc(st + half * 64 * kBK * 2) + kk * kKStepKMajor,
                             desc_b + kk * kKStepMnMajor, (kb | kk) != 0);
        }
      }
      wgmma_commit();
      if (kb > 0) {  // the previous stage's products are done: hand it back
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(q - 1) % C::kStages]);
      }
    }
    if (hand_over && !C::kSerial) named_bar_arrive(kTurnBar + next, 256);
    wgmma_wait<0>();
#pragma unroll
    for (int half = 0; half < 2; ++half) fence_regs(acc[half]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(q - 1) % C::kStages]);

    // ---- epilogue: dy = bf16(acc) into my_dy (the previous tile's reads of
    // it ended before the barrier that closed its epilogue), then 16-byte
    // vectors: h from global memory one vector ahead, dh = gelu_grad(dy, h)
    // stored, the slow elements gathered and run after the tile
    const int tile = blockIdx.x + i * gridDim.x;
    const int row0 = (tile / n_tiles) * kBM;
    const int col0 = (tile % n_tiles) * C::kBN;
    stage_dy<C::kBN, C::kAccRegs, C::kTileBox>(acc, my_dy, warp, lane);
    named_bar_sync(kWgBar + cw, 128);
    auto at = [&](int j, int* row, int* c) {
      const int v = tid + 128 * j;
      *row = v / kChunks;
      *c = v % kChunks;
      return static_cast<long long>(row0 + *row) * n + col0 + *c * kVec;
    };
    auto inside = [&](int row, int c) { return row0 + row < m && col0 + c * kVec < n; };
    SlowQueue<4> slow;
    auto run_slow = [&](SlowQueue<4>& q) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s < q.n) {
          const uint32_t b = q.bits[s];
          const __nv_bfloat16 r = gelu_grad(__ushort_as_bfloat16(static_cast<unsigned short>(b & 0xFFFFu)),
                                            __ushort_as_bfloat16(static_cast<unsigned short>(b >> 16)));
          const int row = q.pos[s] / C::kBN, col = q.pos[s] % C::kBN;
          dh[static_cast<long long>(row0 + row) * n + col0 + col] = r;
        }
      }
    };
    int row, c;
    long long g_at = at(0, &row, &c);
    uint4 h_next = load16_if(h + g_at, inside(row, c));
#pragma unroll 1
    for (int j = 0; j < kTileVecs; ++j) {
      const long long here = g_at;
      const int row_j = row, c_j = c;
      const bool ok = inside(row, c);
      const uint4 hv = h_next;
      if (j + 1 < kTileVecs) {
        g_at = at(j + 1, &row, &c);
        h_next = load16_if(h + g_at, inside(row, c));
      }
      const uint4 dyv = *reinterpret_cast<const uint4*>(my_dy + tile_offset<C::kTileBox>(row_j, c_j));
      if (kWriteDy) store16_if(dy_out + here, dyv, ok);
      uint4 r = dyv;
      const uint32_t mask = gelu_grad8<C::kChains>(r, hv) & (ok ? 0xFFu : 0u);
      store16_if(dh + here, r, ok);
      if (mask) {
        const uint32_t* dw = reinterpret_cast<const uint32_t*>(&dyv);
        const uint32_t* hw = reinterpret_cast<const uint32_t*>(&hv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          if (mask >> e & 1) {
            const uint32_t db = e % 2 ? dw[e / 2] >> 16 : dw[e / 2] & 0xFFFFu;
            const uint32_t hb = e % 2 ? hw[e / 2] >> 16 : hw[e / 2] & 0xFFFFu;
            slow.push(static_cast<uint32_t>(row_j * C::kBN + c_j * kVec + e), db | hb << 16, run_slow);
          }
        }
      }
    }
    run_slow(slow);
    named_bar_sync(kWgBar + cw, 128);  // every read of my_dy is done
    if (hand_over && C::kSerial) named_bar_arrive(kTurnBar + next, 256);
  }
}

int smem_set[3][2] = {};                 // devices on which each instance may use its shared memory
std::atomic<int> sm_count[kMaxDevices];  // per device, queried once

template <int kSchedule, bool kWriteDy>
int launch(const CUtensorMap& tm_g, const CUtensorMap& tm_w, const __nv_bfloat16* h, __nv_bfloat16* dh,
           __nv_bfloat16* dy, int m, int n, int k, cudaStream_t stream) {
  using C = Config<kSchedule>;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(linear_gelu_bf16_bwd_kernel<kSchedule, kWriteDy>),
                             C::kSmemBytes, smem_set[kSchedule][kWriteDy]);
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
  linear_gelu_bf16_bwd_kernel<kSchedule, kWriteDy><<<grid, C::kThreads, C::kSmemBytes, stream>>>(tm_g, tm_w, h, dh,
                                                                                                dy, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int kSchedule>
int launch_schedule(const CUtensorMap& tm_g, const CUtensorMap& tm_w, const __nv_bfloat16* h, __nv_bfloat16* dh,
                    __nv_bfloat16* dy, int m, int n, int k, cudaStream_t stream) {
  return dy != nullptr ? launch<kSchedule, true>(tm_g, tm_w, h, dh, dy, m, n, k, stream)
                       : launch<kSchedule, false>(tm_g, tm_w, h, dh, dy, m, n, k, stream);
}

}  // namespace

// g (m, k), w2 (k, n), h and dh (m, n), dy null or (m, n): contiguous bf16,
// 16-byte aligned, k and n multiples of 8, m >= 1 (the wrapper checks all
// of it). `dy` receives the rounded product (the checks' instance).
// `schedule`: 0 ping-pong 128 x 128 (the default), 1 the same without
// overlap (serial), 2 three consumers in a round robin over 128 x 64 tiles.
// Launches on `stream`; returns 0, a cudaError_t, or a kErr* code of
// sm90_async.cuh when a tensor map cannot be made.
extern "C" int ufm_linear_gelu_bf16_bwd(const void* g, const void* w2, const void* h, void* dh, void* dy, int m,
                                        int n, int k, int schedule, void* stream) {
  CUtensorMap tm_g, tm_w;
  int err = encode_rows_map(&tm_g, g, m, k, k, kBM);
  if (err == 0) err = encode_rows_map(&tm_w, w2, k, n, n, kBK);
  if (err != 0) return err;
  const auto* hb = static_cast<const __nv_bfloat16*>(h);
  auto* db = static_cast<__nv_bfloat16*>(dh);
  auto* yb = static_cast<__nv_bfloat16*>(dy);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (schedule) {
    case kPingPong:
      return launch_schedule<kPingPong>(tm_g, tm_w, hb, db, yb, m, n, k, s);
    case kSerial:
      return launch_schedule<kSerial>(tm_g, tm_w, hb, db, yb, m, n, k, s);
    case kRoundRobin3:
      return launch_schedule<kRoundRobin3>(tm_g, tm_w, hb, db, yb, m, n, k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
