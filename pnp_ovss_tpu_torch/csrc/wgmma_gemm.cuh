// The port's persistent wgmma + TMA GEMM and its row LayerNorm (sm_90a),
// shared by K1 (ln_matmul.cu), K3 (ln_mlp_residual.cu) and K4's
// projection (flash_qkv_proj.cu). Each user supplies an epilogue.
//
// layer_norm: xn = bf16(LN(x)) over rows of D bf16 values, one warp per
// row, 16-byte chunks spread over the lanes: the f32 mean, then the f32
// mean of squared deviations (two passes, as the reference), then
// (x - mu) * rsqrt(var + eps) * gamma + beta rounded to bf16 once.
//
// gemm: out[M, N] = Epi(A[M, K] @ B[N, K]^T), A and B bf16 and K-major
// (B in nn.Linear layout), f32 sums in k16 steps from k = 0 up, never
// split. A persistent grid of one block per SM walks 128-row output tiles
// (N fastest, so concurrent tiles share their A rows in L2), with three
// roles in warpgroups:
// - one producer thread feeds a ring of 64-deep A and B tiles by TMA
//   (2-D tensor maps, 128-byte swizzle, mbarrier transaction counts) and
//   runs ahead into the next tile;
// - two consumer warpgroups run the products (128 f32 accumulators a
//   thread), keeping one k-step of products in flight and releasing each
//   stage when its products are done, and stage the bf16 tile in shared
//   memory;
// - three epilogue warps turn the staged tile into the output with
//   coalesced 16-byte stores, while the tensor cores run the next tile.
// The epilogue type picks one of two schedules (its kPingPong):
// - cooperative (K1's bias, K3's fc2 + residual, K4's proj + residual):
//   128 x 256 tiles, both consumer warpgroups on each (wgmma m64n256k16
//   on 64 rows each), a 3-stage ring of 48 KB; the consumers stage
//   y = bf16(acc + bias) (or bf16(acc), as the epilogue asks) and the
//   epilogue warps apply the epilogue to it. Storing straight from the
//   accumulators, with the tensor cores idle meanwhile, took 45% of K3's
//   call (kernel_ablation.py's no_epilogue, PERF.md).
// - ping-pong (K3's fc1 + gelu): each consumer warpgroup owns whole
//   128 x 128 tiles in turn (two wgmma m64n128k16 a k16 step), a 4-stage
//   ring of 32 KB; named barriers make the two take turns to issue their
//   tile's products, so while one runs on the tensor cores the other
//   applies act to bf16(acc + bias) in registers and stages the result in
//   its own staged tile, which the epilogue warps copy out as it is. The
//   gelu (~40 dependent f32 steps a value) then runs on the consumers
//   beside the other warpgroup's products, not on the epilogue warps,
//   which held fc1 at 40% of its bound. K1's bias ran 4% slower on this
//   schedule: the 128 x 128 tile reads 4/3 the operand bytes a product
//   (PERF.md).
// setmaxnreg moves registers from the producer's and the epilogue's
// warpgroup (56) to the consumers (224). TMA zero-fills the M, N and K
// tails, so M is any value >= 1; the epilogue stores only rows < M and
// columns < N. N and K must be multiples of 8 (16-byte rows and stores).
//
// An epilogue is a type with static members only; the kernel passes it
// its own __restrict__ pointers, so that the epilogue warps' loads of one
// row may run ahead of their stores to another:
//   static constexpr bool kPingPong;   // the ping-pong schedule if true
//   static constexpr bool kStageBias;  // stage bf16(acc + bias) if true,
//                                      // else bf16(acc)
//   static constexpr int kRows;  // rows a thread loads before it stores
//   // what apply reads of the residual for the 8 columns at `off`
//   static __device__ uint4 load(const __nv_bfloat16* resid, long long off);
//   // the 8 values stored from the 8 staged values y of columns
//   // col .. col + 7 and what load returned (cooperative schedule)
//   static __device__ uint4 apply(uint4 y, uint4 in,
//                                 const __nv_bfloat16* bias, int col);
//   // ping-pong schedule: the two values stored (bf16x2) for two
//   // neighbouring staged values (bf16x2), applied by the consumers;
//   // nothing else is applied
//   static __device__ uint32_t act(uint32_t y);
#pragma once

#include <dlfcn.h>

#include <atomic>
#include <initializer_list>

#include "hopper.cuh"

namespace pnp {
namespace gemm {

constexpr int kBM = 128;  // rows of a tile
constexpr int kBK = 64;   // 128 bytes of bf16: one swizzle row
// Warpgroups 0 and 1 consume (128 accumulators a thread, so the block can
// have no more than 384 threads); in warpgroup 2 one thread produces
// (TMA) and warps 1-3 run the epilogue. Registers a thread after
// setmaxnreg: the 384 threads start at 168 and the two counts below stay
// within the same 64512.
constexpr int kThreads = 384;
constexpr int kEpilogueThreads = 96;
constexpr int kConsumerRegs = 224, kSideRegs = 56;
static_assert(2 * kConsumerRegs + kSideRegs <= 3 * 168,
              "register counts must fit the block's allocation");
constexpr int kATile = kBM * kBK * 2;

// A schedule's tile, ring and staged tiles (see the top of the file).
template <bool kPingPong>
struct Schedule {
  static constexpr int kBN = kPingPong ? 128 : 256;  // columns of a tile
  static constexpr int kStages = kPingPong ? 4 : 3;
  static constexpr int kStageBytes = kATile + kBN * kBK * 2;
  // A stage is released by the warps that read it: the one warpgroup
  // that owns the tile, or both.
  static constexpr int kStageReaders = kPingPong ? 4 : 8;
  // Staged tiles: one a consumer warpgroup, or one shared; each written
  // by that many threads.
  static constexpr int kYBufs = kPingPong ? 2 : 1;
  static constexpr int kStagers = kPingPong ? 128 : 256;
  // A staged [128, kBN] bf16 tile; rows padded by 16 bytes so that the
  // consumers' 4-byte stores and the epilogue's 16-byte loads hit
  // distinct banks.
  static constexpr int kLdY = kBN + 8;
  static constexpr int kYBytes = kBM * kLdY * 2;
  static constexpr size_t kSmemBytes = size_t(kStages) * kStageBytes +
                                       size_t(kYBufs) * kYBytes + 1024 + 256;
  static_assert(kSmemBytes <= 232448, "a block has at most 227 KB");
};

constexpr int kMaxLnWidth = 1024;

__global__ void __launch_bounds__(256) layer_norm_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, __nv_bfloat16* __restrict__ xn, int M,
    int D, float eps) {
  constexpr int kPer = kMaxLnWidth / 8 / 32;  // chunks a lane, widest row
  const int chunks = D / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + warp;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + row * D;
  float v[kPer][8];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int chunk = lane + 32 * c;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (chunk < chunks) raw = *reinterpret_cast<const uint4*>(xr + chunk * 8);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16x2(w[i]);
      v[c][2 * i] = f.x;
      v[c][2 * i + 1] = f.y;
      s += f.x + f.y;
    }
  }
  const float mu = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    if (lane + 32 * c >= chunks) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = v[c][i] - mu;
      q += a * a;
    }
  }
  const float rs = rsqrtf(warp_sum(q) / D + eps);
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk >= chunks) continue;
    const int col = chunk * 8;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = col + 2 * i;
      w[i] = pack_bf16x2(
          (v[c][2 * i] - mu) * rs * gamma[j] + beta[j],
          (v[c][2 * i + 1] - mu) * rs * gamma[j + 1] + beta[j + 1]);
    }
    *reinterpret_cast<uint4*>(xn + row * D + col) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// y = bf16(acc + bias) (or bf16(acc), as the epilogue asks) of a
// warpgroup's 64 x W accumulators (wgmma's fragment layout) into rows
// row0 .. row0 + 63 of a staged tile with rows of kLd values, columns n0
// .. n0 + W - 1 of the output; on the ping-pong schedule act(y) in its
// place.
template <class Epi, int W, int kLd>
__device__ __forceinline__ void stage_rows(const float (&acc)[W / 2],
                                           __nv_bfloat16* ys, int row0,
                                           const __nv_bfloat16* bias, int n0,
                                           int N) {
  const int lane = threadIdx.x % 32;
  const int row = row0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int col = j * 8 + 2 * t;
    float2 bb = make_float2(0.f, 0.f);
    if constexpr (Epi::kStageBias) {
      if (n0 + col < N)
        bb = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(bias + n0 + col));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t y;
      if constexpr (Epi::kStageBias)
        y = pack_bf16x2(acc[4 * j + 2 * r] + bb.x,
                        acc[4 * j + 2 * r + 1] + bb.y);
      else
        y = pack_bf16x2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      if constexpr (Epi::kPingPong) y = Epi::act(y);
      *reinterpret_cast<uint32_t*>(ys + (row + 8 * r) * kLd + col) = y;
    }
  }
}

// A and B through their tensor maps (boxes of 64 x 128 and 64 x kBN,
// 128-byte swizzle).
template <class Epi>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a,
    const __grid_constant__ CUtensorMap tm_b,
    const __nv_bfloat16* __restrict__ bias,
    const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ out,
    int M, int N, int K) {
  using S = Schedule<Epi::kPingPong>;
  extern __shared__ unsigned char smem_raw[];
  // Tiles on a 1024-byte boundary (the swizzle's period), then the staged
  // tiles, then the barriers.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* ys =
      reinterpret_cast<__nv_bfloat16*>(smem + S::kStages * S::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + S::kStages * S::kStageBytes + S::kYBufs * S::kYBytes);
  uint64_t* empty = full + S::kStages;
  uint64_t* y_full = empty + S::kStages;  // a staged tile is written
  uint64_t* y_empty = y_full + S::kYBufs;  // ... and read out again
  auto a_tile = [&](int s) { return smem + s * S::kStageBytes; };
  auto b_tile = [&](int s) { return smem + s * S::kStageBytes + kATile; };
  auto y_tile = [&](int buf) { return ys + buf * (kBM * S::kLdY); };

  const int wg = threadIdx.x / 128;
  const int wtid = threadIdx.x % 128;
  const int n_tiles = (N + S::kBN - 1) / S::kBN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int k_tiles = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], S::kStageReaders);  // lane 0 of each
    }
    for (int b = 0; b < S::kYBufs; ++b) {
      hopper::mbar_init(&y_full[b], S::kStagers);
      hopper::mbar_init(&y_empty[b], kEpilogueThreads);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // Warp 0 produces, warps 1-3 run the epilogue.
    hopper::setmaxnreg_dec<kSideRegs>();
    if (wtid < 32) {
      // Producer: one thread keeps the ring full, tile after tile (in the
      // ping-pong schedule the two warpgroups' tiles in turn).
      if (wtid == 0) {
        int stage = 0;
        uint32_t phase = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int m0 = (tile / n_tiles) * kBM;
          const int n0 = (tile % n_tiles) * S::kBN;
          for (int kb = 0; kb < k_tiles; ++kb) {
            hopper::mbar_wait(&empty[stage], phase ^ 1);  // the slot is free
            hopper::mbar_expect_tx(&full[stage], S::kStageBytes);
            hopper::tma_load_2d(a_tile(stage), &tm_a, kb * kBK, m0,
                                &full[stage]);
            hopper::tma_load_2d(b_tile(stage), &tm_b, kb * kBK, n0,
                                &full[stage]);
            if (++stage == S::kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else {
      // Epilogue: reads the block's i-th staged tile (staged tile i %
      // kYBufs) 16 bytes a thread, a warp taking 512 bytes of one or two
      // rows, writes out with coalesced 16-byte stores, and frees the
      // staged tile while the consumers already run the next tile's
      // products. Each thread loads what kRows rows need from device
      // memory before it computes and stores them.
      const int etid = wtid - 32;
      constexpr int kChunks = S::kBN / 8;  // 8 columns a chunk
      constexpr int kPass = kEpilogueThreads / kChunks;  // rows a pass
      const int chunk = etid % kChunks;
      int i = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
        const int m0 = (tile / n_tiles) * kBM;
        const int col = (tile % n_tiles) * S::kBN + chunk * 8;
        const int buf = i % S::kYBufs;
        const __nv_bfloat16* yb = y_tile(buf);
        hopper::mbar_wait(&y_full[buf], (i / S::kYBufs) & 1);
        for (int row = etid / kChunks; row < kBM; row += kPass * Epi::kRows) {
          uint4 in[Epi::kRows];
          if constexpr (!Epi::kPingPong) {
#pragma unroll
            for (int r = 0; r < Epi::kRows; ++r) {
              const int grow = m0 + row + r * kPass;
              if (row + r * kPass < kBM && grow < M && col < N)
                in[r] =
                    Epi::load(resid, static_cast<long long>(grow) * N + col);
            }
          }
#pragma unroll
          for (int r = 0; r < Epi::kRows; ++r) {
            const int yr = row + r * kPass, grow = m0 + yr;
            if (yr >= kBM || grow >= M || col >= N) continue;
            const uint4 yv =
                *reinterpret_cast<const uint4*>(yb + yr * S::kLdY + chunk * 8);
            uint4* dst = reinterpret_cast<uint4*>(
                out + static_cast<long long>(grow) * N + col);
            if constexpr (Epi::kPingPong)
              *dst = yv;
            else
              *dst = Epi::apply(yv, in[r], bias, col);
          }
        }
        hopper::mbar_arrive(&y_empty[buf]);
      }
    }
  } else if constexpr (!Epi::kPingPong) {
    // Cooperative consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63
    // of each tile.
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int lane = wtid % 32;
    float acc[128];
    int stage = 0;
    uint32_t phase = 0, y_phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * S::kBN;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < k_tiles; ++kb) {
        hopper::mbar_wait(&full[stage], phase);
        const uint64_t da = hopper::desc_sw128(a_tile(stage) + wg * 64 * 128);
        const uint64_t db = hopper::desc_sw128(b_tile(stage));
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          hopper::wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk);
        hopper::wgmma_commit();
        hopper::fence_regs(acc);
        hopper::wgmma_wait<1>();  // the previous k-step's products are done
        if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);

      // The staged tile, once the epilogue has read out the last one.
      hopper::mbar_wait(y_empty, y_phase ^ 1);
      stage_rows<Epi, S::kBN, S::kLdY>(acc, ys, wg * 64, bias, n0, N);
      hopper::mbar_arrive(y_full);
      y_phase ^= 1;
    }
  } else {
    // Ping-pong consumers: warpgroup wg owns the block's tiles wg, wg + 2,
    // ... whole (rows 0-63 and 64-127 as two m64 halves), and issues a
    // tile's products after named barrier 1 + wg, then lets the other go;
    // warpgroup 1 lets warpgroup 0 go first.
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int lane = wtid % 32;
    if (wg == 1) hopper::bar_arrive(1, 256);
    float acc[2][64];
    uint32_t y_phase = 0;
    int i = wg;
    for (int tile = blockIdx.x + wg * gridDim.x; tile < tiles;
         tile += 2 * gridDim.x, i += 2) {
      const int n0 = (tile % n_tiles) * S::kBN;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 64; ++v) acc[h][v] = 0.f;
      // The ring's slot and phase at this tile's first k-step: the
      // producer fills k_tiles slots a tile, the block's tiles in order.
      const long long pos = static_cast<long long>(i) * k_tiles;
      int stage = static_cast<int>(pos % S::kStages);
      uint32_t phase = static_cast<uint32_t>(pos / S::kStages) & 1;
      int prev = -1;
      hopper::bar_sync(1 + wg, 256);
      for (int kb = 0; kb < k_tiles; ++kb) {
        hopper::mbar_wait(&full[stage], phase);
        const uint64_t da0 = hopper::desc_sw128(a_tile(stage));
        const uint64_t da1 = hopper::desc_sw128(a_tile(stage) + 64 * 128);
        const uint64_t db = hopper::desc_sw128(b_tile(stage));
        hopper::fence_regs(acc[0]);
        hopper::fence_regs(acc[1]);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          hopper::wgmma_ss<128>(acc[0], da0 + 2 * kk, db + 2 * kk);
          hopper::wgmma_ss<128>(acc[1], da1 + 2 * kk, db + 2 * kk);
        }
        hopper::wgmma_commit();
        hopper::fence_regs(acc[0]);
        hopper::fence_regs(acc[1]);
        hopper::wgmma_wait<1>();  // the previous k-step's products are done
        if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::bar_arrive(1 + (wg ^ 1), 256);  // the other's products next
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc[0]);
      hopper::fence_regs(acc[1]);
      if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);

      // act(y) into this warpgroup's staged tile, once the epilogue has
      // read out its last one.
      hopper::mbar_wait(&y_empty[wg], y_phase ^ 1);
      stage_rows<Epi, S::kBN, S::kLdY>(acc[0], y_tile(wg), 0, bias, n0, N);
      stage_rows<Epi, S::kBN, S::kLdY>(acc[1], y_tile(wg), 64, bias, n0, N);
      hopper::mbar_arrive(&y_full[wg]);
      y_phase ^= 1;
    }
  }
}

// The host helpers keep function-local statics: in an unnamed namespace
// each library has its own (with external linkage the dynamic linker
// would merge them across the libraries a process loads).
namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// already loaded (so the build needs no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// Tensor map of a row-major bf16 [rows, cols] array read in boxes of 64
// columns x box_rows rows with 128-byte swizzle; out-of-range reads are 0.
int make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
             int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The SM count of the current device, with gemm_kernel<Epi>'s dynamic
// shared memory limit raised there: both once per library and device, so
// that a call costs the host only the tensor maps and the launch.
template <class Epi>
int prepare(int* sms) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> ready[kMaxDevices];  // SM count; 0 until set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && (*sms = ready[dev].load(std::memory_order_acquire)) > 0)
    return 0;
  e = cudaFuncSetAttribute(
      gemm_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Schedule<Epi::kPingPong>::kSmemBytes));
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cached) ready[dev].store(*sms, std::memory_order_release);
  return 0;
}

}  // namespace

// out[M, N] = Epi(a[M, K] @ b[N, K]^T) on a persistent grid; bias [N] is
// read if Epi stages it or applies it, resid [M, N] if Epi loads it.
template <class Epi>
int launch_gemm(const void* a, const void* b, const void* bias,
                const void* resid, void* out, int M, int N, int K,
                cudaStream_t st) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using S = Schedule<Epi::kPingPong>;
  CUtensorMap tm_a, tm_b;
  int err = make_map(&tm_a, a, M, K, kBM);
  if (err == 0) err = make_map(&tm_b, b, N, K, S::kBN);
  int sms = 0;
  if (err == 0) err = prepare<Epi>(&sms);
  if (err != 0) return err;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + S::kBN - 1) / S::kBN);
  const int grid = tiles < sms ? tiles : sms;
  gemm_kernel<Epi><<<grid, kThreads, S::kSmemBytes, st>>>(
      tm_a, tm_b, static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(resid),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// xn[M, D] = bf16(LN(x)); D % 8 == 0, D <= 1024.
inline int launch_layer_norm(const void* x, const void* gamma,
                             const void* beta, void* xn, int M, int D,
                             float eps, cudaStream_t st) {
  if (M <= 0 || D <= 0 || D % 8 != 0 || D > kMaxLnWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  layer_norm_kernel<<<(M + 7) / 8, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(xn), M, D,
      eps);
  return static_cast<int>(cudaGetLastError());
}

// Whether every pointer is 16-byte aligned (TMA and the 16-byte stores).
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace gemm
}  // namespace pnp
