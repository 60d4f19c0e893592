// K8: the bilateral message m_i = sum_j exp(-||f_i - f_j||^2 / 2) v_j,
// self included, without materialising the kernel.
//
// Replaces pnp_ovss_tpu/ops/bilateral_pallas.py::gaussian_kernel_matmul
// (pallas_call at :104, body _bilateral_kernel at :34). The CRF runs it for
// the exact CRF (subsample 1), the unmaterialised strided CRF and both
// products of the Nystrom reconstruction.
//
// Numerics, as the Pallas body: the exponent is f32, from explicit
// differences on the CUDA cores (ROADMAP F1), over features the wrapper
// scales by sqrt(1 / (2 ln 2)) so that k = 2^-d^2 is one ex2.approx.ftz (an
// entry below 2^-126 adds nothing a bf16 sum can hold); k and v are rounded
// to bf16 for the product, which sums in f32. The expansion 2a.b - |a|^2 -
// |b|^2 (6 f32 operations a pair in place of 10) was measured and dropped:
// even over features centred at their midrange it leaves ~6e-5 in the
// exponent of pairs with k near 1, 20x explicit differences' 3e-6, and the
// bf16 codes it flips there moved the exact message 1.4e-3 from the plain
// version against a bar of 7e-4 (PERF.md).
//
// Bound on the H100 SXM at the exact CRF's shape (N = M = 36864 pixels of
// the 192x192 bucket, C = 58 channels of two variants): 1.36e9 pairs, each
// one ex2 on the multi-function unit (16 a clock per SM: 0.325 ms at 132
// SMs and the 1.98 GHz that 67 TFLOP/s implies) and 15 f32 operations (5
// subtractions and 5 FMAs; the negation folds into the ex2's operand: 0.30
// ms at 67 TFLOP/s), against 2*N*M*C = 158 GFLOP of bf16 product (0.16 ms
// at 989 TFLOP/s) and ~15 MB of inputs and outputs. The ex2 unit bounds
// it; in issue slots a pair takes about 12 (10 f32, 1 ex2, half a bf16
// pack, half a shared load) of the 128 an SM issues a clock, 0.49 ms.
//
// Design: out = K v on wgmma (hopper.cuh's wgmma_rs, shared with K6), with
// K computed in registers as A.
// - One warpgroup a block owns two m64 row tiles (128 i rows). Each
//   thread computes exactly its own A fragments of wgmma m64nWk16 (the
//   per-warp layout of mma.sync m16n8k16: rows g, g+8 of its warp's 16 in
//   each tile, columns 2t, 2t+1, 2t+8, 2t+9 of each 16-column step), so a
//   column's features, read from shared memory once, serve 4 entries, and
//   k never touches shared memory. The rows' features live in registers.
// - B is the v^T tile, W channels x 64 columns of bf16 in 128-byte
//   swizzled shared memory (K-major as stored). W is C rounded up to one of
//   8, 16, 32, 48, 64, 96, 128 (C = 1, the degree, runs n = 8); more than
//   128 channels split into equal chunks over blockIdx.y, each chunk
//   recomputing the exponents.
// - A ring of kStages stages fed by TMA (one thread arms a stage's
//   mbarrier and issues two 2-D box loads: the v^T tile and the 64
//   columns' scaled features, 12 floats a column, so that the four
//   columns a warp reads at once fall in distinct banks). TMA zero-fills
//   past M and C: a pad column has finite features and v = 0, so it adds
//   exactly 0. The stage wait traps after ~2 s instead of hanging.
// - A stage computes all 32 of its fragments (4 k16 steps, 2 tiles), then
//   issues its 8 products back to back; they run while the next stage
//   waits for its data, and are waited for only before that stage
//   rewrites the fragments. (Writing A registers while an earlier wgmma
//   still reads them makes ptxas serialise every wgmma: C7513.)
// - Work units are (row tile, j chunk): the wrapper splits j into
//   `split` chunks so that every SM gets close to the same number of
//   units (bilateral.matmul_plan). With split > 1 each unit writes its f32
//   partial to a workspace; the last unit of a row tile to arrive (a
//   counter, reset by that unit) sums the partials in the fixed order of
//   the chunks and stores the result, so two launches on the same inputs
//   are bit-equal. No float atomics.

#include <atomic>

#include "wgmma_gemm.cuh"

namespace {

constexpr int kTiles = 2;                // m64 row tiles a warpgroup
constexpr int kThreads = 128;            // one warpgroup a block
constexpr int kRows = 64 * kTiles;       // i rows a block
constexpr int kBJ = 64;                  // j columns a stage: one swizzle row
constexpr int kFLd = 12;                 // floats a packed feature row
constexpr int kStages = 4;               // ring depth
constexpr int kFTile = kBJ * kFLd * 4;   // bytes of a stage's features

// Bytes of a stage (the v^T tile first: a 1024-byte multiple) and of a
// block's dynamic shared memory (the ring, its barriers, a flag, and room
// to align the ring to 1024 bytes).
template <int W>
constexpr int kStageBytes = W * kBJ * 2 + kFTile;
template <int W>
constexpr int kSmemBytes =
    kStages * kStageBytes<W> + kStages * 8 + 16 + 1024;

// 2^x, flushing results below 2^-126 to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The first K floats of a column's packed features, in 16-byte loads
// where they fit (K = 5: two loads, K = 8: two).
template <int K>
__device__ __forceinline__ void load_column(const float* p, float (&b)[K]) {
#pragma unroll
  for (int q = 0; q + 4 <= K; q += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + q);
    b[q] = v.x;
    b[q + 1] = v.y;
    b[q + 2] = v.z;
    b[q + 3] = v.w;
  }
  constexpr int kTail = K / 4 * 4;
  if constexpr (K % 4 >= 2) {
    const float2 v = *reinterpret_cast<const float2*>(p + kTail);
    b[kTail] = v.x;
    b[kTail + 1] = v.y;
  }
  if constexpr (K % 2 == 1) b[K - 1] = p[K - 1];
}

// One block: row tile blockIdx.x / split, j chunk blockIdx.x % split,
// channels blockIdx.y * W ..; features (f_j side) and v^T through their
// tensor maps (boxes of 64 x 12 f32 and 64 x W bf16, the latter with
// 128-byte swizzle).
template <int F, int W>
__global__ void __launch_bounds__(kThreads, (F == 5 && W <= 64) ? 3 : 2)
    matmul_kernel(const __grid_constant__ CUtensorMap tm_f,
                  const __grid_constant__ CUtensorMap tm_v,
                  const float* __restrict__ fi, float* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int N,
                  int M, int C, int split) {
  constexpr int kStage = kStageBytes<W>;
  constexpr int kPairs = kTiles * W / 4;  // float2 of a thread's partial
  extern __shared__ unsigned char smem_raw[];
  // Stages on a 1024-byte boundary (the swizzle's period). An offset into
  // smem_raw, so that the compiler still sees a shared-memory pointer and
  // reads the features with LDS rather than generic loads.
  unsigned char* smem =
      smem_raw + ((1024 - (pnp::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  int* last = reinterpret_cast<int*>(full + kStages);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rt = blockIdx.x / split, q = blockIdx.x % split;
  const int r0 = rt * kRows, c0 = blockIdx.y * W;
  const int stages = (M + kBJ - 1) / kBJ;
  const int s0 = static_cast<int>(static_cast<long long>(q) * stages / split);
  const int n_it =
      static_cast<int>(static_cast<long long>(q + 1) * stages / split) - s0;

  auto v_tile = [&](int slot) { return smem + slot * kStage; };
  auto f_tile = [&](int slot) {
    return reinterpret_cast<const float*>(smem + slot * kStage + W * kBJ * 2);
  };
  // Thread 0: stage `it` of this chunk into its slot.
  auto load = [&](int it) {
    const int slot = it % kStages, j0 = (s0 + it) * kBJ;
    pnp::hopper::mbar_expect_tx(&full[slot], kStage);
    pnp::hopper::tma_load_2d(v_tile(slot), &tm_v, j0, c0, &full[slot]);
    pnp::hopper::tma_load_2d(smem + slot * kStage + W * kBJ * 2, &tm_f, 0,
                             j0, &full[slot]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) pnp::hopper::mbar_init(&full[s], 1);
    pnp::hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages - 1 && s < n_it; ++s) load(s);

  // Row features: entry r = 2 i + h is row 64 i + 16 warp + g + 8 h of
  // the tile, 0 past N.
  float ra[2 * kTiles][F];
#pragma unroll
  for (int r = 0; r < 2 * kTiles; ++r) {
    const int row = r0 + 64 * (r / 2) + 16 * warp + g + 8 * (r % 2);
    const float* p = fi + static_cast<long long>(row) * kFLd;
#pragma unroll
    for (int d = 0; d < F; ++d) ra[r][d] = row < N ? p[d] : 0.f;
  }

  float acc[kTiles][W / 2];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < W / 2; ++e) acc[i][e] = 0.f;
  uint32_t a[kBJ / 16][kTiles][4] = {};  // [k16 step][tile][fragment]
  for (int it = 0; it < n_it; ++it) {
    // The last stage's products are done: its A registers are free, and
    // after the barrier so is its slot, which this stage refills.
    pnp::hopper::wgmma_wait<0>();
    pnp::hopper::fence_a(a);
#pragma unroll
    for (int i = 0; i < kTiles; ++i) pnp::hopper::fence_regs(acc[i]);
    __syncthreads();
    if (tid == 0 && it + kStages - 1 < n_it) load(it + kStages - 1);
    pnp::hopper::mbar_wait_or_trap(&full[it % kStages],
                                   (it / kStages) & 1);

    const float* fs = f_tile(it % kStages);
#pragma unroll
    for (int s = 0; s < kBJ / 16; ++s) {
      // k[r][c]: row entry r, column s*16 + 2t + (c & 1) + 8 (c >> 1).
      float k[2 * kTiles][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float b[F];
        load_column(fs + (s * 16 + 2 * t + (c & 1) + 8 * (c >> 1)) * kFLd, b);
#pragma unroll
        for (int r = 0; r < 2 * kTiles; ++r) {
          float d2 = 0.f;
#pragma unroll
          for (int d = 0; d < F; ++d) {
            const float e = ra[r][d] - b[d];
            d2 = fmaf(e, e, d2);
          }
          k[r][c] = exp2_ftz(-d2);
        }
      }
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        a[s][i][0] = pnp::pack_bf16x2(k[2 * i][0], k[2 * i][1]);
        a[s][i][1] = pnp::pack_bf16x2(k[2 * i + 1][0], k[2 * i + 1][1]);
        a[s][i][2] = pnp::pack_bf16x2(k[2 * i][2], k[2 * i][3]);
        a[s][i][3] = pnp::pack_bf16x2(k[2 * i + 1][2], k[2 * i + 1][3]);
      }
    }
    const uint64_t db = pnp::hopper::desc_sw128(v_tile(it % kStages));
    pnp::hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBJ / 16; ++s)
#pragma unroll
      for (int i = 0; i < kTiles; ++i)
        pnp::hopper::wgmma_rs<W>(acc[i], a[s][i], db + 2 * s);
    pnp::hopper::wgmma_commit();
  }
  pnp::hopper::wgmma_wait<0>();
  pnp::hopper::fence_a(a);
#pragma unroll
  for (int i = 0; i < kTiles; ++i) pnp::hopper::fence_regs(acc[i]);

  if (split > 1) {
    // This unit's partial, float2 p of thread tid at [p][tid] (coalesced);
    // the units of one row tile and chunk are adjacent.
    const long long unit = static_cast<long long>(blockIdx.y) * gridDim.x +
                           blockIdx.x;
    float2* part = reinterpret_cast<float2*>(ws);
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int p = 0; p < W / 4; ++p)
        part[(unit * kPairs + i * (W / 4) + p) * kThreads + tid] =
            make_float2(acc[i][2 * p], acc[i][2 * p + 1]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* cnt = counters + blockIdx.y * (gridDim.x / split) + rt;
      const int prev = atomicAdd(cnt, 1);
      *last = prev == split - 1;
      if (prev == split - 1) *cnt = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!*last) return;
    __threadfence();
    // The last unit sums the partials in chunk order, its own from
    // registers (the same bits it stored); each chunk's loads are issued
    // together. 0 + p_0 = p_0, so the sum is ((p_0 + p_1) + p_2) + ...
    const float2* first = part + (unit - q) * kPairs * kThreads;
    float sum[kTiles][W / 2];
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int e = 0; e < W / 2; ++e) sum[i][e] = 0.f;
    for (int u = 0; u < split; ++u) {
      const float2* pu = first + static_cast<long long>(u) * kPairs * kThreads;
#pragma unroll
      for (int i = 0; i < kTiles; ++i)
#pragma unroll
        for (int p = 0; p < W / 4; ++p) {
          const float2 v =
              u == q ? make_float2(acc[i][2 * p], acc[i][2 * p + 1])
                     : __ldcg(pu + (i * (W / 4) + p) * kThreads + tid);
          sum[i][2 * p] += v.x;
          sum[i][2 * p + 1] += v.y;
        }
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int e = 0; e < W / 2; ++e) acc[i][e] = sum[i][e];
  }

#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + 64 * i + 16 * warp + g + 8 * h;
        const int col = c0 + 8 * j + 2 * t;
        if (row >= N) continue;
        if (col < C) out[row * C + col] = acc[i][4 * j + 2 * h];
        if (col + 1 < C) out[row * C + col + 1] = acc[i][4 * j + 2 * h + 1];
      }
}

// Tensor map of a row-major [rows, cols] array (element `type` of `elem`
// bytes, rows `ld` elements apart) read in boxes of box_cols x box_rows;
// out-of-range reads are 0.
int make_map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem,
                const void* ptr, int rows, int cols, long long ld,
                int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  pnp::gemm::EncodeTiled fn = pnp::gemm::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides,
                        box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// matmul_kernel<F, W>'s shared-memory limit raised once per library and
// device.
template <int F, int W>
int prepare() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && ready[dev].load(std::memory_order_acquire)) return 0;
  e = cudaFuncSetAttribute(matmul_kernel<F, W>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes<W>);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cached) ready[dev].store(true, std::memory_order_release);
  return 0;
}

struct Args {
  CUtensorMap tm_f, tm_v;
  const float* fi;
  float* out;
  float* ws;
  int* counters;
  int N, M, C, split, chunks;
  cudaStream_t stream;
};

template <int F, int W>
int launch(const Args& x) {
  const int err = prepare<F, W>();
  if (err != 0) return err;
  const dim3 grid(((x.N + kRows - 1) / kRows) * x.split, x.chunks);
  constexpr int smem = kSmemBytes<W>;
  matmul_kernel<F, W><<<grid, kThreads, smem, x.stream>>>(
      x.tm_f, x.tm_v, x.fi, x.out, x.ws, x.counters, x.N, x.M, x.C, x.split);
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_width(int width, const Args& x) {
  switch (width) {
    case 8: return launch<F, 8>(x);
    case 16: return launch<F, 16>(x);
    case 32: return launch<F, 32>(x);
    case 48: return launch<F, 48>(x);
    case 64: return launch<F, 64>(x);
    case 96: return launch<F, 96>(x);
    case 128: return launch<F, 128>(x);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// fi [N, 12] and fj [M, 12] f32, the features scaled by
// sqrt(1 / (2 ln 2)) in columns 0..F-1 (bilateral.pack_features); vt
// [C, vt_ld] bf16 (v^T; columns from M on are not
// read); out [N, C] f32; F in {5, 8}; width in {8, 16, 32, 48, 64, 96,
// 128}, chunks = ceil(C / width) over blockIdx.y; 1 <= split <= ceil(M /
// 64). With split > 1, ws holds at least chunks * ceil(N / 128) * split *
// 128 * width floats and counters at least chunks * ceil(N / 128) ints,
// all 0 before the first launch (each launch leaves them 0). fi, fj, vt
// and ws 16-byte aligned, vt_ld % 8 == 0.
extern "C" int gaussian_kernel_matmul(const void* fi, const void* fj,
                                      const void* vt, void* out, void* ws,
                                      void* counters, int N, int M,
                                      int vt_ld, int F, int C, int width,
                                      int split, long long ws_floats,
                                      int n_counters, void* stream) {
  if (N < 0 || M < 1 || C < 1 || width < 8 || vt_ld < M || vt_ld % 8 != 0 ||
      split < 1 || split > (M + kBJ - 1) / kBJ ||
      !pnp::gemm::aligned16({fi, fj, vt, ws}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const int chunks = (C + width - 1) / width;
  const long long tiles =
      static_cast<long long>(chunks) * ((N + kRows - 1) / kRows);
  if (split > 1 && (ws_floats < tiles * split * kRows * width ||
                    n_counters < tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  Args x;
  x.fi = static_cast<const float*>(fi);
  x.out = static_cast<float*>(out);
  x.ws = static_cast<float*>(ws);
  x.counters = static_cast<int*>(counters);
  x.N = N;
  x.M = M;
  x.C = C;
  x.split = split;
  x.chunks = chunks;
  x.stream = static_cast<cudaStream_t>(stream);
  int err = make_map_2d(&x.tm_f, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, fj, M,
                        kFLd, kFLd, kFLd, kBJ, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0)
    err = make_map_2d(&x.tm_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, vt, C,
                      M, vt_ld, kBJ, width, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  if (F == 5) return launch_width<5>(width, x);
  if (F == 8) return launch_width<8>(width, x);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One launch that stalls on a stage whose bytes never arrive; the launch
// traps after ~2 s and the next synchronisation reports the error.
extern "C" int gaussian_kernel_matmul_stall(void* stream) {
  pnp::hopper::stall_kernel<0><<<1, 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
