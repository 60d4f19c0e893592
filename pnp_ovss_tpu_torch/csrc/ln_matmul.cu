// K1: LayerNorm fused into the qkv projection, y = LN(x) @ W^T + b.
//
// Replaces pnp_ovss_tpu/ops/vit_block_pallas.py::ln_matmul (pallas_call at
// :119, body _ln_matmul_kernel at :74).
//
// x [M, D] bf16, gamma/beta [D] f32, W [N, D] bf16 (nn.Linear layout),
// b [N] bf16 -> y [M, N] bf16. LayerNorm in f32 (two passes), rounded to
// bf16 once; the product on the tensor cores with f32 accumulation; the
// bias added in f32 before the single rounding of the output.
//
// Bound on the H100 SXM at the main-path shapes (D = 1024, N = 3072;
// M = 35 * 442 = 15470 at 336 px, 12 * 2305 = 27660 at 768 px): the
// product is 97.3 GFLOP (336 px) or 174 GFLOP (768 px), 0.098 / 0.176 ms
// at 989 TFLOP/s bf16, against 0.133 / 0.238 GB of x, W and y (0.04 /
// 0.07 ms at 3.35 TB/s). Bound by operations.
//
// Design: a block of 8 warps owns a 64-row tile of x and all N output
// columns. It copies its rows into shared memory and normalises them in
// place once (64 x (D + 8) bf16, 132 KB at D = 1024), then runs the
// product over 128-column tiles of W, streamed in 64-deep k tiles through
// a 4-stage cp.async ring (204 KB of shared memory in all at D = 1024),
// one barrier a tile. Warps form a 2 x 4 grid of 32 x 32 warp tiles on
// mma.sync m16n8k16, fragments loaded with ldmatrix. W is re-read from L2
// once per row tile (242 times at 336 px, 433 at 768 px). Measured on the
// H100 (scripts/kernel_ablation.py, PERF.md), the kernel is held back by
// the W stream, the LayerNorm pass and the one-barrier-a-tile mma.sync
// loop, not by the tensor cores; splitting the columns over more blocks
// (recomputing the LayerNorm per group) was slower. M is ragged at both
// main shapes: rows >= M are zero in shared memory and never stored. The
// output keeps 16-byte row alignment for K2/K4, which read it as column
// views.

#include "gemm_tile.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kThreads = 256;
constexpr int kStages = 4;  // cp.async ring of W tiles

__global__ void __launch_bounds__(kThreads) ln_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    int M, int D, int N, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = D + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + kBM * ldx;  // [kStages][128][72]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int ktiles = D / pnp::kWTileK;
  const int total = (N / pnp::kWTileN) * ktiles;
  constexpr int kWs = pnp::kWTileN * pnp::kWTileLd;

  auto prefetch = [&](int it) {  // W tile `it` into its ring stage
    if (it < total)
      pnp::load_w_tile(ws + (it % kStages) * kWs, w, D,
                       (it / ktiles) * pnp::kWTileN,
                       (it % ktiles) * pnp::kWTileK, tid, kThreads);
    pnp::cp_async_commit();
  };

  pnp::load_rows(xs, ldx, x, row0, kBM, M, D, tid, kThreads);
  pnp::cp_async_commit();
  for (int it = 0; it < kStages - 1; ++it) prefetch(it);
  pnp::cp_async_wait<kStages - 1>();  // the rows have landed
  __syncthreads();
  pnp::layer_norm_rows(xs, ldx, kBM, D, gamma, beta, eps, warp,
                       kThreads / 32, lane);

  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 32 x 32
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    pnp::cp_async_wait<kStages - 2>();  // tile `it` has landed
    __syncthreads();  // ... for every thread; the LN and tile it-1 are done
    prefetch(it + kStages - 1);  // refills the stage tile it-1 used
    const __nv_bfloat16* wt = ws + (it % kStages) * kWs;
    const int k0 = (it % ktiles) * pnp::kWTileK;
#pragma unroll
    for (int kk = 0; kk < pnp::kWTileK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        pnp::ldm_a(a[i], xs + (wm * 32 + i * 16) * ldx + k0 + kk, ldx, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        pnp::ldm_b2(b, wt + (wn * 32 + j * 16) * pnp::kWTileLd + kk,
                    pnp::kWTileLd, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pnp::mma_bf16_16816(acc[i][2 * j], a[i], b[0], b[1]);
          pnp::mma_bf16_16816(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }

    if (it % ktiles == ktiles - 1) {
      const int n0 = (it / ktiles) * pnp::kWTileN;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + t * 2;
        const float b0 = __bfloat162float(bias[col]);
        const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const long long row = row0 + wm * 32 + i * 16 + g + r * 8;
            if (row < M)
              *reinterpret_cast<uint32_t*>(out + row * N + col) =
                  pnp::pack_bf16x2(acc[i][j][2 * r] + b0,
                                   acc[i][j][2 * r + 1] + b1);
            acc[i][j][2 * r] = 0.f;
            acc[i][j][2 * r + 1] = 0.f;
          }
        }
      }
    }
  }
}

}  // namespace

// All arrays contiguous. D % 64 == 0, D <= 1024, N % 128 == 0.
extern "C" int ln_matmul_bf16(const void* x, const void* gamma,
                              const void* beta, const void* w,
                              const void* bias, void* out, int M, int D,
                              int N, float eps, void* stream) {
  if (M <= 0 || D % pnp::kWTileK != 0 || D > 1024 || N <= 0 ||
      N % pnp::kWTileN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(__nv_bfloat16) *
      (static_cast<size_t>(kBM) * (D + 8) +
       kStages * pnp::kWTileN * pnp::kWTileLd);
  cudaError_t err = cudaFuncSetAttribute(
      ln_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_matmul_kernel<<<(M + kBM - 1) / kBM, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), M, D, N, eps);
  return static_cast<int>(cudaGetLastError());
}
