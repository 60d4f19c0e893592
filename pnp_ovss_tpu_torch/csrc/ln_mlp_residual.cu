// K3: LayerNorm + the whole MLP + the residual in one kernel,
// y = x + gelu(LN(x) @ W1^T + b1) @ W2^T + b2.
//
// Replaces pnp_ovss_tpu/ops/vit_block_pallas.py::ln_mlp_residual
// (pallas_call at :316, body _ln_mlp_kernel at :225).
//
// x [M, D] bf16, gamma/beta [D] f32, W1 [F, D] and W2 [D, F] bf16
// (nn.Linear layout), b1 [F], b2 [D] bf16 -> y [M, D] bf16. The reference's
// value flow: f32 LayerNorm rounded to bf16; fc1 with f32 accumulation,
// + b1 in f32, rounded to bf16; the exact-erf gelu in bf16 steps, with erf
// the clamped minimax polynomial evaluated in f32 (no erff: its values
// round differently on some bf16 codes); fc2 with f32 accumulation, + b2
// in f32, rounded to bf16; then x + that, rounded once more.
//
// Bound on the H100 SXM at the main-path shapes (D = 1024, F = 4096;
// M = 15470 at 336 px, 27660 at 768 px): 259.5 / 464 GFLOP, 0.262 /
// 0.469 ms at 989 TFLOP/s bf16, against 0.08 / 0.13 GB of x, weights and
// y. Bound by operations.
//
// Design. The TPU kernel carries an f32 [rows, D] accumulator across
// sequential grid steps over F. Blocks run in no order here, so the sum
// over F is a loop inside one block, and the accumulator lives in
// registers: a block owns a 32-row tile (16 warps, 512 threads), each warp
// 32 rows x D/16 output columns (64 f32 registers a thread at D = 1024).
// A 64-row tile would need 256 KB of accumulator, more than a block's
// registers or its 227 KB of shared memory. Per block: the rows are
// normalised once into shared memory; then for each 32-wide hidden chunk
// fc1 runs with its k range split over 8 warp groups (partials summed in
// shared memory), 512 threads apply b1 and the gelu into a 32 x 32 bf16
// tile, and fc2 adds that tile's product to the register accumulator. W1's
// chunk and W2's slice arrive by cp.async while the previous stage
// computes. The hidden chunk never leaves the SM.
//
// Cost of the 32-row tile: W1 and W2 (16.8 MB together) are streamed from
// L2 once per row tile, 484 times at 336 px and 865 at 768 px (8.1 / 14.5
// GB of L2 reads). Measured on the H100 (scripts/kernel_ablation.py,
// PERF.md), that stream is the larger part of the kernel's time, and the
// mma.sync loop without it is still well above the bound; a deeper
// cp.async ring over 128-wide chunks was slower. Thread-block clusters
// sharing the weight stream, and wgmma, are the next steps. Rows >= M are
// zero in shared memory and never stored.

#include "gemm_tile.cuh"

namespace {

constexpr int kBM = 32;
constexpr int kBF = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kKGroups = kWarps / 2;  // fc1: 2 row frags x 8 k groups
constexpr int kLdH = kBF + 8;         // row stride of the gelu and W2 tiles

// The JAX package's erf coefficients (vit_block_pallas.py _ERF_P), the
// doubles rounded to f32 as the reference's jnp.float32(c) rounds them.
__constant__ float kErfP[10] = {
    1.128379139571155,      -0.3761252259731045,
    0.11282976424513898,    -0.026843839553998192,
    0.0051925774717181995,  -0.0008290527520228961,
    0.00010732167832988502, -1.0523825720237124e-05,
    6.793275336392753e-07,  -2.1076366182700845e-08};

// gelu of a bf16 value y (held in f32), rounded to bf16 after every step
// as the reference's bf16 arithmetic does; no contraction into FMAs.
__device__ __forceinline__ float gelu_bf16(float y) {
  const float sqrt2 = 1.4140625f;  // bf16(sqrt(2))
  const float tt = pnp::round_bf16(__fdiv_rn(y, sqrt2));
  const float xc = fminf(fmaxf(tt, -2.2f), 2.2f);
  const float x2 = __fmul_rn(xc, xc);
  float p = kErfP[9];
#pragma unroll
  for (int i = 8; i >= 0; --i)
    p = __fadd_rn(__fmul_rn(p, x2), kErfP[i]);
  const float e = pnp::round_bf16(__fmul_rn(xc, p));
  const float half = pnp::round_bf16(pnp::round_bf16(__fadd_rn(e, 1.f)) *
                                     0.5f);
  return pnp::round_bf16(__fmul_rn(y, half));
}

template <int NF>  // n8 fragments of output columns per warp: D / 128
__global__ void __launch_bounds__(kThreads, 1) ln_mlp_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1,
    const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out,
    int M, int F, float eps) {
  constexpr int D = NF * 8 * kWarps;
  constexpr int ldx = D + 8;
  constexpr int kW1Bytes = kBM * ldx * 2 > kKGroups * kBM * kBF * 4
                               ? kBM * ldx * 2
                               : kKGroups * kBM * kBF * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [32][ldx]
  unsigned char* w1_region = smem + kBM * ldx * 2;
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(w1_region);
  float* red = reinterpret_cast<float*>(w1_region);  // [8][32][32], aliased
  __nv_bfloat16* gs =
      reinterpret_cast<__nv_bfloat16*>(w1_region + kW1Bytes);  // [32][kLdH]
  __nv_bfloat16* w2s = gs + kBM * kLdH;                        // [D][kLdH]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int nchunks = F / kBF;

  auto load_w1 = [&](int j) {  // W1 rows f0..f0+31, all D columns
    const long long f0 = static_cast<long long>(j) * kBF;
    for (int c = tid; c < kBF * D / 8; c += kThreads) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      pnp::cp_async16(w1s + r * ldx + col, w1 + (f0 + r) * D + col);
    }
  };
  auto load_w2 = [&](int j) {  // W2 columns f0..f0+31, all D rows
    const int f0 = j * kBF;
    for (int c = tid; c < D * kBF / 8; c += kThreads) {
      const int r = c / (kBF / 8), col = (c % (kBF / 8)) * 8;
      pnp::cp_async16(w2s + r * kLdH + col,
                      w2 + static_cast<long long>(r) * F + f0 + col);
    }
  };

  pnp::load_rows(xs, ldx, x, row0, kBM, M, D, tid, kThreads);
  pnp::cp_async_commit();
  load_w1(0);
  pnp::cp_async_commit();
  load_w2(0);
  pnp::cp_async_commit();
  pnp::cp_async_wait<2>();  // the rows have landed
  __syncthreads();
  pnp::layer_norm_rows(xs, ldx, kBM, D, gamma, beta, eps, warp, kWarps,
                       lane);

  float acc[2][NF][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  const int fm = warp & 1, kg = warp >> 1;  // fc1: row frag, k group
  constexpr int kSpan = D / kKGroups;
  for (int j = 0; j < nchunks; ++j) {
    pnp::cp_async_wait<1>();  // W1 chunk j has landed (W2 slice j may not)
    __syncthreads();

    // fc1 partial: rows fm*16.., all 32 hidden columns, k in this group.
    float h[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[n][e] = 0.f;
#pragma unroll 4
    for (int kk = kg * kSpan; kk < (kg + 1) * kSpan; kk += 16) {
      uint32_t a[4], b[4], c[4];
      pnp::ldm_a(a, xs + fm * 16 * ldx + kk, ldx, lane);
      pnp::ldm_b2(b, w1s + kk, ldx, lane);
      pnp::ldm_b2(c, w1s + 16 * ldx + kk, ldx, lane);
      pnp::mma_bf16_16816(h[0], a, b[0], b[1]);
      pnp::mma_bf16_16816(h[1], a, b[2], b[3]);
      pnp::mma_bf16_16816(h[2], a, c[0], c[1]);
      pnp::mma_bf16_16816(h[3], a, c[2], c[3]);
    }
    __syncthreads();  // every warp is done with w1s, which red aliases
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = fm * 16 + g + (e >> 1) * 8, col = n * 8 + t * 2 + (e & 1);
        red[(kg * kBM + r) * kBF + col] = h[n][e];
      }
    __syncthreads();

    // + b1, round, gelu: 512 threads x 2 hidden values.
    {
      const int e = tid * 2, r = e / kBF, col = e % kBF;
      const int f = j * kBF + col;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int q = 0; q < kKGroups; ++q) {
        s0 += red[(q * kBM + r) * kBF + col];
        s1 += red[(q * kBM + r) * kBF + col + 1];
      }
      const float y0 = pnp::round_bf16(s0 + __bfloat162float(b1[f]));
      const float y1 = pnp::round_bf16(s1 + __bfloat162float(b1[f + 1]));
      *reinterpret_cast<uint32_t*>(gs + r * kLdH + col) =
          pnp::pack_bf16x2(gelu_bf16(y0), gelu_bf16(y1));
    }
    __syncthreads();  // red is consumed and the gelu tile written
    if (j + 1 < nchunks) load_w1(j + 1);
    pnp::cp_async_commit();
    pnp::cp_async_wait<1>();  // W2 slice j has landed
    __syncthreads();

    // fc2: this warp's D/16 output columns, all 32 rows, k = the chunk.
    const int n_base = warp * NF * 8;
#pragma unroll
    for (int kk = 0; kk < kBF; kk += 16) {
      uint32_t a[2][4];
      pnp::ldm_a(a[0], gs + kk, kLdH, lane);
      pnp::ldm_a(a[1], gs + 16 * kLdH + kk, kLdH, lane);
      if constexpr (NF == 1) {
        uint32_t b[2];
        pnp::ldm_b1(b, w2s + n_base * kLdH + kk, kLdH, lane);
        pnp::mma_bf16_16816(acc[0][0], a[0], b[0], b[1]);
        pnp::mma_bf16_16816(acc[1][0], a[1], b[0], b[1]);
      } else {
#pragma unroll
        for (int p = 0; p < NF / 2; ++p) {
          uint32_t b[4];
          pnp::ldm_b2(b, w2s + (n_base + p * 16) * kLdH + kk, kLdH, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            pnp::mma_bf16_16816(acc[i][2 * p], a[i], b[0], b[1]);
            pnp::mma_bf16_16816(acc[i][2 * p + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // w2s and the gelu tile are consumed
    if (j + 1 < nchunks) load_w2(j + 1);
    pnp::cp_async_commit();
  }

  // out = x + bf16(acc + b2), rounded once more.
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    const int col = warp * NF * 8 + n * 8 + t * 2;
    const float c0 = __bfloat162float(b2[col]);
    const float c1 = __bfloat162float(b2[col + 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = row0 + i * 16 + g + r * 8;
        if (row >= M) continue;
        const float2 xv = pnp::unpack_bf16x2(
            *reinterpret_cast<const uint32_t*>(x + row * D + col));
        const float o0 = pnp::round_bf16(acc[i][n][2 * r] + c0);
        const float o1 = pnp::round_bf16(acc[i][n][2 * r + 1] + c1);
        *reinterpret_cast<uint32_t*>(out + row * D + col) =
            pnp::pack_bf16x2(xv.x + o0, xv.y + o1);
      }
    }
  }
}

template <int NF>
int launch(const void* x, const void* gamma, const void* beta, const void* w1,
           const void* b1, const void* w2, const void* b2, void* out, int M,
           int F, float eps, cudaStream_t st) {
  constexpr int D = NF * 8 * kWarps;
  constexpr size_t ldx = D + 8;
  const size_t w1_bytes = kBM * ldx * 2 > size_t(kKGroups) * kBM * kBF * 4
                              ? kBM * ldx * 2
                              : size_t(kKGroups) * kBM * kBF * 4;
  const size_t smem = kBM * ldx * 2 + w1_bytes + kBM * kLdH * 2 +
                      size_t(D) * kLdH * 2;
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_mlp_kernel<NF><<<(M + kBM - 1) / kBM, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(out),
      M, F, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All arrays contiguous. D in {128, 256, 512, 1024}, F % 32 == 0.
extern "C" int ln_mlp_residual_bf16(const void* x, const void* gamma,
                                    const void* beta, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* out, int M, int D,
                                    int F, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || F <= 0 || F % kBF != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 128:
      return launch<1>(x, gamma, beta, w1, b1, w2, b2, out, M, F, eps, st);
    case 256:
      return launch<2>(x, gamma, beta, w1, b1, w2, b2, out, M, F, eps, st);
    case 512:
      return launch<4>(x, gamma, beta, w1, b1, w2, b2, out, M, F, eps, st);
    case 1024:
      return launch<8>(x, gamma, beta, w1, b1, w2, b2, out, M, F, eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
