// K8: the bilateral message m_i = sum_j exp(-||f_i - f_j||^2 / 2) v_j,
// self included, without materialising the kernel.
//
// Replaces pnp_ovss_tpu/ops/bilateral_pallas.py::gaussian_kernel_matmul
// (pallas_call at :104, body _bilateral_kernel at :34). The CRF runs it for
// the exact CRF (subsample 1), the unmaterialised strided CRF and both
// products of the Nystrom reconstruction.
//
// Numerics, as the Pallas body: the exponent is f32; k and v are rounded
// to bf16 for the product, which accumulates in f32. Rows i >= N are not
// stored; columns j >= M contribute exactly 0 (the wrapper pads v^T with
// zero columns and the features with finite zeros, so k * 0 = 0).
//
// Bound on the H100 SXM at the exact CRF's shape (N = M = 36864 pixels of
// the 192x192 bucket, C = 58 channels of two variants): 1.36e9 pairs, each
// ~17 f32 operations for the explicit-difference exponent (0.35 ms at
// 67 TFLOP/s on the CUDA cores) and one ex2 on the multi-function unit
// (16 a clock per SM), against 2*N*M*C = 158 GFLOP of bf16 product
// (0.16 ms at 989 TFLOP/s) and ~15 MB of inputs and outputs. Bound by the
// f32 exponent work, then by the ex2 rate.
//
// Design: one block of 6 warps owns 96 i-rows (one warp per 16 rows, 384
// blocks at N = 36864: one wave at up to 4 blocks an SM) and walks all of
// j in 64-column stages. Nothing carries between blocks: no atomics, no
// split over j. A stage puts the f_j tile (f32, 8 floats a column) and
// the v^T tile (bf16, channels padded to 16) in shared memory with
// cp.async, double buffered. Each thread computes the kernel entries of
// exactly its own mma.sync m16n8k16 A fragment (rows g, g+8; columns 2t,
// 2t+1, 2t+8, 2t+9 of each 16-column step): its rows' features sit in
// registers, a column's features come from shared memory in two vector
// loads, d^2 is a sum of explicit f32 differences on the CUDA cores, and
// the results are packed to bf16x2 in registers, so k never touches
// shared memory. The wrapper scales the features by sqrt(1 / (2 ln 2)),
// so that k = 2^-d^2 is one ex2 with flush to zero (an entry below 2^-126
// adds nothing a bf16 sum can hold). The feature product feeds an
// exponent, so it never goes through the tensor cores (bf16 or TF32 would
// put an error of order 1 into the exponent at ||f||^2 ~ 8e3). The f32
// accumulators of the [16, channels] output tile stay in registers across
// the whole j loop and are stored once. More than 128 channels split over
// blockIdx.y, each chunk recomputing the exponents.

#include "gemm_tile.cuh"

namespace {

constexpr int kWarps = 6;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // i rows per block
constexpr int kBJ = 64;             // j columns per stage
constexpr int kVLd = kBJ + 8;       // bf16 row stride of the staged v^T tile
constexpr int kFLd = 8;             // floats a feature row holds

// 2^-x, flushing results below 2^-126 to 0.
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(-x));
  return y;
}

// F: feature width used (5, or 8 for 6..8; rows hold kFLd floats, zero
// beyond F); NB: 16-channel blocks per chunk.
template <int F, int NB>
__global__ void __launch_bounds__(kThreads) kernel_matmul(
    const float* __restrict__ fi, const float* __restrict__ fj,
    const __nv_bfloat16* __restrict__ vt, float* __restrict__ out, int N,
    int M_pad, int C) {
  constexpr int kCh = NB * 16;
  __shared__ __align__(16) float fs[2][kBJ * kFLd];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kCh * kVLd];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows + warp * 16;
  const int c0 = blockIdx.y * kCh;

  float fr[2][F];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i = r0 + g + 8 * h;
#pragma unroll
    for (int d = 0; d < F; ++d) fr[h][d] = i < N ? fi[i * kFLd + d] : 0.f;
  }

  auto stage = [&](int buf, int j0) {
    const float* src = fj + static_cast<long long>(j0) * kFLd;
    for (int q = tid; q < kBJ * kFLd / 4; q += kThreads)
      pnp::cp_async16(&fs[buf][q * 4], src + q * 4);
    for (int q = tid; q < kCh * (kBJ / 8); q += kThreads) {
      const int r = q / (kBJ / 8), col = (q % (kBJ / 8)) * 8;
      pnp::cp_async16(&vs[buf][r * kVLd + col],
                      vt + static_cast<long long>(c0 + r) * M_pad + j0 + col);
    }
  };

  float acc[2 * NB][4];
#pragma unroll
  for (int n = 0; n < 2 * NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nj = M_pad / kBJ;
  if (nj > 0) stage(0, 0);
  pnp::cp_async_commit();
  for (int jt = 0; jt < nj; ++jt) {
    const int buf = jt & 1;
    if (jt + 1 < nj) {
      stage(buf ^ 1, (jt + 1) * kBJ);
      pnp::cp_async_commit();
      pnp::cp_async_wait<1>();
    } else {
      pnp::cp_async_wait<0>();
    }
    __syncthreads();
    const float* f = fs[buf];
    const __nv_bfloat16* v = vs[buf];
#pragma unroll
    for (int s = 0; s < kBJ / 16; ++s) {
      // k[h][q]: row g + 8h, column s*16 + 2t + (q & 1) + 8 (q >> 1).
      float k[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* fc =
            f + (s * 16 + 2 * t + (q & 1) + (q >> 1) * 8) * kFLd;
        const float4 lo = *reinterpret_cast<const float4*>(fc);
        const float4 hi = *reinterpret_cast<const float4*>(fc + 4);
        const float b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float d2 = 0.f;
#pragma unroll
          for (int d = 0; d < F; ++d) {
            const float diff = fr[h][d] - b[d];
            d2 = fmaf(diff, diff, d2);
          }
          k[h][q] = exp2_neg(d2);
        }
      }
      const uint32_t a[4] = {
          pnp::pack_bf16x2(k[0][0], k[0][1]), pnp::pack_bf16x2(k[1][0], k[1][1]),
          pnp::pack_bf16x2(k[0][2], k[0][3]), pnp::pack_bf16x2(k[1][2], k[1][3])};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        uint32_t b[4];
        pnp::ldm_b2(b, v + nb * 16 * kVLd + s * 16, kVLd, lane);
        pnp::mma_bf16_16816(acc[2 * nb], a, b[0], b[1]);
        pnp::mma_bf16_16816(acc[2 * nb + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < 2 * NB; ++n) {
    const int col = c0 + n * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long i = r0 + g + 8 * h;
      if (i >= N) continue;
      if (col < C) out[i * C + col] = acc[n][2 * h];
      if (col + 1 < C) out[i * C + col + 1] = acc[n][2 * h + 1];
    }
  }
}

template <int F>
cudaError_t launch(const float* fi, const float* fj, const __nv_bfloat16* vt,
                   float* out, int N, int M_pad, int C, int NB,
                   cudaStream_t stream) {
  const dim3 grid((N + kRows - 1) / kRows, (C + NB * 16 - 1) / (NB * 16));
#define PNP_K8_CASE(nb)                                                     \
  case nb:                                                                  \
    kernel_matmul<F, nb><<<grid, kThreads, 0, stream>>>(fi, fj, vt, out, N, \
                                                         M_pad, C);         \
    break;
  switch (NB) {
    PNP_K8_CASE(1)
    PNP_K8_CASE(2)
    PNP_K8_CASE(4)
    PNP_K8_CASE(6)
    PNP_K8_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PNP_K8_CASE
  return cudaGetLastError();
}

}  // namespace

// fi [N, 8] f32 and fj [M_pad, 8] f32, features scaled by sqrt(1/(2 ln 2))
// and zero beyond column F; vt [ceil(C / (16 NB)) * 16 NB, M_pad] bf16
// (v^T, zero beyond C rows and M columns); out [N, C] f32; all contiguous
// and 16-byte aligned. F in {5, 8}, M_pad % 64 == 0, NB in {1, 2, 4, 6, 8}.
extern "C" int gaussian_kernel_matmul(const void* fi, const void* fj,
                                      const void* vt, void* out, int N,
                                      int M_pad, int F, int C, int NB,
                                      void* stream) {
  if (N < 0 || M_pad < 0 || M_pad % kBJ != 0 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const auto* fi_ = static_cast<const float*>(fi);
  const auto* fj_ = static_cast<const float*>(fj);
  const auto* vt_ = static_cast<const __nv_bfloat16*>(vt);
  auto* out_ = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (F == 5)
    err = launch<5>(fi_, fj_, vt_, out_, N, M_pad, C, NB, st);
  else if (F == 8)
    err = launch<8>(fi_, fj_, vt_, out_, N, M_pad, C, NB, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
