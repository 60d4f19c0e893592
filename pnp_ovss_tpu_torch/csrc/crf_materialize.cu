// K5: build the CRF's materialised bilateral kernel once per image.
//
// Replaces pnp_ovss_tpu/ops/bilateral_pallas.py::gaussian_kernel_materialize
// (pallas_call at :204, body _materialize_kernel at :139).
//
// Computes K^T[m, n] = exp(-0.5 * ||f_j[m] - f_i[n]||^2) over 5-D features
// (x/sxy, y/sxy, rgb/srgb) for anchor rows m < M and pixel columns n < N,
// stored as uint8 round(k * 255) (round half to even, as jnp.round) or
// f32. Rows M <= m < M_pad are exactly 0, so the fused iteration (K6)
// can read all M_pad rows without a slice.
//
// Bound on the H100 SXM at the main-path shape (M_pad = 2304 anchors of a
// 48x48 grid, N = 36864 pixels of the 192x192 bucket): the 85 MB uint8
// output is written once, 25 us at 3.35 TB/s. The real limit is
// instruction issue: an entry needs 5 subtractions and 5 multiply-adds
// for its explicit differences, then the exponent, the rounding and a
// share of the pack and store, about 14 instructions with the design
// below, ~37 us of issue at 132 SMs x 4 schedulers x 1.98 GHz for 85 M
// entries.
//
// Design: the exponent is computed from explicit differences
// sum_f (f_j - f_i)^2 in IEEE f32 on the CUDA cores (F1). No tensor-core
// or TF32 path touches it: at rgb/5 up to 51 a truncated dot product
// puts O(10) absolute error into the exponent. What the design cuts is
// the instructions around it:
// - kExp2: both feature sets are prescaled by sqrt(log2(e) / 2) (once a
//   block and column set) and the sum starts at -log2(255), so the code
//   is one ex2.approx of log2(255) - d2': 255 exp(-d2 / 2) without expf's
//   range reduction or the two multiplies;
// - the code is rounded with the magic number: x + 1.5*2^23 rounds half
//   to even in the FADD and its low byte is the code (F2I.RN, a
//   quarter-rate conversion, is gone), and four codes are packed with
//   two-source byte permutes;
// - each thread keeps the features of 8 consecutive columns (40
//   registers, down from 80) under a cap of 64 registers, 4 blocks of 8
//   warps an SM, and sweeps the 32 rows of its block, whose features it
//   reads from shared memory (one 16-byte and one 4-byte broadcast load a
//   row); a warp writes 256 contiguous bytes a row with 8-byte stores;
// - blocks of 2048 columns x 32 rows, 1296 at the main path, so the
//   dynamic scheduling balances the SMs to within about a tenth.
// With kExp2 off the codes are bit-equal to expf(-d2/2) * 255 rounded by
// F2I.RN; kernel_ablation.py times each step, and PERF.md records the
// share of codes that ex2.approx moves. The f32 kind (Nystrom's K_AA, F2)
// always uses expf.

#include "common.cuh"

namespace {

constexpr int kF = 5;           // feature dimension
constexpr int kCols = 8;        // consecutive columns a thread
constexpr int kMinBlocks = 4;   // blocks an SM: registers capped at 64
constexpr int kThreads = 256;
constexpr int kColsPerBlock = kThreads * kCols;
constexpr int kRowsPerBlock = 32;
constexpr bool kExp2 = true;        // ex2.approx exponent (uint8 kind only)
constexpr bool kMagicRound = true;  // else __float2uint_rn
constexpr float kRound = 12582912.0f;           // 1.5 * 2^23
constexpr float kLog2_255 = 7.99435343685886f;  // log2(255)
constexpr float kExp2Scale = 0.84932180028801907f;  // sqrt(log2(e) / 2)

enum OutKind { kU8 = 0, kF32 = 1 };

// The uint8 code of k*255 (given in f32) in the low byte.
__device__ __forceinline__ uint32_t code_bits(float k255) {
  if (kMagicRound) return __float_as_uint(__fadd_rn(k255, kRound));
  return __float2uint_rn(k255);
}

// Low bytes of a, b, c, d as one word, a lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int kind>
__global__ void __launch_bounds__(kThreads, kMinBlocks) materialize_kernel(
    const float* __restrict__ fj, const float* __restrict__ fi,
    void* __restrict__ out, int M, int M_pad, int N) {
  constexpr bool kFast = kExp2 && kind == kU8;
  constexpr float kScale = kFast ? kExp2Scale : 1.f;
  __shared__ __align__(16) float rows[kRowsPerBlock][8];
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int c0 = blockIdx.x * kColsPerBlock + threadIdx.x * kCols;

  for (int i = threadIdx.x; i < kRowsPerBlock * kF; i += kThreads) {
    const int r = i / kF, d = i % kF;
    rows[r][d] = row0 + r < M ? fj[(long long)(row0 + r) * kF + d] * kScale
                              : 0.f;
  }

  // Columns c0 .. c0 + kCols - 1: 5 kCols consecutive floats (from a
  // 16-byte boundary) when all are in range.
  float f[kCols][kF];
  const bool fi16 = reinterpret_cast<uintptr_t>(fi) % 16 == 0;
  if (c0 + kCols <= N && fi16) {
    const float4* src =
        reinterpret_cast<const float4*>(fi + (long long)c0 * kF);
    float flat[kCols * kF];
#pragma unroll
    for (int i = 0; i < kCols * kF / 4; ++i) {
      const float4 q = src[i];
      flat[4 * i] = q.x;
      flat[4 * i + 1] = q.y;
      flat[4 * i + 2] = q.z;
      flat[4 * i + 3] = q.w;
    }
#pragma unroll
    for (int e = 0; e < kCols; ++e)
#pragma unroll
      for (int d = 0; d < kF; ++d) f[e][d] = flat[e * kF + d] * kScale;
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e)
#pragma unroll
      for (int d = 0; d < kF; ++d)
        f[e][d] =
            c0 + e < N ? fi[(long long)(c0 + e) * kF + d] * kScale : 0.f;
  }
  __syncthreads();
  if (c0 >= N) return;
  // A thread's columns in one store (uint8) or 16-byte stores (f32).
  const bool vec =
      N % kCols == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;

  const int rows_here = min(kRowsPerBlock, M_pad - row0);
#pragma unroll 2
  for (int r = 0; r < rows_here; ++r) {
    const int m = row0 + r;
    const long long base = (long long)m * N + c0;
    float k[kCols];
    if (m < M) {
      const float4 a4 = *reinterpret_cast<const float4*>(&rows[r][0]);
      const float a[kF] = {a4.x, a4.y, a4.z, a4.w, rows[r][4]};
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        float d2 = kFast ? -kLog2_255 : 0.f;
#pragma unroll
        for (int d = 0; d < kF; ++d) {
          const float diff = a[d] - f[e][d];
          d2 = fmaf(diff, diff, d2);
        }
        // kFast: 255 * 2^-(d2') = 2^(log2(255) - d2'); else exp(-d2/2),
        // times 255 for the uint8 kind.
        k[e] = kFast ? ex2_approx(-d2)
                     : (kind == kU8 ? __fmul_rn(expf(-0.5f * d2), 255.0f)
                                    : expf(-0.5f * d2));
      }
    } else {
#pragma unroll
      for (int e = 0; e < kCols; ++e) k[e] = 0.f;
    }
    if (kind == kU8) {
      uint8_t* o = static_cast<uint8_t*>(out);
      uint32_t w[kCols / 4];
#pragma unroll
      for (int i = 0; i < kCols / 4; ++i)
        w[i] = pack4(code_bits(k[4 * i]), code_bits(k[4 * i + 1]),
                     code_bits(k[4 * i + 2]), code_bits(k[4 * i + 3]));
      if (vec) {
        *reinterpret_cast<uint2*>(o + base) = make_uint2(w[0], w[1]);
      } else {
        for (int e = 0; e < kCols && c0 + e < N; ++e)
          o[base + e] = static_cast<uint8_t>(w[e / 4] >> (8 * (e % 4)));
      }
    } else {
      float* o = static_cast<float*>(out);
      if (vec) {
#pragma unroll
        for (int i = 0; i < kCols / 4; ++i)
          *reinterpret_cast<float4*>(o + base + 4 * i) =
              make_float4(k[4 * i], k[4 * i + 1], k[4 * i + 2], k[4 * i + 3]);
      } else {
        for (int e = 0; e < kCols && c0 + e < N; ++e) o[base + e] = k[e];
      }
    }
  }
}

}  // namespace

// fj: [M, 5] f32, fi: [N, 5] f32, out: [M_pad, N] of kind (0 uint8,
// 1 f32), all contiguous.
extern "C" int gaussian_kernel_materialize(const void* fj, const void* fi,
                                           void* out, int M, int M_pad,
                                           int N, int F, int kind,
                                           void* stream) {
  if (F != kF || kind < kU8 || kind > kF32 || M > M_pad || M_pad <= 0 ||
      N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kColsPerBlock - 1) / kColsPerBlock,
                  (M_pad + kRowsPerBlock - 1) / kRowsPerBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(fj);
  const float* b = static_cast<const float*>(fi);
  if (kind == kU8)
    materialize_kernel<kU8><<<grid, kThreads, 0, st>>>(a, b, out, M, M_pad, N);
  else
    materialize_kernel<kF32><<<grid, kThreads, 0, st>>>(a, b, out, M, M_pad,
                                                        N);
  return static_cast<int>(cudaGetLastError());
}
