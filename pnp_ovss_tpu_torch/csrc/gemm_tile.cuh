// Tile helpers of the port's mma.sync kernels (K1 ln_matmul, K4
// flash_mha_qkv_proj, the flash kernel, K8) and of K3's LayerNorm:
// cp.async copies into shared memory, ldmatrix fragment loads for mma.sync
// m16n8k16, warp sums, bf16 rounding and the f32 LayerNorm of rows held in
// shared memory.
#pragma once

#include "common.cuh"

namespace pnp {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that does not pass through registers.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A fragment of mma m16n8k16: the 16 x 16 bf16 block at `p` of a
// row-major shared-memory tile with `ld` elements per row.
__device__ __forceinline__ void ldm_a(uint32_t (&a)[4],
                                      const __nv_bfloat16* p, int ld,
                                      int lane) {
  const __nv_bfloat16* q = p + (lane % 16) * ld + (lane / 16) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(q)));
}

// B fragments of two n8 blocks from an [n][k] tile (k contiguous, `ld`
// elements per row) at `p` = (n0, k0): b[0], b[1] for columns n0..n0+7 and
// b[2], b[3] for n0+8..n0+15, each over k0..k0+15.
__device__ __forceinline__ void ldm_b2(uint32_t (&b)[4],
                                       const __nv_bfloat16* p, int ld,
                                       int lane) {
  const __nv_bfloat16* q =
      p + ((lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(q)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Copy rows [row0, row0 + rows) of x [M, d] (bf16, row-major) into the
// shared tile xs (row stride ld) with cp.async; rows >= M are zeroed.
// The caller commits the group.
__device__ __forceinline__ void load_rows(__nv_bfloat16* xs, int ld,
                                          const __nv_bfloat16* x,
                                          long long row0, int rows, int M,
                                          int d, int tid, int nthreads) {
  const int per_row = d / 8;
  for (int c = tid; c < rows * per_row; c += nthreads) {
    const int r = c / per_row, col = (c % per_row) * 8;
    __nv_bfloat16* dst = xs + r * ld + col;
    if (row0 + r < M)
      cp_async16(dst, x + (row0 + r) * d + col);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// LayerNorm of `rows` rows of d bf16 values in shared memory (row stride
// ld), in place, one warp per row: f32 mean, then the f32 mean of squared
// deviations (two passes, as the reference), then
// (x - mu) * rsqrt(var + eps) * gamma + beta rounded to bf16 once.
__device__ __forceinline__ void layer_norm_rows(
    __nv_bfloat16* xs, int ld, int rows, int d,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float eps, int warp, int nwarps, int lane) {
  for (int r = warp; r < rows; r += nwarps) {
    __nv_bfloat16* row = xs + r * ld;
    float s = 0.f;
    for (int c = lane * 2; c < d; c += 64) {
      const float2 v =
          unpack_bf16x2(*reinterpret_cast<const uint32_t*>(row + c));
      s += v.x + v.y;
    }
    const float mu = warp_sum(s) / d;
    float q = 0.f;
    for (int c = lane * 2; c < d; c += 64) {
      const float2 v =
          unpack_bf16x2(*reinterpret_cast<const uint32_t*>(row + c));
      const float a = v.x - mu, b = v.y - mu;
      q += a * a + b * b;
    }
    const float rs = rsqrtf(warp_sum(q) / d + eps);
    for (int c = lane * 2; c < d; c += 64) {
      uint32_t* p = reinterpret_cast<uint32_t*>(row + c);
      const float2 v = unpack_bf16x2(*p);
      *p = pack_bf16x2((v.x - mu) * rs * gamma[c] + beta[c],
                       (v.y - mu) * rs * gamma[c + 1] + beta[c + 1]);
    }
  }
}

// cp.async of the [128 n][64 k] tile of W [N, K] (row-major) at (n0, k0)
// into ws (row stride 72). The caller commits the group.
constexpr int kWTileN = 128, kWTileK = 64, kWTileLd = kWTileK + 8;
__device__ __forceinline__ void load_w_tile(__nv_bfloat16* ws,
                                            const __nv_bfloat16* w, int K,
                                            int n0, int k0, int tid,
                                            int nthreads) {
  for (int c = tid; c < kWTileN * kWTileK / 8; c += nthreads) {
    const int r = c / (kWTileK / 8), col = (c % (kWTileK / 8)) * 8;
    cp_async16(ws + r * kWTileLd + col,
               w + static_cast<long long>(n0 + r) * K + k0 + col);
  }
}

}  // namespace pnp
