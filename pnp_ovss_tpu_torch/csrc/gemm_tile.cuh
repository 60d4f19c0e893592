// Tile helpers of the port's mma.sync kernels (the flash kernel, K8) and
// of the wgmma GEMM's epilogues and row LayerNorm: cp.async copies into
// shared memory, ldmatrix fragment loads for mma.sync m16n8k16, warp sums
// and bf16 rounding.
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

}  // namespace pnp
