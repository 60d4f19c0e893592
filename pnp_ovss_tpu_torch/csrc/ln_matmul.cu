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
// Design. Normalising a row tile in shared memory and running the whole
// product from it on mma.sync re-streams W from L2 once per row tile and
// reached 135 TFLOP/s on this card, where cuBLAS runs the same product at
// ~700 (PERF.md). So one call runs two kernels on the caller's buffers
// (wgmma_gemm.cuh, shared with K3 and K4):
//   1. the row LayerNorm, x -> xn (bf16), one warp per row;
//   2. the persistent wgmma + TMA GEMM xn @ W^T on its cooperative
//      schedule (128 x 256 tiles), whose consumers stage y = bf16(acc +
//      b) in shared memory; the epilogue warps only copy the staged tile
//      out with 16-byte stores.
// xn makes one round trip through device memory (2 * M * D * 2 bytes,
// 0.019 / 0.034 ms at 3.35 TB/s), the trade K3 makes for its hidden. The
// output keeps its row-major [M, N] layout and 16-byte rows, so K2 and K4
// read q/k/v as column views of it.

#include "wgmma_gemm.cuh"

// Epilogue types name a __global__ template's instance, so they have
// external linkage (no unnamed namespace).
namespace pnp {
namespace k1 {

// y = bf16(acc + b) staged and stored as it is.
struct Bias {
  static constexpr bool kPingPong = false;
  static constexpr bool kStageBias = true;
  static constexpr int kRows = 2;
  static __device__ __forceinline__ uint4 load(const __nv_bfloat16*,
                                               long long) {
    return make_uint4(0, 0, 0, 0);
  }
  static __device__ __forceinline__ uint4 apply(uint4 y, uint4,
                                                const __nv_bfloat16*, int) {
    return y;
  }
};

}  // namespace k1
}  // namespace pnp

// All arrays contiguous, x, w, xn and out 16-byte aligned, bias 4-byte
// aligned. D % 8 == 0, D <= 1024, N % 8 == 0. xn [M, D] is the caller's
// scratch (the normalised rows).
extern "C" int ln_matmul_bf16(const void* x, const void* gamma,
                              const void* beta, const void* w,
                              const void* bias, void* xn, void* out, int M,
                              int D, int N, float eps, void* stream) {
  namespace gm = pnp::gemm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!gm::aligned16({x, w, xn, out}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int err = gm::launch_layer_norm(x, gamma, beta, xn, M, D, eps, st);
  if (err == 0)
    err = gm::launch_gemm<pnp::k1::Bias>(xn, w, bias, nullptr, out, M, N, D,
                                         st);
  return err;
}
