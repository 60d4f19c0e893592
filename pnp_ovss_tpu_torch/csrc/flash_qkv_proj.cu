// K4: attention + output projection + residual,
// y = bf16(x + bf16(bf16(attention(qkv) @ Wp^T) + bp)).
//
// Replaces pnp_ovss_tpu/ops/flash_attention.py::flash_mha_qkv_proj
// (pallas_call at :506, body _flat_proj_kernel at :405).
//
// qkv [B, S, 3*H*D] bf16 ([q | k | v] on the channel axis, read as column
// views), x [B, S, Dm] bf16, Wp [Dm, H*D] bf16 (nn.Linear layout), bp [Dm]
// bf16 -> y [B, S, Dm] bf16. The reference's value flow: per head, q scaled
// in f32, online softmax over keys masked at index >= L, the head output
// rounded to bf16; the whole H*D proj contraction accumulated in f32 and
// rounded once; then x + (that + bp) in bf16 arithmetic.
//
// Bound on the H100 SXM at the 768 px main-path shape (B = 12, S = 2305,
// H = 16, D = 64, Dm = 1024): attention 261 GFLOP plus proj 58 GFLOP,
// 0.323 ms at 989 TFLOP/s bf16, against 285 MB of qkv, x, Wp and y
// (0.085 ms at 3.35 TB/s). Bound by operations.
//
// Design. Keeping a block's [64, H*D] slab of head outputs in shared
// memory for the proj (132 KB at H*D = 1024) leaves no room for a K/V
// ring beside the attention's tiles, and has every block re-read Wp from
// L2 for a proj on mma.sync (2.17 ms a launch at 768 px, PERF.md). So one
// call runs two kernels on the caller's buffers:
//   1. attention: the flash kernel of K2, K7 and K9 (flash_kernel.cuh)
//      through K2's flat strided views of the qkv columns, into the
//      caller's [B, S, H*D] bf16 scratch; each head output is K2's and
//      K7's row bit for bit;
//   2. projection: the shared persistent wgmma + TMA GEMM
//      (wgmma_gemm.cuh) over that scratch, M = B*S, N = Dm, K = H*D, the
//      f32 sum in k16 steps from k = 0 up as cuBLAS takes it, so the fused
//      block equals the sequence-parallel block's x + (F.linear(out, Wp)
//      + bp); on the GEMM's cooperative schedule the consumers stage
//      bf16(acc), and the epilogue warps add bp, round, add x, round.
// The head outputs make one round trip through device memory (2 x 56.6 MB
// at 768 px, 0.034 ms at 3.35 TB/s), the trade K3 makes for its hidden.

#include "flash_kernel.cuh"
#include "wgmma_gemm.cuh"

// Epilogue types name a __global__ template's instance, so they have
// external linkage (no unnamed namespace).
namespace pnp {
namespace k4 {

// y = bf16(acc) staged; bf16(x + bf16(y + bp)) stored. With K = H*D =
// 1024 a tile's products take a quarter of fc2's (K = 4096), so each
// epilogue thread keeps the residual of 4 rows in flight to keep up (the
// proj alone at 768 px: 0.161 / 0.138 / 0.209 ms with 2 / 4 / 8 rows,
// kernel_ablation.py).
struct ProjResidual {
  static constexpr bool kPingPong = false;
  static constexpr bool kStageBias = false;
  static constexpr int kRows = 4;
  static __device__ __forceinline__ uint4 load(
      const __nv_bfloat16* __restrict__ resid, long long off) {
    return *reinterpret_cast<const uint4*>(resid + off);
  }
  static __device__ __forceinline__ uint4 apply(
      uint4 yv, uint4 xv, const __nv_bfloat16* __restrict__ bias, int col) {
    const uint32_t y[4] = {yv.x, yv.y, yv.z, yv.w};
    const uint32_t x[4] = {xv.x, xv.y, xv.z, xv.w};
    const uint32_t* bp = reinterpret_cast<const uint32_t*>(bias + col);
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = pnp::unpack_bf16x2(y[i]);
      const float2 c = pnp::unpack_bf16x2(bp[i]);
      const float2 r = pnp::unpack_bf16x2(x[i]);
      o[i] = pnp::pack_bf16x2(r.x + pnp::round_bf16(f.x + c.x),
                              r.y + pnp::round_bf16(f.y + c.y));
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};

}  // namespace k4
}  // namespace pnp

// The projection alone: out [M, Dm] = bf16(x + bf16(bf16(attn @ wp^T) +
// bp)) for attn [M, HD], x [M, Dm], wp [Dm, HD], bp [Dm]. All contiguous,
// attn, x, wp and out 16-byte aligned, bp 4-byte aligned; HD % 8 == 0,
// Dm % 8 == 0.
extern "C" int qkv_proj_residual_bf16(const void* attn, const void* x,
                                      const void* wp, const void* bp,
                                      void* out, int M, int Dm, int HD,
                                      void* stream) {
  namespace gm = pnp::gemm;
  if (!gm::aligned16({attn, x, wp, out}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return gm::launch_gemm<pnp::k4::ProjResidual>(
      attn, wp, bp, x, out, M, Dm, HD, static_cast<cudaStream_t>(stream));
}

// qkv [B, S, 3*H*D], x / out [B, S, Dm], wp [Dm, H*D], bp [Dm], all
// contiguous; attn [B, S, H*D] is the caller's scratch (the head outputs).
// D in {64, 128}, H even, H*D <= 1024, Dm % 128 == 0, 0 < L <= S.
extern "C" int flash_mha_qkv_proj_bf16(const void* qkv, const void* x,
                                       const void* wp, const void* bp,
                                       void* attn, void* out, int B, int S,
                                       int L, int H, int D, int Dm,
                                       float scale, void* stream) {
  if (B <= 0 || S <= 0 || L <= 0 || L > S || H % 2 != 0 || H * D > 1024 ||
      Dm % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long hd = static_cast<long long>(H) * D;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const pnp::flash::View in{S * 3 * hd, D, 3 * hd};
  int err = pnp::flash::launch_flat(q, q + hd, q + 2 * hd, attn, in, in, in,
                                    pnp::flash::View{S * hd, D, hd}, B, S, L,
                                    H, D, scale, stream);
  if (err == 0)
    err = qkv_proj_residual_bf16(attn, x, wp, bp, out, B * S, Dm, H * D,
                                 stream);
  return err;
}
