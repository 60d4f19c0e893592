// K3: LayerNorm + the whole MLP + the residual,
// y = x + gelu(LN(x) @ W1^T + b1) @ W2^T + b2.
//
// Replaces pnp_ovss_tpu/ops/vit_block_pallas.py::ln_mlp_residual
// (pallas_call at :316, body _ln_mlp_kernel at :225).
//
// x [M, D] bf16, gamma/beta [D] f32, W1 [F, D] and W2 [D, F] bf16
// (nn.Linear layout), b1 [F], b2 [D] bf16 -> y [M, D] bf16. The reference's
// value flow: f32 two-pass LayerNorm rounded to bf16; fc1 with f32
// accumulation, + b1 in f32, rounded to bf16; the exact-erf gelu in bf16
// steps, with erf the clamped minimax polynomial evaluated in f32 (no erff:
// its values round differently on some bf16 codes); fc2 with f32
// accumulation, + b2 in f32, rounded to bf16; then x + that, rounded once
// more.
//
// Bound on the H100 SXM at the main-path shapes (D = 1024, F = 4096;
// M = 15470 at 336 px, 27660 at 768 px): 259.5 / 464 GFLOP, 0.262 /
// 0.469 ms at 989 TFLOP/s bf16, against 0.08 / 0.13 GB of x, weights and
// y. Bound by operations.
//
// Design. The TPU kernel keeps the [rows, F] hidden on chip and carries an
// f32 [rows, D] accumulator across grid steps over F. On this card an f32
// accumulator of D = 1024 allows only 32-row tiles, which re-stream both
// weights from L2 once per 32 rows and keep the products on mma.sync. The
// hidden instead makes one round trip through device memory (2 * M * F * 2
// bytes, 0.08 / 0.14 ms at 3.35 TB/s, under a third of the operations
// bound), and one call runs three kernels on the caller's buffers:
//   1. a row LayerNorm, x -> xn (bf16), one warp per row;
//   2. fc1, xn @ W1^T, with the epilogue + b1, round, gelu -> g (bf16);
//   3. fc2, g @ W2^T, with the epilogue + b2, round, + x, round -> y.
// Both products are the shared persistent wgmma + TMA GEMM
// (wgmma_gemm.cuh), with the row LayerNorm kernel from the same header,
// on its two schedules:
// - fc1 (Fc1Gelu) on the ping-pong schedule: the two consumer warpgroups
//   own 128 x 128 tiles in turn, and while one issues its products the
//   other computes gelu(bf16(acc + b1)) in registers (~40 dependent f32
//   steps a value) and stages it; the epilogue warps only copy it out.
//   In the cooperative schedule's three epilogue warps the gelu held fc1
//   at 40% of its products' bound (fc2: 66%); here fc1 runs at ~51%, the
//   card's power limit reached (PERF.md);
// - fc2 (Fc2Residual) on the cooperative schedule: both warpgroups on
//   each 128 x 256 tile stage y = bf16(acc + b2) in shared memory, and
//   three epilogue warps add the residual while the tensor cores run the
//   next tile.
// g is bit for bit what the cooperative schedule gives (the same k16
// sums, the same roundings). D % 8 == 0 up to 1024 (the LayerNorm's
// widest row), F % 8 == 0, any M >= 1.

#include "wgmma_gemm.cuh"

namespace {

// The JAX package's erf coefficients (vit_block_pallas.py _ERF_P), the
// doubles rounded to f32 as the reference's jnp.float32(c) rounds them.
__constant__ float kErfP[10] = {
    1.128379139571155,      -0.3761252259731045,
    0.11282976424513898,    -0.026843839553998192,
    0.0051925774717181995,  -0.0008290527520228961,
    0.00010732167832988502, -1.0523825720237124e-05,
    6.793275336392753e-07,  -2.1076366182700845e-08};

// The two bf16 values of r (low half first) in f32: a shift and a mask,
// two instructions fewer than unpack_bf16x2's intrinsic.
__device__ __forceinline__ float2 halves(uint32_t r) {
  return make_float2(__uint_as_float(r << 16),
                     __uint_as_float(r & 0xffff0000u));
}

// bf16(a), bf16(b) held in f32: one cvt.rn.bf16x2.f32 for the pair.
__device__ __forceinline__ float2 round_bf16x2(float a, float b) {
  return halves(pnp::pack_bf16x2(a, b));
}

// gelu of the two bf16 values of y2, packed as bf16x2 as they are. Each
// value is rounded to bf16 after every step as the reference's bf16
// arithmetic does, one conversion a step for the pair; no contraction
// into FMAs. The reference divides by bf16(sqrt(2)) = 181/128. An exact
// quotient y * 128 / 181 of a bf16 y never lies on or within 2^-17
// (relative) of a bf16 rounding midpoint, so rounding the f32 product
// with the f32 reciprocal gives the same bf16 value as rounding the
// quotient (checked on every finite bf16 code); and e + 1 halved is
// exact in bf16.
__device__ __forceinline__ uint32_t gelu_bf16x2(uint32_t y2) {
  const float2 y = halves(y2);
  const float inv_sqrt2 = 1.0f / 1.4140625f;  // 1 / bf16(sqrt(2)), in f32
  const float2 tt = round_bf16x2(__fmul_rn(y.x, inv_sqrt2),
                                 __fmul_rn(y.y, inv_sqrt2));
  const float xc[2] = {fminf(fmaxf(tt.x, -2.2f), 2.2f),
                       fminf(fmaxf(tt.y, -2.2f), 2.2f)};
  float p[2];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const float x2 = __fmul_rn(xc[v], xc[v]);
    p[v] = kErfP[9];
#pragma unroll
    for (int i = 8; i >= 0; --i)
      p[v] = __fadd_rn(__fmul_rn(p[v], x2), kErfP[i]);
  }
  const float2 e = round_bf16x2(__fmul_rn(xc[0], p[0]),
                                __fmul_rn(xc[1], p[1]));
  const float2 e1 = round_bf16x2(__fadd_rn(e.x, 1.f), __fadd_rn(e.y, 1.f));
  return pnp::pack_bf16x2(__fmul_rn(y.x, __fmul_rn(e1.x, 0.5f)),
                          __fmul_rn(y.y, __fmul_rn(e1.y, 0.5f)));
}

}  // namespace

// Epilogue types name a __global__ template's instance, so they have
// external linkage (no unnamed namespace).
namespace pnp {
namespace k3 {

// fc1: gelu(bf16(acc + b1)) stored, on the ping-pong schedule: the
// consumers apply act in registers (apply does the same in the epilogue
// warps, should the cooperative schedule run it).
struct Fc1Gelu {
  static constexpr bool kPingPong = true;
  static constexpr bool kStageBias = true;
  static constexpr int kRows = 2;
  static __device__ __forceinline__ uint32_t act(uint32_t y) {
    return gelu_bf16x2(y);
  }
  static __device__ __forceinline__ uint4 load(const __nv_bfloat16*,
                                               long long) {
    return make_uint4(0, 0, 0, 0);
  }
  static __device__ __forceinline__ uint4 apply(uint4 yv, uint4,
                                                const __nv_bfloat16*, int) {
    const uint32_t y[4] = {yv.x, yv.y, yv.z, yv.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = act(y[i]);
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};

// fc2: y = bf16(acc + b2) staged, bf16(resid + y) stored.
struct Fc2Residual {
  static constexpr bool kPingPong = false;
  static constexpr bool kStageBias = true;
  static constexpr int kRows = 2;
  static __device__ __forceinline__ uint4 load(
      const __nv_bfloat16* __restrict__ resid, long long off) {
    return *reinterpret_cast<const uint4*>(resid + off);
  }
  static __device__ __forceinline__ uint4 apply(uint4 yv, uint4 xv,
                                                const __nv_bfloat16*, int) {
    const uint32_t y[4] = {yv.x, yv.y, yv.z, yv.w};
    const uint32_t x[4] = {xv.x, xv.y, xv.z, xv.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = pnp::unpack_bf16x2(y[i]);
      const float2 r = pnp::unpack_bf16x2(x[i]);
      o[i] = pnp::pack_bf16x2(r.x + f.x, r.y + f.y);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};

}  // namespace k3
}  // namespace pnp

// All arrays contiguous, x, the weights, the scratch and out 16-byte
// aligned, the biases 4-byte aligned. D % 8 == 0, D <= 1024,
// F % 8 == 0. xn [M, D] and g [M, F] are the caller's scratch (the
// normalised rows and the gelu hidden).
extern "C" int ln_mlp_residual_bf16(const void* x, const void* gamma,
                                    const void* beta, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* xn, void* g,
                                    void* out, int M, int D, int F, float eps,
                                    void* stream) {
  namespace gm = pnp::gemm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!gm::aligned16({x, w1, w2, xn, g, out}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int err = gm::launch_layer_norm(x, gamma, beta, xn, M, D, eps, st);
  if (err == 0)
    err = gm::launch_gemm<pnp::k3::Fc1Gelu>(xn, w1, b1, nullptr, g, M, F, D,
                                            st);
  if (err == 0)
    err = gm::launch_gemm<pnp::k3::Fc2Residual>(g, w2, b2, x, out, M, D, F,
                                                st);
  return err;
}
