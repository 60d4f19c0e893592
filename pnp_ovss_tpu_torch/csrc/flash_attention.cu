// Flash attention on strided q/k/v views: K2, K7 and K9 are one kernel.
//
// K2 replaces pnp_ovss_tpu/ops/flash_attention.py::flash_mha_flat_qkv
// (pallas_call at :325, body _flat_kernel at :131) and its sliced twin
// flash_mha_flat (pallas_call at :260, same body).
// K7 replaces flash_mha_flat_xlen (pallas_call at :636, same body): the
// sequence-parallel form, a local chunk of Sq query rows over K/V gathered
// from every rank (Skv rows).
// K9 replaces flash_mha (pallas_call at :713, body _flash_kernel at :650):
// the same attention on [B, H, S, D] arrays.
//
// Computes softmax(q k^T / sqrt(D)) v, non-causal, per head. Every tensor
// is read through its own batch, head and row strides: the flat layout
// [B, S, H*D] has head stride D (for the qkv entry the three views sit at
// column offsets 0, H*D and 2*H*D of one [B, S, 3*H*D] array), the BHSD
// layout head stride S*D. Keys at index >= L are masked out; query rows
// >= S are neither read nor written.
//
// Bound on the H100 SXM at the main-path shape of K2 (B=35, S=442 = 21^2
// patches + CLS at 336 px, H=16, D=64):
// qkv is read once (95 MB) and out written once (32 MB), 127 MB at
// 3.35 TB/s = 38 us; the two products are 28 GFLOP, 28 us at 989 TFLOP/s
// bf16. Memory bound, narrowly. K7 at 336 px, sp = 2 (Sq = 221 rows over
// Skv = 442 keys) moves about 95 MB a rank (28 us); at 768 px (B=12,
// Sq = 1153, L = 2305) its products, 131 GFLOP, bound it at 132 us.
//
// Design: one block of 4 warps per (64-query tile, head, batch element);
// each warp owns 16 query rows (the per-warp online softmax is in
// flash_tile.cuh, shared with K4). q is scaled in f32 and rounded to bf16
// once, then held in registers as mma fragments. Tiles of 64 keys stream
// through shared memory (v stored transposed so that its fragments are
// 32-bit loads). Scores and P.V run on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 accumulation) with the online softmax in
// f32 registers, so the S x L probabilities never reach device memory.
// A query row's result depends only on that row and the keys, which every
// block visits in the same order of 64-key tiles from 0 to L: so a row of
// K7's local chunk is bit-equal to the same row of K2 over the whole
// sequence. Each q tile re-reads K and V of its head from L2 (7 tiles at
// S=442). The tile loop is synchronous; TMA, wgmma and double buffering
// are the next steps toward the bound.

#include "flash_tile.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kThreads = 128;
using pnp::flash::kBK;

// Strides of one tensor, in elements: batch, head and row.
struct View {
  long long bs, hs, rs;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_flat_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    View qv, View kv, View vv, View ov, int S, int L, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBK][D + 8];
  __shared__ __align__(16) __nv_bfloat16 vt[D][kBK + 8];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long b = blockIdx.z;
  const long long h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ + warp * 16;

  const __nv_bfloat16* kb = k + b * kv.bs + h * kv.hs;
  const __nv_bfloat16* vb = v + b * vv.bs + h * vv.hs;

  uint32_t qa[D / 16][4];
  pnp::flash::load_q<D>(qa, q + b * qv.bs + h * qv.hs, qv.rs, q0, S, scale,
                        g, t);
  pnp::flash::Softmax<D> sm;
  sm.init();
  for (int k0 = 0; k0 < L; k0 += kBK) {
    __syncthreads();  // the previous tile is fully consumed
    pnp::flash::load_kv<D>(ks, vt, kb, kv.rs, vb, vv.rs, k0, L, tid,
                           kThreads);
    __syncthreads();
    sm.tile(qa, ks, vt, k0, L, g, t);
  }
  sm.finish();

  __nv_bfloat16* ob = o + b * ov.bs + h * ov.hs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g + r * 8;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(ob + row * ov.rs + n * 8 + t * 2) =
          pnp::pack_bf16x2(sm.o[n][2 * r] / sm.l[r],
                           sm.o[n][2 * r + 1] / sm.l[r]);
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* o, View qv,
           View kv, View vv, View ov, int B, int S, int L, int H, int D,
           float scale, void* stream) {
  if (B < 1 || S < 1 || L < 1 || H < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (D == 64) {
    flash_flat_kernel<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, qv, kv,
                                                     vv, ov, S, L, scale);
  } else if (D == 128) {
    flash_flat_kernel<128><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, qv, kv,
                                                      vv, ov, S, L, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2. q/k/v/o point at head 0 of their flat [B, S, H*D] views; *_bs / *_rs
// are batch and row strides in elements. Needs 16-byte aligned rows
// (strides and pointers).
extern "C" int flash_mha_flat_bf16(const void* q, const void* k,
                                   const void* v, void* o, long long q_bs,
                                   long long q_rs, long long k_bs,
                                   long long k_rs, long long v_bs,
                                   long long v_rs, long long o_bs,
                                   long long o_rs, int B, int S, int L, int H,
                                   int D, float scale, void* stream) {
  return launch(q, k, v, o, View{q_bs, D, q_rs}, View{k_bs, D, k_rs},
                View{v_bs, D, v_rs}, View{o_bs, D, o_rs}, B, S, L, H, D,
                scale, stream);
}

// K7. As K2, with Sq query rows (q and o) over Skv key rows (k and v);
// keys at index >= L (the true length, L <= Skv) are masked.
extern "C" int flash_mha_xlen_bf16(const void* q, const void* k,
                                   const void* v, void* o, long long q_bs,
                                   long long q_rs, long long k_bs,
                                   long long k_rs, long long v_bs,
                                   long long v_rs, long long o_bs,
                                   long long o_rs, int B, int Sq, int Skv,
                                   int L, int H, int D, float scale,
                                   void* stream) {
  if (L > Skv) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, o, View{q_bs, D, q_rs}, View{k_bs, D, k_rs},
                View{v_bs, D, v_rs}, View{o_bs, D, o_rs}, B, Sq, L, H, D,
                scale, stream);
}

// K9. q/k/v/o are [B, H, S, D] with batch, head and row strides in
// elements (o contiguous); no key is masked beyond S.
extern "C" int flash_mha_bhsd_bf16(const void* q, const void* k,
                                   const void* v, void* o, long long q_bs,
                                   long long q_hs, long long q_rs,
                                   long long k_bs, long long k_hs,
                                   long long k_rs, long long v_bs,
                                   long long v_hs, long long v_rs,
                                   long long o_bs, long long o_hs,
                                   long long o_rs, int B, int H, int S, int D,
                                   float scale, void* stream) {
  return launch(q, k, v, o, View{q_bs, q_hs, q_rs}, View{k_bs, k_hs, k_rs},
                View{v_bs, v_hs, v_rs}, View{o_bs, o_hs, o_rs}, B, S, S, H, D,
                scale, stream);
}
