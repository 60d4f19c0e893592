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
// bf16, and the 110 M exponentials 26 us on the multi-function units.
// Memory bound, narrowly. K7 at 336 px, sp = 2 (Sq = 221 rows over
// Skv = 442 keys) moves about 95 MB a rank (28 us); at 768 px (B=12,
// Sq = 1153, L = 2305) its products, 131 GFLOP, bound it at 132 us, as
// they bound K9 at S = 2305 (261 GFLOP, 264 us), with the exponentials
// close behind (122 and 244 us at D = 64).
//
// Design: flash_kernel.cuh (wgmma and TMA, warp-specialised), whose
// kernel K4 also runs.

#include "flash_kernel.cuh"

using pnp::flash::launch_flat;
using pnp::flash::View;

// K2. q/k/v/o point at head 0 of their flat [B, S, H*D] views; *_bs / *_rs
// are batch and row strides in elements. Needs 16-byte aligned rows
// (strides and pointers), as TMA does.
extern "C" int flash_mha_flat_bf16(const void* q, const void* k,
                                   const void* v, void* o, long long q_bs,
                                   long long q_rs, long long k_bs,
                                   long long k_rs, long long v_bs,
                                   long long v_rs, long long o_bs,
                                   long long o_rs, int B, int S, int L, int H,
                                   int D, float scale, void* stream) {
  return launch_flat(q, k, v, o, View{q_bs, D, q_rs}, View{k_bs, D, k_rs},
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
  return launch_flat(q, k, v, o, View{q_bs, D, q_rs}, View{k_bs, D, k_rs},
                     View{v_bs, D, v_rs}, View{o_bs, D, o_rs}, B, Sq, L, H,
                     D, scale, stream);
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
  return launch_flat(q, k, v, o, View{q_bs, q_hs, q_rs},
                     View{k_bs, k_hs, k_rs}, View{v_bs, v_hs, v_rs},
                     View{o_bs, o_hs, o_rs}, B, S, S, H, D, scale, stream);
}

// A launch whose one ring stage never fills: it traps (hopper.cuh's
// stall_kernel, through the wait the flash kernel's ring uses).
extern "C" int flash_mha_stall(void* stream) {
  pnp::hopper::stall_kernel<0><<<1, 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
