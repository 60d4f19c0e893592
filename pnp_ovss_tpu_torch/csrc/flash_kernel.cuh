// The flash attention kernel on strided q/k/v views, shared by K2, K7
// and K9 (flash_attention.cu) and by K4's attention (flash_qkv_proj.cu),
// so that every entry's rows come from one code path, bit for bit.
//
// Computes softmax(q k^T / sqrt(D)) v, non-causal, per head. Every tensor
// is read through its own batch, head and row strides (View). Keys at
// index >= L are masked out; query rows >= S are neither read nor
// written.
//
// Design: one block of kWarps warps per (query tile of 16 * kRB * kWarps
// rows, head, batch element); each warp owns kRB blocks of 16 query rows,
// so that each K / V fragment it loads feeds kRB products (the per-warp
// online softmax and its arithmetic are in flash_tile.cuh). q is scaled
// in f32 and rounded to bf16 once, then held in registers as mma
// fragments. Tiles of 64 keys stream through a ring of kStages K/V tile
// pairs in dynamic shared memory, filled by cp.async (zero-fill past L):
// while the warps run one tile's two products, the next kStages - 1 tiles
// are in flight, and one __syncthreads per tile frees the slot the next
// copy reuses. K and V stay row-major; their fragments come from ldmatrix
// (V through ldmatrix.trans), so the tile needs no transpose and its
// fragment loads no bank conflicts (rows padded by 16 bytes). The warp
// count, the row blocks a warp, the ring depth and the blocks an SM holds
// (the register cap) per head dim were chosen by measurement
// (scripts/kernel_ablation.py, PERF.md).
//
// A query row's result depends only on that row and the keys, which every
// block visits in the same order of 64-key tiles from 0 to L, whatever the
// query tile: so a row of K7's local chunk is bit-equal to the same row of
// K2 over the whole sequence, and to K4's head output.
#pragma once

#include "flash_tile.cuh"

namespace pnp {
namespace flash {

// Per head dim: warps of a block, blocks of 16 query rows a warp owns, K/V
// ring stages, and the blocks an SM should hold (which caps registers).
constexpr int kWarpsD64 = 4, kRowBlocksD64 = 1, kStagesD64 = 2;
constexpr int kMinBlocksD64 = 4;
constexpr int kWarpsD128 = 4, kRowBlocksD128 = 1, kStagesD128 = 2;
constexpr int kMinBlocksD128 = 2;

// Strides of one tensor, in elements: batch, head and row.
struct View {
  long long bs, hs, rs;
};

template <int D, int kStages>
constexpr size_t smem_bytes() {
  return size_t(kStages) * 2 * kBK * tile_ld<D>() * sizeof(__nv_bfloat16);
}

template <int D, int kWarps, int kRB, int kStages, int kMinBlocks>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks) flash_flat_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    View qv, View kv, View vv, View ov, int S, int L, float scale) {
  static_assert(kStages >= 2, "the ring needs two stages");
  constexpr int kThreads = kWarps * 32;
  constexpr int kTile = kBK * tile_ld<D>();  // one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long b = blockIdx.z;
  const long long h = blockIdx.y;
  const int q0 = (blockIdx.x * kWarps + warp) * (16 * kRB);

  const __nv_bfloat16* kb = k + b * kv.bs + h * kv.hs;
  const __nv_bfloat16* vb = v + b * vv.bs + h * vv.hs;
  const int ntiles = (L + kBK - 1) / kBK;

  // Key tile `it` into ring slot it % kStages (K, then V); one commit
  // group per call, empty past the last tile, so that the wait below
  // counts tiles.
  auto fetch = [&](int it) {
    if (it < ntiles) {
      __nv_bfloat16* ks = ring + 2 * (it % kStages) * kTile;
      load_kv<D>(ks, ks + kTile, kb, kv.rs, vb, vv.rs, it * kBK, L, tid,
                 kThreads);
    }
    pnp::cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) fetch(it);

  uint32_t qa[kRB][D / 16][4];
#pragma unroll
  for (int rb = 0; rb < kRB; ++rb)
    load_q<D>(qa[rb], q + b * qv.bs + h * qv.hs, qv.rs, q0 + 16 * rb, S,
              scale, g, t);
  Softmax<D, kRB> sm;
  sm.init();
  for (int it = 0; it < ntiles; ++it) {
    pnp::cp_async_wait<kStages - 2>();  // this thread's copies of tile it
    __syncthreads();  // everyone's; and slot (it - 1) % kStages is consumed
    fetch(it + kStages - 1);
    const __nv_bfloat16* ks = ring + 2 * (it % kStages) * kTile;
    sm.tile(qa, ks, ks + kTile, it * kBK, L, lane);
  }
  sm.finish();

  __nv_bfloat16* ob = o + b * ov.bs + h * ov.hs;
#pragma unroll
  for (int rb = 0; rb < kRB; ++rb)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * rb + g + r * 8;
      if (row >= S) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(ob + row * ov.rs + n * 8 + t * 2) =
            pnp::pack_bf16x2(sm.o[rb][n][2 * r] / sm.l[rb][r],
                             sm.o[rb][n][2 * r + 1] / sm.l[rb][r]);
      }
    }
}

template <int D, int kWarps, int kRB, int kStages, int kMinBlocks>
int launch_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
             const __nv_bfloat16* v, __nv_bfloat16* o, View qv, View kv,
             View vv, View ov, int B, int S, int L, int H, float scale,
             cudaStream_t st) {
  auto* kern = flash_flat_kernel<D, kWarps, kRB, kStages, kMinBlocks>;
  constexpr size_t smem = smem_bytes<D, kStages>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBQ = kWarps * kRB * 16;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kWarps * 32, smem, st>>>(q, k, v, o, qv, kv, vv, ov, S, L,
                                        scale);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_flat(const void* q, const void* k, const void* v, void* o,
                       View qv, View kv, View vv, View ov, int B, int S,
                       int L, int H, int D, float scale, void* stream) {
  if (B < 1 || S < 1 || L < 1 || H < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (D == 64)
    return launch_d<64, kWarpsD64, kRowBlocksD64, kStagesD64, kMinBlocksD64>(
        qp, kp, vp, op, qv, kv, vv, ov, B, S, L, H, scale, st);
  if (D == 128)
    return launch_d<128, kWarpsD128, kRowBlocksD128, kStagesD128,
                    kMinBlocksD128>(qp, kp, vp, op, qv, kv, vv, ov, B, S, L,
                                    H, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
}  // namespace pnp
