// Online-softmax attention of one warp's query rows (blocks of 16) over
// tiles of 64 keys, the arithmetic of the flash kernel (flash_kernel.cuh)
// that K2/K7/K9 (flash_attention.cu) and K4 (flash_qkv_proj.cu) run.
//
// This file is the one definition of the per-row arithmetic, so that every
// entry computes a query row bit for bit alike:
// - q is scaled in f32 and rounded to bf16 once, then held in registers as
//   mma fragments;
// - keys are visited in tiles of kBK = 64, from 0 to L, in that order;
// - scores and P.V run on mma.sync m16n8k16 (bf16 operands, f32 sums);
// - the running max and sums are f32, and each exponent is expf of a
//   difference of raw scores (an ex2 of log2(e)-scaled scores was faster
//   but moved chip_smoke.py's narrow card-vs-CPU pipelines past their
//   bars; PERF.md);
// - P is rounded to bf16 straight from the score registers for P.V.
// Keys at index >= L are masked (only the last tile holds any); rows >= S
// are zero q rows.
//
// Key tiles sit in shared memory row-major, K and V alike, each row padded
// by 8 elements (16 bytes) so that the eight rows an ldmatrix reads fall
// on distinct banks. K fragments come from ldmatrix.x4, V fragments from
// ldmatrix.x4.trans, so V is never transposed in memory.
#pragma once

#include "gemm_tile.cuh"

namespace pnp {
namespace flash {

constexpr int kBK = 64;
constexpr float kNeg = -1e30f;

// Row stride of a key tile in shared memory, in elements.
template <int D>
__host__ __device__ constexpr int tile_ld() {
  return D + 8;
}

// q fragments of rows q0..q0+15 of the view at qb (row stride q_rs):
// fragment i covers row g + 8*(i&1), columns 2t + 8*(i>>1) of each
// 16-wide k-step.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4],
                                       const __nv_bfloat16* qb,
                                       long long q_rs, int q0, int S,
                                       float scale, int g, int t) {
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g + (i & 1) * 8;
      const int col = s * 16 + t * 2 + (i >> 1) * 8;
      uint32_t r = 0;
      if (row < S) {
        const float2 f = unpack_bf16x2(
            *reinterpret_cast<const uint32_t*>(qb + row * q_rs + col));
        r = pack_bf16x2(f.x * scale, f.y * scale);
      }
      qa[s][i] = r;
    }
  }
}

// 16-byte global -> shared copy that writes zeros when `valid` is false
// (src must still be a mapped address; it is not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Threads i = 0..n-1 of a group start the cp.async copies of keys
// k0..k0+63 of k and v (row strides k_rs, v_rs) into the row-major tiles
// ks and vs (row stride tile_ld<D>()); keys >= L are zero-filled and never
// read. The caller commits the group.
template <int D>
__device__ __forceinline__ void load_kv(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                        const __nv_bfloat16* kb,
                                        long long k_rs,
                                        const __nv_bfloat16* vb,
                                        long long v_rs, int k0, int L, int i,
                                        int n) {
  constexpr int ld = tile_ld<D>();
  for (int c = i; c < kBK * D / 8; c += n) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const int key = k0 + r;
    const bool ok = key < L;
    const long long src = ok ? key : 0;
    cp_async16_zfill(ks + r * ld + col, kb + src * k_rs + col, ok);
    cp_async16_zfill(vs + r * ld + col, vb + src * v_rs + col, ok);
  }
}

// B fragments of two n8 blocks of P.V from a row-major [key][d] tile at
// `p` = (k0, n0), transposed by ldmatrix: b[0], b[1] for columns n0..n0+7
// and b[2], b[3] for n0+8..n0+15, each over keys k0..k0+15.
__device__ __forceinline__ void ldm_b2_trans(uint32_t (&b)[4],
                                             const __nv_bfloat16* p, int ld,
                                             int lane) {
  const __nv_bfloat16* q = p + (lane % 16) * ld + (lane / 16) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(q)));
}

// Running state of one warp's RB blocks of 16 rows: o[rb][n][e] holds rows
// 16 rb + g (e < 2) and 16 rb + g + 8 (e >= 2), columns 8n + 2t + (e & 1),
// unnormalised. Every row's arithmetic is the same whatever RB is.
template <int D, int RB = 1>
struct Softmax {
  float o[RB][D / 8][4];
  float m[RB][2];  // running max of rows g and g + 8 (raw scores)
  float l[RB][2];  // this thread's share of the running sums

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[rb][n][e] = 0.f;
      m[rb][0] = m[rb][1] = kNeg;
      l[rb][0] = l[rb][1] = 0.f;
    }
  }

  // Fold the key tile k0..k0+63 (row-major ks / vs, row stride
  // tile_ld<D>()) into the state.
  __device__ __forceinline__ void tile(const uint32_t (&qa)[RB][D / 16][4],
                                       const __nv_bfloat16* ks,
                                       const __nv_bfloat16* vs, int k0,
                                       int L, int lane) {
    constexpr int ld = tile_ld<D>();
    const int t = lane % 4;
    float sacc[RB][kBK / 8][4];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[rb][j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
#pragma unroll
      for (int jp = 0; jp < kBK / 16; ++jp) {
        uint32_t b[4];
        ldm_b2(b, ks + jp * 16 * ld + s * 16, ld, lane);
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          mma_bf16_16816(sacc[rb][2 * jp], qa[rb][s], b[0], b[1]);
          mma_bf16_16816(sacc[rb][2 * jp + 1], qa[rb][s], b[2], b[3]);
        }
      }
    }

    // Mask keys >= L (only the last tile has any), then the online-softmax
    // update in f32.
    if (k0 + kBK > L) {
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + j * 8 + t * 2 + (e & 1) >= L) sacc[rb][j][e] = kNeg;
    }
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], sacc[rb][j][e]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[rb][r], mx[r]);
        alpha[r] = expf(m[rb][r] - m_new);
        m[rb][r] = m_new;
        l[rb][r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sacc[rb][j][e] - m[rb][e >> 1]);
          sacc[rb][j][e] = p;
          l[rb][e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[rb][n][e] *= alpha[e >> 1];
    }

    // P (bf16, straight from the score registers) times V.
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      uint32_t pa[RB][4];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        pa[rb][0] = pack_bf16x2(sacc[rb][2 * s][0], sacc[rb][2 * s][1]);
        pa[rb][1] = pack_bf16x2(sacc[rb][2 * s][2], sacc[rb][2 * s][3]);
        pa[rb][2] = pack_bf16x2(sacc[rb][2 * s + 1][0],
                                sacc[rb][2 * s + 1][1]);
        pa[rb][3] = pack_bf16x2(sacc[rb][2 * s + 1][2],
                                sacc[rb][2 * s + 1][3]);
      }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldm_b2_trans(b, vs + s * 16 * ld + np * 16, ld, lane);
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          mma_bf16_16816(o[rb][2 * np], pa[rb], b[0], b[1]);
          mma_bf16_16816(o[rb][2 * np + 1], pa[rb], b[2], b[3]);
        }
      }
    }
  }

  // After the last tile: the full row sums (across the quad), so that the
  // output of row 16 rb + g + 8r, column 8n + 2t + c is
  // o[rb][n][2r + c] / l[rb][r].
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[rb][r] += __shfl_xor_sync(0xffffffffu, l[rb][r], 1);
        l[rb][r] += __shfl_xor_sync(0xffffffffu, l[rb][r], 2);
      }
  }
};

}  // namespace flash
}  // namespace pnp
