// Online-softmax attention of one warp's 16 query rows over tiles of 64
// keys, shared by K2 (flash_attention.cu) and K4 (flash_qkv_proj.cu).
//
// A warp holds its q rows as mma fragments (scaled in f32, rounded to bf16
// once). Key tiles sit in shared memory, v transposed so that its
// fragments are 32-bit loads. Scores and P.V run on mma.sync m16n8k16
// (bf16 operands, f32 accumulation); the running max and sums are f32.
// Keys at index >= L are masked in every tile; rows >= S are zero q rows.
#pragma once

#include "common.cuh"

namespace pnp {
namespace flash {

constexpr int kBK = 64;
constexpr float kNeg = -1e30f;

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

// Threads i = 0..n-1 of a group copy keys k0..k0+63 of k and v (row
// strides k_rs, v_rs) into ks and vt (v transposed); keys >= L are zero.
template <int D>
__device__ __forceinline__ void load_kv(__nv_bfloat16 (*ks)[D + 8],
                                        __nv_bfloat16 (*vt)[kBK + 8],
                                        const __nv_bfloat16* kb,
                                        long long k_rs,
                                        const __nv_bfloat16* vb,
                                        long long v_rs, int k0, int L, int i,
                                        int n) {
  for (int c = i; c < kBK * D / 8; c += n) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const int key = k0 + r;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (key < L) {
      kv = *reinterpret_cast<const uint4*>(kb + key * k_rs + col);
      vv = *reinterpret_cast<const uint4*>(vb + key * v_rs + col);
    }
    *reinterpret_cast<uint4*>(&ks[r][col]) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt[col + e][r] = ve[e];
  }
}

// Running state of one warp's 16 rows: o[n][e] holds rows g (e < 2) and
// g + 8 (e >= 2), columns 8n + 2t + (e & 1), unnormalised.
template <int D>
struct Softmax {
  float o[D / 8][4];
  float m[2];  // running max of rows g and g + 8
  float l[2];  // this thread's share of the running sums

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = kNeg;
    l[0] = l[1] = 0.f;
  }

  // Fold the key tile k0..k0+63 (in ks / vt) into the state.
  __device__ __forceinline__ void tile(const uint32_t (&qa)[D / 16][4],
                                       const __nv_bfloat16 (*ks)[D + 8],
                                       const __nv_bfloat16 (*vt)[kBK + 8],
                                       int k0, int L, int g, int t) {
    float sacc[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&ks[j * 8 + g][s * 16 + t * 2]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            &ks[j * 8 + g][s * 16 + t * 2 + 8]);
        mma_bf16_16816(sacc[j], qa[s], b0, b1);
      }
    }

    // Mask keys >= L, then the online-softmax update in f32.
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + j * 8 + t * 2 + (e & 1) >= L) sacc[j][e] = kNeg;
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sacc[j][e] - m[e >> 1]);
        sacc[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // P (bf16, straight from the score registers) times V.
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(sacc[2 * s][0], sacc[2 * s][1]);
      pa[1] = pack_bf16x2(sacc[2 * s][2], sacc[2 * s][3]);
      pa[2] = pack_bf16x2(sacc[2 * s + 1][0], sacc[2 * s + 1][1]);
      pa[3] = pack_bf16x2(sacc[2 * s + 1][2], sacc[2 * s + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&vt[n * 8 + g][s * 16 + t * 2]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            &vt[n * 8 + g][s * 16 + t * 2 + 8]);
        mma_bf16_16816(o[n], pa, b0, b1);
      }
    }
  }

  // After the last tile: the full row sums (across the quad), so that the
  // output of row g + 8r, column 8n + 2t + c is o[n][2r + c] / l[r].
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
};

}  // namespace flash
}  // namespace pnp
