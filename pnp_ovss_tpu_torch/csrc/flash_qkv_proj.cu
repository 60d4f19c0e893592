// K4: attention + output projection + residual in one kernel,
// y = x + (bf16(attention(qkv) @ Wp^T) + bp).
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
// Design: a block owns one (image, 64-query tile). G groups of 4 warps
// (G = 4 at head dim 64, 16 warps; else 2) take G heads at a time, each
// warp 16 query rows, with K2's per-warp online softmax over 64-key tiles
// (flash_tile.cuh, the one definition of the per-row arithmetic, so each
// head output equals K2's and K7's row bit for bit; each group has its
// own row-major K / V tiles in shared memory, filled by cp.async and read
// through ldmatrix). Each head's bf16 output goes into a [64, H*D] slab in
// shared memory (132 KB at H*D = 1024), so the attention output never
// reaches device memory. The proj then runs from the slab over 128-column
// chunks of Wp, streamed in 64-deep k tiles through a 3-stage cp.async ring
// (which reuses the K / V tiles' shared memory), the full H*D contraction
// in f32 registers, and the epilogue adds bp and x in bf16 steps. One
// block fills an SM (206 KB of shared memory at D = 64), 444 blocks at
// 768 px. Rows >= S are never read or written. Wp is re-read from L2 once
// per block. Each group synchronises on its own named barrier, so the
// groups' key loops drift apart and one group's K / V loads overlap
// another's products, as K2's independent blocks do.

#include "flash_tile.cuh"
#include "gemm_tile.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kStages = 3;  // proj: cp.async ring of Wp tiles
using pnp::flash::kBK;

// Shared memory of one group's K and V tiles.
template <int D>
__host__ __device__ constexpr size_t group_bytes() {
  return 2 * kBK * pnp::flash::tile_ld<D>() * sizeof(__nv_bfloat16);
}
constexpr size_t kProjBytes =
    kStages * pnp::kWTileN * pnp::kWTileLd * sizeof(__nv_bfloat16);

// Barrier of one group's 4 warps (named barrier grp + 1; 0 is
// __syncthreads'), so that the groups' key loops run independently and one
// group's loads overlap another's products.
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(grp + 1) : "memory");
}

template <int D, int G>  // head dim, groups of 4 warps (heads at a time)
__global__ void __launch_bounds__(128 * G, 1) qkv_proj_kernel(
    const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ wp, const __nv_bfloat16* __restrict__ bp,
    __nv_bfloat16* __restrict__ out, int S, int L, int H, int Dm,
    float scale) {
  constexpr int kThreads = 128 * G;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = H * D, lds = hd + 8;
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][lds]
  unsigned char* work = smem + sizeof(__nv_bfloat16) * kBQ * lds;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int grp = warp / 4, wq = warp % 4;
  const long long b = blockIdx.y;
  const int qt0 = blockIdx.x * kBQ;
  const long long rs = 3LL * hd;  // qkv row stride
  const __nv_bfloat16* base = qkv + b * S * rs;

  // This group's K and V tiles.
  __nv_bfloat16* ks =
      reinterpret_cast<__nv_bfloat16*>(work + grp * group_bytes<D>());
  __nv_bfloat16* vs = ks + kBK * pnp::flash::tile_ld<D>();

  for (int h0 = 0; h0 < H; h0 += G) {
    const int h = h0 + grp;
    uint32_t qa[1][D / 16][4];
    pnp::flash::load_q<D>(qa[0], base + h * D, rs, qt0 + wq * 16, S, scale,
                          g, t);
    pnp::flash::Softmax<D> sm;
    sm.init();
    for (int k0 = 0; k0 < L; k0 += kBK) {
      group_sync(grp);  // the group's previous tile is fully consumed
      pnp::flash::load_kv<D>(ks, vs, base + hd + h * D, rs,
                             base + 2 * hd + h * D, rs, k0, L, tid % 128,
                             128);
      pnp::cp_async_commit();
      pnp::cp_async_wait<0>();
      group_sync(grp);
      sm.tile(qa, ks, vs, k0, L, lane);
    }
    sm.finish();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __nv_bfloat16* srow = slab + (wq * 16 + g + r * 8) * lds + h * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(srow + n * 8 + t * 2) =
            pnp::pack_bf16x2(sm.o[0][n][2 * r] / sm.l[0][r],
                             sm.o[0][n][2 * r + 1] / sm.l[0][r]);
    }
  }
  __syncthreads();  // the slab is complete; the K / V tiles are free

  // proj: warps form 4 (16-row frags) x G (column slices of 128 / G) of
  // each 128-column chunk.
  constexpr int kNF = 16 / G;  // n8 fragments a warp
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(work);
  constexpr int kWs = pnp::kWTileN * pnp::kWTileLd;
  const int wm = warp % 4, wn = warp / 4;
  const int ktiles = hd / pnp::kWTileK;
  const int total = (Dm / pnp::kWTileN) * ktiles;
  float acc[kNF][4];
#pragma unroll
  for (int n = 0; n < kNF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  auto prefetch = [&](int it) {  // Wp tile `it` into its ring stage
    if (it < total)
      pnp::load_w_tile(ws + (it % kStages) * kWs, wp, hd,
                       (it / ktiles) * pnp::kWTileN,
                       (it % ktiles) * pnp::kWTileK, tid, kThreads);
    pnp::cp_async_commit();
  };
  for (int it = 0; it < kStages - 1; ++it) prefetch(it);
  for (int it = 0; it < total; ++it) {
    pnp::cp_async_wait<kStages - 2>();  // tile `it` has landed
    __syncthreads();  // ... for every thread; tile it-1 is consumed
    prefetch(it + kStages - 1);
    const __nv_bfloat16* wt = ws + (it % kStages) * kWs;
    const int k0 = (it % ktiles) * pnp::kWTileK;
#pragma unroll
    for (int kk = 0; kk < pnp::kWTileK; kk += 16) {
      uint32_t a[4];
      pnp::ldm_a(a, slab + wm * 16 * lds + k0 + kk, lds, lane);
#pragma unroll
      for (int p = 0; p < kNF / 2; ++p) {
        uint32_t bf[4];
        pnp::ldm_b2(bf,
                    wt + (wn * kNF * 8 + p * 16) * pnp::kWTileLd + kk,
                    pnp::kWTileLd, lane);
        pnp::mma_bf16_16816(acc[2 * p], a, bf[0], bf[1]);
        pnp::mma_bf16_16816(acc[2 * p + 1], a, bf[2], bf[3]);
      }
    }

    if (it % ktiles == ktiles - 1) {
      const int n0 = (it / ktiles) * pnp::kWTileN + wn * kNF * 8;
#pragma unroll
      for (int n = 0; n < kNF; ++n) {
        const int col = n0 + n * 8 + t * 2;
        const float c0 = __bfloat162float(bp[col]);
        const float c1 = __bfloat162float(bp[col + 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = qt0 + wm * 16 + g + r * 8;
          if (row < S) {
            const long long off = (b * S + row) * Dm + col;
            const float2 xv = pnp::unpack_bf16x2(
                *reinterpret_cast<const uint32_t*>(x + off));
            const float y0 = pnp::round_bf16(
                pnp::round_bf16(acc[n][2 * r]) + c0);
            const float y1 = pnp::round_bf16(
                pnp::round_bf16(acc[n][2 * r + 1]) + c1);
            *reinterpret_cast<uint32_t*>(out + off) =
                pnp::pack_bf16x2(xv.x + y0, xv.y + y1);
          }
          acc[n][2 * r] = 0.f;
          acc[n][2 * r + 1] = 0.f;
        }
      }
    }
  }
}

template <int D, int G>
int launch(const void* qkv, const void* x, const void* wp, const void* bp,
           void* out, int B, int S, int L, int H, int Dm, float scale,
           cudaStream_t st) {
  const size_t attn = G * group_bytes<D>();
  const size_t smem =
      sizeof(__nv_bfloat16) * static_cast<size_t>(kBQ) * (H * D + 8) +
      (attn > kProjBytes ? attn : kProjBytes);
  cudaError_t err = cudaFuncSetAttribute(
      qkv_proj_kernel<D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B);
  qkv_proj_kernel<D, G><<<grid, 128 * G, smem, st>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp),
      static_cast<const __nv_bfloat16*>(bp), static_cast<__nv_bfloat16*>(out),
      S, L, H, Dm, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [B, S, 3*H*D], x / out [B, S, Dm], wp [Dm, H*D], bp [Dm], all
// contiguous. D in {64, 128}, H even, H*D <= 1024, Dm % 128 == 0,
// 0 < L <= S.
extern "C" int flash_mha_qkv_proj_bf16(const void* qkv, const void* x,
                                       const void* wp, const void* bp,
                                       void* out, int B, int S, int L, int H,
                                       int D, int Dm, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || L <= 0 || L > S || H % 2 != 0 || H * D > 1024 ||
      Dm % pnp::kWTileN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64 && H % 4 == 0)
    return launch<64, 4>(qkv, x, wp, bp, out, B, S, L, H, Dm, scale, st);
  if (D == 64)
    return launch<64, 2>(qkv, x, wp, bp, out, B, S, L, H, Dm, scale, st);
  if (D == 128)
    return launch<128, 2>(qkv, x, wp, bp, out, B, S, L, H, Dm, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
