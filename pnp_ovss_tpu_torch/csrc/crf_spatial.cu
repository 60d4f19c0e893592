// crf_spatial_operands: K6's two per-iteration operands from the state of
// the strided, materialised CRF's fused loop.
//
// Replaces no Pallas kernel: the JAX package leaves this work to XLA
// (pnp_ovss_tpu/ops/crf.py:476-544, the separable spatial product with
// the normaliser folded into the band matrices, and the strided take of
// the state). It was added to cut the loop's launches: the port ran each
// iteration's operands as ~8 PyTorch launches (a cast, two f32 GEMMs, a
// scale, a strided copy, a pad, a scale, two casts) before one K6; now
// one launch makes both.
//
// For each state row r < rows, an [h, w] image Q_r of the bf16 state q:
//   msp[r]  = pos_w * (khp @ Q_r @ kwp^T)                        [h * w]
//   khp     = n_h kh n_h, kh[y, i] = exp(-((y - i) / sigma_y)^2 / 2),
//   n_h     = rsqrt(max(kh 1, 1e-20)); kwp the same along w (sigma_x)
//   qsub[r, m] = bf16(q[r, p(m)] * norm_bi[p(m)]) at the strided anchors
//                p(m) = (m / ws) s w + (m % ws) s for m < M = hs ws, and
//                0 for M <= m < M_pad
// Rows r >= rows of both outputs are written 0 without reading q (the
// fused loop's pad rows, which K6 keeps 0). The band entries and their
// normalisers come from sigma ([2] f32 on the card: sigma_y, sigma_x) in
// every block, so no launch builds them. All products and sums are f32;
// msp is rounded to bf16 once (or kept f32 for the tests); qsub is the
// one f32 product rounded to bf16, bit-equal to PyTorch's.
//
// Bound on the H100 SXM at the main-path shape (R = 64 rows of which 58
// live, h = w = 192, s = 4, M_pad = 2304; VOC's sigma_y = 1.536, sigma_x
// = 1.152): 4.7 MB of q in, 4.7 MB of msp and 0.3 MB of qsub out, 9.9 MB,
// 3.0 us at 3.35 TB/s. The f32 work the band needs (entries whose f32
// exp is not 0: 45 taps down h, 33 along w) is 2 * 58 * 36864 * 78 =
// 0.33 GFLOP, 5.0 us at 67 TFLOP/s; the dense product would be 1.8 GFLOP.
// Operations bound it.
//
// Design:
// - exp(-d^2 / 2 sigma^2) is exactly 0 in f32 from |d| ~ 14.4 sigma on
//   (the cut), so each output needs only the 2 cut - 1 taps around it;
//   skipping the others drops only exact zeros. The normaliser of index i
//   is a sum over at most 2 cut - 1 entries, read off a prefix sum of the
//   entries. One warp an axis finds the cut and the sums by ballots and
//   shuffles when the block starts.
// - A block owns kYT = 16 image rows and a group of state rows, which it
//   takes in turn, so the bands are built once for several rows; the grid
//   holds about kMinBlocks blocks an SM. Columns go in x-tiles of kXC =
//   192, each with a halo of cut - 1 where w is wider.
// - Down h, a thread sums one column: the column's band of rows is first
//   copied to shared memory as bf16 by cp.async, all rows in flight at
//   once, then read back one row at a time, each feeding 16 FMAs into 16
//   sums kept in registers. Along w, a thread sums 16 columns of one row
//   of that result from shared memory (an odd row stride, so the 16 rows
//   of a warp fall in distinct banks) and stores them to msp as two
//   16-byte stores.
// - For cut <= 32 (sigma up to ~2.2 px) both sums are unrolled at a
//   compile-time band of 16, 20, 24 or 32 taps a side, picked in the
//   block: the band's entries sit in registers; taps past the cut are 0,
//   so they add exact zeros. Wider bands take generic loops over the
//   entries (and exp past the table), correct at any sigma and slower;
//   their sums along w meet in shared memory when the band spans more
//   than one chunk of columns.
// - On the H100 it takes 25-30 us a launch at the main-path shape
//   (PERF.md section 6), the FMA pipes at about a fifth of their rate;
//   each block runs its phases (copy, sum down, sum along) in turn.

#include <atomic>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 192;  // one column of a slice a thread
constexpr int kYT = 16;        // image rows a block
constexpr int kXR = 16;        // columns a thread's run along w
constexpr int kXC = 192;       // output columns an x-tile
constexpr int kFastCut = 32;   // the widest band the unrolled paths take
// Columns of the product down h held at once: an x-tile with a halo of
// kFastCut - 1 on each side.
constexpr int kJCap = kXC + 2 * kFastCut;
// Rows of q staged at once: a block's rows with a halo of kFastCut - 1.
constexpr int kPRows = kYT + 2 * (kFastCut - 1);
constexpr int kLd = kJCap + 1;  // odd: a warp's 16 rows in distinct banks
constexpr int kLdO = kXC + 1;   // the same for the sums along w
constexpr int kTab = 256;       // band entries and prefix sums kept an axis
constexpr int kMinBlocks = 3;  // blocks an SM (registers capped to fit)
// Dynamic shared memory: the staged rows [kPRows][kThreads] bf16, then
// the product down h [kYT][kLd] and the sums along w [kYT][kLdO], f32.
constexpr int kStageBytes = kPRows * kThreads * 2;
constexpr int kSmemBytes = kStageBytes + (kYT * kLd + kYT * kLdO) * 4;
static_assert(kStageBytes % 16 == 0, "f32 arrays after the staged rows");
static_assert(kXC / kXR * kYT <= kThreads, "one run along w a thread");

struct Params {
  const __nv_bfloat16* q;  // [R, h * w]
  const float* norm_bi;    // [h * w]
  const float* sigma;      // [2]: sigma_y, sigma_x
  void* msp;               // [R, h * w] bf16 or f32
  __nv_bfloat16* qsub;     // [R, m_pad]
  int R, rows, h, w, s, hs, ws, m_pad;
  float pos_w;
};

// One entry of the Gaussian band, as PyTorch computes
// exp(-0.5 * ((i - j) / sigma) ** 2).
__device__ __forceinline__ float band(int d, float sigma) {
  const float t = static_cast<float>(d) / sigma;
  return expf(-0.5f * (t * t));
}

// One warp: an axis's entries and prefix sums for d < kTab (entries from
// the cut on 0) and its cut, the least d >= 1 with band(d) == 0 (the band
// falls with d), at most dim (no pair of indices is further apart).
__device__ void build_axis(float sigma, int dim, float* tab, float* pre,
                           int* cut_out) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  float run = 0.f;
  int cut = dim;
  for (int base = 0; base < dim; base += 32) {
    const int d = base + lane;
    const float v = d < dim ? band(d, sigma) : 0.f;
    const unsigned zero =
        __ballot_sync(kAll, d > 0 && (v == 0.f || d >= dim));
    const int first = zero ? base + __ffs(zero) - 1 : dim;
    const float u = d < first ? v : 0.f;
    float sum = u;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float t = __shfl_up_sync(kAll, sum, off);
      if (lane >= off) sum += t;
    }
    if (d < kTab) {
      tab[d] = u;
      pre[d] = run + sum;
    }
    run += __shfl_sync(kAll, sum, 31);
    if (zero) {
      cut = first;
      break;
    }
  }
  for (int d = cut + lane; d < kTab; d += 32) tab[d] = 0.f;
  if (lane == 0) *cut_out = max(cut, 1);
}

// An axis's band: its sigma, cut, entries and their prefix sums for
// d < kTab (the rest computed where needed).
struct Axis {
  float sigma;
  int cut, dim;
  const float* tab;
  const float* pre;

  __device__ __forceinline__ float g(int d) const {
    return d < kTab ? tab[d] : band(d, sigma);
  }
  // sum of band(e) for e = 0..k, k < cut.
  __device__ float prefix(int k) const {
    if (k < kTab) return pre[k];
    float acc = pre[kTab - 1];
    for (int e = kTab; e <= k; ++e) acc += band(e, sigma);
    return acc;
  }
  // rsqrt(max(sum_j band(|i - j|), 1e-20)) over j in [0, dim).
  __device__ float norm(int i) const {
    const float sum = prefix(min(i, cut - 1)) +
                      prefix(min(dim - 1 - i, cut - 1)) - tab[0];
    return rsqrtf(fmaxf(sum, 1e-20f));
  }
};

// 16-byte global -> shared copy; zeros when !valid (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Sum down h of one column at rows y0..y0+kYT: acc[k] += sum_i
// band(|y0 + k - i|) nh(i) q[i] over the staged rows i in [lo, hi) (col
// points at the column's row lo, a row every kThreads; nh[i - lo] is
// nh(i)), at a compile-time band of C taps a side (the table is 0 from
// the cut on).
template <int C>
__device__ __forceinline__ void down_fast(const __nv_bfloat16* col,
                                          const float* nh, int y0, int lo,
                                          int hi, const float* tab,
                                          float (&acc)[kYT]) {
  float g[C];
#pragma unroll
  for (int d = 0; d < C; ++d) g[d] = tab[d];
#pragma unroll
  for (int o = 0; o < kYT + 2 * C - 2; ++o) {
    const int i = y0 - C + 1 + o;  // the same for the whole block
    if (i < lo || i >= hi) continue;
    const float v = nh[i - lo] * __bfloat162float(col[(i - lo) * kThreads]);
#pragma unroll
    for (int k = 0; k < kYT; ++k) {
      const int d = k + C - 1 > o ? k + C - 1 - o : o - k - C + 1;
      if (d < C) acc[k] = fmaf(g[d], v, acc[k]);
    }
  }
}

__device__ void down_any(const __nv_bfloat16* col, int y0, int lo, int hi,
                         const Axis& ay, float (&acc)[kYT]) {
  for (int i = lo; i < hi; ++i) {
    const float v =
        ay.norm(i) * __bfloat162float(col[(i - lo) * kThreads]);
#pragma unroll
    for (int k = 0; k < kYT; ++k) {
      const int d = abs(y0 + k - i);
      if (d < ay.cut) acc[k] = fmaf(ay.g(d), v, acc[k]);
    }
  }
}

// Sum along w of row y at columns xs..xs+kXR over the product down h,
// t[j - jc0] held for columns [jc0, jc1) (0 outside), at a compile-time
// band of C taps a side, into acc.
template <int C>
__device__ __forceinline__ void along_fast(const float* t, int jc0, int jc1,
                                           int xs, const float* tab,
                                           float (&acc)[kXR]) {
  float g[C];
#pragma unroll
  for (int d = 0; d < C; ++d) g[d] = tab[d];
#pragma unroll
  for (int k = 0; k < kXR; ++k) acc[k] = 0.f;
#pragma unroll
  for (int e = 0; e < kXR + 2 * C - 2; ++e) {
    const int j = xs - C + 1 + e;
    const float v = j >= jc0 && j < jc1 ? t[j - jc0] : 0.f;
#pragma unroll
    for (int k = 0; k < kXR; ++k) {
      const int d = k + C - 1 > e ? k + C - 1 - e : e - k - C + 1;
      if (d < C) acc[k] = fmaf(g[d], v, acc[k]);
    }
  }
}

// msp at n <= kXR columns from dst: pos_w * nw[k] * acc[k]; 16-byte
// stores where aligned.
__device__ __forceinline__ void store_run(__nv_bfloat16* dst,
                                          const float (&acc)[kXR],
                                          const float* nw, int n,
                                          float pos_w) {
  float v[kXR];
#pragma unroll
  for (int k = 0; k < kXR; ++k) v[k] = pos_w * (nw[k < n ? k : 0] * acc[k]);
  if (n == kXR && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
#pragma unroll
    for (int e = 0; e < kXR / 8; ++e)
      reinterpret_cast<uint4*>(dst)[e] = make_uint4(
          pnp::pack_bf16x2(v[8 * e], v[8 * e + 1]),
          pnp::pack_bf16x2(v[8 * e + 2], v[8 * e + 3]),
          pnp::pack_bf16x2(v[8 * e + 4], v[8 * e + 5]),
          pnp::pack_bf16x2(v[8 * e + 6], v[8 * e + 7]));
  } else {
#pragma unroll
    for (int k = 0; k < kXR; ++k)
      if (k < n) dst[k] = __float2bfloat16_rn(v[k]);
  }
}

__device__ __forceinline__ void store_run(float* dst,
                                          const float (&acc)[kXR],
                                          const float* nw, int n,
                                          float pos_w) {
#pragma unroll
  for (int k = 0; k < kXR; ++k)
    if (k < n) dst[k] = pos_w * (nw[k] * acc[k]);
}

__device__ void along_any(const float* t, int jc0, int jc1, int xs,
                          const Axis& ax, float* o, int n, bool add) {
  for (int k = 0; k < n; ++k) {
    const int x = xs + k;
    const int lo = max(jc0, x - ax.cut + 1), hi = min(jc1, x + ax.cut);
    float a = add ? o[k] : 0.f;
    for (int j = lo; j < hi; ++j) a = fmaf(ax.g(abs(x - j)), t[j - jc0], a);
    o[k] = a;
  }
}

// Rows [lo, hi) of q's columns [s0, s0 + kThreads) into the stage, a row
// every kThreads bf16 (zeros past w); 16-byte copies where rows allow.
__device__ void stage_rows(__nv_bfloat16* stage, const __nv_bfloat16* qr,
                           int w, int lo, int hi, int s0, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {  // w and s0 multiples of 8, q 16-byte aligned
    constexpr int kChunks = kThreads / 8;
    for (int e = tid; e < (hi - lo) * kChunks; e += kThreads) {
      const int o = e / kChunks, c = (e % kChunks) * 8;
      const bool in = s0 + c < w;
      cp_async16(stage + o * kThreads + c,
                 in ? qr + static_cast<size_t>(lo + o) * w + s0 + c : qr, in);
    }
    cp_async_wait_all();
  } else {
    const int x = s0 + tid;
    for (int o = 0; o < hi - lo; ++o)
      stage[o * kThreads + tid] =
          x < w ? qr[static_cast<size_t>(lo + o) * w + x]
                : __float2bfloat16_rn(0.f);
  }
}

// One row of msp: pos_w * nw[x] * o[x] for x < tw; bf16 pairs where
// aligned.
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float* o,
                                          const float* nw, int tw,
                                          float pos_w) {
  const int tid = threadIdx.x;
  if (reinterpret_cast<uintptr_t>(dst) % 4 == 0) {
    for (int x = 2 * tid; x + 1 < tw; x += 2 * kThreads)
      *reinterpret_cast<__nv_bfloat162*>(dst + x) = __floats2bfloat162_rn(
          pos_w * (nw[x] * o[x]), pos_w * (nw[x + 1] * o[x + 1]));
    if (tw % 2 && tid == 0)
      dst[tw - 1] = __float2bfloat16_rn(pos_w * (nw[tw - 1] * o[tw - 1]));
  } else {
    for (int x = tid; x < tw; x += kThreads)
      dst[x] = __float2bfloat16_rn(pos_w * (nw[x] * o[x]));
  }
}

__device__ __forceinline__ void store_row(float* dst, const float* o,
                                          const float* nw, int tw,
                                          float pos_w) {
  for (int x = threadIdx.x; x < tw; x += kThreads)
    dst[x] = pos_w * (nw[x] * o[x]);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    spatial_operands_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ts = reinterpret_cast<float*>(smem + kStageBytes);  // [kYT][kLd]
  float* os = ts + kYT * kLd;                                 // [kYT][kLdO]
  __shared__ float tab[2][kTab], pre[2][kTab];
  __shared__ float nhy[kYT], nhw[kPRows], nwj[kJCap], nwx[kXC];
  __shared__ int cuts[2];
  const int tid = threadIdx.x, warp = tid / 32;
  const int h = p.h, w = p.w, y0 = blockIdx.x * kYT;
  const int y1 = min(h, y0 + kYT);
  const size_t n = static_cast<size_t>(h) * w;

  if (warp < 2)
    build_axis(p.sigma[warp], warp ? w : h, tab[warp], pre[warp],
               &cuts[warp]);
  __syncthreads();
  const Axis ay{p.sigma[0], cuts[0], h, tab[0], pre[0]};
  const Axis ax{p.sigma[1], cuts[1], w, tab[1], pre[1]};
  // The rows of q that reach this block's rows, and their normalisers
  // (the first kPRows: all of them on the unrolled path).
  const int lo = max(0, y0 - ay.cut + 1), hi = min(h, y0 + kYT + ay.cut - 1);
  if (tid < kYT) nhy[tid] = y0 + tid < h ? ay.norm(y0 + tid) : 0.f;
  for (int k = tid; k < min(kPRows, hi - lo); k += kThreads)
    nhw[k] = ay.norm(lo + k);
  const bool vec = w % 8 == 0 && reinterpret_cast<uintptr_t>(p.q) % 16 == 0;
  // One x-tile in one chunk (w <= kXC): the column normalisers once.
  const bool one = w <= kXC;
  if (one)
    for (int k = tid; k < w; k += kThreads) nwx[k] = nwj[k] = ax.norm(k);

  for (int r = blockIdx.y; r < p.R; r += gridDim.y) {
    OutT* msp = static_cast<OutT*>(p.msp) + r * n;
    __nv_bfloat16* qsub = p.qsub + static_cast<size_t>(r) * p.m_pad;
    const __nv_bfloat16* qr = p.q + r * n;
    const bool live = r < p.rows;

    // qsub: the anchors on this block's image rows, then (block row 0)
    // the pad columns; one f32 product rounded once, as PyTorch's.
    const int a0 = (y0 + p.s - 1) / p.s, a1 = (y1 + p.s - 1) / p.s;
    for (int e = tid; e < (a1 - a0) * p.ws; e += kThreads) {
      const int ya = a0 + e / p.ws, xa = e % p.ws;
      const size_t src = static_cast<size_t>(ya) * p.s * w + xa * p.s;
      qsub[ya * p.ws + xa] = __float2bfloat16_rn(
          live ? __bfloat162float(qr[src]) * p.norm_bi[src] : 0.f);
    }
    if (blockIdx.x == 0)
      for (int m = p.hs * p.ws + tid; m < p.m_pad; m += kThreads)
        qsub[m] = __float2bfloat16_rn(0.f);
    if (!live) {
      OutT* o = msp + static_cast<size_t>(y0) * w;
      for (size_t e = tid; e < static_cast<size_t>(y1 - y0) * w;
           e += kThreads)
        o[e] = OutT(0.f);
      continue;
    }

    for (int xt0 = 0; xt0 < w; xt0 += kXC) {
      const int xt1 = min(w, xt0 + kXC), tw = xt1 - xt0;
      const int jlo = max(0, xt0 - ax.cut + 1);
      const int jhi = min(w, xt1 + ax.cut - 1);
      __syncthreads();  // the last tile's stores are done
      if (!one)
        for (int k = tid; k < tw; k += kThreads) nwx[k] = ax.norm(xt0 + k);
      for (int jc0 = jlo; jc0 < jhi; jc0 += kJCap) {
        const int jc1 = min(jhi, jc0 + kJCap);
        const bool add = jc0 > jlo;  // sums of an earlier chunk in os
        __syncthreads();  // the last chunk's readers of ts are done
        if (!one)
          for (int k = tid; k < jc1 - jc0; k += kThreads)
            nwj[k] = ax.norm(jc0 + k);
        // Down h, a slice of kThreads columns at a time, the rows [lo,
        // hi) staged kPRows at a time.
        for (int s0 = jc0; s0 < jc1; s0 += kThreads) {
          const int x = s0 + tid;
          float acc[kYT];
#pragma unroll
          for (int k = 0; k < kYT; ++k) acc[k] = 0.f;
          for (int b0 = lo; b0 < hi; b0 += kPRows) {
            const int b1 = min(hi, b0 + kPRows);
            __syncthreads();  // the stage's last readers are done
            stage_rows(stage, qr, w, b0, b1, s0, vec && s0 % 8 == 0);
            __syncthreads();
            const __nv_bfloat16* col = stage + tid;
            const bool whole = b0 == lo && b1 == hi;
            if (whole && ay.cut <= 16)
              down_fast<16>(col, nhw, y0, lo, hi, ay.tab, acc);
            else if (whole && ay.cut <= 20)
              down_fast<20>(col, nhw, y0, lo, hi, ay.tab, acc);
            else if (whole && ay.cut <= 24)
              down_fast<24>(col, nhw, y0, lo, hi, ay.tab, acc);
            else if (whole && ay.cut <= kFastCut)
              down_fast<kFastCut>(col, nhw, y0, lo, hi, ay.tab, acc);
            else
              down_any(col, y0, b0, b1, ay, acc);
          }
          if (x < jc1) {
            const float nw = nwj[x - jc0];
#pragma unroll
            for (int k = 0; k < kYT; ++k)
              ts[k * kLd + x - jc0] = nhy[k] * nw * acc[k];
          }
        }
        __syncthreads();
        // Along w: row y of the block, kXR columns from xs; a warp's
        // lanes take consecutive rows. On the unrolled path each run goes
        // to msp at once; else the sums of every chunk meet in os.
        const int runs = (tw + kXR - 1) / kXR;
        for (int it = tid; it < kYT * runs; it += kThreads) {
          const int y = it % kYT, xs = xt0 + it / kYT * kXR;
          const float* t = ts + y * kLd;
          const int cnt = min(kXR, xt1 - xs);
          if (ax.cut > kFastCut) {
            along_any(t, jc0, jc1, xs, ax, os + y * kLdO + (xs - xt0), cnt,
                      add);
            continue;
          }
          float acc[kXR];
          if (ax.cut <= 16)
            along_fast<16>(t, jc0, jc1, xs, ax.tab, acc);
          else if (ax.cut <= 20)
            along_fast<20>(t, jc0, jc1, xs, ax.tab, acc);
          else if (ax.cut <= 24)
            along_fast<24>(t, jc0, jc1, xs, ax.tab, acc);
          else
            along_fast<kFastCut>(t, jc0, jc1, xs, ax.tab, acc);
          if (y0 + y < h)
            store_run(msp + static_cast<size_t>(y0 + y) * w + xs, acc,
                      nwx + (xs - xt0), cnt, p.pos_w);
        }
      }
      if (ax.cut <= kFastCut) continue;  // one chunk, stored
      __syncthreads();
      // msp, neighbouring threads on neighbouring columns.
      for (int y = 0; y < y1 - y0; ++y)
        store_row(msp + static_cast<size_t>(y0 + y) * w + xt0,
                  os + y * kLdO, nwx, tw, p.pos_w);
    }
  }
}

// The kernels' shared-memory limit raised once per library and device;
// the device's SM count.
int prepare(int* sms) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && (*sms = cached[dev].load(std::memory_order_acquire)) > 0)
    return 0;
  e = cudaFuncSetAttribute(spatial_operands_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(spatial_operands_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (keep) cached[dev].store(*sms, std::memory_order_release);
  return 0;
}

// crf_first_state replaces no Pallas kernel either (XLA's softmax, clip
// and log, the degree and its normalisers: pnp_ovss_tpu/ops/crf.py:190-
// 191, :459-462 and :502). The fused loop's set-up, once an image, in one
// launch instead of fourteen:
// - blocks of blockIdx.y < v, per pixel of variant blockIdx.y: q0 = the
//   softmax of the f32 logits over the c channels (the max, then the sum
//   of exp(x - max) in channel order, then exp(x - max) / sum, as
//   PyTorch's softmax); first[0] = bf16(q0), first[1] = bf16(log(clamp(
//   q0, 1e-5, 1)));
// - blocks of blockIdx.y == v: rows v*c..R of both made 0, and the
//   bilateral normalisers from K^T's column sums (integers, exact in
//   f32): deg = sum_m kt[m, n] * (1/255), norms[0] = norm_bi =
//   rsqrt(max(deg, 1e-20)), norms[1] = nb = nb_scale * norm_bi.
// Bound by K^T's 85 MB at the main-path shape (25 us); a warp sums 8
// columns a lane over every 8th row, so 256 columns of a block take 8
// rows at once, and the 8 partial sums meet in shared memory.
constexpr int kFirstThreads = 256;

template <typename InT>
__global__ void __launch_bounds__(kFirstThreads)
    first_state_kernel(const InT* __restrict__ logits,
                       const uint8_t* __restrict__ kt,
                       __nv_bfloat16* __restrict__ first,
                       float* __restrict__ norms, int v, int c, int R, int n,
                       int m_pad, float nb_scale) {
  const int tid = threadIdx.x, vi = blockIdx.y;
  const int n0 = blockIdx.x * kFirstThreads, px = n0 + tid;
  const size_t rn = static_cast<size_t>(R) * n;
  if (vi < v) {
    if (px >= n) return;
    const InT* x = logits + static_cast<size_t>(vi) * c * n + px;
    auto at = [&](int k) {
      return static_cast<float>(x[static_cast<size_t>(k) * n]);
    };
    float m = -__int_as_float(0x7f800000);  // -inf
    for (int k = 0; k < c; ++k) m = fmaxf(m, at(k));
    float sum = 0.f;
    for (int k = 0; k < c; ++k) sum += expf(at(k) - m);
    for (int k = 0; k < c; ++k) {
      const float q0 = expf(at(k) - m) / sum;
      const size_t o = static_cast<size_t>(vi * c + k) * n + px;
      first[o] = __float2bfloat16_rn(q0);
      first[rn + o] =
          __float2bfloat16_rn(logf(fminf(fmaxf(q0, 1e-5f), 1.f)));
    }
    return;
  }
  if (px < n)
    for (int row = v * c; row < R; ++row) {
      first[static_cast<size_t>(row) * n + px] = __float2bfloat16_rn(0.f);
      first[rn + static_cast<size_t>(row) * n + px] =
          __float2bfloat16_rn(0.f);
    }
  __shared__ uint32_t part[kFirstThreads / 32][kFirstThreads + 1];
  const int warp = tid / 32, lane = tid % 32, c0 = n0 + 8 * lane;
  uint32_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (n % 8 == 0 && c0 < n) {
#pragma unroll 8
    for (int m = warp; m < m_pad; m += kFirstThreads / 32) {
      const uint2 b = *reinterpret_cast<const uint2*>(
          kt + static_cast<size_t>(m) * n + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[e] += (b.x >> (8 * e)) & 0xffu;
        acc[4 + e] += (b.y >> (8 * e)) & 0xffu;
      }
    }
  } else {
    for (int m = warp; m < m_pad; m += kFirstThreads / 32)
      for (int e = 0; e < 8 && c0 + e < n; ++e)
        acc[e] += kt[static_cast<size_t>(m) * n + c0 + e];
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) part[warp][8 * lane + e] = acc[e];
  __syncthreads();
  if (px >= n) return;
  uint32_t total = 0;
#pragma unroll
  for (int w = 0; w < kFirstThreads / 32; ++w) total += part[w][tid];
  const float deg = static_cast<float>(total) * (1.f / 255.f);
  const float norm = rsqrtf(fmaxf(deg, 1e-20f));
  norms[px] = norm;
  norms[n + px] = nb_scale * norm;
}

}  // namespace

// logits: [v, c, n] bf16 (logits_f32 = 0) or f32; kt: [m_pad, n] uint8;
// first: [2, R, n] bf16; norms: [2, n] f32; all contiguous on one device;
// v * c <= R.
extern "C" int crf_first_state(const void* logits, const void* kt,
                               void* first, void* norms, int v, int c, int R,
                               int n, int m_pad, float nb_scale,
                               int logits_f32, void* stream) {
  if (v < 1 || v >= 65535 || c < 1 || v * c > R || n < 1 || m_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(kt) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(norms) % 4 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((n + kFirstThreads - 1) / kFirstThreads, v + 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* k = static_cast<const uint8_t*>(kt);
  __nv_bfloat16* f = static_cast<__nv_bfloat16*>(first);
  float* o = static_cast<float*>(norms);
  if (logits_f32)
    first_state_kernel<float><<<grid, kFirstThreads, 0, st>>>(
        static_cast<const float*>(logits), k, f, o, v, c, R, n, m_pad,
        nb_scale);
  else
    first_state_kernel<__nv_bfloat16><<<grid, kFirstThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), k, f, o, v, c, R, n,
        m_pad, nb_scale);
  return static_cast<int>(cudaGetLastError());
}

// q: [R, h * w] bf16; norm_bi: [h * w] f32; sigma: [2] f32 (sigma_y,
// sigma_x); msp: [R, h * w] bf16 (msp_f32 = 0) or f32; qsub: [R, m_pad]
// bf16; all contiguous on one device. Rows >= `rows` are written 0.
extern "C" int crf_spatial_operands(const void* q, const void* norm_bi,
                                    const void* sigma, void* msp, void* qsub,
                                    int R, int rows, int h, int w, int s,
                                    int m_pad, float pos_w, int msp_f32,
                                    void* stream) {
  if (R < 1 || rows < 0 || rows > R || h < 1 || w < 1 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hs = (h + s - 1) / s, ws = (w + s - 1) / s;
  if (static_cast<long long>(hs) * ws > m_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : std::initializer_list<const void*>{
           norm_bi, sigma, msp_f32 ? msp : nullptr})
    if (reinterpret_cast<uintptr_t>(p) % 4 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  int sms = 0;
  const int err = prepare(&sms);
  if (err != 0) return err;
  const Params prm{static_cast<const __nv_bfloat16*>(q),
                   static_cast<const float*>(norm_bi),
                   static_cast<const float*>(sigma),
                   msp,
                   static_cast<__nv_bfloat16*>(qsub),
                   R, rows, h, w, s, hs, ws, m_pad, pos_w};
  // About kMinBlocks blocks an SM, each over a group of state rows.
  const int tiles = (h + kYT - 1) / kYT;
  const int groups =
      min(min(R, 65535), max(1, (kMinBlocks * sms + tiles - 1) / tiles));
  const dim3 grid(tiles, groups);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (msp_f32)
    spatial_operands_kernel<float><<<grid, kThreads, kSmemBytes, st>>>(prm);
  else
    spatial_operands_kernel<__nv_bfloat16>
        <<<grid, kThreads, kSmemBytes, st>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
