// K8: the bilateral message m_i = sum_j exp(-||f_i - f_j||^2 / 2) v_j,
// self included, without materialising the kernel.
//
// Replaces pnp_ovss_tpu/ops/bilateral_pallas.py::gaussian_kernel_matmul
// (pallas_call at :104, body _bilateral_kernel at :34). The CRF runs it for
// the exact CRF (subsample 1), the unmaterialised strided CRF and both
// products of the Nystrom reconstruction.
//
// Numerics, as the Pallas body: the exponent is f32, from explicit
// differences on the CUDA cores (ROADMAP F1), over features the wrapper
// scales by sqrt(1 / (2 ln 2)) so that k = 2^-d^2 is one ex2.approx.ftz (an
// entry below 2^-126 adds nothing a bf16 sum can hold); k and v are rounded
// to bf16 for the product, which sums in f32. The expansion 2a.b - |a|^2 -
// |b|^2 (6 f32 operations a pair in place of 10) was measured and dropped:
// even over features centred at their midrange it leaves ~6e-5 in the
// exponent of pairs with k near 1, 20x explicit differences' 3e-6, and the
// bf16 codes it flips there moved the exact message 1.4e-3 from the plain
// version against a bar of 7e-4 (PERF.md).
//
// Bound on the H100 SXM at the exact CRF's shape (N = M = 36864 pixels of
// the 192x192 bucket, C = 58 channels of two variants): 1.36e9 pairs, each
// one ex2 on the multi-function unit (16 a clock per SM: 0.325 ms at 132
// SMs and the 1.98 GHz that 67 TFLOP/s implies) and 15 f32 operations (5
// subtractions and 5 FMAs; the negation folds into the ex2's operand: 0.30
// ms at 67 TFLOP/s), against 2*N*M*C = 158 GFLOP of bf16 product (0.16 ms
// at 989 TFLOP/s) and ~15 MB of inputs and outputs. The ex2 unit bounds
// it; in issue slots a pair takes about 12 (10 f32, 1 ex2, half a bf16
// pack, half a shared load) of the 128 an SM issues a clock, 0.49 ms.
//
// Design: out = K v on wgmma (hopper.cuh's wgmma_rs, shared with K6), with
// K computed in registers as A.
// - One warpgroup a block owns two m64 row tiles (128 i rows). Each
//   thread computes exactly its own A fragments of wgmma m64nWk16 (the
//   per-warp layout of mma.sync m16n8k16: rows g, g+8 of its warp's 16 in
//   each tile, columns 2t, 2t+1, 2t+8, 2t+9 of each 16-column step), so a
//   column's features, read from shared memory once, serve 4 entries, and
//   k never touches shared memory. The rows' features live in registers.
// - B is the v^T tile, W channels x 64 columns of bf16 in 128-byte
//   swizzled shared memory (K-major as stored). W is C rounded up to one of
//   8, 16, 32, 48, 64, 96, 128 (C = 1, the degree, runs n = 8); more than
//   128 channels split into equal chunks over blockIdx.y, each chunk
//   recomputing the exponents.
// - A ring of kStages stages fed by TMA (one thread arms a stage's
//   mbarrier and issues two 2-D box loads: the v^T tile and the 64
//   columns' scaled features, 12 floats a column, so that the four
//   columns a warp reads at once fall in distinct banks). TMA zero-fills
//   past M and C: a pad column has finite features and v = 0, so it adds
//   exactly 0. The stage wait traps after ~2 s instead of hanging.
// - A stage computes all 32 of its fragments (4 k16 steps, 2 tiles), then
//   issues its 8 products back to back; they run while the next stage
//   waits for its data, and are waited for only before that stage
//   rewrites the fragments. (Writing A registers while an earlier wgmma
//   still reads them makes ptxas serialise every wgmma: C7513.)
// - Work units are (row tile, j chunk): the wrapper splits j into
//   `split` chunks so that every SM gets close to the same number of
//   units (bilateral.matmul_plan). With split > 1 each unit writes its f32
//   partial to a workspace; the last unit of a row tile to arrive (a
//   counter, reset by that unit) sums the partials in the fixed order of
//   the chunks and stores the result, so two launches on the same inputs
//   are bit-equal. No float atomics.
//
// The symmetric schedule (kSym; the wrapper takes it where the j side is
// the i side itself, at W = 8 or 16: the exact CRF's degree and messages).
// K is then symmetric, and its entries are bitwise so: f_j - f_i is the
// exact negation of f_i - f_j, and the squares sum in the same order. So
// each exponent tile is computed once and feeds both products, and only
// the order of the f32 sums differs from the general schedule.
// - The pixels form blocks of R row tiles (R * 128 pixels; the wrapper's
//   bilateral.symmetric_plan picks R). A unit is a pair of blocks (P, Q),
//   P <= Q, in the order P, then Q: the upper triangle, with row block P
//   done after every unit that holds it. Row tile rt of P runs every
//   stage s of Q (on the diagonal unit, from its own stage 2 rt on):
//   out_rt += K v_s from registers, as above, and, where s lies past the
//   row tile (s >= 2 rt + 2), out_s += K^T v_rt: the bf16 fragments go to
//   shared memory transposed (stmatrix), as wgmma's A beside v_rt^T as B,
//   both K-major. The 128-pixel diagonal tiles thus run once, on one side.
// - The J-side sums of the unit's 2R stages stay in shared memory (each
//   thread its own floats), 2 R * 64 * W floats: 24 KB at W = 8, R = 6
//   and 32 KB at W = 16, R = 4, the plan's choices at N = 36864, with 3
//   blocks an SM (W = 16 from R = 5 on: 2). (They cannot live in
//   registers: a stage's index into them is not known at compile time.)
//   At wider W they outgrow a block, and smaller units would spend more
//   on partials than the exponents save: the general schedule runs there.
//   At N = 36864 the schedule runs 0.49 ms at W = 8 and 0.53 at W = 16
//   against the general one's 0.745 (PERF.md).
// - Each pixel gets one f32 partial from each block: its own block's
//   from the diagonal unit (both sides summed there), block Q > P's from
//   the I side of (P, Q), block Q < P's from the J side of (Q, P). After
//   the units the grid holds one reduction block a row tile; it waits for
//   its block's units (a counter a block), sums its pixels' partials in
//   block order and stores them, so the last block's sums spread over R
//   blocks (one block summing a whole block's partials, N * W floats,
//   held the launch's end ~50 us). One launch, bit-equal from launch to
//   launch, no float atomics.

#include <atomic>

#include "wgmma_gemm.cuh"

namespace {

constexpr int kTiles = 2;                // m64 row tiles a warpgroup
constexpr int kThreads = 128;            // one warpgroup a block
constexpr int kRows = 64 * kTiles;       // i rows a block
constexpr int kBJ = 64;                  // j columns a stage: one swizzle row
constexpr int kFLd = 12;                 // floats a packed feature row
constexpr int kStages = 4;               // ring depth
constexpr int kFTile = kBJ * kFLd * 4;   // bytes of a stage's features
constexpr int kSymMaxTiles = 8;          // row tiles a symmetric unit side
constexpr int kKtPanel = kBJ * 64 * 2;   // bytes of 64 j x 64 i bf16 of K^T

// Bytes of a stage (the v^T tile first: a 1024-byte multiple) and of a
// block's dynamic shared memory (the ring, its barriers, a flag, and room
// to align the ring to 1024 bytes).
template <int W>
constexpr int kStageBytes = W * kBJ * 2 + kFTile;
template <int W>
constexpr int kSmemBytes =
    kStages * kStageBytes<W> + kStages * 8 + 16 + 1024;
// The symmetric schedule's: its ring (3 stages at W = 16, so that 3
// blocks fit an SM up to R = 4), the K^T tile (two 64 x 64 panels), two
// buffers of v_rt^T (two W x 64 panels each) and the J-side sums of 2R
// stages; the reduction's kSymRedChunks chunks of 8 float4 a thread reuse
// that space (a region of at least their size); then the ring's and the
// v_rt buffers' barriers, and the alignment room
// (bilateral.symmetric_smem_bytes).
template <int W>
constexpr int kSymStages = W <= 8 ? 4 : 3;
constexpr int kSymRedChunks = 4;
template <int W>
__host__ __device__ constexpr int sym_region_bytes(int unit_tiles) {
  const int main = kSymStages<W> * kStageBytes<W> + 2 * kKtPanel +
                   4 * W * kBJ * 2 + 2 * unit_tiles * kBJ * W * 4;
  const int red = kSymRedChunks * 8 * 16 * kThreads;
  return main > red ? main : red;
}
template <int W>
__host__ __device__ constexpr int sym_smem_bytes(int unit_tiles) {
  return sym_region_bytes<W>(unit_tiles) + (kSymStages<W> + 2) * 8 + 1024;
}

// 2^x, flushing results below 2^-126 to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The first K floats of a column's packed features, in 16-byte loads
// where they fit (K = 5: two loads, K = 8: two).
template <int K>
__device__ __forceinline__ void load_column(const float* p, float (&b)[K]) {
#pragma unroll
  for (int q = 0; q + 4 <= K; q += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + q);
    b[q] = v.x;
    b[q + 1] = v.y;
    b[q + 2] = v.z;
    b[q + 3] = v.w;
  }
  constexpr int kTail = K / 4 * 4;
  if constexpr (K % 4 >= 2) {
    const float2 v = *reinterpret_cast<const float2*>(p + kTail);
    b[kTail] = v.x;
    b[kTail + 1] = v.y;
  }
  if constexpr (K % 2 == 1) b[K - 1] = p[K - 1];
}

// Row features of the row tile at r0: entry r = 2 i + h is row 64 i + 16
// warp + g + 8 h of the tile, 0 past N.
template <int F>
__device__ __forceinline__ void load_rows(const float* __restrict__ fi,
                                          int r0, int N, int warp, int g,
                                          float (&ra)[2 * kTiles][F]) {
#pragma unroll
  for (int r = 0; r < 2 * kTiles; ++r) {
    const int row = r0 + 64 * (r / 2) + 16 * warp + g + 8 * (r % 2);
    const float* p = fi + static_cast<long long>(row) * kFLd;
#pragma unroll
    for (int d = 0; d < F; ++d) ra[r][d] = row < N ? p[d] : 0.f;
  }
}

// A stage's 32 A fragments [k16 step][tile][register] from the row
// features and the stage's column features fs: k = 2^-d^2 from explicit
// f32 differences, rounded to bf16.
template <int F>
__device__ __forceinline__ void k_fragments(
    const float (&ra)[2 * kTiles][F], const float* fs, int t,
    uint32_t (&a)[kBJ / 16][kTiles][4]) {
#pragma unroll
  for (int s = 0; s < kBJ / 16; ++s) {
    // k[r][c]: row entry r, column s*16 + 2t + (c & 1) + 8 (c >> 1).
    float k[2 * kTiles][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float b[F];
      load_column(fs + (s * 16 + 2 * t + (c & 1) + 8 * (c >> 1)) * kFLd, b);
#pragma unroll
      for (int r = 0; r < 2 * kTiles; ++r) {
        float d2 = 0.f;
#pragma unroll
        for (int d = 0; d < F; ++d) {
          const float e = ra[r][d] - b[d];
          d2 = fmaf(e, e, d2);
        }
        k[r][c] = exp2_ftz(-d2);
      }
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      a[s][i][0] = pnp::pack_bf16x2(k[2 * i][0], k[2 * i][1]);
      a[s][i][1] = pnp::pack_bf16x2(k[2 * i + 1][0], k[2 * i + 1][1]);
      a[s][i][2] = pnp::pack_bf16x2(k[2 * i][2], k[2 * i][3]);
      a[s][i][3] = pnp::pack_bf16x2(k[2 * i + 1][2], k[2 * i + 1][3]);
    }
  }
}

// The row tile at r0's [N, C] output from the accumulators, channels c0 ..
template <int W>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&acc)[kTiles][W / 2],
                                           int r0, int c0, int N, int C,
                                           int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + 64 * i + 16 * warp + g + 8 * h;
        const int col = c0 + 8 * j + 2 * t;
        if (row >= N) continue;
        if (col < C) out[row * C + col] = acc[i][4 * j + 2 * h];
        if (col + 1 < C) out[row * C + col + 1] = acc[i][4 * j + 2 * h + 1];
      }
}

// 16 bytes from global memory (through L2 only) to shared memory,
// asynchronously (cp.async groups: pnp::cp_async_commit / _wait).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// The symmetric schedule's unit blockIdx.x (see the header), R =
// unit_tiles row tiles a block side. Partials: float4 q of thread tid of
// pixel row tile rt from block b at ws[((rt * blocks + b) * kP4 + q) *
// kThreads + tid] (q: tile q / kJ4, its floats 4 (q % kJ4) ..); one
// counter a block.
template <int F, int W>
__device__ __forceinline__ void symmetric_unit(
    const CUtensorMap* tm_f, const CUtensorMap* tm_v,
    const float* __restrict__ fi, float* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ counters, int N, int C,
    int unit_tiles, unsigned char* smem) {
  constexpr int kStage = kStageBytes<W>;
  constexpr int kVPanel = W * kBJ * 2;  // bytes of W x 64 bf16 of v^T
  constexpr int kJ4 = W / 8;            // float4 of a thread's stage sums
  constexpr int kP4 = kTiles * kJ4;     // float4 of a thread's partial
  constexpr int kSt = kSymStages<W>;
  const int R = unit_tiles;
  unsigned char* kt = smem + kSt * kStage;
  unsigned char* vi = kt + 2 * kKtPanel;  // [buffer][panel]
  float4* jacc = reinterpret_cast<float4*>(vi + 4 * kVPanel);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + sym_region_bytes<W>(unit_tiles));
  uint64_t* vfull = full + kSt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const int n_rt = (N + kRows - 1) / kRows, n_st = (N + kBJ - 1) / kBJ;
  const int blocks = (n_rt + R - 1) / R;
  int P = 0, u = blockIdx.x;
  while (u >= blocks - P) u -= blocks - P++;
  const int Q = P + u;
  const bool diag = P == Q;
  const int rt0 = P * R, rt1 = min(rt0 + R, n_rt);
  const int st0 = 2 * Q * R, st1 = min(st0 + 2 * R, n_st);
  auto first_stage = [&](int rt) { return diag ? 2 * rt : st0; };
  int n_it = 0;
  for (int rt = rt0; rt < rt1; ++rt) n_it += st1 - first_stage(rt);

  auto v_tile = [&](int slot) { return smem + slot * kStage; };
  auto f_tile = [&](int slot) {
    return reinterpret_cast<const float*>(smem + slot * kStage + W * kBJ * 2);
  };
  // Thread 0: the unit's stages in order, each into the next ring slot.
  int lit = 0, lrt = rt0, ls = first_stage(rt0);
  auto load_next = [&]() {
    const int slot = lit % kSt, j0 = ls * kBJ;
    pnp::hopper::mbar_expect_tx(&full[slot], kStage);
    pnp::hopper::tma_load_2d(v_tile(slot), tm_v, j0, 0, &full[slot]);
    pnp::hopper::tma_load_2d(smem + slot * kStage + W * kBJ * 2, tm_f, 0,
                             j0, &full[slot]);
    ++lit;
    if (++ls == st1 && ++lrt < rt1) ls = first_stage(lrt);
  };
  // Thread 0: v^T of row tile rt (two panels) into buffer b.
  auto load_vi = [&](int b, int rt) {
    pnp::hopper::mbar_expect_tx(&vfull[b], 2 * kVPanel);
    for (int h = 0; h < 2; ++h)
      pnp::hopper::tma_load_2d(vi + (2 * b + h) * kVPanel, tm_v,
                               rt * kRows + h * kBJ, 0, &vfull[b]);
  };
  // A stage's J-side sums of this thread, float4 q.
  auto jsum = [&](int stage, int q) -> float4& {
    return jacc[(stage * kJ4 + q) * kThreads + tid];
  };
  for (int e = 0; e < 2 * R * kJ4; ++e)
    jacc[e * kThreads + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid == 0) {
    for (int s = 0; s < kSt + 2; ++s) pnp::hopper::mbar_init(&full[s], 1);
    pnp::hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int b = 0; b < 2 && rt0 + b < rt1; ++b) load_vi(b, rt0 + b);
    while (lit < kSt - 1 && lit < n_it) load_next();
  }

  // This thread's stmatrix row addresses in the K^T tile: lane 8m + q
  // gives row j = 16 s + 8 (m >> 1) + q of panel `tile` (its i range),
  // 16-byte chunk 2 warp + (m & 1) of that row, 128-byte swizzled.
  const int m = lane / 8, q8 = lane % 8;
  const uint32_t kt_row = pnp::smem_addr(kt) + (8 * (m >> 1) + q8) * 128 +
                          (((2 * warp + (m & 1)) ^ q8) << 4);
  float4* ws4 = reinterpret_cast<float4*>(ws);
  // ws float4 q of this thread's partial of row tile rt from block b.
  auto partial = [&](int rt, int b, int q) -> float4& {
    return ws4[((static_cast<long long>(rt) * blocks + b) * kP4 + q) *
                   kThreads + tid];
  };
  float acc[kTiles][W / 2];
  float jt[W / 2] = {};
  uint32_t a[kBJ / 16][kTiles][4] = {};  // [k16 step][tile][fragment]
  auto store_jt = [&](int stage) {
#pragma unroll
    for (int q = 0; q < kJ4; ++q)
      jsum(stage, q) = make_float4(jt[4 * q], jt[4 * q + 1], jt[4 * q + 2],
                                   jt[4 * q + 3]);
  };
  int it = 0;
  for (int rt = rt0; rt < rt1; ++rt) {
    const int kk = rt - rt0;
    float ra[2 * kTiles][F];
    load_rows<F>(fi, rt * kRows, N, warp, g, ra);
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int e = 0; e < W / 2; ++e) acc[i][e] = 0.f;
    pnp::hopper::mbar_wait_or_trap(&vfull[kk & 1], (kk >> 1) & 1);
    const unsigned char* vrt = vi + 2 * (kk & 1) * kVPanel;
    int pending = -1;  // the J stage whose sums are in flight in jt
    for (int s = first_stage(rt); s < st1; ++s, ++it) {
      // The last stage's products from registers are done (each stage
      // commits two groups, the transposed product last, maybe empty):
      // the A registers and, after the barrier, the ring slot are free.
      // The transposed product may still run: it is waited for only
      // before the K^T tile is rewritten.
      pnp::hopper::wgmma_wait<1>();
      pnp::hopper::fence_a(a);
#pragma unroll
      for (int i = 0; i < kTiles; ++i) pnp::hopper::fence_regs(acc[i]);
      __syncthreads();
      if (tid == 0 && lit < n_it) load_next();
      pnp::hopper::mbar_wait_or_trap(&full[it % kSt], (it / kSt) & 1);
      k_fragments<F>(ra, f_tile(it % kSt), t, a);
      const bool jside = s >= 2 * rt + 2;
      if (jside) {
        // The last stage's transposed product is done: jt and the K^T
        // tile are free.
        pnp::hopper::wgmma_wait<0>();
        pnp::hopper::fence_regs(jt);
        if (pending >= 0) store_jt(pending);
#pragma unroll
        for (int s4 = 0; s4 < kBJ / 16; ++s4)
#pragma unroll
          for (int i = 0; i < kTiles; ++i)
            pnp::hopper::stmatrix_x4_trans(kt_row + i * kKtPanel + s4 * 2048,
                                           a[s4][i]);
        pnp::hopper::fence_proxy_async();
#pragma unroll
        for (int q = 0; q < kJ4; ++q) {
          const float4 v = jsum(s - st0, q);
          jt[4 * q] = v.x;
          jt[4 * q + 1] = v.y;
          jt[4 * q + 2] = v.z;
          jt[4 * q + 3] = v.w;
        }
      }
      const uint64_t db = pnp::hopper::desc_sw128(v_tile(it % kSt));
      pnp::hopper::wgmma_fence();
#pragma unroll
      for (int s4 = 0; s4 < kBJ / 16; ++s4)
#pragma unroll
        for (int i = 0; i < kTiles; ++i)
          pnp::hopper::wgmma_rs<W>(acc[i], a[s4][i], db + 2 * s4);
      pnp::hopper::wgmma_commit();
      if (jside) {
        __syncthreads();  // every warp's part of the K^T tile is stored
#pragma unroll
        for (int kq = 0; kq < 2 * kBJ / 16; ++kq)
          pnp::hopper::wgmma_ss<W>(
              jt,
              pnp::hopper::desc_sw128(kt + (kq / 4) * kKtPanel) +
                  2 * (kq % 4),
              pnp::hopper::desc_sw128(vrt + (kq / 4) * kVPanel) +
                  2 * (kq % 4));
        pending = s - st0;
      }
      pnp::hopper::wgmma_commit();
    }
    pnp::hopper::wgmma_wait<0>();
    pnp::hopper::fence_a(a);
#pragma unroll
    for (int i = 0; i < kTiles; ++i) pnp::hopper::fence_regs(acc[i]);
    pnp::hopper::fence_regs(jt);
    if (pending >= 0) store_jt(pending);
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int q = 0; q < kJ4; ++q) {
        const float4 x = make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                     acc[i][4 * q + 2], acc[i][4 * q + 3]);
        if (!diag) {
          partial(rt, Q, i * kJ4 + q) = x;
        } else if (2 * rt + i < st1) {
          // The row tile's own stages 2 rt, 2 rt + 1 of the diagonal
          // unit: the I side joins the J side there (same layout).
          float4& v = jsum(2 * rt + i - st0, q);
          v = make_float4(v.x + x.x, v.y + x.y, v.z + x.z, v.w + x.w);
        }
      }
    __syncthreads();  // v_rt's buffer is read by no wgmma any more
    if (tid == 0 && rt + 2 < rt1) load_vi(kk & 1, rt + 2);
  }

  // The J side (and on the diagonal unit both sides): block Q's partial
  // from block P.
  for (int c = Q * R; c < min(Q * R + R, n_rt); ++c)
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int q = 0; q < kJ4; ++q)
        partial(c, P, i * kJ4 + q) = 2 * c + i < st1
                                         ? jsum(2 * c + i - st0, q)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    atomicAdd(counters + P, 1);
    if (!diag) atomicAdd(counters + Q, 1);
  }
}

// The symmetric schedule's reduction block blockIdx.x - units: one row
// tile, rt, of block x = rt / R. It waits until all `blocks` units that
// hold x have stored their partials (counters[x]; the wait traps after
// ~2 s, as the ring's do), sums the row tile's partials in block order,
// 0 + p_0 = p_0, so ((p_0 + p_1) + p_2) + ..., and stores them. Each
// thread streams its own floats through shared memory in chunks of kRS
// blocks, kSymRedChunks chunks in flight. The last of x's reduction blocks
// resets both of x's counters for the next launch. (The reduction blocks
// come after every unit in the grid, so they wait only on units that
// were scheduled before them.)
template <int W>
__device__ __forceinline__ void symmetric_reduce(
    float* __restrict__ out, const float* __restrict__ ws,
    int* __restrict__ counters, int N, int C, int unit_tiles, int units,
    unsigned char* smem) {
  constexpr int kP4 = kTiles * W / 8;  // float4 of a thread's partial
  constexpr int kRS = 8 / kP4, kRB = kSymRedChunks;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_rt = (N + kRows - 1) / kRows;
  const int blocks = (n_rt + unit_tiles - 1) / unit_tiles;
  const int rt = blockIdx.x - units, x = rt / unit_tiles;
  int* done = counters + blocks + x;
  if (tid == 0) {
    const volatile int* arrived = counters + x;
    const long long t0 = clock64();
    while (*arrived < blocks) {
      __nanosleep(256);
      if (clock64() - t0 > (1ll << 32)) __trap();
    }
  }
  __syncthreads();
  __threadfence();
  const float4* src = reinterpret_cast<const float4*>(ws) +
                      static_cast<long long>(rt) * blocks * kP4 * kThreads +
                      tid;
  float4* red = reinterpret_cast<float4*>(smem);
  const int chunks = (blocks + kRS - 1) / kRS;
  auto issue = [&](int ch) {  // always a group, maybe empty
    for (int j = 0; j < kRS; ++j) {
      const int b = ch * kRS + j;
      if (ch < chunks && b < blocks)
#pragma unroll
        for (int q = 0; q < kP4; ++q)
          cp_async16(pnp::smem_addr(red + (((ch % kRB) * kRS + j) * kP4 + q) *
                                              kThreads + tid),
                     src + (b * kP4 + q) * kThreads);
    }
    pnp::cp_async_commit();
  };
  for (int ch = 0; ch < kRB - 1; ++ch) issue(ch);
  float sum[kTiles][W / 2];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < W / 2; ++e) sum[i][e] = 0.f;
  for (int ch = 0; ch < chunks; ++ch) {
    issue(ch + kRB - 1);
    pnp::cp_async_wait<kRB - 1>();
#pragma unroll
    for (int j = 0; j < kRS; ++j) {
      if (ch * kRS + j >= blocks) break;
#pragma unroll
      for (int q = 0; q < kP4; ++q) {
        const float4 v = red[(((ch % kRB) * kRS + j) * kP4 + q) * kThreads +
                             tid];
        sum[q / (W / 8)][4 * (q % (W / 8))] += v.x;
        sum[q / (W / 8)][4 * (q % (W / 8)) + 1] += v.y;
        sum[q / (W / 8)][4 * (q % (W / 8)) + 2] += v.z;
        sum[q / (W / 8)][4 * (q % (W / 8)) + 3] += v.w;
      }
    }
  }
  pnp::cp_async_wait<0>();
  store_rows<W>(out, sum, rt * kRows, 0, N, C, warp, g, t);
  __syncthreads();
  if (tid == 0) {
    const int tiles = min(x * unit_tiles + unit_tiles, n_rt) - x * unit_tiles;
    if (atomicAdd(done, 1) == tiles - 1) {
      counters[x] = 0;  // ready for the next launch
      *done = 0;
    }
  }
}

// The general schedule's unit: row tile blockIdx.x / split, j chunk
// blockIdx.x % split, channels blockIdx.y * W ..
template <int F, int W>
__device__ __forceinline__ void split_unit(
    const CUtensorMap* tm_f, const CUtensorMap* tm_v,
    const float* __restrict__ fi, float* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ counters, int N, int M, int C,
    int split, unsigned char* smem) {
  constexpr int kStage = kStageBytes<W>;
  constexpr int kPairs = kTiles * W / 4;  // float2 of a thread's partial
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  int* last = reinterpret_cast<int*>(full + kStages);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rt = blockIdx.x / split, q = blockIdx.x % split;
  const int r0 = rt * kRows, c0 = blockIdx.y * W;
  const int stages = (M + kBJ - 1) / kBJ;
  const int s0 = static_cast<int>(static_cast<long long>(q) * stages / split);
  const int n_it =
      static_cast<int>(static_cast<long long>(q + 1) * stages / split) - s0;

  auto v_tile = [&](int slot) { return smem + slot * kStage; };
  auto f_tile = [&](int slot) {
    return reinterpret_cast<const float*>(smem + slot * kStage + W * kBJ * 2);
  };
  // Thread 0: stage `it` of this chunk into its slot.
  auto load = [&](int it) {
    const int slot = it % kStages, j0 = (s0 + it) * kBJ;
    pnp::hopper::mbar_expect_tx(&full[slot], kStage);
    pnp::hopper::tma_load_2d(v_tile(slot), tm_v, j0, c0, &full[slot]);
    pnp::hopper::tma_load_2d(smem + slot * kStage + W * kBJ * 2, tm_f, 0,
                             j0, &full[slot]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) pnp::hopper::mbar_init(&full[s], 1);
    pnp::hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages - 1 && s < n_it; ++s) load(s);

  float ra[2 * kTiles][F];
  load_rows<F>(fi, r0, N, warp, g, ra);

  float acc[kTiles][W / 2];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < W / 2; ++e) acc[i][e] = 0.f;
  uint32_t a[kBJ / 16][kTiles][4] = {};  // [k16 step][tile][fragment]
  for (int it = 0; it < n_it; ++it) {
    // The last stage's products are done: its A registers are free, and
    // after the barrier so is its slot, which this stage refills.
    pnp::hopper::wgmma_wait<0>();
    pnp::hopper::fence_a(a);
#pragma unroll
    for (int i = 0; i < kTiles; ++i) pnp::hopper::fence_regs(acc[i]);
    __syncthreads();
    if (tid == 0 && it + kStages - 1 < n_it) load(it + kStages - 1);
    pnp::hopper::mbar_wait_or_trap(&full[it % kStages],
                                   (it / kStages) & 1);

    k_fragments<F>(ra, f_tile(it % kStages), t, a);
    const uint64_t db = pnp::hopper::desc_sw128(v_tile(it % kStages));
    pnp::hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBJ / 16; ++s)
#pragma unroll
      for (int i = 0; i < kTiles; ++i)
        pnp::hopper::wgmma_rs<W>(acc[i], a[s][i], db + 2 * s);
    pnp::hopper::wgmma_commit();
  }
  pnp::hopper::wgmma_wait<0>();
  pnp::hopper::fence_a(a);
#pragma unroll
  for (int i = 0; i < kTiles; ++i) pnp::hopper::fence_regs(acc[i]);

  if (split > 1) {
    // This unit's partial, float2 p of thread tid at [p][tid] (coalesced);
    // the units of one row tile and chunk are adjacent.
    const long long unit = static_cast<long long>(blockIdx.y) * gridDim.x +
                           blockIdx.x;
    float2* part = reinterpret_cast<float2*>(ws);
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int p = 0; p < W / 4; ++p)
        part[(unit * kPairs + i * (W / 4) + p) * kThreads + tid] =
            make_float2(acc[i][2 * p], acc[i][2 * p + 1]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* cnt = counters + blockIdx.y * (gridDim.x / split) + rt;
      const int prev = atomicAdd(cnt, 1);
      *last = prev == split - 1;
      if (prev == split - 1) *cnt = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!*last) return;
    __threadfence();
    // The last unit sums the partials in chunk order, its own from
    // registers (the same bits it stored); each chunk's loads are issued
    // together. 0 + p_0 = p_0, so the sum is ((p_0 + p_1) + p_2) + ...
    const float2* first = part + (unit - q) * kPairs * kThreads;
    float sum[kTiles][W / 2];
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int e = 0; e < W / 2; ++e) sum[i][e] = 0.f;
    for (int u = 0; u < split; ++u) {
      const float2* pu = first + static_cast<long long>(u) * kPairs * kThreads;
#pragma unroll
      for (int i = 0; i < kTiles; ++i)
#pragma unroll
        for (int p = 0; p < W / 4; ++p) {
          const float2 v =
              u == q ? make_float2(acc[i][2 * p], acc[i][2 * p + 1])
                     : __ldcg(pu + (i * (W / 4) + p) * kThreads + tid);
          sum[i][2 * p] += v.x;
          sum[i][2 * p + 1] += v.y;
        }
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int e = 0; e < W / 2; ++e) acc[i][e] = sum[i][e];
  }

  store_rows<W>(out, acc, r0, c0, N, C, warp, g, t);
}

// One block: a unit of the general schedule or, with kSym, of the
// symmetric one (`split` row tiles a block side; f_j = f_i, M = N, one
// channel chunk). Features (f_j side) and v^T come through their tensor
// maps (boxes of 64 x 12 f32 and 64 x W bf16, the latter with 128-byte
// swizzle).
template <int F, int W, bool kSym>
__global__ void __launch_bounds__(
    kThreads, (F == 5 && W <= (kSym ? 16 : 64)) ? 3 : 2)
    matmul_kernel(const __grid_constant__ CUtensorMap tm_f,
                  const __grid_constant__ CUtensorMap tm_v,
                  const float* __restrict__ fi, float* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int N,
                  int M, int C, int split) {
  extern __shared__ unsigned char smem_raw[];
  // Stages on a 1024-byte boundary (the swizzle's period). An offset into
  // smem_raw, so that the compiler still sees a shared-memory pointer and
  // reads the features with LDS rather than generic loads.
  unsigned char* smem =
      smem_raw + ((1024 - (pnp::smem_addr(smem_raw) & 1023)) & 1023);
  if constexpr (kSym) {
    const int blocks = ((N + kRows - 1) / kRows + split - 1) / split;
    const int units = blocks * (blocks + 1) / 2;
    if (static_cast<int>(blockIdx.x) < units)
      symmetric_unit<F, W>(&tm_f, &tm_v, fi, out, ws, counters, N, C, split,
                           smem);
    else
      symmetric_reduce<W>(out, ws, counters, N, C, split, units, smem);
  } else
    split_unit<F, W>(&tm_f, &tm_v, fi, out, ws, counters, N, M, C, split,
                     smem);
}

// Tensor map of a row-major [rows, cols] array (element `type` of `elem`
// bytes, rows `ld` elements apart) read in boxes of box_cols x box_rows;
// out-of-range reads are 0.
int make_map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem,
                const void* ptr, int rows, int cols, long long ld,
                int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  pnp::gemm::EncodeTiled fn = pnp::gemm::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides,
                        box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// matmul_kernel<F, W, kSym>'s shared-memory limit raised once per library
// and device.
template <int F, int W, bool kSym>
int prepare() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && ready[dev].load(std::memory_order_acquire)) return 0;
  e = cudaFuncSetAttribute(
      matmul_kernel<F, W, kSym>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSym ? sym_smem_bytes<W>(kSymMaxTiles) : kSmemBytes<W>);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cached) ready[dev].store(true, std::memory_order_release);
  return 0;
}

struct Args {
  CUtensorMap tm_f, tm_v;
  const float* fi;
  float* out;
  float* ws;
  int* counters;
  int N, M, C, split, chunks;
  cudaStream_t stream;
};

template <int F, int W>
int launch(const Args& x) {
  const int err = prepare<F, W, false>();
  if (err != 0) return err;
  const dim3 grid(((x.N + kRows - 1) / kRows) * x.split, x.chunks);
  constexpr int smem = kSmemBytes<W>;
  matmul_kernel<F, W, false><<<grid, kThreads, smem, x.stream>>>(
      x.tm_f, x.tm_v, x.fi, x.out, x.ws, x.counters, x.N, x.M, x.C, x.split);
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_width(int width, const Args& x) {
  switch (width) {
    case 8: return launch<F, 8>(x);
    case 16: return launch<F, 16>(x);
    case 32: return launch<F, 32>(x);
    case 48: return launch<F, 48>(x);
    case 64: return launch<F, 64>(x);
    case 96: return launch<F, 96>(x);
    case 128: return launch<F, 128>(x);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The symmetric schedule: one block a unit, `split` row tiles a side.
template <int F, int W>
int launch_sym(const Args& x) {
  const int err = prepare<F, W, true>();
  if (err != 0) return err;
  const int row_tiles = (x.N + kRows - 1) / kRows;
  const int blocks = (row_tiles + x.split - 1) / x.split;
  matmul_kernel<F, W, true>
      <<<blocks * (blocks + 1) / 2 + row_tiles, kThreads,
         sym_smem_bytes<W>(x.split),
         x.stream>>>(x.tm_f, x.tm_v, x.fi, x.out, x.ws, x.counters, x.N,
                     x.M, x.C, x.split);
  return static_cast<int>(cudaGetLastError());
}

// The tensor maps of the features (the j side, [M, 12] f32, boxes of 64
// rows) and of v^T ([C, vt_ld] bf16, boxes of W rows x 64 columns).
int make_maps(Args* x, const void* fj, const void* vt, int M, int vt_ld,
              int C, int width) {
  const int err =
      make_map_2d(&x->tm_f, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, fj, M, kFLd,
                  kFLd, kFLd, kBJ, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  return make_map_2d(&x->tm_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, vt, C, M,
                     vt_ld, kBJ, width, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// fi [N, 12] and fj [M, 12] f32, the features scaled by
// sqrt(1 / (2 ln 2)) in columns 0..F-1 (bilateral.pack_features); vt
// [C, vt_ld] bf16 (v^T; columns from M on are not
// read); out [N, C] f32; F in {5, 8}; width in {8, 16, 32, 48, 64, 96,
// 128}, chunks = ceil(C / width) over blockIdx.y; 1 <= split <= ceil(M /
// 64). With split > 1, ws holds at least chunks * ceil(N / 128) * split *
// 128 * width floats and counters at least chunks * ceil(N / 128) ints,
// all 0 before the first launch (each launch leaves them 0). fi, fj, vt
// and ws 16-byte aligned, vt_ld % 8 == 0.
extern "C" int gaussian_kernel_matmul(const void* fi, const void* fj,
                                      const void* vt, void* out, void* ws,
                                      void* counters, int N, int M,
                                      int vt_ld, int F, int C, int width,
                                      int split, long long ws_floats,
                                      int n_counters, void* stream) {
  if (N < 0 || M < 1 || C < 1 || width < 8 || vt_ld < M || vt_ld % 8 != 0 ||
      split < 1 || split > (M + kBJ - 1) / kBJ ||
      !pnp::gemm::aligned16({fi, fj, vt, ws}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const int chunks = (C + width - 1) / width;
  const long long tiles =
      static_cast<long long>(chunks) * ((N + kRows - 1) / kRows);
  if (split > 1 && (ws_floats < tiles * split * kRows * width ||
                    n_counters < tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  Args x;
  x.fi = static_cast<const float*>(fi);
  x.out = static_cast<float*>(out);
  x.ws = static_cast<float*>(ws);
  x.counters = static_cast<int*>(counters);
  x.N = N;
  x.M = M;
  x.C = C;
  x.split = split;
  x.chunks = chunks;
  x.stream = static_cast<cudaStream_t>(stream);
  const int err = make_maps(&x, fj, vt, M, vt_ld, C, width);
  if (err != 0) return err;
  if (F == 5) return launch_width<5>(width, x);
  if (F == 8) return launch_width<8>(width, x);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8 on the symmetric schedule: m = K v with both sides the features f
// [N, 12] (as fi above), vt [C, vt_ld] bf16, out [N, C] f32, F in {5, 8},
// C <= width, width in {8, 16}, 1 <= unit_tiles <= 8 row tiles a block
// side. ws holds at least ceil(N / 128) * blocks * 128 * width floats and
// counters at least 2 * blocks ints, blocks = ceil(ceil(N / 128) /
// unit_tiles), all 0 before the first launch (each launch leaves them 0).
// The grid: one block a unit, then one a row tile for the sums.
// f, vt and ws 16-byte aligned, vt_ld % 8 == 0.
extern "C" int gaussian_kernel_matmul_symmetric(
    const void* f, const void* vt, void* out, void* ws, void* counters,
    int N, int vt_ld, int F, int C, int width, int unit_tiles,
    long long ws_floats, int n_counters, void* stream) {
  if (N < 1 || C < 1 || C > width || (width != 8 && width != 16) ||
      unit_tiles < 1 || unit_tiles > kSymMaxTiles || vt_ld < N ||
      vt_ld % 8 != 0 || !pnp::gemm::aligned16({f, vt, ws}))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_rt = (N + kRows - 1) / kRows;
  const int blocks = (n_rt + unit_tiles - 1) / unit_tiles;
  if (ws_floats < static_cast<long long>(n_rt) * blocks * kRows * width ||
      n_counters < 2 * blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  Args x;
  x.fi = static_cast<const float*>(f);
  x.out = static_cast<float*>(out);
  x.ws = static_cast<float*>(ws);
  x.counters = static_cast<int*>(counters);
  x.N = N;
  x.M = N;
  x.C = C;
  x.split = unit_tiles;
  x.chunks = 1;
  x.stream = static_cast<cudaStream_t>(stream);
  const int err = make_maps(&x, f, vt, N, vt_ld, C, width);
  if (err != 0) return err;
  if (F == 5 && width == 8) return launch_sym<5, 8>(x);
  if (F == 5 && width == 16) return launch_sym<5, 16>(x);
  if (F == 8 && width == 8) return launch_sym<8, 8>(x);
  if (F == 8 && width == 16) return launch_sym<8, 16>(x);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One launch that stalls on a stage whose bytes never arrive; the launch
// traps after ~2 s and the next synchronisation reports the error.
extern "C" int gaussian_kernel_matmul_stall(void* stream) {
  pnp::hopper::stall_kernel<0><<<1, 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
