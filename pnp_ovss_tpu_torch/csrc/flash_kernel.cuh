// The flash attention kernel on strided q/k/v views, shared by K2, K7
// and K9 (flash_attention.cu) and by K4's attention (flash_qkv_proj.cu),
// so that every entry's rows come from one code path, bit for bit.
//
// Replaces the bodies of pnp_ovss_tpu/ops/flash_attention.py:
// _flat_kernel (:131; pallas_calls at :260 flash_mha_flat, :325
// flash_mha_flat_qkv and :636 flash_mha_flat_xlen), _flat_proj_kernel
// (:405; pallas_call at :506, flash_mha_qkv_proj, whose attention half
// this is) and _flash_kernel (:650; pallas_call at :713, flash_mha).
//
// Computes softmax(q k^T / sqrt(D)) v, non-causal, per head. Every tensor
// is read through its own batch, head and row strides (View). Keys at
// index >= L are masked out; query rows >= S are neither read nor
// written. D is 64 or 128.
//
// What bounds it on the H100 (SXM, 700 W: 3.35 TB/s, 989 TFLOP/s bf16,
// expf's ex2 on the multi-function units at 16 a clock per SM):
// - at 336 px (K2, B = 35, S = L = 442, 16 heads of 64) the bytes: 127 MB
//   of q/k/v and output, 0.038 ms, against 28 GFLOP of products (0.028
//   ms) and 110 M exponentials (0.026 ms);
// - at 768 px (K4's attention, B = 12, S = L = 2305) and at D = 128 the
//   products and the exponentials together: 261 GFLOP (0.264 ms) and
//   1.02 G exponentials (0.244 ms at D = 64; half as many at D = 128),
//   which run on different units and must overlap to come near either.
//
// Design (sm_90a: TMA, mbarriers, wgmma; hopper.cuh):
// - A persistent grid, one block an SM, walks work tiles of kBQ = 64 *
//   kConsumers query rows of one (batch, head), query tiles fastest, so
//   that the blocks at work at once share each head's K/V in L2. Two
//   consumers (128 rows), or three at D = 64 from 1024 rows on.
// - Warp specialisation. One producer thread (warpgroup 0, its registers
//   lowered by setmaxnreg) keeps TMA loads in flight: each tile's q once,
//   then its key tiles of kBN keys into rings of kStages K and kStages V
//   tiles, one mbarrier each for "full" and "empty", running ahead into
//   the next work tile. Each consumer warpgroup owns 64 query rows, so a
//   K/V tile serves kBQ rows: half or a third of the L2 -> SM traffic of
//   the 64-row tiles of the mma.sync kernel this replaces.
// - Every tensor map is 4-D (D, rows, heads, batch) over the caller's
//   strides, with 128-byte swizzle. The K and V maps have a row extent of
//   L, so TMA writes zeros for keys >= L (never reads them: a NaN past L
//   cannot reach a row), and the q map one of S (zero rows past S).
// - q is scaled in f32 and rounded to bf16 once, then held in registers
//   as the A operand of every QK^T product.
// - S = q K^T on wgmma m64n{kBN}k16 (A from registers, B the K-major K
//   tile). O += P V on wgmma m64n{D}k16 with A = P, rounded to bf16
//   straight from the score accumulators (their layout is the A
//   fragments'), and B the V tile as TMA stores it, [key][d]: MN-major,
//   read through the transposed-B form and an MN-major descriptor, so V
//   is never transposed.
// - The softmax overlaps the products. Within a warpgroup, key tile j's
//   QK^T and tile j - 1's P V are issued together, and tile j's softmax
//   runs while P V does. Between two consumers, named barriers make them
//   take turns to issue (ping-pong). Issuing tile j + 1's QK^T before
//   tile j's softmax (two score buffers) would hide QK^T's latency too,
//   but ptxas then serialises every wgmma (C7513 / C7515: a wgmma's A or
//   accumulator registers written while another is in flight).
// - Per-row arithmetic (the same for every entry, and the same as the
//   mma.sync kernel this replaces, whose outputs it reproduces bit for
//   bit: wgmma's k16 steps sum as mma.sync's do): f32 running max and
//   sums; each exponent expf of a raw-score difference (flash_exp); P
//   rounded to bf16 once; keys visited in tiles of kBN = 64 from 0 to L,
//   in that order, whatever the query tile; o / l at the end. So a row's
//   result depends only on that row and the keys: K7's rows equal K2's,
//   and K4's head outputs K2's, bit for bit. An ex2 exponent (19-24%
//   faster) and 128-key tiles (up to 9% faster) each moved
//   chip_smoke.py's 3-head narrow pipeline past its bar (PERF.md).
// - Every ring wait traps after ~2 s instead of hanging the card.
// The consumer count, key tile and ring depth per head dim were chosen by
// measurement (scripts/kernel_ablation.py, PERF.md).
#pragma once

#include "wgmma_gemm.cuh"

namespace pnp {
namespace flash {

// Per head dim: consumer warpgroups (64 query rows each), keys a tile and
// K/V ring stages; at D = 64, sequences of kLongRows query rows or more
// take kConsumersD64Long (which only changes which block computes a row).
constexpr int kConsumersD64 = 2, kKeysD64 = 64, kStagesD64 = 6;
constexpr int kConsumersD64Long = 3, kLongRows = 1024;
constexpr int kConsumersD128 = 2, kKeysD128 = 64, kStagesD128 = 4;
// Two consumer warpgroups take turns to issue their products (three
// lose 5% at 768 px by it).
constexpr bool kPingPong = true;

constexpr float kNeg = -1e30f;

// Strides of one tensor, in elements: batch, head and row.
struct View {
  long long bs, hs, rs;
};

// exp(s - m), the exponent of every score and of every rescale. expf,
// not one ex2.approx of log2(e) (s - m): that was 19-24% faster but moved
// chip_smoke.py's 3-head narrow pipeline past its bar (kernel_ablation.py's
// ex2 variant, PERF.md).
__device__ __forceinline__ float flash_exp(float s, float m) {
  return expf(s - m);
}

// v[0] = max(v[0 .. 2W)), folding in halves (exact in any order).
template <int W, int N>
__device__ __forceinline__ void fold_max(float (&v)[N]) {
  if constexpr (W > 0) {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = fmaxf(v[i], v[i + W]);
    fold_max<W / 2>(v);
  }
}

template <int D, int kConsumers, int kBN, int kStages>
struct Plan {
  static constexpr int kBQ = 64 * kConsumers;  // query rows a work tile
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBoxes = D / 64;  // 64-column boxes a row
  static constexpr bool kTurns = kPingPong && kConsumers == 2;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;  // one K or V tile
  // Registers a thread after setmaxnreg (the block starts at 65536 /
  // kThreads, rounded down to 8): the producer's warpgroup and each
  // consumer's. A block of one consumer keeps what it starts with.
  static constexpr int kProducerRegs = kConsumers == 2 ? 24 : 32;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
  // Shared memory: q, the K ring, the V ring (each tile on a 1024-byte
  // boundary), then the barriers; and room to align the start.
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  static constexpr int kSmemBytes = kBarOff + (2 + 4 * kStages) * 8 + 1024;
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0,
                "tiles must keep the swizzle's 1024-byte period");
  static_assert(kBN == 64 || kBN == 128, "key tiles of 64 or 128");
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kConsumers == 1 ||
                    kProducerRegs + kConsumers * kConsumerRegs <=
                        (1 + kConsumers) * ((65536 / kThreads) / 8 * 8),
                "register counts must fit the block's allocation");
};

// A warp's q fragments from the work tile's q (64-column boxes of kBQ
// rows of 128 bytes, 128-byte swizzle): fragment [s][i] covers row row0 +
// g + 8 (i & 1), column 16 s + 2t + 8 (i >> 1), scaled in f32 and rounded
// to bf16.
template <int D, int kBQ>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4],
                                       const unsigned char* q_box,
                                       int row0, float scale, int g, int t) {
#pragma unroll
  for (int s = 0; s < D / 16; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + 8 * (i & 1);
      const int c = (s * 16 + 2 * t + 8 * (i >> 1)) % 64;
      const unsigned char* p = q_box + (s / 4) * kBQ * 128 + r * 128 +
                               (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
      const float2 f = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p));
      qa[s][i] = pack_bf16x2(f.x * scale, f.y * scale);
    }
}

template <int D, int kConsumers, int kBN, int kStages>
__global__ void __launch_bounds__(128 * (1 + kConsumers), 1) flash_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    View ov, int S, int L, int H, int q_tiles, int tiles, float scale) {
  using P = Plan<D, kConsumers, kBN, kStages>;
  constexpr int kBQ = P::kBQ;
  extern __shared__ unsigned char smem_raw[];
  // On a 1024-byte boundary (the swizzle's period), as an offset into
  // smem_raw so that q is read with shared-memory loads.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_box = smem + P::kQOff;
  auto k_tile = [&](int s) { return smem + P::kKOff + s * P::kKVBytes; };
  auto v_tile = [&](int s) { return smem + P::kVOff + s * P::kKVBytes; };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + P::kBarOff);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int wg = threadIdx.x / 128;
  const int n_kt = (L + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 128 * kConsumers);  // every consumer thread
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 4 * kConsumers);  // each consumer warp
      hopper::mbar_init(&v_empty[s], 4 * kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread loads each work tile's q, then its key tiles,
    // as the ring's slots free up.
    if constexpr (kConsumers > 1) hopper::setmaxnreg_dec<P::kProducerRegs>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int qt = tile % q_tiles, h = (tile / q_tiles) % H,
                  b = tile / q_tiles / H;
        hopper::mbar_wait_or_trap(q_empty, q_phase ^ 1);
        hopper::mbar_expect_tx(q_full, P::kQBytes);
#pragma unroll
        for (int c = 0; c < P::kBoxes; ++c)
          hopper::tma_load_4d(q_box + c * kBQ * 128, &tm_q, 64 * c, qt * kBQ,
                              h, b, q_full);
        q_phase ^= 1;
        for (int j = 0; j < n_kt; ++j) {
          hopper::mbar_wait_or_trap(&k_empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&k_full[stage], P::kKVBytes);
#pragma unroll
          for (int c = 0; c < P::kBoxes; ++c)
            hopper::tma_load_4d(k_tile(stage) + c * kBN * 128, &tm_k, 64 * c,
                                j * kBN, h, b, &k_full[stage]);
          hopper::mbar_wait_or_trap(&v_empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&v_full[stage], P::kKVBytes);
#pragma unroll
          for (int c = 0; c < P::kBoxes; ++c)
            hopper::tma_load_4d(v_tile(stage) + c * kBN * 128, &tm_v, 64 * c,
                                j * kBN, h, b, &v_full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    if constexpr (kConsumers > 1) hopper::setmaxnreg_inc<P::kConsumerRegs>();
    const int cw = wg - 1;  // this consumer's 64 rows of each work tile
    const int wtid = threadIdx.x % 128;
    const int warp = wtid / 32, lane = wtid % 32;
    const int g = lane / 4, t = lane % 4;
    // Ping-pong: consumer cw issues after named barrier 1 + cw, then lets
    // the next one go; the last one lets the first go at the start.
    auto turn_wait = [&] {
      if constexpr (P::kTurns) hopper::bar_sync(1 + cw, 256);
    };
    auto turn_pass = [&] {
      if constexpr (P::kTurns)
        hopper::bar_arrive(1 + (cw + 1) % kConsumers, 256);
    };
    if (P::kTurns && cw == kConsumers - 1) hopper::bar_arrive(1, 256);

    uint32_t qa[D / 16][4];  // scaled q, the A of QK^T
    float sc[kBN / 2];       // scores, then P in f32
    uint32_t pa[kBN / 16][4];  // P in bf16, the A of P V
    float acc[D / 2];        // o, unnormalised
    float m[2], l[2], alpha[2];  // rows g and g + 8 of this warp
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;

    // Ring slot and phase of the it-th key tile this block visits (over
    // all its work tiles; the K and V rings advance together).
    auto slot = [](int it) { return it % kStages; };
    auto parity = [](int it) {
      return static_cast<uint32_t>(it / kStages) & 1;
    };
    auto release = [&](uint64_t* bar) {
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    // Issue sc = q K^T of key tile it, once its K tile is in.
    auto issue_qk = [&](int it) {
      hopper::mbar_wait_or_trap(&k_full[slot(it)], parity(it));
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::wgmma_rs<kBN>(
            sc, qa[ks],
            hopper::desc_sw128(k_tile(slot(it)) + (ks / 4) * kBN * 128) +
                2 * (ks % 4),
            ks > 0);
      hopper::wgmma_commit();
    };
    // Rescale o by the last softmax's alpha (skipped where every alpha of
    // the warp is 1: o * 1 is o), then issue o += P V of key tile it once
    // its V tile is in.
    auto issue_pv = [&](int it) {
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * n + e] *= alpha[e >> 1];
      }
      hopper::mbar_wait_or_trap(&v_full[slot(it)], parity(it));
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        hopper::wgmma_rs<D, 1>(
            acc, pa[kk],
            hopper::desc_sw128_mn(v_tile(slot(it)) + kk * 16 * 128,
                                  kBN * 128));
      hopper::wgmma_commit();
    };
    // The online-softmax update of the scores of keys k0 .. k0 + kBN - 1:
    // keys >= L masked, the running max (a tree: exact in any order),
    // alpha (the rescale of o and l) and P = exp(score - max) in f32 in
    // place, summed into l in key order.
    auto softmax = [&](int k0) {
      if (k0 + kBN > L) {
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * n + 2 * t + (e & 1) >= L) sc[4 * n + e] = kNeg;
      }
      float mx[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[kBN / 8];
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
          v[n] = fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]);
        fold_max<kBN / 16>(v);
        mx[r] = v[0];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = flash_exp(m[r], m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = flash_exp(sc[4 * n + e], m[e >> 1]);
          sc[4 * n + e] = p;
          l[e >> 1] += p;
        }
    };
    // P to bf16 in the A layout: k16 step kk takes n8 blocks 2kk, 2kk + 1.
    auto to_pa = [&] {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        pa[kk][0] = pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    int it0 = 0;  // key tiles visited before this work tile
    uint32_t q_phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int qt = tile % q_tiles, h = (tile / q_tiles) % H,
                b = tile / q_tiles / H;
      hopper::mbar_wait_or_trap(q_full, q_phase);
      q_phase ^= 1;
      load_q<D, kBQ>(qa, q_box, cw * 64 + warp * 16, scale, g, t);
      hopper::mbar_arrive(q_empty);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      m[0] = m[1] = kNeg;
      l[0] = l[1] = 0.f;

      // Key tile 0: QK^T alone.
      turn_wait();
      issue_qk(it0);
      turn_pass();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      release(&k_empty[slot(it0)]);
      softmax(0);
      to_pa();
      // Key tile j: its QK^T and tile j - 1's P V in flight together; the
      // softmax of tile j runs while P V does. P goes to pa only once P V
      // is done: ptxas makes every wgmma of the kernel synchronous if a
      // wgmma's A registers are written while another wgmma is in flight
      // (C7513).
      for (int j = 1; j < n_kt; ++j) {
        turn_wait();
        issue_qk(it0 + j);
        issue_pv(it0 + j - 1);
        turn_pass();
        hopper::wgmma_wait<1>();  // QK^T done (groups retire in order)
        hopper::fence_regs(sc);
        release(&k_empty[slot(it0 + j)]);
        softmax(j * kBN);
        // The softmax's results pinned before the wait, so that it runs
        // while P V does.
        hopper::fence_regs(sc);
        hopper::fence_regs(l);
        hopper::wgmma_wait<0>();  // P V done
        hopper::fence_regs(acc);
        hopper::fence_a(pa);
        release(&v_empty[slot(it0 + j - 1)]);
        to_pa();
      }
      // The last tile's P V.
      turn_wait();
      issue_pv(it0 + n_kt - 1);
      turn_pass();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_a(pa);
      release(&v_empty[slot(it0 + n_kt - 1)]);
      it0 += n_kt;

      // The full row sums (across the quad); the output of row
      // 16 warp + g + 8r, column 8n + 2t + c is acc[4n + 2r + c] / l[r].
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      __nv_bfloat16* ob = o + b * ov.bs + h * ov.hs;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qt * kBQ + cw * 64 + warp * 16 + g + 8 * r;
        if (row >= S) continue;
        __nv_bfloat16* orow = ob + row * ov.rs + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n) =
              pack_bf16x2(acc[4 * n + 2 * r] / l[r],
                          acc[4 * n + 2 * r + 1] / l[r]);
      }
    }
  }
}

// The host helpers keep function-local statics: in an unnamed namespace
// each library has its own.
namespace {

// Tensor map of a strided bf16 [B, H, rows, D] view (View strides in
// elements; 16-byte aligned rows) read in boxes of 64 columns x box_rows
// rows of one head, 128-byte swizzle; reads past `rows` are 0.
int make_map(CUtensorMap* map, const void* ptr, View v, int rows, int H,
             int B, int D, int box_rows) {
  gemm::EncodeTiled fn = gemm::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // A dimension of one element is never stepped; give it a valid stride.
  const long long row_bytes = 2 * v.rs;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(row_bytes),
      static_cast<cuuint64_t>(H == 1 ? row_bytes : 2 * v.hs),
      static_cast<cuuint64_t>(B == 1 ? row_bytes : 2 * v.bs)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The SM count of the current device, with the kernel's dynamic shared
// memory limit raised there: both once per library and device.
template <int D, int kConsumers, int kBN, int kStages>
int prepare(int* sms) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> ready[kMaxDevices];  // SM count; 0 until set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && (*sms = ready[dev].load(std::memory_order_acquire)) > 0)
    return 0;
  e = cudaFuncSetAttribute(
      flash_kernel<D, kConsumers, kBN, kStages>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      Plan<D, kConsumers, kBN, kStages>::kSmemBytes);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cached) ready[dev].store(*sms, std::memory_order_release);
  return 0;
}

}  // namespace

template <int D, int kConsumers, int kBN, int kStages>
int launch_d(const void* q, const void* k, const void* v, void* o, View qv,
             View kv, View vv, View ov, int B, int S, int L, int H,
             float scale, cudaStream_t st) {
  using P = Plan<D, kConsumers, kBN, kStages>;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, qv, S, H, B, D, P::kBQ);
  if (err == 0) err = make_map(&tk, k, kv, L, H, B, D, kBN);
  if (err == 0) err = make_map(&tv, v, vv, L, H, B, D, kBN);
  int sms = 0;
  if (err == 0) err = prepare<D, kConsumers, kBN, kStages>(&sms);
  if (err != 0) return err;
  const long long q_tiles = (S + P::kBQ - 1) / P::kBQ;
  const long long tiles = q_tiles * H * B;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  flash_kernel<D, kConsumers, kBN, kStages>
      <<<grid, P::kThreads, P::kSmemBytes, st>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o), ov, S, L, H,
          static_cast<int>(q_tiles), static_cast<int>(tiles), scale);
  return static_cast<int>(cudaGetLastError());
}

// What every entry launches: checks what TMA needs (16-byte aligned
// pointers and strides), then the kernel of head dim D.
inline int launch_flat(const void* q, const void* k, const void* v, void* o,
                       View qv, View kv, View vv, View ov, int B, int S,
                       int L, int H, int D, float scale, void* stream) {
  if (B < 1 || S < 1 || L < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const View& w : {qv, kv, vv, ov})
    if (w.bs % 8 != 0 || w.hs % 8 != 0 || w.rs % 8 != 0 || w.rs <= 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (!gemm::aligned16({q, k, v, o}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 && S >= kLongRows)
    return launch_d<64, kConsumersD64Long, kKeysD64, kStagesD64>(
        q, k, v, o, qv, kv, vv, ov, B, S, L, H, scale, st);
  if (D == 64)
    return launch_d<64, kConsumersD64, kKeysD64, kStagesD64>(
        q, k, v, o, qv, kv, vv, ov, B, S, L, H, scale, st);
  if (D == 128)
    return launch_d<128, kConsumersD128, kKeysD128, kStagesD128>(
        q, k, v, o, qv, kv, vv, ov, B, S, L, H, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
}  // namespace pnp
