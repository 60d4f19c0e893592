// K6: one fused mean-field iteration of the strided, materialised CRF.
//
// Replaces pnp_ovss_tpu/ops/bilateral_pallas.py::crf_fused_iteration
// (pallas_call at :320, body _crf_iter_kernel at :234).
//
// Per pixel column n:
//   y[r]   = sum_m qsub[r, m] * K^T[m, n]     (uint8 K^T dequantised to
//                                              bf16 exactly: 0..255)
//   e[r]   = nb[n] * y[r] + msp[r, n] + u[r, n]
//   out[r] = softmax of e over the rows of each of v variant blocks of c
//            rows ([vi*c, (vi+1)*c)); rows >= v*c are exactly 0.
// nb carries bi_w * norm_bi and the 1/255 dequantisation scale, so the
// kernel multiplies by the raw stored codes. u, msp and out are bf16; the
// energies and the softmax run in f32 and the output is rounded to bf16
// once.
//
// Bound on the H100 SXM at the main-path shape (R = 64 rows for v = 2
// blocks of c = 29, M = 2304, N = 36864): 85 MB of K^T plus 14 MB of
// u/msp/out (bf16) are 99 MB, 30 us at 3.35 TB/s; the product is
// 2*R*M*N = 10.9 GFLOP, 11 us at 989 TFLOP/s bf16. Bytes bound: K^T must
// be read exactly once, at close to the memory's rate.
//
// Design: the tile is computed transposed, out^T[n, r] = K[n, m] qsub^T,
// on wgmma m64n64k16 with A (the pixels' dequantised codes) in registers
// and B (qsub, anchors contiguous: K-major as stored) in shared memory.
// - One block of kWarpgroups warpgroups per slab of 128 * kWarpgroups
//   columns; each warpgroup owns two m64 tiles, 128 columns. K^T is read
//   from device memory exactly once over the grid.
// - A ring of kStages stages in dynamic shared memory fed by TMA (one
//   thread issues two 2-D box loads a k-step and arms the stage's
//   mbarrier; one barrier a k-step frees the slot of the last): each
//   stage holds the block's [64, 128] uint8 K^T tile and the [64, 64]
//   bf16 qsub tile, both 128-byte swizzled (the layout the wgmma
//   descriptor reads for qsub, and conflict-free byte loads for K^T).
//   TMA zero-fills past M, N and R, so R in {16, .., 64}, a last k-step
//   past M and a last slab past N need no other case.
// - The codes are widened in registers straight into wgmma's A fragments:
//   row g (+8) of a warp's 16 in tile i is slab column 4 (8w + g) + 2h + i,
//   so one 4-byte load per k row gives a thread the bytes of both tiles
//   and both row halves; each bf16 pair comes from two bytes by prmt into
//   the f32 2^23 + code, a subtraction of 2^23 (exact) and one cvt to
//   bf16x2. No scalar stores, no transposed copy.
// - A k-step widens all its codes (four k16 steps, two tiles) and then
//   issues its eight products back to back; they run while the next
//   k-step waits for its data and the barrier, and are waited for only
//   before that k-step refills the slot they read.
// - Once the ring is drained, the slab's u and msp rows are copied into
//   it by cp.async while the f32 result [R, kBN] is staged beside them,
//   so the epilogue waits on device memory once, not once a row. In the
//   epilogue each thread owns two columns of one variant block: energy,
//   softmax and the stores, coalesced across the warp, so the state
//   between the product and the next state never reaches device memory.
// wgmma, not mma.sync: with qsub through ldmatrix and 16 products a warp
// and k16 step, issuing the products and fragment loads took most of the
// kernel's time (PERF.md section 6).

#include <atomic>
#include <initializer_list>

#include "wgmma_gemm.cuh"

namespace {

constexpr int kWarpgroups = 1;          // per block
constexpr int kBN = 128 * kWarpgroups;  // columns per block (one thread each)
constexpr int kStages = 4;              // ring depth
constexpr int kBK = 64;                 // anchors per stage: one swizzle row
constexpr int kMaxR = 64;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kQTile = kMaxR * kBK * 2;  // bytes, 1024-aligned
constexpr int kKTile = kBK * 128;        // bytes, one warpgroup's tile
constexpr int kStageBytes = kQTile + kWarpgroups * kKTile;
// The epilogue's layout in the drained ring: the staged f32 result, then
// the slab's u and msp rows (bf16, kBN a row).
constexpr int kLdY = kBN + 1;  // f32 per staged result row
constexpr int kYBytes = (kMaxR * kLdY * 4 + 15) / 16 * 16;
constexpr int kEpiBytes = kYBytes + 2 * kMaxR * kBN * 2;
constexpr int kRingBytes =
    kStages * kStageBytes > kEpiBytes ? kStages * kStageBytes : kEpiBytes;
constexpr int kSmemBytes = kRingBytes + kStages * 8 + 1024;

// 16-byte global -> shared copy; zeros when !valid (src is not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   pnp::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Waits for the phase of parity `parity` of a stage's barrier; traps (a
// launch error, not a hang) if the bytes it expects never arrive.
__device__ __forceinline__ void wait_stage(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = pnp::smem_addr(bar);
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (spin > (1ll << 26)) __trap();
  }
}

// bf16 pair {byte j of lo, byte j of hi}: each byte as the f32 2^23 + b,
// less 2^23 (exact), rounded to bf16 (exact: b <= 255).
__device__ __forceinline__ uint32_t dequant_pair(uint32_t lo, uint32_t hi,
                                                 int j) {
  const float flo =
      __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7440 + j)) - 8388608.f;
  const float fhi =
      __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7440 + j)) - 8388608.f;
  return pnp::pack_bf16x2(flo, fhi);
}

// K^T and qsub through their tensor maps (boxes of 128 x 64 bytes and
// 64 x 64 bf16, 128-byte swizzle).
__global__ void __launch_bounds__(kThreads) crf_iter_kernel(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_q,
    const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ msp,
    const float* __restrict__ nb, __nv_bfloat16* __restrict__ out, int R,
    int M, int N, int v, int c) {
  extern __shared__ unsigned char smem_raw[];
  // Stages on a 1024-byte boundary (the swizzle's period).
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kBN;
  const int k_tiles = (M + kBK - 1) / kBK;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  auto q_tile = [&](int slot) { return smem + slot * kStageBytes; };
  auto k_tile = [&](int slot) {
    return smem + slot * kStageBytes + kQTile + wg * kKTile;
  };
  // Thread 0: k-step kb's tiles into its slot, completing its barrier.
  auto load = [&](int kb) {
    const int slot = kb % kStages;
    pnp::hopper::mbar_expect_tx(&full[slot], kStageBytes);
    pnp::hopper::tma_load_2d(q_tile(slot), &tm_q, kb * kBK, 0, &full[slot]);
    for (int w = 0; w < kWarpgroups; ++w)
      pnp::hopper::tma_load_2d(smem + slot * kStageBytes + kQTile + w * kKTile,
                               &tm_k, n0 + 128 * w, kb * kBK, &full[slot]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) pnp::hopper::mbar_init(&full[s], 1);
    pnp::hopper::mbar_fence_init();
  }
  __syncthreads();

  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;

  if (tid == 0)
    for (int s = 0; s < kStages - 1 && s < k_tiles; ++s) load(s);
  // This thread's four columns 4 (8w + g) + {0, 1, 2, 3} of its
  // warpgroup's 128: byte 2h + i is row g + 8h of tile i. In the swizzled
  // K^T tile row r's 16-byte chunk x sits at chunk x ^ (r % 8).
  const int wc = (warp * 8 + g) * 4;
  auto k_word = [&](const unsigned char* ks, int r) {
    return *reinterpret_cast<const uint32_t*>(
        ks + r * 128 + (((wc / 16) ^ (r % 8)) * 16) + wc % 16);
  };
  uint32_t a[kBK / 16][2][4] = {};  // [k16 step][tile][fragment]
  for (int kb = 0; kb < k_tiles; ++kb) {
    // The last k-step's products are done: its A registers are free, and
    // after the barrier so is its slot, which this k-step refills.
    pnp::hopper::wgmma_wait<0>();
    pnp::hopper::fence_a(a);
#pragma unroll
    for (int i = 0; i < 2; ++i) pnp::hopper::fence_regs(acc[i]);
    __syncthreads();
    if (tid == 0 && kb + kStages - 1 < k_tiles) load(kb + kStages - 1);
    wait_stage(&full[kb % kStages], (kb / kStages) & 1);

    // The stage's codes, widened into A fragments, then its eight
    // products issued back to back; they run while the next k-step waits
    // for its data.
    const unsigned char* ks = k_tile(kb % kStages);
    const uint64_t db = pnp::hopper::desc_sw128(q_tile(kb % kStages));
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      const int r = s * 16 + 2 * t;
      const uint32_t w0 = k_word(ks, r), w1 = k_word(ks, r + 1);
      const uint32_t w8 = k_word(ks, r + 8), w9 = k_word(ks, r + 9);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[s][i][0] = dequant_pair(w0, w1, i);      // row g, k 2t..
        a[s][i][1] = dequant_pair(w0, w1, 2 + i);  // row g + 8
        a[s][i][2] = dequant_pair(w8, w9, i);      // row g, k 2t + 8..
        a[s][i][3] = dequant_pair(w8, w9, 2 + i);
      }
    }
    pnp::hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        pnp::hopper::wgmma_rs<64>(acc[i], a[s][i], db + 2 * s);
    pnp::hopper::wgmma_commit();
  }
  pnp::hopper::wgmma_wait<0>();
  pnp::hopper::fence_a(a);
#pragma unroll
  for (int i = 0; i < 2; ++i) pnp::hopper::fence_regs(acc[i]);
  __syncthreads();  // the ring is drained: its memory holds the epilogue's

  float* ys = reinterpret_cast<float*>(smem);
  __nv_bfloat16* us = reinterpret_cast<__nv_bfloat16*>(smem + kYBytes);
  __nv_bfloat16* ms = us + kMaxR * kBN;
  const int vc = v * c;
  for (int ch = tid; ch < 2 * vc * (kBN / 8); ch += kThreads) {
    const int which = ch / (vc * (kBN / 8)), rest = ch % (vc * (kBN / 8));
    const int r = rest / (kBN / 8), col = (rest % (kBN / 8)) * 8;
    const bool ok = n0 + col < N;
    const __nv_bfloat16* src = which ? msp : u;
    cp_async16_zfill((which ? ms : us) + r * kBN + col,
                     ok ? src + (long long)r * N + n0 + col : src, ok);
  }
  pnp::cp_async_commit();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * j + 2 * t + e;
          if (r < R)
            ys[r * kLdY + wg * 128 + wc + 2 * h + i] =
                acc[i][4 * j + 2 * h + e];
        }
  pnp::cp_async_wait<0>();
  __syncthreads();

  // Epilogue: thread tid owns columns 2p, 2p + 1 of the slab (p = tid %
  // (kBN / 2)) in variant block tid / (kBN / 2), with 4-byte loads and
  // stores (a warp reads and writes 128 contiguous bytes a row).
  const int vi = tid / (kBN / 2), col = 2 * (tid % (kBN / 2));
  const long long n = n0 + col;
  if (n >= N) return;
  if (vi < v) {
    const float2 nbv = *reinterpret_cast<const float2*>(nb + n);
    const int lo = vi * c, hi = lo + c;
    float mv0 = -1e30f, mv1 = -1e30f;
#pragma unroll 4
    for (int r = lo; r < hi; ++r) {
      const float2 sp = pnp::unpack_bf16x2(
          *reinterpret_cast<const uint32_t*>(ms + r * kBN + col));
      const float2 un = pnp::unpack_bf16x2(
          *reinterpret_cast<const uint32_t*>(us + r * kBN + col));
      float* y = ys + r * kLdY + col;
      // No contraction: the same rounding steps as the plain version.
      const float e0 = __fadd_rn(__fadd_rn(__fmul_rn(nbv.x, y[0]), sp.x), un.x);
      const float e1 = __fadd_rn(__fadd_rn(__fmul_rn(nbv.y, y[1]), sp.y), un.y);
      y[0] = e0;
      y[1] = e1;
      mv0 = fmaxf(mv0, e0);
      mv1 = fmaxf(mv1, e1);
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll 4
    for (int r = lo; r < hi; ++r) {
      float* y = ys + r * kLdY + col;
      const float p0 = expf(y[0] - mv0), p1 = expf(y[1] - mv1);
      y[0] = p0;
      y[1] = p1;
      sum0 += p0;
      sum1 += p1;
    }
#pragma unroll 4
    for (int r = lo; r < hi; ++r) {
      const float* y = ys + r * kLdY + col;
      *reinterpret_cast<uint32_t*>(out + (long long)r * N + n) =
          pnp::pack_bf16x2(y[0] / sum0, y[1] / sum1);
    }
  }
  for (int r = v * c + vi; r < R; r += 2)
    *reinterpret_cast<uint32_t*>(out + (long long)r * N + n) = 0u;
}

// Tensor map of the row-major uint8 [rows, cols] K^T read in boxes of 128
// columns x 64 rows with 128-byte swizzle; out-of-range reads are 0.
int make_map_u8(CUtensorMap* map, const void* ptr, int rows, int cols) {
  pnp::gemm::EncodeTiled fn = pnp::gemm::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(kBK)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's shared-memory limit raised once per library and device.
int prepare() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && ready[dev].load(std::memory_order_acquire)) return 0;
  e = cudaFuncSetAttribute(crf_iter_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cached) ready[dev].store(true, std::memory_order_release);
  return 0;
}

}  // namespace

// qsub [R, M] bf16, kt [M, N] uint8, u/msp/out [R, N] bf16, nb [*, N] f32
// (row 0 read), all contiguous and 16-byte aligned. R % 16 == 0,
// R <= 64, M % 32 == 0, N % 128 == 0 (any N: the last slab is masked),
// v in {1, 2}, v * c <= R.
extern "C" int crf_fused_iteration(const void* qsub, const void* kt,
                                   const void* u, const void* msp,
                                   const void* nb, void* out, int R, int M,
                                   int N, int v, int c, void* stream) {
  if (R < 16 || R % 16 != 0 || R > kMaxR || M <= 0 || M % 32 != 0 ||
      N <= 0 || N % 128 != 0 || v < 1 || v > 2 || c < 1 || v * c > R)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p :
       std::initializer_list<const void*>{qsub, kt, u, msp, nb, out})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tm_k, tm_q;
  int err = make_map_u8(&tm_k, kt, M, N);
  if (err == 0) err = pnp::gemm::make_map(&tm_q, qsub, R, M, kMaxR);
  if (err == 0) err = prepare();
  if (err != 0) return err;
  crf_iter_kernel<<<(N + kBN - 1) / kBN, kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      tm_k, tm_q, static_cast<const __nv_bfloat16*>(u),
      static_cast<const __nv_bfloat16*>(msp), static_cast<const float*>(nb),
      static_cast<__nv_bfloat16*>(out), R, M, N, v, c);
  return static_cast<int>(cudaGetLastError());
}
