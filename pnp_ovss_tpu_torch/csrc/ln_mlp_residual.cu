// K3: LayerNorm + the whole MLP + the residual,
// y = x + gelu(LN(x) @ W1^T + b1) @ W2^T + b2.
//
// Replaces pnp_ovss_tpu/ops/vit_block_pallas.py::ln_mlp_residual
// (pallas_call at :316, body _ln_mlp_kernel at :225).
//
// x [M, D] bf16, gamma/beta [D] f32, W1 [F, D] and W2 [D, F] bf16
// (nn.Linear layout), b1 [F], b2 [D] bf16 -> y [M, D] bf16. The reference's
// value flow: f32 two-pass LayerNorm rounded to bf16; fc1 with f32
// accumulation, + b1 in f32, rounded to bf16; the exact-erf gelu in bf16
// steps, with erf the clamped minimax polynomial evaluated in f32 (no erff:
// its values round differently on some bf16 codes); fc2 with f32
// accumulation, + b2 in f32, rounded to bf16; then x + that, rounded once
// more.
//
// Bound on the H100 SXM at the main-path shapes (D = 1024, F = 4096;
// M = 15470 at 336 px, 27660 at 768 px): 259.5 / 464 GFLOP, 0.262 /
// 0.469 ms at 989 TFLOP/s bf16, against 0.08 / 0.13 GB of x, weights and
// y. Bound by operations.
//
// Design. The TPU kernel keeps the [rows, F] hidden on chip and carries an
// f32 [rows, D] accumulator across grid steps over F. On this card an f32
// accumulator of D = 1024 allows only 32-row tiles, which re-stream both
// weights from L2 once per 32 rows and keep the products on mma.sync. The
// hidden instead makes one round trip through device memory (2 * M * F * 2
// bytes, 0.08 / 0.14 ms at 3.35 TB/s, under a third of the operations
// bound), and one call runs three kernels on the caller's buffers:
//   1. a row LayerNorm, x -> xn (bf16), one warp per row;
//   2. fc1, xn @ W1^T, with the epilogue + b1, round, gelu -> g (bf16);
//   3. fc2, g @ W2^T, with the epilogue + b2, round, + x, round -> y.
// Both products are one wgmma GEMM: a persistent grid of one block per SM
// walks 128 x 256 output tiles (N fastest, so concurrent tiles share their
// A rows in L2), with three roles in warpgroups:
// - one producer thread feeds a 3-stage ring of 64-deep A and B tiles by
//   TMA (2-D tensor maps, 128-byte swizzle, mbarrier transaction counts)
//   and runs ahead into the next tile;
// - two consumer warpgroups each run wgmma m64n256k16 on 64 rows of the
//   tile (128 f32 accumulators a thread), keeping one k-step of products in
//   flight and releasing each stage when its products are done, then stage
//   y = bf16(acc + bias) in shared memory and go on to the next tile;
// - three epilogue warps turn the staged tile into the output (fc1's
//   gelu, ~40 dependent f32 steps a value, or fc2's residual) with
//   coalesced 16-byte stores while the tensor cores run the next tile.
// Storing straight from the accumulators, with the tensor cores idle
// meanwhile, took 45% of the call (kernel_ablation.py's no_epilogue,
// PERF.md). setmaxnreg moves registers from the producer's and the
// epilogue's warpgroup (56) to the consumers (224). TMA zero-fills the M,
// N and K tails, so M is any value >= 1; the epilogue stores only rows < M
// and columns < N.

#include <dlfcn.h>

#include "hopper.cuh"

namespace {

namespace hw = pnp::hopper;

constexpr int kBM = 128;  // two consumer warpgroups of 64 rows
constexpr int kBN = 256;
constexpr int kBK = 64;   // 128 bytes of bf16: one swizzle row
constexpr int kStages = 3;
// Warpgroups 0 and 1 consume (wgmma m64n256: 128 accumulators a thread,
// so the block can have no more than 384 threads); in warpgroup 2 one
// thread produces (TMA) and warps 1-3 run the epilogue. Registers a thread
// after setmaxnreg: the 384 threads start at 168 and the two counts below
// stay within the same 64512.
constexpr int kThreads = 384;
constexpr int kEpilogueThreads = 96;
constexpr int kConsumerRegs = 224, kSideRegs = 56;
static_assert(2 * kConsumerRegs + kSideRegs <= 3 * 168,
              "register counts must fit the block's allocation");
constexpr int kATile = kBM * kBK * 2;
constexpr int kBTile = kBN * kBK * 2;
constexpr int kStageBytes = kATile + kBTile;
// The staged [128, 256] bf16 tile; rows padded by 16 bytes so that the
// consumers' 4-byte stores and the epilogue's 16-byte loads hit distinct
// banks.
constexpr int kLdY = kBN + 8;
constexpr int kYBytes = kBM * kLdY * 2;
constexpr size_t kSmemBytes =
    size_t(kStages) * kStageBytes + kYBytes + 1024 + 256;

// The JAX package's erf coefficients (vit_block_pallas.py _ERF_P), the
// doubles rounded to f32 as the reference's jnp.float32(c) rounds them.
__constant__ float kErfP[10] = {
    1.128379139571155,      -0.3761252259731045,
    0.11282976424513898,    -0.026843839553998192,
    0.0051925774717181995,  -0.0008290527520228961,
    0.00010732167832988502, -1.0523825720237124e-05,
    6.793275336392753e-07,  -2.1076366182700845e-08};

// gelu of a bf16 value y (held in f32), rounded to bf16 after every step
// as the reference's bf16 arithmetic does; no contraction into FMAs. The
// reference divides by bf16(sqrt(2)) = 181/128. An exact quotient y * 128
// / 181 of a bf16 y never lies on or within 2^-17 (relative) of a bf16
// rounding midpoint, so rounding the f32 product with the f32 reciprocal
// gives the same bf16 value as rounding the quotient (checked on every
// finite bf16 code); and e + 1 halved is exact in bf16.
__device__ __forceinline__ float gelu_bf16(float y) {
  const float inv_sqrt2 = 1.0f / 1.4140625f;  // 1 / bf16(sqrt(2)), in f32
  const float tt = pnp::round_bf16(__fmul_rn(y, inv_sqrt2));
  const float xc = fminf(fmaxf(tt, -2.2f), 2.2f);
  const float x2 = __fmul_rn(xc, xc);
  float p = kErfP[9];
#pragma unroll
  for (int i = 8; i >= 0; --i)
    p = __fadd_rn(__fmul_rn(p, x2), kErfP[i]);
  const float e = pnp::round_bf16(__fmul_rn(xc, p));
  const float half = __fmul_rn(pnp::round_bf16(__fadd_rn(e, 1.f)), 0.5f);
  return pnp::round_bf16(__fmul_rn(y, half));
}

// Row LayerNorm: one warp per row of D bf16 values, 16-byte chunks spread
// over the lanes. f32 mean, then the f32 mean of squared deviations (two
// passes, as the reference), then (x - mu) * rsqrt(var + eps) * gamma +
// beta rounded to bf16 once.
template <int D>
__global__ void __launch_bounds__(256) layer_norm_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, __nv_bfloat16* __restrict__ xn, int M,
    float eps) {
  constexpr int kChunks = D / 8;
  constexpr int kPer = (kChunks + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + warp;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + row * D;
  float v[kPer][8];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int chunk = lane + 32 * c;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (chunk < kChunks) raw = *reinterpret_cast<const uint4*>(xr + chunk * 8);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = pnp::unpack_bf16x2(w[i]);
      v[c][2 * i] = f.x;
      v[c][2 * i + 1] = f.y;
      s += f.x + f.y;
    }
  }
  const float mu = pnp::warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    if (lane + 32 * c >= kChunks) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = v[c][i] - mu;
      q += a * a;
    }
  }
  const float rs = rsqrtf(pnp::warp_sum(q) / D + eps);
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk >= kChunks) continue;
    const int col = chunk * 8;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = col + 2 * i;
      w[i] = pnp::pack_bf16x2(
          (v[c][2 * i] - mu) * rs * gamma[j] + beta[j],
          (v[c][2 * i + 1] - mu) * rs * gamma[j + 1] + beta[j + 1]);
    }
    *reinterpret_cast<uint4*>(xn + row * D + col) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

enum Epilogue { kFc1Gelu, kFc2Residual };

// out[M, N] = epilogue(A[M, K] @ B[N, K]^T): A and B through their tensor
// maps (boxes of 64 x 128 and 64 x 256, 128-byte swizzle). The consumers
// stage y = bf16(acc + bias) of each tile in shared memory; the epilogue
// warpgroup turns it into out: kFc1Gelu gelu(y), kFc2Residual
// bf16(resid + y).
template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1) mlp_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a,
    const __grid_constant__ CUtensorMap tm_b,
    const __nv_bfloat16* __restrict__ bias,
    const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ out,
    int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // Tiles on a 1024-byte boundary (the swizzle's period), then the staged
  // tile, then the barriers.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* ys =
      reinterpret_cast<__nv_bfloat16*>(smem + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes +
                                               kYBytes);
  uint64_t* empty = full + kStages;
  uint64_t* y_full = empty + kStages;  // the staged tile is written
  uint64_t* y_empty = y_full + 1;      // ... and read out again
  auto a_tile = [&](int s) { return smem + s * kStageBytes; };
  auto b_tile = [&](int s) { return smem + s * kStageBytes + kATile; };

  const int wg = threadIdx.x / 128;
  const int wtid = threadIdx.x % 128;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int k_tiles = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hw::mbar_init(y_full, 256);  // every consumer thread
    hw::mbar_init(y_empty, kEpilogueThreads);  // every epilogue thread
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // Warp 0 produces, warps 1-3 run the epilogue.
    hw::setmaxnreg_dec<kSideRegs>();
    if (wtid < 32) {
      // Producer: one thread keeps the ring full, tile after tile.
      if (wtid == 0) {
        int stage = 0;
        uint32_t phase = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * kBN;
          for (int kb = 0; kb < k_tiles; ++kb) {
            hw::mbar_wait(&empty[stage], phase ^ 1);  // the slot is free
            hw::mbar_expect_tx(&full[stage], kStageBytes);
            hw::tma_load_2d(a_tile(stage), &tm_a, kb * kBK, m0,
                            &full[stage]);
            hw::tma_load_2d(b_tile(stage), &tm_b, kb * kBK, n0,
                            &full[stage]);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else {
      // Epilogue: reads the staged tile 16 bytes a thread (a warp takes one
      // row), writes out with coalesced 16-byte stores, and frees the stage
      // while the consumers already run the next tile's products.
      const int etid = wtid - 32;
      uint32_t phase = 0;
      const int chunk = etid % (kBN / 8);  // 8 columns a chunk
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * kBN;
        const int col = n0 + chunk * 8;
        hw::mbar_wait(y_full, phase);
#pragma unroll 2
        for (int row = etid / (kBN / 8); row < kBM;
             row += kEpilogueThreads / (kBN / 8)) {
          const uint4 yv =
              *reinterpret_cast<const uint4*>(ys + row * kLdY + chunk * 8);
          const int grow = m0 + row;
          if (grow >= M || col >= N) continue;
          const long long off = static_cast<long long>(grow) * N + col;
          const uint32_t y[4] = {yv.x, yv.y, yv.z, yv.w};
          uint32_t o[4];
          if constexpr (kEpi == kFc1Gelu) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 f = pnp::unpack_bf16x2(y[i]);
              o[i] = pnp::pack_bf16x2(gelu_bf16(f.x), gelu_bf16(f.y));
            }
          } else {
            const uint4 xv = *reinterpret_cast<const uint4*>(resid + off);
            const uint32_t x[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 f = pnp::unpack_bf16x2(y[i]);
              const float2 r = pnp::unpack_bf16x2(x[i]);
              o[i] = pnp::pack_bf16x2(r.x + f.x, r.y + f.y);
            }
          }
          *reinterpret_cast<uint4*>(out + off) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
        hw::mbar_arrive(y_empty);
        phase ^= 1;
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile.
    hw::setmaxnreg_inc<kConsumerRegs>();
    const int warp = wtid / 32, lane = wtid % 32;
    const int g = lane / 4, t = lane % 4;
    float acc[128];
    int stage = 0;
    uint32_t phase = 0, y_phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * kBN;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < k_tiles; ++kb) {
        hw::mbar_wait(&full[stage], phase);
        const uint64_t da = hw::desc_sw128(a_tile(stage) + wg * 64 * 128);
        const uint64_t db = hw::desc_sw128(b_tile(stage));
        hw::fence_regs(acc);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          hw::wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk);
        hw::wgmma_commit();
        hw::fence_regs(acc);
        hw::wgmma_wait<1>();  // the previous k-step's products are done
        if (prev >= 0 && lane == 0) hw::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
      if (prev >= 0 && lane == 0) hw::mbar_arrive(&empty[prev]);

      // y = bf16(acc + bias) into the staged tile, once the epilogue has
      // read out the last one.
      hw::mbar_wait(y_empty, y_phase ^ 1);
      const int row = wg * 64 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = j * 8 + 2 * t;
        float2 bb = make_float2(0.f, 0.f);
        if (n0 + col < N)
          bb = pnp::unpack_bf16x2(
              *reinterpret_cast<const uint32_t*>(bias + n0 + col));
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(ys + (row + 8 * r) * kLdY + col) =
              pnp::pack_bf16x2(acc[4 * j + 2 * r] + bb.x,
                               acc[4 * j + 2 * r + 1] + bb.y);
      }
      hw::mbar_arrive(y_full);
      y_phase ^= 1;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// already loaded (so the build needs no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// Tensor map of a row-major bf16 [rows, cols] array read in boxes of 64
// columns x box_rows rows with 128-byte swizzle; out-of-range reads are 0.
int make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
             int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// out[M, N] = epilogue(a[M, K] @ b[N, K]^T) on a persistent grid.
template <int kEpi>
int launch_gemm(const void* a, const void* b, const void* bias,
                const void* resid, void* out, int M, int N, int K,
                cudaStream_t st) {
  CUtensorMap tm_a, tm_b;
  int err = make_map(&tm_a, a, M, K, kBM);
  if (err == 0) err = make_map(&tm_b, b, N, K, kBN);
  if (err != 0) return err;
  auto* kern = mlp_gemm_kernel<kEpi>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int grid = tiles < sms ? tiles : sms;
  kern<<<grid, kThreads, kSmemBytes, st>>>(
      tm_a, tm_b, static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(resid),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_ln(const void* x, const void* gamma, const void* beta, void* xn,
              int M, float eps, cudaStream_t st) {
  layer_norm_kernel<D><<<(M + 7) / 8, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(xn), M,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All arrays contiguous and 16-byte aligned. D in {128, 256, 512, 1024},
// F % 32 == 0. xn [M, D] and g [M, F] are the caller's scratch (the
// normalised rows and the gelu hidden).
extern "C" int ln_mlp_residual_bf16(const void* x, const void* gamma,
                                    const void* beta, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* xn, void* g,
                                    void* out, int M, int D, int F, float eps,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || F <= 0 || F % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  switch (D) {
    case 128:
      err = launch_ln<128>(x, gamma, beta, xn, M, eps, st);
      break;
    case 256:
      err = launch_ln<256>(x, gamma, beta, xn, M, eps, st);
      break;
    case 512:
      err = launch_ln<512>(x, gamma, beta, xn, M, eps, st);
      break;
    case 1024:
      err = launch_ln<1024>(x, gamma, beta, xn, M, eps, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err == 0)
    err = launch_gemm<kFc1Gelu>(xn, w1, b1, nullptr, g, M, F, D, st);
  if (err == 0)
    err = launch_gemm<kFc2Residual>(g, w2, b2, x, out, M, D, F, st);
  return err;
}
