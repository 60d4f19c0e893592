// Hopper building blocks of the port's wgmma kernels (sm_90a): mbarriers
// (also a wait that traps), named barriers, TMA tile loads,
// 128-byte-swizzled shared-memory descriptors (K-major and MN-major),
// wgmma and register reallocation between warpgroups. Plain PTX, no CuTe.
#pragma once

#include <cuda.h>

#include "gemm_tile.cuh"

namespace pnp {
namespace hopper {

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive and expect `bytes` more of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Whether the phase of parity `parity` of the barrier has completed
// (waits a while in hardware before it says no).
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// As mbar_wait, but traps (a launch error, not a hang) once ~2 s (2^32
// clocks) have passed without the phase completing: a ring whose bytes
// never arrive ends the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  for (uint32_t spin = 1; !mbar_try_wait(bar, parity); ++spin)
    if (spin % 1024 == 0 && clock64() - t0 > (1ll << 32)) __trap();
}

// One block whose barrier waits for 16 bytes that never come: the wait
// traps after ~2 s and the next synchronisation reports the error. Lets
// a test see that a stalled ring ends a launch instead of hanging the
// card (a template, so that only the libraries that launch it hold it).
template <int = 0>
__global__ void stall_kernel() {
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) mbar_expect_tx(&bar, 16);
  __syncthreads();
  mbar_wait_or_trap(&bar, 0);
}

// Named barriers 1..15 over `n` threads (a multiple of 32): sync waits
// for the other threads' arrivals, arrive does not wait.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// TMA: the box at (c0 inner, c1 outer) of the tensor map into shared
// memory at dst, completing `bar`'s transaction count. Out-of-range
// elements are written as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* tm,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// TMA: the box at (c0 innermost, .., c3 outermost) of a 4-D tensor map.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* tm,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a K-major tile written by TMA with 128-byte swizzle:
// rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes apart; the tile
// must start on a 1024-byte boundary. Advancing k by 16 elements adds 2
// (32 bytes) to the descriptor.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// wgmma descriptor of an MN-major B operand written by TMA with 128-byte
// swizzle: rows of 64 bf16 along N (128 bytes), one row per k, 8-row
// groups of k 1024 bytes apart (the stride byte offset); the next 64
// columns of N start `lbo` bytes further (the leading byte offset). The
// tile must start on a 1024-byte boundary; advancing k by 16 adds 128
// (2048 bytes). Used with wgmma_rs<W, 1> (B transposed).
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* tile, int lbo) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are
// pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) += A (64 x 16, smem desc) * B (16 x 256, smem desc),
// both operands bf16 and K-major. Thread T of the warpgroup holds, for
// each n8 block j, d[4j], d[4j + 1] at row 16 * (T / 32) + (T % 32) / 4,
// columns 8j + 2 (T % 4) + {0, 1}, and d[4j + 2], d[4j + 3] eight rows
// below.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from reusing A fragment registers ([S][T] or [S]
// fragments of 4) before the asynchronous wgmma that reads them is known
// to be done.
template <int S, int T>
__device__ __forceinline__ void fence_a(uint32_t (&a)[S][T][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[s][i][j])::"memory");
}

template <int S>
__device__ __forceinline__ void fence_a(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[s][j])::"memory");
}

// d (64 x W, f32) += A (64 x 16, bf16 registers, mma.sync's per-warp
// fragment layout) * B (16 x W, bf16 smem descriptor), for W in
// {8, 16, 32, 48, 64, 96, 128}; d = A * B alone where `acc` is 0. B is
// K-major (desc_sw128) for TB = 0 and MN-major (desc_sw128_mn) for
// TB = 1. Thread T holds d[4j], d[4j + 1] at row 16 (T / 32) + (T % 32) / 4,
// columns 8j + 2 (T % 4) + {0, 1}, and d[4j + 2], d[4j + 3] eight rows
// below.
template <int W, int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[W / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc = 1);

// wgmma_rs<W, TB>'s operands: PNP_RS_D_n lists d[0..n) as "+f" outputs,
// PNP_RS_S_n names them "%0, ..., %(n-1)"; the four A registers, the
// descriptor and the accumulate flag follow as %n..%(n+5).
#define PNP_RS_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define PNP_RS_D8(i) PNP_RS_D4(i), PNP_RS_D4(i + 4)
#define PNP_RS_D16(i) PNP_RS_D8(i), PNP_RS_D8(i + 8)
#define PNP_RS_D_4 PNP_RS_D4(0)
#define PNP_RS_D_8 PNP_RS_D8(0)
#define PNP_RS_D_16 PNP_RS_D16(0)
#define PNP_RS_D_24 PNP_RS_D_16, PNP_RS_D8(16)
#define PNP_RS_D_32 PNP_RS_D_16, PNP_RS_D16(16)
#define PNP_RS_D_48 PNP_RS_D_32, PNP_RS_D16(32)
#define PNP_RS_D_64 PNP_RS_D_48, PNP_RS_D16(48)
#define PNP_RS_S_4 "%0, %1, %2, %3"
#define PNP_RS_S_8 PNP_RS_S_4 ", %4, %5, %6, %7"
#define PNP_RS_S_16 PNP_RS_S_8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define PNP_RS_S_24 PNP_RS_S_16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define PNP_RS_S_32 PNP_RS_S_24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define PNP_RS_S_48                                                      \
  PNP_RS_S_32 ", %32, %33, %34, %35, %36, %37, %38, %39"                 \
              ", %40, %41, %42, %43, %44, %45, %46, %47"
#define PNP_RS_S_64                                                      \
  PNP_RS_S_48 ", %48, %49, %50, %51, %52, %53, %54, %55"                 \
              ", %56, %57, %58, %59, %60, %61, %62, %63"
#define PNP_WGMMA_RS_TB(W, TB, N, A0, A1, A2, A3, DB, ACC)               \
  template <>                                                            \
  __device__ __forceinline__ void wgmma_rs<W, TB>(                       \
      float(&d)[N], const uint32_t(&a)[4], uint64_t db, int acc) {       \
    asm volatile(                                                        \
        "{\n"                                                            \
        ".reg .pred p;\n"                                                \
        "setp.ne.b32 p, %" #ACC ", 0;\n"                                 \
        "wgmma.mma_async.sync.aligned.m64n" #W "k16.f32.bf16.bf16 {"     \
        PNP_RS_S_##N "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DB \
        ", p, 1, 1, " #TB ";\n"                                          \
        "}\n"                                                            \
        : PNP_RS_D_##N                                                   \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)); \
  }
#define PNP_WGMMA_RS(W, N, A0, A1, A2, A3, DB, ACC)   \
  PNP_WGMMA_RS_TB(W, 0, N, A0, A1, A2, A3, DB, ACC)   \
  PNP_WGMMA_RS_TB(W, 1, N, A0, A1, A2, A3, DB, ACC)
PNP_WGMMA_RS(8, 4, 4, 5, 6, 7, 8, 9)
PNP_WGMMA_RS(16, 8, 8, 9, 10, 11, 12, 13)
PNP_WGMMA_RS(32, 16, 16, 17, 18, 19, 20, 21)
PNP_WGMMA_RS(48, 24, 24, 25, 26, 27, 28, 29)
PNP_WGMMA_RS(64, 32, 32, 33, 34, 35, 36, 37)
PNP_WGMMA_RS(96, 48, 48, 49, 50, 51, 52, 53)
PNP_WGMMA_RS(128, 64, 64, 65, 66, 67, 68, 69)

// d (64 x W, f32) += A (64 x 16, bf16 smem descriptor) * B (16 x W, bf16
// smem descriptor), both K-major (desc_sw128), for W in {8, 16, 128}; d =
// A * B alone where `acc` is 0. d's layout as wgmma_rs's.
template <int W>
__device__ __forceinline__ void wgmma_ss(float (&d)[W / 2], uint64_t da,
                                         uint64_t db, int acc = 1);
#define PNP_WGMMA_SS(W, N, DA, DB, ACC)                                  \
  template <>                                                            \
  __device__ __forceinline__ void wgmma_ss<W>(float(&d)[N], uint64_t da, \
                                              uint64_t db, int acc) {    \
    asm volatile(                                                        \
        "{\n"                                                            \
        ".reg .pred p;\n"                                                \
        "setp.ne.b32 p, %" #ACC ", 0;\n"                                 \
        "wgmma.mma_async.sync.aligned.m64n" #W "k16.f32.bf16.bf16 {"     \
        PNP_RS_S_##N "}, %" #DA ", %" #DB ", p, 1, 1, 0, 0;\n"           \
        "}\n"                                                            \
        : PNP_RS_D_##N                                                   \
        : "l"(da), "l"(db), "r"(acc));                                   \
  }
PNP_WGMMA_SS(8, 4, 4, 5, 6)
PNP_WGMMA_SS(16, 8, 8, 9, 10)
PNP_WGMMA_SS(128, 64, 64, 65, 66)
#undef PNP_WGMMA_SS
#undef PNP_WGMMA_RS
#undef PNP_WGMMA_RS_TB
#undef PNP_RS_D4
#undef PNP_RS_D8
#undef PNP_RS_D16
#undef PNP_RS_D_4
#undef PNP_RS_S_4
#undef PNP_RS_D_8
#undef PNP_RS_S_8
#undef PNP_RS_D_16
#undef PNP_RS_S_16
#undef PNP_RS_D_24
#undef PNP_RS_S_24
#undef PNP_RS_D_32
#undef PNP_RS_S_32
#undef PNP_RS_D_48
#undef PNP_RS_S_48
#undef PNP_RS_D_64
#undef PNP_RS_S_64

// Stores four 8x8 bf16 matrices, transposed: register j of the thread
// (row lane / 4, columns 2 (lane % 4) + {0, 1} of matrix j, mma.sync's
// fragment layout) goes to column lane / 4 of rows 2 (lane % 4) + {0, 1};
// lanes 8j .. 8j + 7 give the addresses of matrix j's eight stored rows,
// 16 bytes each.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1, %2, %3, %4};\n" ::"r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// Orders this thread's earlier shared-memory writes before later reads by
// the async proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

}  // namespace hopper
}  // namespace pnp
