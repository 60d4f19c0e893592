#!/usr/bin/env python3
"""What bounds the fused ViT kernels K1 (ln_matmul), K3 (ln_mlp_residual)
and K4 (flash_mha_qkv_proj), the flash kernel (K2/K7/K9) and the CRF's K5
(gaussian_kernel_materialize), K6 (crf_fused_iteration) and K8
(gaussian_kernel_matmul) on one GPU: each is rebuilt with one part of its
work taken out, or with another block shape, and timed at its main-path
shapes (336 px; K4 at 768 px, B = 12, S = 2305; the flash kernel also at
the CLIP scorer's [8, 577] and at S = 2305 with head dim 64 and 128; K5 and K6 at chip_smoke.py's shapes,
M = 2304 anchors, N = 36864 pixels, R = 64, v = 2, c = 29; K8 at
chip_smoke.py's five shapes) beside the full kernel.

    python3 scripts/kernel_ablation.py [--out DIR] [--kernels SRC,...]
        [--variants NAME,...]

Variants (built from the sources in ``pnp_ovss_tpu_torch/csrc`` with a
textual edit of the source or of a header it includes, into ``DIR``;
their outputs are wrong by design and only their times are read):

- K1 (two kernels a call: LayerNorm, then the wgmma GEMM with the bias
  epilogue on the cooperative schedule): ``no_ln`` runs the GEMM alone
  (on rows normalised beforehand), ``no_ln_no_epilogue`` the GEMM alone
  with nothing staged or stored (the consumers skip their staging, the
  epilogue warps their work), ``pingpong`` the GEMM on the ping-pong
  schedule (outputs right);
- K3 (three kernels a call: LayerNorm, fc1 + gelu on the ping-pong
  schedule, fc2 + residual on the cooperative one): ``no_gelu`` stores
  fc1's rounded output without the gelu, ``no_epilogue`` has both GEMMs
  stage and store nothing, ``fc2_rows4`` keeps 4 rows of fc2's residual in
  flight in place of 2 (outputs right), ``fc1_cooperative`` runs fc1 on
  the cooperative schedule, its gelu in the epilogue warps (outputs
  right), ``no_tma`` has the producer arrive on each stage without
  loading it (the products read stale shared memory), so the wgmma loop
  runs alone, ``pp_no_mma`` has fc1's ping-pong consumers issue no
  products (the loads and the gelu alone), ``pp_no_mma_no_tma`` no
  loads either (the gelu alone, both warpgroups at once). K1 and K3 run
  at the 336 px and the 768 px main path's rows
  (M = 15470 and 27660), each call split into its kernels' times by the
  profiler, each GEMM beside its products' bound;
- K4 (two kernels a call: the flash kernel, then the wgmma GEMM with the
  proj + residual epilogue): ``attention_only`` and ``proj_only`` run one
  of the two (the proj on head outputs of an earlier full call);
  ``proj_only_rows2`` / ``_rows8`` the proj with 2 or 8 rows of the
  residual in flight per epilogue thread in place of 4 (outputs right);
- flash kernel (outputs right, their error against the plain version
  printed at 336 px and the CLIP shape): ``no_pingpong`` lets two
  consumer warpgroups issue their products without taking turns,
  ``turns3`` makes three take turns too, ``one_consumer`` a block of one
  consumer (64 query rows a K/V tile), ``two_consumers`` two (128 rows)
  in place of three at D = 64 and S >= 1024, ``three_consumers`` three
  (192 rows) at D = 64 at every S, ``keys128`` 128-key tiles in place of
  64 (a ring of 2 at D = 128; another per-row arithmetic), ``stages2`` /
  ``stages4`` rings of 2 / 4 stages in place of 6 (D = 64; ``stages2``
  also 2 in place of 4 at D = 128), ``d128_stages6`` 6 at D = 128,
  ``ex2`` the exponent as one FFMA and one ex2.approx in place of expf
  (right within the kernel's bar, but it moves chip_smoke.py's 3-head
  narrow pipeline past its bar), ``no_pin`` leaves the compiler free to
  sink the softmax past the wait for P V, ``always_rescale`` multiplies
  o by alpha also where every alpha of a warp is 1; outputs wrong by
  design: ``no_exp`` takes the score difference itself as P (no
  exponentials), ``no_pv`` skips the P V products, ``no_qk`` the QK^T
  products;
- K8 (each at chip_smoke.py's five shapes: the exact CRF's messages,
  C = 58 and 12, and degree, C = 1, and both Nystrom shapes; the general
  schedule, ``features_j`` given): ``no_ex2`` takes
  the exponent itself as k, ``no_mma`` replaces the products by a
  register update, ``no_ex2_no_mma`` both, ``no_cvt`` rounds k to bf16
  by truncation (a byte permute) in place of cvt.rn, ``skeleton`` takes
  one multiply an entry in place of the exponent's arithmetic,
  ``no_loads`` skips the ring's TMA loads (stale tiles); variants whose
  outputs stay right: ``minb2`` caps registers for 2 blocks an SM in
  place of 3 at W <= 64, ``step_issue`` issues each k16 step's products
  as soon as its fragments are packed, ``bfs`` orders a step's
  arithmetic breadth first, ``stages3`` a ring of 3 stages in place of
  4, ``one_tile`` / ``three_tiles`` give a warpgroup 1 or 3 m64 row
  tiles in place of 2, ``expansion`` takes the f32 expansion
  2a.b - |a|^2 - |b|^2 in place of explicit differences (on
  ``pack_expansion``'s operands, centred at the midrange, and as
  ``no_center`` uncentred; its error against the plain version is
  printed beside its time); on the full build ``split1`` / ``split2`` /
  ``split4`` / ``split8`` force the j split in place of
  ``bilateral.matmul_plan``'s (buffers from ``bilateral.matmul_bufs``),
  and the wrapper's copy of the values into v^T is timed alone. Each K8
  call goes through ``bilateral.launch_matmul``, as the wrapper's does,
  so its time includes that copy;
- K5 (uint8 kind; codes are compared with the plain version's): ``expf``
  takes the exponent as expf(-d2/2) * 255 in place of one ex2.approx over
  prescaled features, ``f2i`` rounds with F2I.RN in place of the magic
  number, ``expf_f2i`` both (the arithmetic of the kernel before its
  redesign); ``rows64`` gives a block 64 rows in place of 32, ``minb1``
  lifts the register cap for 4 blocks an SM;
- K6: ``no_dequant`` feeds the raw bytes to the products as bf16 bits,
  ``no_mma`` replaces the products by a register update, ``mma_x2``
  issues each product twice, ``no_epilogue`` skips the energy, softmax
  and stores (the result is still staged); ``no_k_loads`` / ``no_q_loads``
  / ``no_loads`` skip the K^T box loads, the qsub box loads or both
  (stale tiles); ``stages3`` / ``stages6`` a ring of 3 or 6 stages in
  place of 4, ``wg2`` / ``wg2_stages3`` blocks of two warpgroups (256-column
  slabs sharing one qsub tile) in place of one (outputs right). The same
  call is timed at R = 16, 32 and 48 state rows.

Also times cuBLAS on K1's product alone (``F.linear`` on the normalised
rows) and on K4's proj product alone (``F.linear`` on the head outputs)
as yardsticks. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# An edit is (old, new) in the source itself or (header, old, new) in a
# header it includes from csrc/.
_GEMM = "wgmma_gemm.cuh"
_FLASH = "flash_kernel.cuh"
# Nothing staged or stored: the epilogue warps skip their loop, the
# consumers (of either schedule) their staging.
_NO_EPILOGUE = [(_GEMM, "for (int row = etid / kChunks; row < kBM;",
                 "for (int row = kBM; row < kBM;"),
                (_GEMM, "for (int j = 0; j < W / 8; ++j) {",
                 "for (int j = 0; j < 0; ++j) {")]
# The producer arrives on each stage without loading it (stale tiles).
_NO_TMA = [(_GEMM, "hopper::mbar_expect_tx(&full[stage], S::kStageBytes);",
            "hopper::mbar_arrive(&full[stage]);"),
           (_GEMM, "hopper::tma_load_2d(a_tile(stage)",
            "if (0) hopper::tma_load_2d(a_tile(stage)"),
           (_GEMM, "hopper::tma_load_2d(b_tile(stage)",
            "if (0) hopper::tma_load_2d(b_tile(stage)")]
# The ping-pong consumers issue no products (the staged values are
# act(bias)).
_PP_NO_MMA = (_GEMM, "hopper::wgmma_ss<128>(acc[",
              "if (0) hopper::wgmma_ss<128>(acc[")
# The flash kernel: its exponent, one score's exponent, and its two
# products' wgmma calls.
_FLASH_P = "const float p = flash_exp(sc[4 * n + e], m[e >> 1]);"
_FLASH_EX2 = (_FLASH, "return expf(s - m);",
              "float y;\n  asm(\"ex2.approx.ftz.f32 %0, %1;\"\n      : \"=f\"(y)"
              "\n      : \"f\"(fmaf(s, 1.4426950408889634f, "
              "-m * 1.4426950408889634f)));\n  return y;")
_FLASH_PV = "hopper::wgmma_rs<D, 1>("
_FLASH_QK = "hopper::wgmma_rs<kBN>("
_FLASH_PIN = ("        hopper::fence_regs(sc);\n"
              "        hopper::fence_regs(l);\n")
_PROJ_ONLY = ("int err = pnp::flash::launch_flat(",
              "int err = 0;\n  if (0)\n    err = pnp::flash::launch_flat(")
_NO_LN = ("int err = gm::launch_layer_norm(x, gamma, beta, xn, M, D, eps, "
          "st);", "int err = 0;")

# K6: its product call; the K^T or qsub box loads skipped, with the
# stage's barrier told to expect only what is still loaded.
_K6_WGMMA = "pnp::hopper::wgmma_rs<64>(acc[i], a[s][i], db + 2 * s);"
_K6_EXPECT = "pnp::hopper::mbar_expect_tx(&full[slot], kStageBytes);"
_K6_TMA_Q = "pnp::hopper::tma_load_2d(q_tile(slot), &tm_q,"
_K6_TMA_K = "pnp::hopper::tma_load_2d(smem + slot * kStageBytes + kQTile"

# K8: its exponent (explicit differences) and product lines, and the
# f32 expansion in their place (row and column norms at feature F).
_K8_EXP = """        float d2 = 0.f;
#pragma unroll
        for (int d = 0; d < F; ++d) {
          const float e = ra[r][d] - b[d];
          d2 = fmaf(e, e, d2);
        }
        k[r][c] = exp2_ftz(-d2);"""
_K8_EXPANSION = """        float x = b[F];
#pragma unroll
        for (int d = 0; d < F; ++d) x = fmaf(ra[r][d], b[d], x);
        k[r][c] = exp2_ftz(x + ra[r][F]);"""
_K8_ROW_LOAD = "for (int d = 0; d < F; ++d) ra[r][d] = row < N ? p[d] : 0.f;"
_K8_WGMMA = "pnp::hopper::wgmma_rs<W>(acc[i], a[s][i], db + 2 * s);"
_K8_SKELETON = (_K8_EXP,
                "        k[r][c] = ra[r][c & 1] * b[r % F];")
_K8_EXPECT = "pnp::hopper::mbar_expect_tx(&full[slot], kStage);"
_K8_TMA_V = "pnp::hopper::tma_load_2d(v_tile(slot), tm_v,"
_K8_TMA_F = "pnp::hopper::tma_load_2d(smem + slot * kStage + W * kBJ * 2,"
_K8_NO_EX2 = ("k[r][c] = exp2_ftz(-d2);", "k[r][c] = -d2;")
_K8_NO_MMA = (_K8_WGMMA, "acc[i][0] += __uint_as_float(a[s][i][0] ^ "
              "a[s][i][1] ^ a[s][i][2] ^ a[s][i][3]);")
_K8_BOUNDS = ("__launch_bounds__(\n    kThreads, (F == 5 && W <= (kSym ? 16 : 64)) ? 3 : 2)",
              "__launch_bounds__(kThreads, 2)")
# Each k16 step's products issued as soon as its fragments are packed:
# k_fragments calls a hook after each step (the symmetric schedule's an
# empty one).
_K8_STEP_ISSUE = [
    ("""template <int F>
__device__ __forceinline__ void k_fragments(
    const float (&ra)[2 * kTiles][F], const float* fs, int t,
    uint32_t (&a)[kBJ / 16][kTiles][4]) {""",
     """template <int F, typename Hook>
__device__ __forceinline__ void k_fragments(
    const float (&ra)[2 * kTiles][F], const float* fs, int t,
    uint32_t (&a)[kBJ / 16][kTiles][4], Hook hook) {"""),
    ("""      a[s][i][3] = pnp::pack_bf16x2(k[2 * i + 1][2], k[2 * i + 1][3]);
    }
""", """      a[s][i][3] = pnp::pack_bf16x2(k[2 * i + 1][2], k[2 * i + 1][3]);
    }
    hook(s);
"""),
    ("""    k_fragments<F>(ra, f_tile(it % kStages), t, a);
    const uint64_t db = pnp::hopper::desc_sw128(v_tile(it % kStages));
    pnp::hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBJ / 16; ++s)
#pragma unroll
      for (int i = 0; i < kTiles; ++i)
        pnp::hopper::wgmma_rs<W>(acc[i], a[s][i], db + 2 * s);
    pnp::hopper::wgmma_commit();""",
     """    const uint64_t db = pnp::hopper::desc_sw128(v_tile(it % kStages));
    k_fragments<F>(ra, f_tile(it % kStages), t, a, [&](int s) {
      pnp::hopper::wgmma_fence();
#pragma unroll
      for (int i = 0; i < kTiles; ++i)
        pnp::hopper::wgmma_rs<W>(acc[i], a[s][i], db + 2 * s);
    });
    pnp::hopper::wgmma_commit();"""),
    ("k_fragments<F>(ra, f_tile(it % kSt), t, a);",
     "k_fragments<F>(ra, f_tile(it % kSt), t, a, [](int) {});")]
# A k16 step's exponents breadth first: each feature's differences for
# all 16 entries, then the next feature's (outputs unchanged).
_K8_STEP_BODY = """    float k[2 * kTiles][4];
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
"""
_K8_STEP_BFS = """    float b[4][F], k[2 * kTiles][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      load_column(fs + (s * 16 + 2 * t + (c & 1) + 8 * (c >> 1)) * kFLd,
                  b[c]);
#pragma unroll
      for (int r = 0; r < 2 * kTiles; ++r) k[r][c] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < F; ++d)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 2 * kTiles; ++r) {
          const float e = ra[r][d] - b[c][d];
          k[r][c] = fmaf(e, e, k[r][c]);
        }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 2 * kTiles; ++r) k[r][c] = exp2_ftz(-k[r][c]);
"""
# Runs of each K8 build: {run: (packing, split)}; packing None is the
# wrapper's, else the expansion's operands centred or not; split None is
# bilateral.matmul_plan's. Builds with another row tile than 128 rows.
K8_RUNS = {"full": {"full": (None, None), "split1": (None, 1),
                    "split2": (None, 2), "split4": (None, 4),
                    "split8": (None, 8)},
           "expansion": {"expansion": ("centred", None),
                         "no_center": ("uncentred", None)}}
K8_ROWS = {"one_tile": 64, "three_tiles": 192}


def expansion_centre(fi, fj):
    """The expansion's centre [F] f32: the midrange, per feature, of both
    sides' scaled features. Translating both sides by it leaves every
    exponent as it is and keeps the expansion's norms small."""
    s = (0.5 / math.log(2.0)) ** 0.5
    lo = (fi.float() * s).amin(0).minimum((fj.float() * s).amin(0))
    hi = (fi.float() * s).amax(0).maximum((fj.float() * s).amax(0))
    return (lo + hi) * 0.5


def pack_expansion(features, centre, j_side: bool):
    """The ``expansion`` build's operands of x_ij = 2 a_i . b_j - |a_i|^2 -
    |b_j|^2 in K8's [rows, 12] layout: the scaled features less ``centre``
    (twice that on the j side) in columns 0..F-1 and minus the squared
    norm of the undoubled row (float64, rounded once) in column F."""
    rows, f = features.shape
    a = features.float() * (0.5 / math.log(2.0)) ** 0.5 - centre
    out = features.new_zeros((rows, 12), dtype=a.dtype)
    out[:, :f] = 2.0 * a if j_side else a
    out[:, f] = -a.double().square().sum(1).float()
    return out

VARIANTS = {
    "ln_matmul": {
        "full": [],
        "no_ln": [_NO_LN],
        "no_ln_no_epilogue": [_NO_LN, *_NO_EPILOGUE],
        "pingpong": [("static constexpr bool kPingPong = false;",
                      "static constexpr bool kPingPong = true;\n  "
                      "static __device__ __forceinline__ uint32_t act("
                      "uint32_t y) { return y; }")],
    },
    "ln_mlp_residual": {
        "full": [],
        "no_gelu": [("return gelu_bf16x2(y);", "return y;")],
        "no_epilogue": _NO_EPILOGUE,
        "fc2_rows4": [("static constexpr int kRows = 2;\n  static __device__ "
                       "__forceinline__ uint4 load(\n      const",
                       "static constexpr int kRows = 4;\n  static __device__ "
                       "__forceinline__ uint4 load(\n      const")],
        "no_tma": _NO_TMA,
        "fc1_cooperative": [("static constexpr bool kPingPong = true;",
                             "static constexpr bool kPingPong = false;")],
        "pp_no_mma": [_PP_NO_MMA],
        "pp_no_mma_no_tma": [_PP_NO_MMA, *_NO_TMA],
    },
    "flash_qkv_proj": {
        "full": [],
        "attention_only": [("  if (err == 0)\n    err = "
                            "qkv_proj_residual_bf16(",
                            "  if (0)\n    err = qkv_proj_residual_bf16(")],
        "proj_only": [_PROJ_ONLY],
        "proj_only_rows2": [_PROJ_ONLY, ("kRows = 4;", "kRows = 2;")],
        "proj_only_rows8": [_PROJ_ONLY, ("kRows = 4;", "kRows = 8;")],
    },
    "flash_attention": {
        "full": [],
        # Outputs stay right.
        "no_pingpong": [(_FLASH, "kPingPong = true", "kPingPong = false")],
        "one_consumer": [
            (_FLASH, "kConsumersD64 = 2", "kConsumersD64 = 1"),
            (_FLASH, "kConsumersD64Long = 3", "kConsumersD64Long = 1"),
            (_FLASH, "kConsumersD128 = 2", "kConsumersD128 = 1")],
        "two_consumers": [
            (_FLASH, "kConsumersD64Long = 3", "kConsumersD64Long = 2")],
        "three_consumers": [
            (_FLASH, "kConsumersD64 = 2", "kConsumersD64 = 3")],
        "keys128": [(_FLASH, "kKeysD64 = 64", "kKeysD64 = 128"),
                    (_FLASH, "kKeysD128 = 64, kStagesD128 = 4",
                     "kKeysD128 = 128, kStagesD128 = 2")],
        "stages2": [(_FLASH, "kStagesD64 = 6", "kStagesD64 = 2"),
                    (_FLASH, "kStagesD128 = 4", "kStagesD128 = 2")],
        "stages4": [(_FLASH, "kStagesD64 = 6", "kStagesD64 = 4")],
        "d128_stages6": [(_FLASH, "kStagesD128 = 4", "kStagesD128 = 6")],
        "turns3": [(_FLASH, "kPingPong && kConsumers == 2",
                    "kPingPong && kConsumers > 1")],
        "ex2": [_FLASH_EX2],
        # The softmax left free to sink past the wait for P V.
        "no_pin": [(_FLASH, _FLASH_PIN, "")],
        "always_rescale": [(_FLASH, "if (__any_sync(0xffffffffu, alpha[0] "
                            "!= 1.f || alpha[1] != 1.f)) {", "{")],
        # Outputs wrong by design.
        "no_exp": [(_FLASH, _FLASH_P, "const float p = sc[4 * n + e];")],
        "no_pv": [(_FLASH, _FLASH_PV, "if (0) " + _FLASH_PV)],
        "no_qk": [(_FLASH, _FLASH_QK, "if (0) " + _FLASH_QK)],
    },
    "crf_materialize": {
        "full": [],
        "expf": [("kExp2 = true;", "kExp2 = false;")],
        "f2i": [("kMagicRound = true;", "kMagicRound = false;")],
        "expf_f2i": [("kExp2 = true;", "kExp2 = false;"),
                     ("kMagicRound = true;", "kMagicRound = false;")],
        "rows64": [("kRowsPerBlock = 32;", "kRowsPerBlock = 64;")],
        "minb1": [("kMinBlocks = 4;", "kMinBlocks = 1;")],
    },
    "crf_iteration": {
        "full": [],
        "no_dequant": [("return pnp::pack_bf16x2(flo, fhi);",
                        "return __byte_perm(lo, hi, 0x5140 + j);")],
        "no_mma": [(_K6_WGMMA, "acc[i][0] += __uint_as_float(a[s][i][0] ^ "
                    "a[s][i][1] ^ a[s][i][2] ^ a[s][i][3]);")],
        "mma_x2": [(_K6_WGMMA, "{\n          " + _K6_WGMMA + "\n          "
                    + _K6_WGMMA + "\n        }")],
        "no_epilogue": [("if (n >= N) return;", "if (n >= 0) return;")],
        "no_k_loads": [
            (_K6_EXPECT, _K6_EXPECT.replace("kStageBytes", "kQTile")),
            (_K6_TMA_K, "if (0) " + _K6_TMA_K)],
        "no_q_loads": [
            (_K6_EXPECT, _K6_EXPECT.replace("kStageBytes",
                                            "kWarpgroups * kKTile")),
            (_K6_TMA_Q, "if (0) " + _K6_TMA_Q)],
        "no_loads": [
            (_K6_EXPECT, "pnp::hopper::mbar_arrive(&full[slot]);"),
            (_K6_TMA_Q, "if (0) " + _K6_TMA_Q),
            (_K6_TMA_K, "if (0) " + _K6_TMA_K)],
        "stages3": [("kStages = 4;", "kStages = 3;")],
        "stages6": [("kStages = 4;", "kStages = 6;")],
        "wg2": [("kWarpgroups = 1;", "kWarpgroups = 2;")],
        "wg2_stages3": [("kWarpgroups = 1;", "kWarpgroups = 2;"),
                        ("kStages = 4;", "kStages = 3;")],
    },
    "crf_matmul": {
        "full": [],
        "no_ex2": [_K8_NO_EX2],
        # K8 computes its A fragment itself, so the stand-in reads all of
        # it or the compiler drops the unread kernel entries.
        "no_mma": [_K8_NO_MMA],
        "no_ex2_no_mma": [_K8_NO_EX2, _K8_NO_MMA],
        # bf16 by truncation (a byte permute) in place of cvt.rn.
        "no_cvt": [("pnp::pack_bf16x2(k", "trunc_pack(k"),
                   ("// A stage's 32 A fragments",
                    "__device__ __forceinline__ uint32_t trunc_pack(float x, "
                    "float y) {\n  return __byte_perm(__float_as_uint(x), "
                    "__float_as_uint(y), 0x7632);\n}\n\n"
                    "// A stage's 32 A fragments")],
        "minb2": [_K8_BOUNDS],
        "step_issue": _K8_STEP_ISSUE,
        "stages3": [("constexpr int kStages = 4;",
                     "constexpr int kStages = 3;")],
        "bfs": [(_K8_STEP_BODY, _K8_STEP_BFS)],
        # One multiply an entry in place of its exponent: what the loop
        # costs without the exponents' arithmetic.
        "skeleton": [_K8_SKELETON],
        # The ring's loads skipped (stale tiles), each stage's barrier only
        # arrived on.
        "no_loads": [(_K8_EXPECT, "pnp::hopper::mbar_arrive(&full[slot]);"),
                     (_K8_TMA_V, "if (0) " + _K8_TMA_V),
                     (_K8_TMA_F, "if (0) " + _K8_TMA_F)],
        "three_tiles": [("constexpr int kTiles = 2;",
                         "constexpr int kTiles = 3;"), _K8_BOUNDS],
        "expansion": [("float ra[2 * kTiles][F];",
                       "float ra[2 * kTiles][F + 1];"),
                      ("(&ra)[2 * kTiles][F]", "(&ra)[2 * kTiles][F + 1]"),
                      (_K8_ROW_LOAD, _K8_ROW_LOAD.replace("d < F", "d <= F")),
                      ("float b[F];", "float b[F + 1];"),
                      (_K8_EXP, _K8_EXPANSION)],
        "one_tile": [("constexpr int kTiles = 2;",
                      "constexpr int kTiles = 1;")],
    },
}


def kernel_split(call, iters: int) -> dict:
    """Device ms a launch of each kernel that ``call`` launches once, by
    the profiler over ``iters`` calls."""
    import torch

    from port_bench import devtrace

    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = devtrace.short_name(e.name)
            split[key] = (split.get(key, 0.0)
                          + e.device_time_total / 1e3 / iters)
    return split


def build(out_dir: str, sources, only=None):
    """Compile every variant of ``sources`` (or those named in ``only``) in
    parallel, each in its own directory beside its edited headers (a
    quoted include finds them before csrc/'s). Returns {(kernel,
    variant): lib}."""
    from pnp_ovss_tpu_torch.ops import _build

    procs = {}
    for src in sources:
        for name, edits in VARIANTS[src].items():
            if only is not None and name not in only:
                continue
            files = {f"{src}.cu": None}
            for edit in edits:
                fname, old, new = edit if len(edit) == 3 else (
                    f"{src}.cu", *edit)
                text = files.get(fname) or (_build.CSRC / fname).read_text()
                if old not in text:
                    raise SystemExit(f"{src}/{name}: edit target not found "
                                     f"in {fname}")
                files[fname] = text.replace(old, new)
            vdir = os.path.join(out_dir, f"{src}_{name}")
            os.makedirs(vdir, exist_ok=True)
            for fname, text in files.items():
                with open(os.path.join(vdir, fname), "w") as f:
                    f.write(text or (_build.CSRC / fname).read_text())
            so = os.path.join(vdir, f"{src}.so")
            procs[(src, name)] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-o", so, os.path.join(vdir, f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{key}: nvcc failed\n{log}")
        libs[key] = ctypes.CDLL(so)
        regs = [line.replace("ptxas info    :", "").strip()
                for line in log.splitlines()
                if "registers" in line or "spill stores" in line]
        print(f"{key[0]} {key[1]} ptxas: {'; '.join(regs)}", flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/ablation")
    ap.add_argument("--kernels", default=",".join(VARIANTS),
                    help="sources to ablate, comma-separated (default all: "
                    f"{','.join(VARIANTS)})")
    ap.add_argument("--variants", default=None,
                    help="variant names to build, comma-separated (default "
                    "all of each source)")
    args = ap.parse_args()
    sources = args.kernels.split(",")
    if not set(sources) <= set(VARIANTS):
        raise SystemExit(f"kernel_ablation: --kernels must name sources of "
                         f"{sorted(VARIANTS)}")

    import torch
    from torch.nn import functional as F

    import chip_smoke
    from pnp_ovss_tpu_torch.ops import (
        _build, bilateral, flash_attention, vit_block,
    )
    from port_bench import counting

    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    libs = build(args.out, sources,
                 args.variants and set(args.variants.split(",")))

    cfg = chip_smoke.full_config(336)
    vit = cfg.model.vit
    m, d = cfg.batch_size * vit.seq_len, vit.hidden_size
    n, f = 3 * d, int(d * vit.mlp_ratio)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(torch.bfloat16)

    # K1 and K3 at the 336 px and the 768 px main path's rows (35 x 442,
    # 12 x 2305): each call reads the first M rows of the same arrays.
    rows = (m, 12 * 2305)
    x = randn(rows[-1], d)
    g = torch.ones(d, device=dev)
    b = torch.zeros(d, device=dev)
    w, bias = randn(n, d, scale=d**-0.5), randn(n, scale=0.02)
    w1, b1 = randn(f, d, scale=d**-0.5), randn(f, scale=0.02)
    w2, b2 = randn(d, f, scale=f**-0.5), randn(d, scale=0.02)
    y = torch.empty((rows[-1], n), dtype=torch.bfloat16, device=dev)
    z = torch.empty_like(x)
    # K1's and K3's LayerNorm scratch, holding the normalised rows for the
    # variants that run K1's GEMM alone.
    xn = vit_block.layer_norm_f32(x, g, b, 1e-6).to(torch.bfloat16)
    hidden = torch.empty((rows[-1], f), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    Ll = ctypes.c_longlong
    # The flash kernel through its flat entry on q/k/v column views of one
    # qkv array: K2 at 336 px, and S = 2305 (the 768 px leg) with 16 heads
    # of 64 and 8 heads of 128 (the shapes of K9's slow rows).
    flash_shapes = []
    for label, fb, fs, fh, fd in (("336 px", cfg.batch_size, vit.seq_len,
                                   vit.num_heads, vit.head_dim),
                                  ("CLIP", 8, 577, 16, 64),
                                  ("768 px", 12, 2305, 16, 64),
                                  ("768 px D=128", 12, 2305, 8, 128)):
        qkv = randn(fb, fs, 3 * fh * fd)
        hd_ = fh * fd
        # The plain version where it fits in a few GB (not at 768 px).
        ref = (flash_attention.attention_plain(
            qkv[..., :hd_], qkv[..., hd_:2 * hd_], qkv[..., 2 * hd_:],
            num_heads=fh, true_len=fs, out_dtype=torch.float32)
            if fs < 1024 else None)
        flash_shapes.append((f"{label} [{fb}, {fh}, {fs}, {fd}]", qkv,
                             torch.empty((fb, fs, fh * fd),
                                         dtype=torch.bfloat16, device=dev),
                             fb, fs, fh, fd, ref))
    # K8 at chip_smoke.py's five shapes and features, packed for each run;
    # the plain version on the first 1024 rows of each.
    k8_support = chip_smoke.k8_support(cfg, gen)
    k8_cases = []
    for label, side_i, side_j, c, signed, _ in chip_smoke.K8_SHAPES:
        fi8, fj8 = k8_support[side_i], k8_support[side_j]
        vals = chip_smoke.k8_values(fj8.shape[0], c, signed, gen)
        centre = expansion_centre(fi8, fj8)
        packed = {None: (bilateral.pack_features(fi8),
                         bilateral.pack_features(fj8))}
        for key, cc in (("centred", centre),
                        ("uncentred", torch.zeros_like(centre))):
            packed[key] = (pack_expansion(fi8, cc, False),
                           pack_expansion(fj8, cc, True))
        ref = bilateral.kernel_matmul_plain(fi8[:1024], vals, fj8)
        k8_cases.append((label, fi8.shape[0], fj8.shape[0], vals, packed,
                         ref))
    # K4 at the 768 px leg: its qkv, residual, proj weights, head-output
    # scratch (written by the full variant, read by proj_only) and output.
    pb_, ps_ = 12, 2305
    pqkv, px = randn(pb_, ps_, 3 * d), randn(pb_, ps_, d, scale=0.1)
    pw, pbias = randn(d, d, scale=d**-0.5), randn(d, scale=0.02)
    pattn = torch.empty((pb_, ps_, d), dtype=torch.bfloat16, device=dev)
    pout = torch.empty_like(px)
    # K5 and K6 at chip_smoke.py's shapes; K^T from the port's own K5.
    fj5, fi5 = chip_smoke.crf_features(cfg, gen)
    m5, n5 = fj5.shape[0], fi5.shape[0]
    kt = bilateral.gaussian_kernel_materialize(fj5, fi5)
    m_pad5 = kt.shape[0]
    kt_plain = bilateral.materialize_plain(fj5, fi5, m_pad5, torch.uint8)
    kt_out = torch.empty_like(kt)
    k6_args, k6_v, k6_c = chip_smoke.crf_iteration_args(cfg, kt, gen)
    k6_r = k6_args[0].shape[0]
    k6_plain = bilateral.crf_iteration_plain(*k6_args, v=k6_v, c=k6_c,
                                             out_dtype=torch.bfloat16)
    k6_out = torch.empty_like(k6_plain)
    if "crf_iteration" in sources:
        ms = chip_smoke.time_ms(lambda: kt.view(torch.int64).sum(), 20)
        print(f"torch read of K^T (int64 sum over its {kt.numel()} bytes): "
              f"{ms:.4f} ms ({kt.numel() / ms / 1e6:.1f} GB/s)", flush=True)
    print(f"336 px main-path shapes: M={m}, D={d}, N={n}, F={f}; K4 B="
          f"{pb_} S={ps_}; K8 {[case[0] for case in k8_cases]}", flush=True)
    for (src, name), lib in libs.items():
        if src == "crf_materialize":
            fn = lib.gaussian_kernel_materialize
            fn.argtypes = [P, P, P, I, I, I, I, I, P]
            call = (lambda fn=fn: fn(
                fj5.data_ptr(), fi5.data_ptr(), kt_out.data_ptr(), m5, m_pad5,
                n5, 5, 0, stream))
            if call() != 0:
                raise SystemExit(f"{src} {name}: launch failed")
            ms = chip_smoke.time_ms(call, 20)
            differ = (kt_out != kt_plain).sum().item() / kt_out.numel()
            top = (kt_out.int() - kt_plain.int()).abs().max().item()
            print(f"{src} {name}: {ms:.4f} ms ({m_pad5 * n5 / ms / 1e6:.1f} "
                  f"GB/s written; codes differing from plain {differ:.4g}, "
                  f"at most by {top})", flush=True)
            continue
        if src == "crf_iteration":
            fn = lib.crf_fused_iteration
            fn.argtypes = [P] * 6 + [I] * 5 + [P]
            call = (lambda fn=fn: fn(
                *(t.data_ptr() for t in k6_args), k6_out.data_ptr(), k6_r,
                m_pad5, n5, k6_v, k6_c, stream))
            if call() != 0:
                raise SystemExit(f"{src} {name}: launch failed")
            ms = chip_smoke.time_ms(call, 20)
            err = (k6_out.float() - k6_plain.float()).abs().max().item()
            nbytes = (m_pad5 * n5 + k6_r * m_pad5 * 2 + 3 * k6_r * n5 * 2
                      + n5 * 4)
            print(f"{src} {name}: {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s "
                  f"over the bound's bytes; max |out - plain| {err:.3g})",
                  flush=True)
            if name == "full":  # the same call on the first R state rows
                for r in (16, 32, 48):
                    q, kt_, u_, msp_, nb_ = k6_args
                    rargs = [q[:r].contiguous(), kt_, u_[:r].contiguous(),
                             msp_[:r].contiguous(), nb_]
                    rout = k6_out[:r].contiguous()
                    ms = chip_smoke.time_ms(
                        lambda fn=fn, rargs=rargs, rout=rout, r=r: fn(
                            *(t.data_ptr() for t in rargs), rout.data_ptr(),
                            r, m_pad5, n5, 1, r, stream), 20)
                    print(f"{src} {name} R={r} (v=1, c={r}): {ms:.4f} ms",
                          flush=True)
            continue
        if src == "crf_matmul":
            fn = lib.gaussian_kernel_matmul
            fn.argtypes = _build.SOURCES["crf_matmul"]["gaussian_kernel_matmul"]
            runs = K8_RUNS.get(name, {name: (None, None)})
            for label, n8, m8, vals, packed, ref in k8_cases:
                bms = 1e3 * counting.gaussian_matmul_least_s(
                    n8, m8, vals.shape[1])
                width, _, plan_split = bilateral.matmul_plan(
                    n8, m8, vals.shape[1], sms)
                for mode, (packing, split) in runs.items():
                    fi8, fj8 = packed[packing]
                    bufs = bilateral.matmul_bufs(
                        n8, m8, vals.shape[1], dev, width,
                        split or plan_split, K8_ROWS.get(name, 128))
                    rc, out, bufs = bilateral.launch_matmul(
                        fn, fi8, fj8, 5, vals, stream, bufs)
                    if rc != 0:
                        raise SystemExit(f"{src} {mode} {label}: launch "
                                         f"failed ({rc})")
                    # Against plain: a variant that keeps its outputs
                    # right reads as the full kernel does.
                    err = ((out[:1024] - ref).abs().max()
                           / ref.abs().max()).item()
                    ms = chip_smoke.time_ms(
                        lambda fn=fn, fi8=fi8, fj8=fj8, vals=vals,
                        bufs=bufs: bilateral.launch_matmul(
                            fn, fi8, fj8, 5, vals, stream, bufs), 10)
                    print(f"{src} {mode} {label}: {ms:.4f} ms "
                          f"({float(n8) * m8 / ms / 1e9:.3f} T pairs/s, "
                          f"{ms / bms:.2f}x its bound {bms:.4f}; "
                          f"max|out - plain|/max|plain| {err:.3g})",
                          flush=True)
                if name == "full":  # the wrapper's copy of v into v^T
                    vt = bufs[0]
                    ms = chip_smoke.time_ms(
                        lambda vt=vt, vals=vals, m8=m8: vt[:, :m8].copy_(
                            vals.t()), 10)
                    print(f"{src} v^T copy alone {label}: {ms:.4f} ms",
                          flush=True)
            continue
        if src == "flash_attention":
            fn = lib.flash_mha_flat_bf16
            fn.argtypes = [P] * 4 + [Ll] * 8 + [I] * 5 + [Fl, P]
            for label, qkv, o, fb, fs, fh, fd, ref in flash_shapes:
                hd = fh * fd
                rs, bs = 3 * hd, fs * 3 * hd
                ptr = qkv.data_ptr()
                call = (lambda fn=fn, ptr=ptr, hd=hd, rs=rs, bs=bs, o=o,
                        fb=fb, fs=fs, fh=fh, fd=fd: fn(
                            ptr, ptr + 2 * hd, ptr + 4 * hd, o.data_ptr(),
                            bs, rs, bs, rs, bs, rs, fs * hd, hd, fb, fs, fs,
                            fh, fd, fd**-0.5, stream))
                if call() != 0:
                    raise SystemExit(f"{src} {name}: launch failed")
                torch.cuda.synchronize()
                err = ("" if ref is None else "; max |out - plain| "
                       f"{(o.float() - ref).abs().max().item():.3g}")
                ms = chip_smoke.time_ms(call, 20)
                bms = 1e3 * counting.flash_least_s(fb, fh, fs, fd)
                print(f"{src} {name} {label}: {ms:.4f} ms ("
                      f"{4.0 * fb * fh * fs * fs * fd / ms / 1e9:.1f} "
                      f"TFLOP/s, {ms / bms:.2f}x its bound {bms:.4f}{err})",
                      flush=True)
            continue
        if src == "flash_qkv_proj":
            fn = lib.flash_mha_qkv_proj_bf16
            fn.argtypes = [P] * 6 + [I] * 6 + [Fl, P]
            hh, hd_ = vit.num_heads, vit.head_dim
            call = (lambda fn=fn: fn(
                pqkv.data_ptr(), px.data_ptr(), pw.data_ptr(),
                pbias.data_ptr(), pattn.data_ptr(), pout.data_ptr(), pb_,
                ps_, ps_, hh, hd_, d, hd_**-0.5, stream))
            if call() != 0:
                raise SystemExit(f"{src} {name}: launch failed")
            ms = chip_smoke.time_ms(call, 10)
            att = 4.0 * pb_ * hh * ps_ * ps_ * hd_
            proj = 2.0 * pb_ * ps_ * d * d
            print(f"{src} {name}: {ms:.4f} ms ({att / 1e9:.0f} GFLOP of "
                  f"attention, {proj / 1e9:.0f} of proj; "
                  f"{(att + proj) / ms / 1e9:.1f} TFLOP/s of the full "
                  "kernel's work)", flush=True)
            continue
        # K1 and K3 at both row counts: the whole call by CUDA events, then
        # each of its kernels by the profiler, each GEMM beside its
        # products' bound.
        if src == "ln_matmul":
            fn = lib.ln_matmul_bf16
            fn.argtypes = [P] * 7 + [I] * 3 + [Fl, P]
            calls = {mm: (lambda fn=fn, mm=mm: fn(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(),
                bias.data_ptr(), xn.data_ptr(), y.data_ptr(), mm, d, n, 1e-6,
                stream)) for mm in rows}
            gemms = {"k1::Bias": n}
        else:
            fn = lib.ln_mlp_residual_bf16
            fn.argtypes = [P] * 10 + [I] * 3 + [Fl, P]
            calls = {mm: (lambda fn=fn, mm=mm: fn(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), xn.data_ptr(),
                hidden.data_ptr(), z.data_ptr(), mm, d, f, 1e-6, stream))
                for mm in rows}
            gemms = {"k3::Fc1Gelu": f, "k3::Fc2Residual": f}
        for mm, call in calls.items():
            if call() != 0:
                raise SystemExit(f"{src} {name}: launch failed")
            ms = chip_smoke.time_ms(call, 10)
            flops = 2.0 * mm * d * sum(gemms.values())
            parts = []
            for kernel, kms in kernel_split(call, 10).items():
                epi = kernel.rsplit("<pnp::", 1)[-1].rstrip(">")
                share = ""
                if epi in gemms:
                    bound = 2.0 * mm * d * gemms[epi] / counting.BF16_FLOPS
                    share = f", {100 * bound * 1e3 / kms:.1f}% of its bound"
                parts.append(f"{kernel.split('::')[-1]} {kms:.4f}{share}")
            print(f"{src} {name} M={mm}: {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                  "TFLOP/s of the full kernel's work); ms a launch: "
                  f"{'; '.join(parts)}", flush=True)
    h = vit_block.layer_norm_f32(x[:m], g, b, 1e-6).to(torch.bfloat16)
    ms = chip_smoke.time_ms(lambda: F.linear(h, w), 10)
    print(f"cuBLAS F.linear of K1's product alone: {ms:.4f} ms "
          f"({2.0 * m * d * n / ms / 1e9:.1f} TFLOP/s)", flush=True)
    if "flash_qkv_proj" in sources:
        ms = chip_smoke.time_ms(lambda: F.linear(pattn, pw), 10)
        print(f"cuBLAS F.linear of K4's proj product alone: {ms:.4f} ms "
              f"({2.0 * pb_ * ps_ * d * d / ms / 1e9:.1f} TFLOP/s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
