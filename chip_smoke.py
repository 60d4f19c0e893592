#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pnp_ovss_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card: the GPU's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the port from ``pnp_ovss_tpu_torch/csrc``,
   one nvcc per source, all started together, and the host parity path's
   lattice CRF (``native/densecrf/permutohedral.cc``, g++, into
   ``build/densecrf/``);
3. kernels: each kernel at the main paths' shapes against its plain
   PyTorch version on the card, within the tolerance stated beside it,
   then timed with CUDA events: the kernel, its plain version, where one
   PyTorch call computes the same function that call (attention:
   ``F.scaled_dot_product_attention``), and for the fused ViT kernels
   the port's unfused route (LayerNorm, cuBLAS products, ``F.gelu``,
   K2), which the fused path never calls; K8 at the exact CRF's shape
   and at both Nystrom shapes, with its launch plan and two launches
   bit-equal; K7 at both sequence-parallel chunk shapes
   (sp = 2 at 336 and 768 px), bit-equal to K2's rows over the whole
   sequence; K9 on [B, H, S, D] views at four shapes; K2 also at the
   CLIP scorer's shape (ViT-L/14 at 336 px: 8 images x 577 tokens, 16
   heads of 64; also with keys masked past 535), a further entry of its
   ``shapes``; ``crf_spatial_operands`` on K6's output at the fused
   CRF's shape (qsub bit-equal, msp within 1e-5 relative L2 before its
   rounding and one bf16 ulp after) and ``crf_first_state`` on K5's
   K^T (one bf16 ulp; norm_bi and nb within 1e-6 relative);
4. reference: each branch of the CRF alone on the card against the CPU
   on one seeded scene (strided s=4 through K5, ``crf_first_state``,
   ``crf_spatial_operands`` and K6, the general loop on
   K5's kernel for 66 state rows and for N = 1600, exact through K8,
   Nystrom through K5 + K8); then narrow configurations of the whole
   pipeline on the card against the same weights and inputs on the CPU
   (plain versions): the fused ViT at 192 px (K1, K2, K3) and 384 px (K1,
   K4, K3), and the unfused ViT at 192 px with 2 heads (K2) and with 3
   heads (K9), each with the strided s=4 CRF (K5, K6); then the fused ViT
   at 192 px with the exact CRF (K8), with the Nystrom CRF at s=4 (K5,
   K8) and with 32 classes, whose 66 state rows take the general loop
   (K5); then the fused 192 px pipeline sequence-parallel over two
   spawned ranks that share the card through gloo (K1, K7, K3), against
   the same two ranks on the CPU and the card's unsharded run; then a
   narrow bf16 CLIP (168 px at patch 14, width 128, 2 layers each tower)
   on the card against the CPU: ``encode_image`` (K2 once a layer) and
   ``encode_text`` (no kernel);
5. pipeline: four full-width runs of ``SegmentationRunner`` with random
   weights from a seeded ``torch.Generator`` (BLIP-ITM-Large, 4 drop
   rounds, bucket 192, blur + 10-iteration CRF): the reference default
   (336 px, batch 35, fused ViT, strided s=4 CRF), bench.py's second leg
   (768 px, batch 12, fused ViT through K4), the unfused ViT at 336 px,
   and the reference default with the exact CRF (s=1, K8). Each checks
   the launch count of every kernel over three batches after a warm-up,
   labels in range and maps finite; their speed is ``port_bench``'s to
   measure (``python3 port_bench/run.py``). Then the reference default
   sequence-parallel over two ranks on the card (K1, K7, K3), against the
   unsharded run's labels, and one 768 px sequence-parallel encode
   against the unsharded encode;
6. the segmentation CLI (``pnp_ovss_tpu_torch.cli.segment.main``, in this
   process, on the card) over a synthetic VOC directory of 75 photo-like
   JPEGs at VOC sizes with PNG ground truth and a GPT-4o class cache (two
   full batches of 35 and a ragged tail of 5): its defaults (one r0 and
   one agg hist per image, each summing to the image's pixels; launches
   per batch those of the 336 px fused run, the tail batch included; the
   CLI's wall img/s over the two full batches), the same command again
   (resume: no launch, no file rewritten), the CLI's loader alone (its
   img/s, no device work), ``--eval_at_bucket`` (every
   device hist equal to numpy's, the run totals to the files' sums), and
   ``--checkpoint`` twice on a full-width LAVIS-layout state dict drawn
   from a seed at 384 px (every parameter equal to the dict's, the
   position embeddings resampled; the second run reads the cache);
7. the host parity path, the synthetic postprocess gate and the search,
   on the same synthetic VOC set: the CLI with ``--postprocess_backend
   host`` (two batches of 4: hist files complete, device launches the
   336 px fused run's at that batch, every parity label map equal to
   ``finalize_image_parity`` re-run on the main thread; beside it the
   device CLI's img/s on the same flags); the gate
   (``scripts/synthetic_postprocess_gate_torch.py``) at seed 0 x 48
   scenes for the strided s=4 CRF at bucket 192 and the exact CRF, each
   mean mIoU delta against the host anchor at least -0.3 points; and
   ``cli.search --scorer itc --n_iter 4`` at full width over 8 images
   with the 12-layer GradCAM ensemble and the ITM head scaled so that the
   maps reach the search's thresholds (a score above 0; layer 8's maps
   equal to the single-layer capture's within 1e-6 of the largest; one
   scorer call's ITC similarities on the card within 0.01 of the CPU's;
   K1 = K2 = K3 = 24 x the image encodes; seconds an image for the
   ensemble and for each evaluation); then ``cli.search --scorer clip``
   on the same flags with ``--clip_checkpoint``, a full-width ViT-L/14-336
   in OpenAI's layout drawn from a seed and written in half precision
   (every loaded parameter equal to the file's; K1 = K3 = 24 x the BLIP
   encodes, K2 = 24 x the BLIP and CLIP image encodes; every probability
   row finite and summing to 1, every scorer call on the main thread; one
   scorer call's CLIP similarities on the card within 0.01 of the CPU's;
   seconds an image as run G's);
8. data, tensor and pipeline parallelism (``parallel/``), every rank a
   spawned process sharing the card through gloo (NCCL refuses two ranks
   on one device), so every wall time is transport, no speed result: two
   ranks (data 1 x model 2) run the narrow 192 px fused pipeline under
   TP (one local head: K9; against the ranks' CPU run and the card's
   unsharded run, at five seeds) and under PP (equal to the unsharded
   run), then the reference default under TP (K1 = 192, K2' = 96, K3 =
   0 a rank; the timed runner's round-0 encode and GradCAM no further
   from the unsharded runner's than the unfused runner's, its labels
   within that yardstick) and under PP (pp 2, M 5:
   K1 = K2 = K3 = 240 a rank; equal to phase 5's run), each printing
   its parameter bytes and peak memory a rank; the CLI with
   ``--distributed --mesh --eval_at_bucket --device cuda:0`` on two
   ranks (torchrun's environment) over phase 6's synthetic set (every
   per-image hist equal to phase 6's single-process run's, both ranks'
   totals their sum, one synchronised average); and
   ``entry.dryrun_multichip(4)``. Phase 3 also holds K2' (a TP rank's
   8 heads, strided views) against its plain version and K2's heads.

The last four lines of output are one JSON object with the CLI and
parallel runs' rows, one with every kernel's numbers (each bound is
``port_bench/counting.py``'s roofline), the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

PIPELINE_BATCHES = 3  # launches counted, double-buffered, after a warm-up
BUCKET = 192  # the CRF bucket of the reference default (bench.py)
LEG_768 = (768, 12)  # bench.py's second leg: image size, batch
GT_SIZES = ((500, 375), (375, 500))  # VOC-like (H, W), alternating
# The sequence-parallel runs: ranks (spawned; they share the one card
# through gloo, since NCCL refuses two ranks on one device) and timed
# batches of the full-width run, whose wall time is gloo's transport.
SP = 2
SP_BATCHES = 1
RANKS_TIMEOUT_S = 600  # a spawn of ranks that outlasts this is killed


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def least_ms(nbytes: float, products: float = 0.0,
             elementwise: float = 0.0) -> tuple:
    """A launch's least time in ms by ``port_bench/counting.py``'s
    roofline (each byte read or written once, products at the bf16
    tensor-core rate, element-wise f32 work counting one operation an
    exponent), and which of "bytes", "products" or "element-wise" sets
    it."""
    from port_bench import counting

    parts = {"bytes": (nbytes, 0.0, 0.0), "products": (0.0, products, 0.0),
             "element-wise": (0.0, 0.0, elementwise)}
    by = max(parts, key=lambda k: counting.least_s(*parts[k]))
    return 1e3 * counting.least_s(nbytes, products, elementwise), by


def flash_least_ms(b: int, h: int, sq: int, l: int, d: int,
                   nbytes: float = None, products: float = 0.0) -> tuple:
    """``least_ms`` of the flash kernel at b x h heads of sq query rows
    over l keys of head dim d, by ``counting.flash_least_s``'s counts
    (equal to it at sq == l): q and the output at sq rows, k and v at l,
    bf16; QK^T and PV on the tensor cores; one exponent a score.
    ``nbytes`` replaces the bytes, ``products`` adds tensor-core work
    (K4's proj)."""
    scores = float(b) * h * sq * l
    if nbytes is None:
        nbytes = 2.0 * b * h * d * (2 * sq + 2 * l)
    return least_ms(nbytes, 4.0 * scores * d + products, scores)


def k8_least_ms(n: int, m: int, c: int) -> tuple:
    """``least_ms`` of K8 by ``counting.gaussian_matmul_least_s``'s counts
    (equal to it): f32 features of both sides and bf16 values read, the
    f32 output written; the distance's cross term and the product with
    the values on the tensor cores; one exponent a pair."""
    pairs = float(n) * m
    return least_ms((n + m) * 5 * 4 + m * c * 2 + n * c * 4,
                    2.0 * pairs * (5 + c), pairs)


# Tolerances of the fused ViT kernels against their plain versions, in
# absolute units at the main-path shapes, each about 2x the seeded H100
# reading (printed beside it, with one bf16 ulp at the largest output):
# K1 0.0156 at |y| <= 5.8 (half an ulp), K3 0.0312 at |y| <= 6.5 (one
# ulp; two roundings), K4 0.0039 at |y| <= 0.59 (one ulp).
TOL_LN_MATMUL = 0.04
TOL_LN_MLP = 0.0625
TOL_QKV_PROJ = 0.008


def check(name: str, err: float, tol: float) -> None:
    print(f"  {name}: max_abs_err {err:.3g} (tolerance {tol:g})", flush=True)
    if not err <= tol:
        raise SystemExit(f"FAIL: {name} max_abs_err {err} > {tol}")


def with_rate(row: dict, nbytes: float) -> dict:
    """``row`` with the achieved memory rate of its ``ms`` over the
    ``nbytes`` its bound counts (GB/s)."""
    row["gb_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
    return row


def with_shapes(lines) -> dict:
    """The first of ``lines``, one kernel's rows at several shapes, with
    every row less the kernel's own fields as its ``shapes``."""
    row = dict(lines[0])
    row["shapes"] = [{k: v for k, v in r.items() if k not in (
        "name", "route", "source", "replaces")} for r in lines]
    return row


def crf_features(cfg, gen):
    """K5's inputs as the CRF makes them once per image: N = bucket^2
    pixel features against M = (bucket/s)^2 strided anchors, scaled for a
    VOC image as the runner scales them, xy_scale = (bucket/gt_w,
    bucket/gt_h)."""
    import torch

    from pnp_ovss_tpu_torch.ops.crf import bilateral_features

    hb, sub = BUCKET, cfg.postprocess.bilateral_subsample
    crf_cfg = cfg.postprocess.crf
    gt_h, gt_w = GT_SIZES[0]
    dev = gen.device
    rgb = torch.randint(0, 256, (hb, hb, 3), generator=gen, device=dev)
    scale = torch.tensor([hb / gt_w, hb / gt_h], device=dev)
    feats = bilateral_features(rgb.float(), crf_cfg.bi_xy_std * scale,
                               crf_cfg.bi_rgb_std)
    feats_j = feats.reshape(hb, hb, 5)[::sub, ::sub].reshape(-1, 5)
    return feats_j, feats


def crf_iteration_args(cfg, kt, gen):
    """K6's inputs as the CRF makes them once per image and iteration, on
    K5's ``kt``: v = 2 unary variants (round-0 and aggregated maps) of
    c = max_classes + 1 channels (background added), rows padded to a 16
    multiple as crf.py packs them. Returns ((qsub, kt, u_neg, msp, nb),
    v, c)."""
    import torch
    from torch.nn import functional as F

    from pnp_ovss_tpu_torch.ops import bilateral

    hb, sub = BUCKET, cfg.postprocess.bilateral_subsample
    crf_cfg = cfg.postprocess.crf
    m_pad, n = kt.shape
    m = (-(-hb // sub)) ** 2
    vv, c = 2, cfg.max_classes + 1
    r = -(-(vv * c) // 16) * 16

    def anchors(x):  # [rows, N] -> [rows, M] at the strided anchors
        return x.reshape(-1, hb, hb)[:, ::sub, ::sub].reshape(x.shape[0], -1)

    q255 = bilateral.KT_QUANT_SCALE
    norm_bi = torch.rsqrt(
        (kt.sum(dim=0, dtype=torch.float32)[None] / q255).clamp(min=1e-20))
    nb = crf_cfg.bi_w / q255 * norm_bi
    probs = torch.softmax(torch.randn((vv, c, n), generator=gen,
                                      device=gen.device),
                          dim=1).reshape(vv * c, n)
    rows_pad = (0, 0, 0, r - vv * c)
    state = F.pad(probs, rows_pad)
    qsub = F.pad(anchors(state) * anchors(norm_bi),
                 (0, m_pad - m)).to(torch.bfloat16)
    u_neg = F.pad(torch.log(probs.clamp(1e-5, 1.0)), rows_pad) \
        .to(torch.bfloat16)
    msp = (crf_cfg.pos_w * state).to(torch.bfloat16)
    return (qsub, kt, u_neg, msp, nb), vv, c


def kernels_vs_plain(cfg):
    """Phase 3, at the shapes the main path of ``cfg`` gives each kernel.
    Returns {kernel name: row of the kernels line}."""
    import torch
    from torch.nn import functional as F

    from pnp_ovss_tpu_torch.ops import bilateral, flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # K2 as the ViT calls it: one launch per layer over the whole batch,
    # S = (336/16)^2 patches + CLS = 442 tokens, 16 heads of 64.
    vit = cfg.model.vit
    b, s, h, d = cfg.batch_size, vit.seq_len, vit.num_heads, vit.head_dim
    hd = h * d
    qkv = torch.randn((b, s, 3 * hd), generator=gen, device=dev) \
        .to(torch.bfloat16)
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    out = flash_attention.flash_mha_flat_qkv(qkv, num_heads=h)
    ref = flash_attention.attention_plain(q, k, v, num_heads=h, true_len=s,
                                          out_dtype=torch.float32)
    print(f"  flash_mha_flat_qkv B={b} S={s} H={h} D={d}: |ref| max "
          f"{ref.abs().max().item():.3g}, rms "
          f"{ref.square().mean().sqrt().item():.3g}", flush=True)
    # The kernel rounds P to bf16 for the P.V product and the output to
    # bf16 once. With randn q/k/v the outputs have rms ~0.08 and reach
    # ~1.2 (H100 reading, printed above); the sound reading is 0.002, and
    # 5e-3 is 2.5x that and 1/16 of the outputs' rms.
    err = (out.float() - ref).abs().max().item()
    check("flash_mha_flat_qkv vs plain", err, 5e-3)
    sliced = flash_attention.flash_mha_flat(
        q.contiguous(), k.contiguous(), v.contiguous(), num_heads=h)
    check("flash_mha_flat (sliced q/k/v) vs flash_mha_flat_qkv",
          (sliced.float() - out.float()).abs().max().item(), 0.0)
    # Padded carry: keys >= tl masked; rows >= tl are garbage by contract.
    tl = s - 42
    pad_out = flash_attention.flash_mha_flat_qkv(qkv, num_heads=h,
                                                 true_len=tl)
    pad_ref = flash_attention.attention_plain(
        q, k, v, num_heads=h, true_len=tl, out_dtype=torch.float32)
    check(f"flash_mha_flat_qkv true_len={tl} vs plain",
          (pad_out[:, :tl].float() - pad_ref[:, :tl]).abs().max().item(),
          5e-3)
    torch.cuda.synchronize()
    qh, kh_, vh = (x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v))
    nbytes = qkv.numel() * 2 + b * s * hd * 2
    bms, by = flash_least_ms(b, h, s, s, d)
    rows["flash_mha_flat_qkv"] = with_rate(dict(
        name="flash_mha_flat_qkv", route="cuda",
        source="pnp_ovss_tpu_torch/csrc/flash_attention.cu",
        replaces="pnp_ovss_tpu/ops/flash_attention.py:325",
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention.flash_mha_flat_qkv(
            qkv, num_heads=h), 20),
        plain_ms=time_ms(lambda: flash_attention.attention_plain(
            q, k, v, num_heads=h, true_len=s, out_dtype=torch.bfloat16), 5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh_, vh), 20),
        shape=f"336 px BLIP ViT [{b}, {s}, {3 * hd}]"), nbytes)
    rows["flash_mha_flat_qkv"] = with_shapes(
        [rows["flash_mha_flat_qkv"], clip_flash_kernel(gen)])

    # K2' as tensor parallelism calls it (tp = 2): rank 1's 8 heads, the
    # strided column views [512:1024] of q, k and v in the replicated qkv.
    hl = h // 2
    lo, w = hl * d, hl * d
    ql, kl, vl = (qkv[..., i * hd + lo:i * hd + lo + w] for i in range(3))
    out_l = flash_attention.flash_mha_flat(ql, kl, vl, num_heads=hl)
    ref_l = flash_attention.attention_plain(ql, kl, vl, num_heads=hl,
                                            true_len=s,
                                            out_dtype=torch.float32)
    err_l = (out_l.float() - ref_l).abs().max().item()
    check("flash_mha_flat (a TP rank's heads) vs plain", err_l, 5e-3)
    check("flash_mha_flat (a TP rank's heads) vs K2's same heads",
          (out_l.float() - out[..., lo:lo + w].float()).abs().max().item(),
          0.0)
    qlh, klh, vlh = (x.view(b, s, hl, d).transpose(1, 2)
                     for x in (ql, kl, vl))
    nbytes = 4 * b * s * w * 2
    bms, by = flash_least_ms(b, hl, s, s, d)
    rows["flash_mha_flat"] = with_rate(dict(
        name="flash_mha_flat", route="cuda",
        source="pnp_ovss_tpu_torch/csrc/flash_attention.cu",
        replaces="pnp_ovss_tpu/ops/flash_attention.py:260",
        max_abs_err=err_l,
        ms=time_ms(lambda: flash_attention.flash_mha_flat(
            ql, kl, vl, num_heads=hl), 20),
        plain_ms=time_ms(lambda: flash_attention.attention_plain(
            ql, kl, vl, num_heads=hl, true_len=s,
            out_dtype=torch.bfloat16), 5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qlh, klh, vlh), 20),
        shape=f"336 px TP rank [{b}, {s}, {hl} of {h} heads]"), nbytes)

    # K5 as the CRF calls it, once per image.
    feats_j, feats = crf_features(cfg, gen)
    kt = bilateral.gaussian_kernel_materialize(feats_j, feats)
    kt_ref = bilateral.materialize_plain(feats_j, feats, kt.shape[0],
                                         torch.uint8)
    # Codes may differ by one where k*255 sits at a rounding boundary
    # (the exponent's arithmetic differs from torch.exp's).
    err5 = (kt.int() - kt_ref.int()).abs().max().item()
    differ = (kt != kt_ref).sum().item() / kt.numel()
    print(f"  gaussian_kernel_materialize: {differ:.3g} of {kt.numel()} "
          "codes differ from plain", flush=True)
    check("gaussian_kernel_materialize uint8 vs plain (codes)", err5, 1)
    del kt_ref
    kf = bilateral.gaussian_kernel_materialize(feats_j, feats,
                                               out_dtype=torch.float32)
    kf_ref = bilateral.materialize_plain(feats_j, feats, kf.shape[0],
                                         torch.float32)
    check("gaussian_kernel_materialize f32 vs plain",
          (kf - kf_ref).abs().max().item(), 1e-6)
    del kf, kf_ref
    m, n = feats_j.shape[0], feats.shape[0]
    odd = bilateral.gaussian_kernel_materialize(feats_j[:m - 4], feats)
    if odd.shape[0] % 128 or odd.shape[0] < m - 4 or odd[m - 4:].any():
        raise SystemExit("FAIL: gaussian_kernel_materialize pad rows not 0")
    m_pad = kt.shape[0]
    nbytes = m_pad * n + (m + n) * 5 * 4
    # As K8's entries: the distance's cross term a product, one exponent.
    bms, by = least_ms(nbytes, 2.0 * m * n * 5, 1.0 * m * n)
    rows["gaussian_kernel_materialize"] = with_rate(dict(
        name="gaussian_kernel_materialize", route="cuda",
        source="pnp_ovss_tpu_torch/csrc/crf_materialize.cu",
        replaces="pnp_ovss_tpu/ops/bilateral_pallas.py:204",
        max_abs_err=float(err5), codes_differing=differ,
        ms=time_ms(lambda: bilateral.gaussian_kernel_materialize(
            feats_j, feats), 20),
        plain_ms=time_ms(lambda: bilateral.materialize_plain(
            feats_j, feats, m_pad, torch.uint8), 3),
        bound_ms=bms, bound_by=by, library_ms=None), nbytes)

    # K6 as the CRF calls it, once per image and iteration.
    args, vv, c = crf_iteration_args(cfg, kt, gen)
    r = args[0].shape[0]
    out6 = bilateral.crf_fused_iteration(*args, v=vv, c=c)
    ref6 = bilateral.crf_iteration_plain(*args, v=vv, c=c,
                                         out_dtype=torch.bfloat16)
    # Probabilities rounded to bf16 once: 2 ulps at 1.0.
    err6 = (out6.float() - ref6.float()).abs().max().item()
    check("crf_fused_iteration vs plain", err6, 1e-2)
    if out6[vv * c:].any():
        raise SystemExit("FAIL: crf_fused_iteration pad rows not 0")
    nbytes = m_pad * n + r * m_pad * 2 + 3 * r * n * 2 + n * 4
    bms, by = least_ms(nbytes, 2.0 * r * m_pad * n)
    rows["crf_fused_iteration"] = with_rate(dict(
        name="crf_fused_iteration", route="cuda",
        source="pnp_ovss_tpu_torch/csrc/crf_iteration.cu",
        replaces="pnp_ovss_tpu/ops/bilateral_pallas.py:320",
        max_abs_err=err6,
        ms=time_ms(lambda: bilateral.crf_fused_iteration(
            *args, v=vv, c=c), 20),
        plain_ms=time_ms(lambda: bilateral.crf_iteration_plain(
            *args, v=vv, c=c, out_dtype=torch.bfloat16), 5),
        bound_ms=bms, bound_by=by, library_ms=None), nbytes)
    rows["crf_spatial_operands"] = spatial_operands_row(cfg, kt, out6)
    rows["crf_first_state"] = first_state_row(cfg, kt, gen)
    return rows


def band_taps(sigma: float, dim: int) -> int:
    """Taps a side of the spatial band whose f32 entries are not 0 (the
    kernel's cut): the least c with exp(-(c / sigma)^2 / 2) == 0 in f32,
    at most ``dim``."""
    import numpy as np

    c = 1
    while c < dim and np.exp(np.float32(-0.5) * np.square(
            np.float32(c) / np.float32(sigma))) != 0:
        c += 1
    return c


def spatial_operands_row(cfg, kt, state):
    """Phase 3 for ``crf_spatial_operands`` as the fused loop calls it,
    once per image and iteration, on the state K6 returned (R = 64 rows,
    pad rows 0) at the first VOC-like ground truth's spatial sigmas:
    qsub bit-equal to the plain product rounded once, msp before its
    rounding within 1e-5 relative L2 of the plain f32 product and after
    it within one bf16 ulp. The bound counts the band's f32 FMAs whose
    entries are not 0, and each byte once. Returns its kernels-line
    row."""
    import torch

    from pnp_ovss_tpu_torch.ops import crf

    hb, sub = BUCKET, cfg.postprocess.bilateral_subsample
    crf_cfg = cfg.postprocess.crf
    gt_h, gt_w = GT_SIZES[0]
    sigma = (crf_cfg.pos_xy_std * hb / gt_h, crf_cfg.pos_xy_std * hb / gt_w)
    sig = torch.tensor(sigma, device=state.device)
    m_pad, n = kt.shape
    r, rows = state.shape[0], 2 * (cfg.max_classes + 1)
    norm_bi = torch.rsqrt(crf._materialised_degree(kt).clamp(min=1e-20))
    kw = dict(h=hb, w=hb, s=sub, m_pad=m_pad, pos_w=crf_cfg.pos_w)
    msp, qsub = crf.crf_spatial_operands(state, norm_bi, sig, rows=rows,
                                         **kw)
    msp32, _ = crf.crf_spatial_operands(state, norm_bi, sig, rows=rows,
                                        msp_dtype=torch.float32, **kw)
    want16, want_qsub = crf.spatial_operands_plain(state, norm_bi, sig,
                                                   **kw)
    want32, _ = crf.spatial_operands_plain(state, norm_bi, sig,
                                           msp_dtype=torch.float32, **kw)
    check("crf_spatial_operands qsub vs plain",
          (qsub.float() - want_qsub.float()).abs().max().item(), 0.0)
    rel = ((msp32 - want32).norm() / want32.norm()).item()
    check("crf_spatial_operands msp f32 vs plain (relative L2)", rel, 1e-5)
    ulps = (msp.view(torch.int16).int()
            - want16.view(torch.int16).int()).abs().max().item()
    check("crf_spatial_operands msp vs plain (bf16 ulps)", ulps, 1)
    if msp[rows:].any() or qsub[rows:].any():
        raise SystemExit("FAIL: crf_spatial_operands pad rows not 0")
    taps = sum(2 * band_taps(sg, hb) - 1 for sg in sigma)
    nbytes = 2 * r * n * 2 + r * m_pad * 2 + n * 4
    bms, by = least_ms(nbytes, 2.0 * rows * n * taps)
    return with_rate(dict(
        name="crf_spatial_operands", route="cuda",
        source="pnp_ovss_tpu_torch/csrc/crf_spatial.cu",
        replaces="none (XLA: pnp_ovss_tpu/ops/crf.py:476-544)",
        max_abs_err=rel, bf16_ulps=ulps,
        ms=time_ms(lambda: crf.crf_spatial_operands(
            state, norm_bi, sig, rows=rows, **kw), 50),
        plain_ms=time_ms(lambda: crf.spatial_operands_plain(
            state, norm_bi, sig, **kw), 10),
        bound_ms=bms, bound_by=by, library_ms=None,
        dense_ops_bound_ms=least_ms(0.0, 2.0 * rows * 2 * hb ** 3)[0],
        taps=taps, sigma=list(sigma)), nbytes)


def first_state_row(cfg, kt, gen):
    """Phase 3 for ``crf_first_state`` as the fused loop calls it, once an
    image, on K5's ``kt``: two variants of max_classes + 1 slots over the
    bucket's pixels, bf16 logits with the slots past 4 classes at the
    runner's disabled value: the state and its log within one bf16 ulp
    of the plain version, pad rows 0, norm_bi and nb within 1e-6
    relative. Bound by its bytes (K^T's the most). Returns its
    kernels-line row."""
    import torch

    from pnp_ovss_tpu_torch.ops import crf
    from pnp_ovss_tpu_torch.pipeline.runner import _DISABLED

    vv, c, n = 2, cfg.max_classes + 1, kt.shape[1]
    r = -(-(vv * c) // 16) * 16
    nb_scale = cfg.postprocess.crf.bi_w / 255.0
    logits = torch.randn((vv, c, n), generator=gen, device=gen.device) * 3
    logits[:, 5:] = _DISABLED
    logits = logits.to(torch.bfloat16)
    (got, norms), (want, want_norms) = (
        crf.crf_first_state(logits, kt, r, nb_scale),
        crf.first_state_plain(logits, kt, r, nb_scale))
    ulps = (got.view(torch.int16).int()
            - want.view(torch.int16).int()).abs().max().item()
    check("crf_first_state vs plain (bf16 ulps)", ulps, 1)
    rel = ((norms - want_norms).abs() / want_norms).max().item()
    check("crf_first_state norms vs plain (relative)", rel, 1e-6)
    if got[:, vv * c:].any():
        raise SystemExit("FAIL: crf_first_state pad rows not 0")
    nbytes = logits.numel() * 2 + kt.numel() + got.numel() * 2 + n * 8
    bms, by = least_ms(nbytes)
    return with_rate(dict(
        name="crf_first_state", route="cuda",
        source="pnp_ovss_tpu_torch/csrc/crf_spatial.cu",
        replaces="none (XLA: pnp_ovss_tpu/ops/crf.py:190-191, :459-462, "
        ":502)",
        max_abs_err=float(ulps), norms_rel_err=rel,
        ms=time_ms(lambda: crf.crf_first_state(logits, kt, r, nb_scale), 50),
        plain_ms=time_ms(
            lambda: crf.first_state_plain(logits, kt, r, nb_scale), 20),
        bound_ms=bms, bound_by=by, library_ms=None), nbytes)


# The CLIP scorer's batch: the 2K masked images (positives, then black
# negatives) of an image with K = 4 classes, each one encode_image call.
CLIP_SCORER_BATCH = 8


def clip_flash_kernel(gen) -> dict:
    """Phase 3 for K2 at the CLIP vision tower's shape (ViT-L/14 at 336
    px: 24 x 24 + 1 = 577 tokens, 16 heads of 64), one launch per layer
    over the scorer's batch: against its plain version within
    ``TOL_FLASH``, also with ``true_len = S - 42`` (keys past it must not
    leak into the rows before it, trap F3), then timed beside SDPA.
    Returns the shape's entry of K2's ``shapes``."""
    import torch
    from torch.nn import functional as F

    from pnp_ovss_tpu_torch.config import CLIPConfig
    from pnp_ovss_tpu_torch.ops import flash_attention

    v = CLIPConfig().vision
    b, s, h, d = CLIP_SCORER_BATCH, v.num_patches + 1, v.num_heads, \
        v.head_dim
    hd = h * d
    qkv = torch.randn((b, s, 3 * hd), generator=gen, device=gen.device) \
        .to(torch.bfloat16)
    q, k, vv = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    err = 0.0
    for tl in (s, s - 42):
        out = flash_attention.flash_mha_flat_qkv(qkv, num_heads=h,
                                                 true_len=tl)
        ref = flash_attention.attention_plain(
            q, k, vv, num_heads=h, true_len=tl, out_dtype=torch.float32)
        e = (out[:, :tl].float() - ref[:, :tl]).abs().max().item()
        check(f"flash_mha_flat_qkv CLIP [{b}, {s}, {3 * hd}] true_len={tl} "
              "vs plain", e, TOL_FLASH)
        err = e if tl == s else err
    del out, ref
    torch.cuda.synchronize()
    qh, kh, vh = (x.view(b, s, h, d).transpose(1, 2) for x in (q, k, vv))
    nbytes = qkv.numel() * 2 + b * s * hd * 2
    bms, by = flash_least_ms(b, h, s, s, d)
    return with_rate(dict(
        shape=f"336 px CLIP ViT-L/14 [{b}, {s}, {3 * hd}]", max_abs_err=err,
        ms=time_ms(lambda: flash_attention.flash_mha_flat_qkv(
            qkv, num_heads=h), 20),
        plain_ms=time_ms(lambda: flash_attention.attention_plain(
            q, k, vv, num_heads=h, true_len=s, out_dtype=torch.bfloat16), 5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh), 20)), nbytes)


# K8's shapes: (label, i-side, j-side, channels, signed values), with the
# tolerance on max |K8 - plain| / max |plain|, about 2x the seeded H100
# reading beside it (the starting bar was 5e-3). Both round k to bf16, so
# a k code may flip where the exponent's rounding differs (K8 scales the
# features for ex2 and sums the differences in another order).
K8_SHAPES = (
    ("exact C=58", "pixels", "pixels", 58, False, 7e-4),  # 3.35e-4
    ("exact degree C=1", "pixels", "pixels", 1, False, 2e-4),  # 8.62e-5
    ("exact C=12", "pixels", "pixels", 12, False, 7e-4),
    ("nystrom K_AN C=58", "anchors", "pixels", 58, False, 5e-4),  # 2.18e-4
    ("nystrom K_NA C=58 signed", "pixels", "anchors", 58, True,
     4e-5),  # 1.95e-5
)
K8_CHECK_ROWS = 4096  # the plain version at N x N takes seconds


def photo_like_rgb(h: int, w: int, gen):
    """A smooth textured image with noise (tests' CRF scene), so that many
    bilateral pairs interact and not only each pixel with itself."""
    import torch

    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=gen.device),
        torch.arange(w, dtype=torch.float32, device=gen.device),
        indexing="ij")
    img = torch.stack([120 + 60 * torch.sin(xx / 9) + 40 * yy / h,
                       100 + 50 * torch.cos(yy / 7) + 30 * xx / w,
                       90 + 45 * torch.sin((xx + yy) / 11)], -1)
    noise = torch.randn((h, w, 3), generator=gen, device=gen.device)
    return (img + 12 * noise).clamp(0, 255)


def k8_support(cfg, gen):
    """K8's features at the exact and Nystrom CRFs' shapes: the pixels of
    the 192 bucket of a photo-like scene, scaled as the runner scales
    them for a 500x375 GT, and the s = 4 anchors."""
    import torch

    from pnp_ovss_tpu_torch.ops.crf import bilateral_features

    hb, sub = BUCKET, 4
    crf_cfg = cfg.postprocess.crf
    gt_h, gt_w = GT_SIZES[0]
    scale = torch.tensor([hb / gt_w, hb / gt_h], device=gen.device)
    feats = bilateral_features(photo_like_rgb(hb, hb, gen),
                               crf_cfg.bi_xy_std * scale, crf_cfg.bi_rgb_std)
    return {"pixels": feats,
            "anchors": feats.reshape(hb, hb, 5)[::sub, ::sub]
            .reshape(-1, 5).contiguous()}


def k8_values(m: int, c: int, signed: bool, gen):
    """K8's values as the CRF passes them: ones for the degree (C = 1),
    two variants' probabilities for a message, or signed values (the
    Nystrom projection's output)."""
    import torch

    if c == 1:
        return torch.ones((m, 1), device=gen.device)
    if signed:
        return torch.randn((m, c), generator=gen, device=gen.device)
    return torch.softmax(torch.randn((m, 2, c // 2), generator=gen,
                                     device=gen.device), -1).reshape(m, c)


def flash_sass_counts(paths) -> dict:
    """Instruction counts in the built flash libraries' SASS (cuobjdump):
    HGMMA (wgmma), HMMA (mma.sync) and LDGSTS (cp.async)."""
    from pnp_ovss_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    counts = {}
    for name in ("flash_attention", "flash_qkv_proj"):
        sass = subprocess.run([cuobjdump, "-sass", str(paths[name])],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts[name] = {op: sum(line.split()[1:2] == [op] or
                                f" {op}." in line or f" {op} " in line
                                for line in sass.splitlines()
                                if "/*" in line)
                        for op in ("HGMMA", "HMMA", "LDGSTS")}
    return counts


def kernel_matmul_check(cfg):
    """Phase 3 for K8 at the shapes of the exact CRF (N = M = 36864
    pixels of the 192 bucket: the message with C = 58 channels of two
    variants and the degree with C = 1) and of the Nystrom CRF at s = 4
    (2304 anchors against the pixels and back, with signed values), the
    features scaled as the runner scales them for a 500x375 GT, and the
    exact CRF's widest message in the benchmark's traffic (C = 12, two
    variants of 4 classes and 2 slots). K8 rows are independent, so the
    plain version runs on the first ``K8_CHECK_ROWS`` i-rows against all
    j; a second launch must equal the first bit for bit. Prints each
    shape's schedule and launch plan (channel width, j split or block
    side, work units an SM), read from the buffers of the launch that
    ran, and asserts ``crf.k8_symmetric_launches``: one a call where the
    j side is the i side and C <= 16 (the degree, C = 12), none else. ``ms`` times the one-shot entry
    ``gaussian_kernel_matmul``, which packs the features on every call,
    ``closure_ms`` the wrapper as the CRF calls it (``kernel_matmul_fn``,
    features packed once per image). Returns the row of the kernels line,
    at the exact CRF's message shape."""
    import torch

    from pnp_ovss_tpu_torch.ops import bilateral
    from pnp_ovss_tpu_torch.utils.tracing import TRACER

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    support = k8_support(cfg, gen)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lines = []
    for label, side_i, side_j, c, signed, tol in K8_SHAPES:
        fi, fj = support[side_i], support[side_j]
        n, m = fi.shape[0], fj.shape[0]
        vals = k8_values(m, c, signed, gen)
        fj_arg = None if side_i == side_j else fj
        # As the CRF calls it: the features packed once per image.
        fn = bilateral.kernel_matmul_fn(fi, fj_arg)
        TRACER.drain()
        TRACER.enable()
        try:
            out = fn(vals)
            counted = TRACER.drain()["counters"]
        finally:
            TRACER.disable()
        plan = fn.bufs[c]
        symmetric = fj_arg is None and c <= 16
        if plan.unit_tiles:
            sym = bilateral.symmetric_plan(n, c, sms)
            print(f"  gaussian_kernel_matmul {label}: symmetric schedule, "
                  f"width {plan.width}, blocks of {plan.unit_tiles} row "
                  f"tiles: {sym.units} units, {sym.units_per_sm:.3f} an SM "
                  f"of {sms}, partials {plan.ws.numel() * 4 / 1e6:.1f} MB",
                  flush=True)
        else:
            units = plan.counters.numel() * plan.split  # tiles x chunks x split
            print(f"  gaussian_kernel_matmul {label}: general schedule, "
                  f"width {plan.width} x {-(-c // plan.width)} chunk(s), j "
                  f"split {plan.split}: {units} units, {units / sms:.3f} an "
                  f"SM of {sms}", flush=True)
        if bool(plan.unit_tiles) != symmetric or counted != (
                {"crf.k8_symmetric_launches": 1} if symmetric else {}):
            raise SystemExit(f"FAIL: gaussian_kernel_matmul {label}: "
                             f"schedule {plan.unit_tiles}, counters "
                             f"{counted}, want symmetric={symmetric}")
        if not (torch.equal(out, fn(vals)) and torch.equal(
                out, bilateral.gaussian_kernel_matmul(fi, vals, fj_arg))):
            raise SystemExit(f"FAIL: gaussian_kernel_matmul {label}: two "
                             "launches differ")
        rows = min(K8_CHECK_ROWS, n)
        ref = bilateral.kernel_matmul_plain(fi[:rows], vals, fj)
        top = ref.abs().max().item()
        rel = (out[:rows] - ref).abs().max().item() / top
        print(f"  gaussian_kernel_matmul {label} N={n} M={m}: "
              f"first {rows} rows, |ref| max {top:.4g}", flush=True)
        check(f"gaussian_kernel_matmul {label} max|K8-plain|/max|plain|",
              rel, tol)
        del out, ref
        torch.cuda.synchronize()
        bms, by = k8_least_ms(n, m, c)
        nbytes = (n + m) * 5 * 4 + m * c * 4 + n * c * 4  # f32 values
        lines.append(with_rate(dict(
            name="gaussian_kernel_matmul", route="cuda",
            source="pnp_ovss_tpu_torch/csrc/crf_matmul.cu",
            replaces="pnp_ovss_tpu/ops/bilateral_pallas.py:104",
            max_abs_err=rel * top, rel_err=rel, tolerance_rel=tol,
            ms=time_ms(lambda: bilateral.gaussian_kernel_matmul(
                fi, vals, fj_arg), 10),
            closure_ms=time_ms(lambda: fn(vals), 10),
            plain_ms=time_ms(lambda: bilateral.kernel_matmul_plain(
                fi, vals, fj), 1, warmup=1),
            bound_ms=bms, bound_by=by, library_ms=None,
            shape=f"{label} N={n} M={m}"), nbytes))
    return with_shapes(lines)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    import math

    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def fused_vit_kernels(cfg, cfg768):
    """Phase 3 for K1 and K3 at both main-path shapes (M = B * S rows of
    the ViT's residual stream at 336 and 768 px; neither M is a multiple
    of their GEMM's 128-row tile) and K4 at 768 px, weights drawn
    as ``init_blip_itm`` draws them (N(0, 1/fan_in)) with perturbed norms
    and biases. Returns {kernel name: row of the kernels line}, each row
    at the shape of the path that runs it: K1 and K3 at 336 px (the
    reference default), K4 at 768 px."""
    import torch
    from torch.nn import functional as F

    from pnp_ovss_tpu_torch.ops import _build, flash_attention, vit_block

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    vit = cfg.model.vit
    d, h, hd = vit.hidden_size, vit.num_heads, vit.head_dim
    f = int(d * vit.mlp_ratio)
    eps = vit.layer_norm_eps

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(dtype)

    def norm():
        return (1 + randn(d, scale=0.1, dtype=torch.float32),
                randn(d, scale=0.1, dtype=torch.float32))

    g1, be1 = norm()
    g2, be2 = norm()
    wqkv, bqkv = randn(3 * d, d, scale=d**-0.5), randn(3 * d, scale=0.02)
    w1, b1 = randn(f, d, scale=d**-0.5), randn(f, scale=0.02)
    w2, b2 = randn(d, f, scale=f**-0.5), randn(d, scale=0.02)
    wp, bp = randn(d, d, scale=d**-0.5), randn(d, scale=0.02)

    def ln_bf16(x, g, b):  # the unfused block's LayerNorm module
        return F.layer_norm(x.float(), (d,), g, b, eps).to(torch.bfloat16)

    def err_of(out, ref, name, tol):
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        print(f"  {name}: |ref| max {top:.3g} (1 bf16 ulp there "
              f"{bf16_ulp(top):.3g})", flush=True)
        check(name, err, tol)
        return err

    rows = {}
    for label, c in (("336 px", cfg), ("768 px", cfg768)):
        b, s = c.batch_size, c.model.vit.seq_len
        m = b * s
        x = randn(m, d)
        k1 = lambda: vit_block.ln_matmul(x, g1, be1, wqkv, bqkv, eps=eps)
        k1_plain = lambda: vit_block.ln_matmul_plain(
            x, g1, be1, wqkv, bqkv, eps=eps)
        # Both round the same f32 sums to bf16 once, summed in another
        # order: a value may land one ulp apart, 0.0312 at |y| in [4, 8).
        e1 = err_of(k1(), k1_plain(),
                    f"ln_matmul {label} M={m} (M mod 128 = {m % 128}) vs "
                    "plain", TOL_LN_MATMUL)
        k3 = lambda: vit_block.ln_mlp_residual(
            x, g2, be2, w1, b1, w2, b2, eps=eps)
        k3_plain = lambda: vit_block.ln_mlp_residual_plain(
            x, g2, be2, w1, b1, w2, b2, eps=eps)
        # Two roundings (the MLP output, then x + it) after sums taken in
        # another order, and the hidden rounded to bf16 twice on the way.
        e3 = err_of(k3(), k3_plain(),
                    f"ln_mlp_residual {label} M={m} (M mod 128 = "
                    f"{m % 128}) vs plain", TOL_LN_MLP)
        torch.cuda.synchronize()
        k1_unfused = lambda: F.linear(
            ln_bf16(x, g1, be1), wqkv, bqkv)
        k3_unfused = lambda: x + F.linear(
            F.gelu(F.linear(ln_bf16(x, g2, be2), w1, b1)), w2, b2)
        k1_bytes = 2 * (m * d + 3 * d * d + 3 * d + 3 * d * m) + 8 * d
        k3_bytes = 2 * (2 * m * d + 2 * d * f + f + d) + 8 * d
        t1 = dict(ms=time_ms(k1, 20), plain_ms=time_ms(k1_plain, 3),
                  unfused_ms=time_ms(k1_unfused, 20))
        t3 = dict(ms=time_ms(k3, 10), plain_ms=time_ms(k3_plain, 3),
                  unfused_ms=time_ms(k3_unfused, 10))
        for name, t, e, nbytes, ops, src, rep in (
                ("ln_matmul", t1, e1, k1_bytes, 2.0 * m * d * 3 * d,
                 "ln_matmul.cu", "vit_block_pallas.py:119"),
                ("ln_mlp_residual", t3, e3, k3_bytes, 4.0 * m * d * f,
                 "ln_mlp_residual.cu", "vit_block_pallas.py:316")):
            bms, by = least_ms(nbytes, ops)
            row = with_rate(dict(name=name, route="cuda",
                       source=f"pnp_ovss_tpu_torch/csrc/{src}",
                       replaces=f"pnp_ovss_tpu/ops/{rep}", max_abs_err=e,
                       ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bms,
                       bound_by=by, library_ms=None,
                       unfused_ms=t["unfused_ms"], shape=f"{label} M={m}"),
                            nbytes)
            if label == "336 px":
                rows[name] = row
            else:  # the 768 px leg's numbers beside the 336 px row's
                rows[name] = with_shapes([rows[name], row])
        del x

    # K4 as the ViT calls it at 768 px: one launch per layer over the
    # whole batch. The residual stream is scaled down so that the
    # attention + proj term, not x, sets the output's size.
    b, s = cfg768.batch_size, cfg768.model.vit.seq_len
    qkv = randn(b, s, 3 * d)
    x = randn(b, s, d, scale=0.1)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    k4 = lambda: flash_attention.flash_mha_qkv_proj(
        qkv, x, wp, bp, num_heads=h)
    k4_plain = lambda: flash_attention.qkv_proj_plain(
        qkv, x, wp, bp, num_heads=h, true_len=s)
    # bf16 P in P.V, bf16 head outputs and two bf16 roundings after the
    # proj sum.
    e4 = err_of(k4(), k4_plain(),
                f"flash_mha_qkv_proj 768 px B={b} S={s} vs plain", TOL_QKV_PROJ)
    tl = s - 42  # padded carry: keys >= tl masked, rows >= tl garbage
    out = flash_attention.flash_mha_qkv_proj(qkv, x, wp, bp, num_heads=h,
                                             true_len=tl)
    ref = flash_attention.qkv_proj_plain(qkv, x, wp, bp, num_heads=h,
                                         true_len=tl)
    err_of(out[:, :tl], ref[:, :tl],
           f"flash_mha_qkv_proj true_len={tl} vs plain", TOL_QKV_PROJ)
    del out, ref
    torch.cuda.synchronize()
    k4_unfused = lambda: x + F.linear(
        flash_attention.flash_mha_flat_qkv(qkv, num_heads=h), wp, bp)
    # K4's two kernels alone, through their own entries (not counted):
    # the attention is K2's launch at this shape, the proj the C entry that
    # K4's call runs after it, on head outputs K2 wrote.
    attn = flash_attention.flash_mha_flat_qkv(qkv, num_heads=h)
    proj_out = torch.empty_like(x)
    lib = _build.library("flash_qkv_proj")
    k4_proj = lambda: _build.check(lib, lib.qkv_proj_residual_bf16(
        attn.data_ptr(), x.data_ptr(), wp.data_ptr(), bp.data_ptr(),
        proj_out.data_ptr(), b * s, d, d, _build.stream_ptr(x)),
        "qkv_proj_residual")
    # Beside the SP block's expression on the same head outputs: the
    # 768 px SP encode's equality bar (phase 5) rests on these agreeing.
    k4_proj()
    ne = proj_out != x + (F.linear(attn, wp) + bp)
    print(f"  flash_mha_qkv_proj proj vs x + (F.linear(out, Wp) + bp): "
          f"{ne.sum().item()} of {ne.numel()} values differ", flush=True)
    nbytes = 2 * (qkv.numel() + 2 * x.numel() + wp.numel() + d)
    bms, by = flash_least_ms(b, h, s, s, hd, nbytes=nbytes,
                             products=2.0 * b * s * d * d)
    # The library's route to the same function (timed, used nowhere):
    # SDPA on the heads, then cuBLAS's proj product with the bias, and
    # the residual.
    qh, kh, vh = (t.view(b, s, h, hd).transpose(1, 2) for t in (q, k, v))
    k4_library = lambda: x + F.linear(
        F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2)
        .reshape(b, s, d), wp, bp)
    row = dict(name="flash_mha_qkv_proj", route="cuda",
               source="pnp_ovss_tpu_torch/csrc/flash_qkv_proj.cu",
               replaces="pnp_ovss_tpu/ops/flash_attention.py:506",
               max_abs_err=e4, ms=time_ms(k4, 10),
               plain_ms=time_ms(k4_plain, 2), bound_ms=bms, bound_by=by,
               library_ms=time_ms(k4_library, 10),
               unfused_ms=time_ms(k4_unfused, 10),
               attention_ms=time_ms(
                   lambda: flash_attention.flash_mha_flat_qkv(
                       qkv, num_heads=h), 10),
               proj_ms=time_ms(k4_proj, 10), shape=f"768 px B={b} S={s}")
    rows["flash_mha_qkv_proj"] = with_rate(row, nbytes)
    return rows


# K7 and K9 run K2's kernel and math: K2's tolerance against the plain
# version (bf16 P in the P.V product, a bf16 output).
TOL_FLASH = 5e-3


def xlen_and_bhsd_kernels(cfg, cfg768):
    """Phase 3 for K7 and K9. K7 at the sequence-parallel chunk shapes of
    sp = 2: the local q rows of each rank over the gathered K/V, whose
    last chunk carries the padding at 768 px (2305 tokens in 2 x 1153 rows,
    ``true_kv_len`` 2305), each chunk against its plain version and bit
    for bit against K2's rows over the whole sequence. K9 on [B, H, S, D]
    views of one qkv array, as the unfused ViT passes them, at the ViT-L
    shapes of both legs, a head dim of 128, and the 3-head narrow run's
    shape (S = 145). Returns {kernel name: row of the kernels line}, at
    the 336 px shapes."""
    import torch
    from torch.nn import functional as F

    from pnp_ovss_tpu_torch.ops import flash_attention
    from pnp_ovss_tpu_torch.ops.attention import mha_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    vit = cfg.model.vit
    h, d = vit.num_heads, vit.head_dim
    hd = h * d
    k7 = []
    for label, c in (("336 px", cfg), ("768 px", cfg768)):
        b, s = c.batch_size, c.model.vit.seq_len
        chunk = -(-s // SP)
        qkv = torch.randn((b, chunk * SP, 3 * hd), generator=gen,
                          device=dev).to(torch.bfloat16)
        kv = qkv[..., hd:].contiguous()  # as gathered from the ranks
        k, v = kv[..., :hd], kv[..., hd:]
        whole = flash_attention.flash_mha_flat(qkv[..., :hd], k, v,
                                               num_heads=h, true_len=s)
        err = 0.0
        for r in range(SP):
            q = qkv[:, r * chunk:(r + 1) * chunk].contiguous()[..., :hd]
            out = flash_attention.flash_mha_flat_xlen(q, k, v, num_heads=h,
                                                      true_kv_len=s)
            rows = min(chunk, s - r * chunk)  # the rest is padding
            if not torch.equal(out[:, :rows],
                               whole[:, r * chunk:r * chunk + rows]):
                raise SystemExit(f"FAIL: flash_mha_flat_xlen {label} rank "
                                 f"{r} differs from K2's rows")
            ref = flash_attention.attention_plain(
                q, k, v, num_heads=h, true_len=s, out_dtype=torch.float32)
            err = max(err, (out[:, :rows].float() - ref[:, :rows]).abs()
                      .max().item())
        print(f"  flash_mha_flat_xlen {label} B={b} Sq={chunk} Skv="
              f"{chunk * SP} true_kv_len={s}: both chunks bit-equal to K2's "
              "rows", flush=True)
        check(f"flash_mha_flat_xlen {label} vs plain", err, TOL_FLASH)
        del whole, out, ref
        torch.cuda.synchronize()
        # Rank 0's launch: its q rows, all true_kv_len keys read once.
        q = qkv[:, :chunk].contiguous()[..., :hd]
        qh = q.unflatten(-1, (h, d)).transpose(1, 2)
        kh, vh = (t[:, :s].unflatten(-1, (h, d)).transpose(1, 2)
                  for t in (k, v))
        nbytes = 2 * (2 * b * chunk * hd + 2 * b * s * hd)
        bms, by = flash_least_ms(b, h, chunk, s, d)
        k7.append(with_rate(dict(
            name="flash_mha_flat_xlen", route="cuda",
            source="pnp_ovss_tpu_torch/csrc/flash_attention.cu",
            replaces="pnp_ovss_tpu/ops/flash_attention.py:636",
            max_abs_err=err,
            ms=time_ms(lambda: flash_attention.flash_mha_flat_xlen(
                q, k, v, num_heads=h, true_kv_len=s), 20),
            plain_ms=time_ms(lambda: flash_attention.attention_plain(
                q, k, v, num_heads=h, true_len=s,
                out_dtype=torch.bfloat16), 3),
            bound_ms=bms, bound_by=by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh), 20),
            shape=f"{label} sp={SP} B={b} Sq={chunk} Skv={chunk * SP} "
                  f"true_kv_len={s}"), nbytes))
        del qkv, kv, k, v, q
    k9 = []
    for label, b, hh, s, dd in (
            ("336 px", cfg.batch_size, h, vit.seq_len, d),
            ("768 px", cfg768.batch_size, h, cfg768.model.vit.seq_len, d),
            ("768 px D=128", cfg768.batch_size, hd // 128,
             cfg768.model.vit.seq_len, 128),
            ("narrow 3 heads", 4, 3, 145, 64)):
        qkv = torch.randn((b, s, 3, hh, dd), generator=gen, device=dev) \
            .to(torch.bfloat16)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # [B, H, S, D] views
        out = flash_attention.flash_mha(q, k, v)
        ref = mha_plain(q, k, v, out_dtype=torch.float32)
        err = (out.float() - ref).abs().max().item()
        check(f"flash_mha {label} [{b}, {hh}, {s}, {dd}] vs plain", err,
              TOL_FLASH)
        del out, ref
        torch.cuda.synchronize()
        nbytes = 4 * 2 * b * hh * s * dd
        bms, by = flash_least_ms(b, hh, s, s, dd)
        k9.append(with_rate(dict(
            name="flash_mha", route="cuda",
            source="pnp_ovss_tpu_torch/csrc/flash_attention.cu",
            replaces="pnp_ovss_tpu/ops/flash_attention.py:713",
            max_abs_err=err,
            ms=time_ms(lambda: flash_attention.flash_mha(q, k, v), 20),
            plain_ms=time_ms(lambda: mha_plain(
                q, k, v, out_dtype=torch.bfloat16), 3),
            bound_ms=bms, bound_by=by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v), 20),
            shape=f"{label} [{b}, {hh}, {s}, {dd}]"), nbytes))
        del qkv, q, k, v
    return {lines[0]["name"]: with_shapes(lines) for lines in (k7, k9)}


def synthetic_batch(cfg, batch: int, bucket: int, seed: int = 0):
    """uint8 images, captions, bucket RGB and VOC-like GT sizes, as
    bench.py builds them."""
    import numpy as np

    from pnp_ovss_tpu_torch.text.captions import (
        build_caption_batch, fitted_text_len,
    )
    from pnp_ovss_tpu_torch.text.wordpiece import WordPieceTokenizer

    nms = ["dog", "cat", "grass", "sky", "person", "car", "tree", "wall"]
    tok = WordPieceTokenizer.toy(["a", "picture", "of"] + nms)
    rng = np.random.RandomState(seed)
    class_lists = [[nms[i % 8], nms[(i + 3) % 8], nms[(i + 5) % 8]]
                   for i in range(batch)]
    text_len = fitted_text_len(class_lists, tok,
                               max_text_len=cfg.model.max_text_len)
    cap = build_caption_batch(class_lists, tok, max_text_len=text_len,
                              max_classes=cfg.max_classes)
    images = rng.randint(0, 256, (batch, cfg.img_size, cfg.img_size, 3)) \
        .astype(np.uint8)
    rgb = rng.randint(0, 255, (batch, bucket, bucket, 3)).astype(np.float32)
    gt_sizes = [GT_SIZES[i % 2] for i in range(batch)]
    return images, cap, rgb, gt_sizes


def narrow_config(image_size: int, hidden_size: int = 128,
                  num_heads: int = 2):
    """A narrow bf16 pipeline config (ViT 2 layers, by default of width
    128 with 2 heads of 64; bucket-64 CRF), whose ViT the fused kernels
    take: 192 px gives 145 tokens (one 512-key block: K1, K2, K3), 384 px
    577 (K1, K4, K3). 3 heads of 64 take the unfused block's K9."""
    from pnp_ovss_tpu_torch.config import (
        ModelConfig, PipelineConfig, ViTConfig,
    )

    cfg = PipelineConfig.tiny()
    return dataclasses.replace(
        cfg, batch_size=4,
        model=ModelConfig(
            vit=ViTConfig(image_size=image_size, hidden_size=hidden_size,
                          num_layers=2, num_heads=num_heads),
            bert=dataclasses.replace(cfg.model.bert,
                                     encoder_width=hidden_size,
                                     dtype="bfloat16"),
            max_text_len=16),
        attribution=dataclasses.replace(cfg.attribution, layer=1, head=1))


_VIT_336 = ("ln_matmul", "flash_mha_flat_qkv", "ln_mlp_residual")
_VIT_SP = ("ln_matmul", "flash_mha_flat_xlen", "ln_mlp_residual")
_K5, _K8 = "gaussian_kernel_materialize", "gaussian_kernel_matmul"
_CRF_S4 = (_K5, "crf_first_state", "crf_spatial_operands",
           "crf_fused_iteration")

# Phase 4's CRF branches alone: (label, scene size, channels per variant,
# CRF settings, kernels the card launches; every other kernel stays at 0,
# least share of labels equal to the CPU's), two variants, 10 iterations.
# The CPU runs the plain versions with f32 products where the card's
# products are bf16. Each bar leaves about 1.5x the disagreement of the
# seeded H100 reading beside it, and 0.1% (a few pixels) where the
# reading is 1.
CRF_BRANCHES = (
    ("strided s=4 fused", 64, 4, {}, _CRF_S4, 0.9994),  # 0.99963
    ("general loop, v*c = 66", 64, 33, {}, (_K5,), 0.999),  # 0.99939
    ("general loop, N = 1600", 40, 4, {}, (_K5,), 0.999),  # 1.0
    ("exact s=1", 64, 4, dict(bilateral_subsample=1), (_K8,), 0.999),  # 1.0
    ("nystrom s=4", 64, 4,  # 1.0
     dict(bilateral_subsample=4, bilateral_mode="nystrom"), (_K5, _K8),
     0.999),
)


def launched_exactly(name: str, kernels) -> dict:
    """The launch counts since the last reset; fails unless exactly the
    kernels named were launched."""
    from pnp_ovss_tpu_torch.ops import _build

    counts = dict(_build.LAUNCHES)
    if any((n > 0) != (k in kernels) for k, n in counts.items()):
        raise SystemExit(f"FAIL: {name} launched {counts}, want exactly "
                         f"{kernels}")
    return counts


def crf_branch_check(label: str, size: int, c: int, post: dict, kernels,
                     min_agree: float) -> None:
    """Phase 4: one branch of ``mean_field_crf_variants`` on the card
    against the CPU, on a textured scene with noisy logits that favour one
    class per half and a third in a blob (the tests' CRF scene)."""
    import numpy as np
    import torch

    from pnp_ovss_tpu_torch.config import CRFConfig
    from pnp_ovss_tpu_torch.ops import _build
    from pnp_ovss_tpu_torch.ops.crf import mean_field_crf_variants

    rng = np.random.RandomState(size + c)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    image = photo_like_rgb(size, size, torch.Generator().manual_seed(c))
    logits = rng.randn(2, c, size, size).astype(np.float32) * 0.5
    logits[:, 0, :size // 2] += 0.8
    logits[:, 1, size // 2:] += 0.8
    logits[:, 2][:, (yy - 0.6 * size) ** 2 + (xx - 0.7 * size) ** 2
                 < (size / 4) ** 2] += 1.2
    labels = {}
    for dev in ("cuda", "cpu"):
        _build.reset_launch_counts()
        labels[dev] = mean_field_crf_variants(
            torch.from_numpy(logits).to(dev), image.to(dev), CRFConfig(),
            xy_scale=(0.4, 0.5), **post).cpu()
        if dev == "cuda":
            counts = launched_exactly(f"CRF {label}", kernels)
    agree = (labels["cuda"] == labels["cpu"]).float().mean().item()
    print(f"  CRF {label} ({size}x{size}, 2x{c} channels) card vs CPU: "
          f"labels equal {agree:.5f} (bar {min_agree:g}); card launches "
          f"{ {k: n for k, n in counts.items() if n} }", flush=True)
    if agree < min_agree or len(labels["cuda"].unique()) < 2:
        raise SystemExit(f"FAIL: CRF {label} disagrees with the CPU run")


# Phase 4's narrow runs: (image size, fused ViT, settings beside the
# narrow config's (``postprocess`` beside the default strided s=4 CRF),
# kernels the card run must launch; every other kernel must stay at 0),
# and the bars on the card-vs-CPU differences (max relative difference of
# the round-0 map sums, least share of equal labels), each about 1.5x the
# difference of the seeded H100 reading noted beside it. A flipped drop
# decision in the GradCAM rounds changes every later map, so labels differ
# more than the round-0 sums do, and these bars cannot see a CRF fault
# that flips a few labels: the CRF branches above are held alone.
NARROW_RUNS = (
    # seeded readings: 0.0255, 0.9749 (r0), 0.9897 (agg)
    (192, True, {}, _VIT_336 + _CRF_S4, 0.04, 0.96),
    # seeded readings: 0.0161, 0.9882 (r0), 0.9553 (agg)
    (384, True, {}, ("ln_matmul", "flash_mha_qkv_proj", "ln_mlp_residual")
     + _CRF_S4, 0.025, 0.93),
    # seeded readings: 0.0201, 0.9833 (r0), 0.9848 (agg)
    (192, False, {}, ("flash_mha_flat_qkv",) + _CRF_S4, 0.03, 0.975),
    # seeded readings: 0.0255, 0.9758 (r0), 0.9890 (agg)
    (192, True, dict(postprocess=dict(bilateral_subsample=1)),
     _VIT_336 + (_K8,), 0.04, 0.96),
    # seeded readings: 0.0255, 0.9758 (r0), 0.9889 (agg)
    (192, True, dict(postprocess=dict(bilateral_subsample=4,
                                      bilateral_mode="nystrom")),
     _VIT_336 + (_K5, _K8), 0.04, 0.96),
    # 32 classes: 2 x 33 = 66 state rows, beyond K6's 64, so the general
    # loop runs on K5's kernel. Seeded readings: 0.0255, 0.9749 (r0),
    # 0.9899 (agg)
    (192, True, dict(max_classes=32), _VIT_336 + (_K5,), 0.04, 0.96),
    # 3 heads of 64 (width 192): the unfused block sends attention to K9
    # through ``mha(impl="flash")``, never to K2. Seeded readings: 0.0139,
    # 0.9957 (r0), 0.9816 (agg)
    (192, False, dict(vit=dict(hidden_size=192, num_heads=3)),
     ("flash_mha",) + _CRF_S4, 0.021, 0.972),
)


def summary(res) -> dict:
    """What the card-vs-CPU and rank-vs-rank checks read of a batch
    result: labels, round-0 map sums, finite maps."""
    import numpy as np

    return dict(labels_r0=res.labels_r0, labels_agg=res.labels_agg,
                sums_r0=res.maps_r0.sum((2, 3)),
                finite=bool(np.isfinite(res.maps_r0).all()
                            and np.isfinite(res.maps_agg).all()))


def hold(name: str, a: dict, b: dict, max_rel: float,
         min_agree: float) -> None:
    """Fail unless both runs' maps (``summary``s) are finite and they
    agree within the bars: the max relative difference of the round-0
    map sums, the least share of equal labels r0 and agg."""
    import numpy as np

    if not (a["finite"] and b["finite"]):
        raise SystemExit(f"FAIL: {name}: maps not finite")
    rel = np.abs(a["sums_r0"] - b["sums_r0"]).max() / max(
        np.abs(b["sums_r0"]).max(), 1e-9)
    r0 = (a["labels_r0"] == b["labels_r0"]).mean()
    agg = (a["labels_agg"] == b["labels_agg"]).mean()
    print(f"  {name}: round-0 map sums rel diff {rel:.4g} (bar {max_rel:g}),"
          f" labels equal r0 {r0:.4f} agg {agg:.4f} (bar {min_agree:g})",
          flush=True)
    if rel > max_rel or r0 < min_agree or agg < min_agree:
        raise SystemExit(f"FAIL: {name} disagree")


def narrow_run(cfg, device: str, vit_fused: bool = True, seed: int = 1,
               **parallel):
    """One batch of the narrow pipeline (weights drawn on the card from
    ``seed``, inputs from ``seed``) on ``device``: its ``summary`` and the
    kernel launches it made. ``parallel``: the runner's ``mesh``,
    ``encode_parallel`` and ``pp_microbatches``."""
    from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm
    from pnp_ovss_tpu_torch.ops import _build
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

    images, cap, rgb, gt = synthetic_batch(cfg, 4, 64, seed=seed)
    model = init_blip_itm(cfg.model, capture_layers=(0,), seed=seed,
                          device="cuda", vit_fused=vit_fused).to(device)
    runner = SegmentationRunner(cfg, model, device=device, bucket_size=64,
                                **parallel)
    _build.reset_launch_counts()
    res = runner.run_batch(images, cap, rgb, return_maps=True, gt_sizes=gt)
    return summary(res), dict(_build.LAUNCHES)


def reference_check(image_size: int, vit_fused: bool, settings: dict,
                    kernels, max_rel, min_agree) -> dict:
    """Phase 4: a narrow configuration on the card against the CPU with
    the same weights and inputs. Phase 3 holds each kernel alone; this
    holds the wiring around them on the card (uint8 upload, strided views
    into the kernels, bf16 CRF products, the stream order of
    submit/result) to the plain path. Returns the card run's launches."""
    cfg = narrow_config(image_size, **settings.get("vit", {}))
    post = settings.get("postprocess", {})
    cfg = dataclasses.replace(
        cfg, postprocess=dataclasses.replace(cfg.postprocess, **post),
        **{k: v for k, v in settings.items()
           if k not in ("postprocess", "vit")})
    name = (f"{image_size} px {'fused' if vit_fused else 'unfused'} ViT"
            + "".join(f", {k}={v}" for k, v in settings.get("vit",
                                                              {}).items())
            + "".join(f", {k}={v}" for k, v in post.items())
            + "".join(f", {k}={v}" for k, v in settings.items()
                      if k not in ("postprocess", "vit")))
    card, counts = narrow_run(cfg, "cuda", vit_fused)
    launched_exactly(f"narrow {name}", kernels)
    cpu, _ = narrow_run(cfg, "cpu", vit_fused)
    # Both sides compute in bf16 with different summation orders, and the
    # card's CRF products are bf16 where the CPU's are f32.
    hold(f"narrow {name} card vs CPU", card, cpu, max_rel, min_agree)
    print(f"    card launches {counts}", flush=True)
    return counts


# Phase 4's narrow CLIP: max |card - CPU| of the unit-norm embeddings, in
# bf16 on both sides, about twice the seeded H100 reading of the image
# tower (0.00235; the text tower, which runs no kernel, read 3e-8).
TOL_CLIP_NARROW = 5e-3


def narrow_clip_config():
    """A narrow bf16 CLIP: 168 px at patch 14 (145 tokens, so the vision
    tower takes K2), width 128 with 2 heads of 64, 2 layers each tower,
    the tiny text vocab and context."""
    from pnp_ovss_tpu_torch.config import (
        CLIPConfig, CLIPTextConfig, CLIPVisionConfig,
    )

    return CLIPConfig(
        vision=CLIPVisionConfig(image_size=168, patch_size=14,
                                hidden_size=128, num_layers=2, num_heads=2,
                                embed_dim=64),
        text=CLIPTextConfig(vocab_size=1024, context_length=16,
                            hidden_size=128, num_layers=2, num_heads=2,
                            embed_dim=64))


def narrow_clip_inputs(cfg, seed: int = 1):
    """CLIP-normalised-like images [4, H, W, 3] and the BPE ids of four
    class names (toy merge table, under the tiny vocab)."""
    import numpy as np
    import torch

    from pnp_ovss_tpu_torch.text.bpe import CLIPBPETokenizer

    names = ["dog", "potted plant", "tv monitor", "sky"]
    tok = CLIPBPETokenizer.toy([w for n in names for w in n.split()])
    ids = tok.encode_batch(names, cfg.text.context_length)
    rng = np.random.RandomState(seed)
    size = cfg.vision.image_size
    images = rng.randn(4, size, size, 3).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(ids).long()


def narrow_clip_check() -> None:
    """Phase 4: the narrow CLIP on the card against the same weights on
    the CPU: ``encode_image`` (K2 once a layer, no other kernel) and
    ``encode_text`` (the causal text tower: no kernel) within
    ``TOL_CLIP_NARROW``."""
    import torch

    from pnp_ovss_tpu_torch.models.clip import init_clip
    from pnp_ovss_tpu_torch.ops import _build

    cfg = narrow_clip_config()
    model = init_clip(cfg, seed=1, device="cuda")
    images, ids = narrow_clip_inputs(cfg)
    _build.reset_launch_counts()
    img = model.encode_image(images.cuda()).cpu()
    counts = launched_exactly("narrow CLIP encode_image",
                              ("flash_mha_flat_qkv",))
    if counts["flash_mha_flat_qkv"] != cfg.vision.num_layers:
        raise SystemExit(f"FAIL: narrow CLIP encode_image launched {counts}")
    _build.reset_launch_counts()
    txt = model.encode_text(ids.cuda()).cpu()
    launched_exactly("narrow CLIP encode_text", ())
    model.cpu()
    err_i = (img - model.encode_image(images)).abs().max().item()
    err_t = (txt - model.encode_text(ids)).abs().max().item()
    print(f"  narrow CLIP (168 px, width 128, 2 x 2 layers, bf16): "
          f"encode_image launches {counts}", flush=True)
    check("narrow CLIP encode_image card vs CPU", err_i, TOL_CLIP_NARROW)
    check("narrow CLIP encode_text card vs CPU", err_t, TOL_CLIP_NARROW)


def full_config(image_size: int = 336):
    """The reference default, or bench.py's 768 px leg (batch 12)."""
    from pnp_ovss_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig.reference_default()
    if image_size == cfg.img_size:
        return cfg
    size, batch = LEG_768
    if image_size != size:
        raise ValueError(f"no full-width leg at {image_size} px")
    vit = dataclasses.replace(cfg.model.vit, image_size=size)
    return dataclasses.replace(
        cfg, batch_size=batch, model=dataclasses.replace(cfg.model, vit=vit))


def pipeline_setup(seed: int = 0, *, image_size: int = 336,
                   vit_fused: bool = True, post=None, **parallel):
    """A full-width runner on the card with random weights from ``seed``
    (by default the reference default: 336 px, batch 35, fused ViT,
    strided s=4 CRF; ``post`` replaces postprocess settings; ``parallel``:
    the runner's ``mesh``, ``encode_parallel`` and ``pp_microbatches``),
    and one batch of synthetic inputs (images, captions, bucket RGB, GT
    sizes)."""
    from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

    cfg = full_config(image_size)
    cfg = dataclasses.replace(
        cfg, postprocess=dataclasses.replace(cfg.postprocess, **(post or {})))
    model = init_blip_itm(cfg.model,
                          capture_layers=(cfg.attribution.layer - 1,),
                          seed=seed, device="cuda", vit_fused=vit_fused)
    runner = SegmentationRunner(cfg, model, device="cuda",
                                bucket_size=BUCKET, **parallel)
    return cfg, runner, synthetic_batch(cfg, cfg.batch_size, BUCKET, seed)


# Phase 5's full-width runs: (name, image size, fused ViT, the ViT
# kernels each layer of each drop round launches, postprocess settings
# beside the default strided s=4 CRF).
FULL_RUNS = (
    ("336 px fused", 336, True, _VIT_336, {}),
    ("768 px fused", LEG_768[0], True,
     ("ln_matmul", "flash_mha_qkv_proj", "ln_mlp_residual"), {}),
    ("336 px unfused", 336, False, ("flash_mha_flat_qkv",), {}),
    ("336 px fused exact CRF", 336, True, _VIT_336,
     dict(bilateral_subsample=1)),
)


def expected_launches(cfg, vit_kernels, bucket: int = BUCKET) -> dict:
    """Launches per batch of every kernel on one run's path. The ViT
    kernels launch once per layer and drop round. The CRF runs once per
    image: the materialised strided CRF launches K5 and
    ``crf_first_state`` once, then ``crf_spatial_operands`` and K6 once
    per iteration each; the exact
    and unmaterialised CRFs launch K8 once per message (the degree, then
    each iteration); Nystrom launches K5 once (the anchor Gram matrix) and
    K8 twice per message."""
    from pnp_ovss_tpu_torch.ops import _build
    from pnp_ovss_tpu_torch.ops.crf import _MATERIALIZE_LIMIT

    want = dict.fromkeys(_build.LAUNCHES, 0)
    for name in vit_kernels:  # a kernel named twice launches twice
        want[name] += cfg.model.vit.num_layers * cfg.drop.num_rounds
    pp, b = cfg.postprocess, cfg.batch_size
    s, iters = pp.bilateral_subsample, pp.crf.num_iters
    nystrom = pp.bilateral_mode == "nystrom" and s > 1
    n, m = bucket * bucket, (-(-bucket // s)) ** 2
    if not nystrom and s > 1 and n * m <= _MATERIALIZE_LIMIT:
        if 2 * (cfg.max_classes + 1) > 64:
            raise ValueError("a full-width run takes the fused CRF iteration")
        want["gaussian_kernel_materialize"] = want["crf_first_state"] = b
        want["crf_spatial_operands"] = b * iters
        want["crf_fused_iteration"] = b * iters
    else:
        want[_K8] = b * (iters + 1) * (2 if nystrom else 1)
        want[_K5] = b if nystrom else 0
    return want


def run_pipeline(cfg, runner, inputs, per_batch: dict,
                 n_batches: int = PIPELINE_BATCHES):
    """Phase 5, one run: a checked warm-up batch, then ``n_batches``
    double-buffered batches with the launch counts set to 0 just before
    and read just after. Returns (launch counts of those batches, the warm-up batch's
    ``summary``). The speed of these runs is ``port_bench``'s to
    measure."""
    import numpy as np
    import torch

    from pnp_ovss_tpu_torch.ops import _build

    images, cap, rgb, gt = inputs
    batch, k = cfg.batch_size, cfg.max_classes
    res = runner.run_batch(images, cap, rgb, return_maps=True, gt_sizes=gt)
    if res.labels_agg.shape != (batch, BUCKET, BUCKET):
        raise SystemExit(f"FAIL: labels shape {res.labels_agg.shape}")
    for lab in (res.labels_r0, res.labels_agg):
        if lab.min() < 0 or lab.max() > k:
            raise SystemExit("FAIL: labels outside [0, max_classes]")
    if len(np.unique(res.labels_agg)) < 2:
        raise SystemExit("FAIL: the CRF returned a single label")
    for maps in (res.maps_r0, res.maps_agg):
        if maps.shape != (batch, k, BUCKET, BUCKET) or \
                not np.isfinite(maps).all():
            raise SystemExit("FAIL: maps not finite or of the wrong shape")
    if not res.maps_agg.any():
        raise SystemExit("FAIL: the aggregated maps are all zero")

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    pending = None  # the next batch is submitted before this one's result
    for _ in range(n_batches):
        nxt = runner.submit_batch(images, cap, rgb, gt_sizes=gt)
        if pending is not None:
            pending.result()
        pending = nxt
    last = pending.result()
    counts = dict(_build.LAUNCHES)
    if last.labels_agg.max() > k:
        raise SystemExit("FAIL: labels outside [0, max_classes]")
    for name, want in per_batch.items():
        if counts[name] != want * n_batches:
            raise SystemExit(f"FAIL: {name} launched {counts[name]} times "
                             f"in {n_batches} batches, want "
                             f"{want * n_batches}")
    print(f"  launches over {n_batches} batches: {counts} "
          f"(per batch {per_batch})", flush=True)
    return counts, summary(res)


def capture_round0(runner, on: bool = True) -> tuple:
    """While ``on``, spies on ``runner``'s next batch: its round-0 ViT
    encode (a forward hook on the model's visual encoder) and its round-0
    GradCAM of the attribution head (a wrapper around the runner's round
    step, which keeps every patch in round 0), both as f32 on the host.
    Returns (the record, a function that removes the spies)."""
    rec = {}
    if not on:
        return rec, lambda: None
    real = runner._round_step

    def spy(*args):
        dropped, gc = real(*args)
        if "gradcam" not in rec:
            rec["gradcam"] = gc.float().cpu()
        return dropped, gc

    def hook(_module, _inputs, out):
        if "encode" not in rec:
            rec["encode"] = out.float().cpu()

    handle = runner.model.visual_encoder.register_forward_hook(hook)
    runner._round_step = spy

    def remove():
        handle.remove()
        runner._round_step = real
    return rec, remove


def sp_narrow(mesh) -> dict:
    """Phase 4 on one rank: the narrow 192 px fused pipeline split over
    the mesh's model axis, on the card (with its launches) and on the
    CPU."""
    cfg = narrow_config(192)
    card, counts = narrow_run(cfg, "cuda", mesh=mesh, encode_parallel="sp")
    cpu, _ = narrow_run(cfg, "cpu", mesh=mesh, encode_parallel="sp")
    return dict(cuda=card, cpu=cpu, launches=counts)


def sp_full(mesh) -> dict:
    """Phase 5 on one rank: the reference default split over the mesh's
    model axis, through ``run_pipeline`` (a checked warm-up batch, then
    batches whose launches it asserts)."""
    cfg, runner, inputs = pipeline_setup(mesh=mesh, encode_parallel="sp")
    counts, res = run_pipeline(cfg, runner, inputs,
                               expected_launches(cfg, _VIT_SP), SP_BATCHES)
    return dict(launches=counts, **res)


def sp_encode_768(mesh) -> dict:
    """Phase 5 on one rank: one sequence-parallel encode of bench.py's
    768 px leg with its launches and wall time; rank 0 also runs the
    unsharded encode (K4) and returns the difference."""
    import torch

    from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm
    from pnp_ovss_tpu_torch.ops import _build
    from pnp_ovss_tpu_torch.parallel.sequence import encode_images_sp

    torch.cuda.empty_cache()
    cfg = full_config(LEG_768[0])
    model = init_blip_itm(cfg.model,
                          capture_layers=(cfg.attribution.layer - 1,),
                          device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    size = cfg.model.vit.image_size
    images = torch.randn((cfg.batch_size, size, size, 3), generator=gen,
                         device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    emb = encode_images_sp(model.visual_encoder, images, mesh.model_axis)
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0, launches=dict(_build.LAUNCHES),
               shape=tuple(emb.shape), finite=bool(torch.isfinite(emb).all()))
    if mesh.rank == 0:
        ref = model.encode_image(images).float()
        diff = (emb.float() - ref).abs()
        out.update(max_abs=diff.max().item(), mean_abs=diff.mean().item(),
                   ref_max=ref.abs().max().item())
    return out


SP_JOBS = {"narrow": sp_narrow, "full": sp_full, "encode_768": sp_encode_768}


def mesh_rank(rank: int, init_method: str, table: str, jobs,
              out_dir: str) -> None:
    """One spawned rank of the multi-rank runs: joins a data 1 x model 2
    mesh (both ranks on the one card, so gloo), runs ``jobs`` of the job
    table named ``table`` (``SP_JOBS``, ``MP_JOBS``) in order and saves
    their results for the parent."""
    import torch

    from pnp_ovss_tpu_torch.parallel.mesh import make_mesh_2d

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh_2d(SP, ["cuda:0"] * SP, rank=rank,
                        init_method=init_method)
    try:
        out = {job: globals()[table][job](mesh) for job in jobs}
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(jobs, table: str = "SP_JOBS") -> list:
    """``jobs`` of ``table`` on ``SP`` ranks spawned with the spawn start
    method; a rank that fails (or a run past ``RANKS_TIMEOUT_S``) makes
    this raise. Returns each rank's {job: result}."""
    import torch

    from pnp_ovss_tpu_torch.ops import _build
    from pnp_ovss_tpu_torch.parallel.mesh import free_port, spawn

    out_dir = _build.BUILD_DIR.parent / "sp_ranks"
    out_dir.mkdir(parents=True, exist_ok=True)
    for r in range(SP):
        (out_dir / f"rank{r}.pt").unlink(missing_ok=True)
    spawn(mesh_rank, SP, (f"tcp://localhost:{free_port()}", table, jobs,
                          str(out_dir)), timeout_s=RANKS_TIMEOUT_S)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(SP)]


# Bars of the sequence-parallel runs (max relative difference of the
# round-0 map sums, least share of equal labels). Against the CPU, the
# 192 px fused run's bars (seeded reading 0.0255, 0.9749 / 0.9897, as
# that run's). On the card the sharded runs equal the unsharded ones bit
# for bit, and rank 1 equals rank 0 (seeded readings 0, 1.0, 1.0 at 192
# and 336 px, max |diff| 0 of the 768 px encode): K7's rows are K2's,
# K1 and K3 are row-local, and cuBLAS sums the proj in the same order at
# either row count; so the bars are equality.
SP_VS_CPU = (0.04, 0.96)
SP_EXACT = (0.0, 1.0)


def sp_narrow_check(ranks) -> None:
    """Phase 4: each rank launched exactly K1 = K3 = K7 = layers x
    rounds, K5 and K6 by the CRF, and nothing else; rank 0's card run
    agrees with the ranks' CPU run and equals the card's unsharded run,
    and rank 1 equals rank 0."""
    cfg = narrow_config(192)
    want = expected_launches(cfg, _VIT_SP, bucket=64)
    for r, out in enumerate(ranks):
        counts = out["narrow"]["launches"]
        if counts != want:
            raise SystemExit(f"FAIL: narrow SP rank {r} launched {counts}, "
                             f"want {want}")
    print(f"  narrow 192 px fused SP, {SP} ranks on one card (gloo): "
          f"launches per rank {want}", flush=True)
    unsharded, _ = narrow_run(cfg, "cuda")
    r0 = ranks[0]["narrow"]
    hold("narrow SP rank 0 card vs the ranks on the CPU", r0["cuda"],
         r0["cpu"], *SP_VS_CPU)
    hold("narrow SP rank 0 vs the card's unsharded run", r0["cuda"],
         unsharded, *SP_EXACT)
    hold("narrow SP rank 1 vs rank 0 on the card",
         ranks[1]["narrow"]["cuda"], r0["cuda"], *SP_EXACT)


def sp_full_check(ranks, unsharded: dict) -> dict:
    """Phase 5: the reference default over ``SP`` ranks (each asserted
    its launches in ``run_pipeline``) against the unsharded run's warm-up
    labels and map sums, and the 768 px SP encode's launches and its
    equality with the unsharded encode (K4). Returns rank 0's row of the
    pipeline line."""
    hold("336 px fused SP rank 0 vs the unsharded run", ranks[0]["full"],
         unsharded, *SP_EXACT)
    hold("336 px fused SP rank 1 vs rank 0", ranks[1]["full"],
         ranks[0]["full"], *SP_EXACT)
    cfg = full_config(LEG_768[0])
    want = {k: 0 for k in ranks[0]["encode_768"]["launches"]}
    for name in _VIT_SP:
        want[name] = cfg.model.vit.num_layers
    for r, out in enumerate(ranks):
        enc = out["encode_768"]
        if enc["launches"] != want or not enc["finite"] or enc["shape"] != (
                cfg.batch_size, cfg.model.vit.seq_len, cfg.model.vit.hidden_size):
            raise SystemExit(f"FAIL: 768 px SP encode rank {r}: launches "
                             f"{enc['launches']} (want {want}), shape "
                             f"{enc['shape']}, finite {enc['finite']}")
        print(f"  768 px SP encode rank {r}: {enc['seconds']:.3f} s (gloo "
              f"transport on one card), launches {want}", flush=True)
    enc = ranks[0]["encode_768"]
    print(f"  768 px SP encode vs unsharded (K4): max |diff| "
          f"{enc['max_abs']:.4g} at max |y| {enc['ref_max']:.4g}, mean "
          f"|diff| {enc['mean_abs']:.4g} (bar: equal)", flush=True)
    if enc["max_abs"] != 0:
        raise SystemExit("FAIL: 768 px SP encode differs from the unsharded")
    return dict(batch=full_config(336).batch_size, batches=SP_BATCHES,
                note="gloo transport on one card, no speed result",
                encode_768_s=enc["seconds"])


# Phase 6: the segmentation CLI in-process on a synthetic VOC directory.
CLI_IMAGES = 75  # two full batches of 35 and a ragged tail of 5
CLI_SIZES = ((375, 500), (500, 333))  # VOC-like GT sizes (H, W)
CLI_CKPT_GRID = 24  # BLIP-ITM-Large ships at 384 px: a 24 x 24 pos grid


def lavis_state_dict(cfg, seed: int, grid=None) -> dict:
    """A BLIP-ITM state dict under LAVIS names at ``cfg``'s (a port
    ``ModelConfig``) widths, drawn from ``seed`` with numpy: matrices
    N(0, 1/fan_in), norms 1 + N(0, 0.1^2), biases and embeddings
    N(0, 0.02^2); the ViT position grid ``grid`` x ``grid`` (default the
    config's), the ITC projections at ``cfg.embed_dim``. It also carries
    keys of the retrieval checkpoint that the loader must drop: momentum
    copies, ITC queues, the temperature, BERT's ``position_ids`` and
    token-type table."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sd = {}

    def normal(shape, std):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= std
        return x

    def lin(name, n_in, n_out):
        sd[name + ".weight"] = normal((n_out, n_in), n_in ** -0.5)
        sd[name + ".bias"] = normal((n_out,), 0.02)

    def ln(name, n):
        sd[name + ".weight"] = 1 + normal((n,), 0.1)
        sd[name + ".bias"] = normal((n,), 0.02)

    v, c = cfg.vit, cfg.bert
    d, p, g = v.hidden_size, v.patch_size, grid or v.grid
    mlp = int(d * v.mlp_ratio)
    sd["visual_encoder.patch_embed.proj.weight"] = normal(
        (d, 3, p, p), (3 * p * p) ** -0.5)
    sd["visual_encoder.patch_embed.proj.bias"] = normal((d,), 0.02)
    sd["visual_encoder.cls_token"] = normal((1, 1, d), 0.02)
    sd["visual_encoder.pos_embed"] = normal((1, g * g + 1, d), 0.02)
    for i in range(v.num_layers):
        b = f"visual_encoder.blocks.{i}"
        ln(b + ".norm1", d)
        lin(b + ".attn.qkv", d, 3 * d)
        lin(b + ".attn.proj", d, d)
        ln(b + ".norm2", d)
        lin(b + ".mlp.fc1", d, mlp)
        lin(b + ".mlp.fc2", mlp, d)
    ln("visual_encoder.norm", d)
    h = c.hidden_size
    sd["text_encoder.embeddings.word_embeddings.weight"] = normal(
        (c.vocab_size, h), 0.02)
    sd["text_encoder.embeddings.position_embeddings.weight"] = normal(
        (c.max_position_embeddings, h), 0.02)
    ln("text_encoder.embeddings.LayerNorm", h)
    for i in range(c.num_layers):
        b = f"text_encoder.encoder.layer.{i}"
        for part, kv_in in (("attention", h),
                            ("crossattention", c.encoder_width)):
            lin(f"{b}.{part}.self.query", h, h)
            lin(f"{b}.{part}.self.key", kv_in, h)
            lin(f"{b}.{part}.self.value", kv_in, h)
            lin(f"{b}.{part}.output.dense", h, h)
            ln(f"{b}.{part}.output.LayerNorm", h)
        lin(b + ".intermediate.dense", h, c.intermediate_size)
        lin(b + ".output.dense", c.intermediate_size, h)
        ln(b + ".output.LayerNorm", h)
    lin("itm_head", h, 2)
    lin("vision_proj", d, cfg.embed_dim)  # 256, blip_itm_large.yaml:23
    lin("text_proj", h, cfg.embed_dim)
    sd["visual_encoder_m.cls_token"] = sd["visual_encoder.cls_token"].copy()
    sd["text_encoder_m.embeddings.LayerNorm.weight"] = \
        sd["text_encoder.embeddings.LayerNorm.weight"].copy()
    lin("vision_proj_m", d, cfg.embed_dim)
    for name in ("image_queue", "text_queue"):
        sd[name] = normal((cfg.embed_dim, 57), 1.0)
    sd["idx_queue"] = np.full((1, 57), -100, np.int64)
    sd["queue_ptr"] = np.zeros((1,), np.int64)
    sd["temp"] = np.asarray(0.07, np.float32)
    sd["text_encoder.embeddings.position_ids"] = np.arange(
        c.max_position_embeddings, dtype=np.int64)[None]
    sd["text_encoder.embeddings.token_type_embeddings.weight"] = normal(
        (2, h), 0.02)
    return sd


def write_fake_voc(root: str, n: int, seed: int = 0) -> dict:
    """A VOC-layout dataset under ``root``: JPEGs from ``photo_like_rgb``
    at VOC-like sizes, PNG ground truth with two or three classes and a
    band of 255 (ignore), the val split, and the GPT-4o class cache in the
    reference's raw two-list format (2-4 classes above 70%, one below).
    Returns {image id: (H, W)}."""
    import numpy as np
    import torch
    from PIL import Image

    from pnp_ovss_tpu_torch.data.categories import get_dataset_meta

    base = os.path.join(root, "VOCdevkit", "VOC2012")
    for sub in ("JPEGImages", "SegmentationClass",
                os.path.join("ImageSets", "Segmentation")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "GPT4o_classification"), exist_ok=True)
    nms = get_dataset_meta("voc").nms
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    sizes, gpt = {}, {}
    for i in range(n):
        img_id = f"2007_{i:06d}"
        h, w = CLI_SIZES[i % 2]
        rgb = photo_like_rgb(h, w, gen).round().to(torch.uint8).numpy()
        Image.fromarray(rgb).save(
            os.path.join(base, "JPEGImages", img_id + ".jpg"), quality=90)
        k = 2 + i % 3  # classes above the cutoff
        ids = rng.choice(np.arange(1, len(nms) + 1), k + 1, replace=False)
        gt = np.zeros((h, w), np.uint8)
        gt[h // 5: h // 2, w // 6: w // 2] = ids[0]
        gt[h // 2:, w // 2:] = ids[1]
        if k > 2:
            gt[: h // 6, w // 2:] = ids[2]
        gt[h // 2 - 4: h // 2 + 4] = 255  # object boundary: ignored
        Image.fromarray(gt).save(
            os.path.join(base, "SegmentationClass", img_id + ".png"))
        probs = [rng.randint(71, 100) for _ in range(k)] + [40]
        gpt[img_id] = (
            "[" + ", ".join(f"{j}: '{nms[j - 1]}'" for j in ids) + "], ["
            + ", ".join(f"{j}: {pr}%" for j, pr in zip(ids, probs)) + "]")
        sizes[img_id] = (h, w)
    with open(os.path.join(base, "ImageSets", "Segmentation", "val.txt"),
              "w") as f:
        f.write("\n".join(sizes) + "\n")
    with open(os.path.join(root, "GPT4o_classification",
                           "voc_classification_noboundary.json"), "w") as f:
        json.dump(gpt, f)
    return sizes


HIST_DIRS = ("hist_withfiltered_caption",
             "all_drop_hist_with_filtered_caption")


def read_hists(out: str, suffix: str = "") -> dict:
    """{variant dir: {image id: hist}} of a CLI output directory."""
    import numpy as np

    hists = {}
    for sub in HIST_DIRS:
        d = os.path.join(out, sub + suffix)
        hists[sub] = {
            name[len("img_"):name.index("_max_blocknum")]:
            np.load(os.path.join(d, name)) for name in sorted(os.listdir(d))}
    return hists


def cli_run(args, entry=None) -> tuple:
    """``entry(args)`` (default ``cli.segment.main``) on the card with the
    launch counts set to 0 just before and read just after. Returns (its
    summary, the counts, wall seconds)."""
    import torch

    from pnp_ovss_tpu_torch.cli import segment
    from pnp_ovss_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    summary = (entry or segment.main)(args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    torch.cuda.empty_cache()
    return summary, counts, dt


def cli_defaults(tmp: str, data: str, sizes: dict, card: str) -> tuple:
    """Run A: the CLI's defaults (336 px, batch 35, fused ViT, blur +
    strided s=4 CRF, random weights, toy vocab) over every image, then
    run B: the same command again, which resume must skip whole, then the
    CLI's loader alone. Returns (run A's launches, its row of the
    pipeline line: img/s over the two full batches, each full batch's
    host finalize seconds, the loader's img/s)."""
    import numpy as np

    cfg = full_config(336)
    out = os.path.join(tmp, "out_a")
    args = ["--data_type", "voc", "--home_dir", data, "--save_path", out]
    summary, counts, dt = cli_run(args)
    n_batches = -(-CLI_IMAGES // cfg.batch_size)  # the tail batch is padded
    per_batch = expected_launches(cfg, _VIT_336)
    want = {k: v * n_batches for k, v in per_batch.items()}
    if counts != want:
        raise SystemExit(f"FAIL: CLI run A launched {counts}, want {want} "
                         f"({n_batches} batches of {per_batch})")
    if summary["batch_images"] != [35, 35, 5] or \
            len(summary["batch_done_s"]) != n_batches:
        raise SystemExit(f"FAIL: CLI run A batches {summary}")
    hists = read_hists(out)
    for sub, per_image in hists.items():
        if sorted(per_image) != sorted(sizes):
            raise SystemExit(f"FAIL: CLI {sub}: {len(per_image)} files for "
                             f"{len(sizes)} images")
        for img_id, h in per_image.items():
            if h.shape != (21, 21) or h.sum() != np.prod(sizes[img_id]):
                raise SystemExit(f"FAIL: CLI {sub} {img_id}: shape "
                                 f"{h.shape}, sum {h.sum()} for "
                                 f"{sizes[img_id]} pixels")
    agg = sum(hists[HIST_DIRS[1]].values())
    if np.count_nonzero(agg.sum(0)) < 3:
        raise SystemExit("FAIL: CLI predictions take fewer than 3 classes")
    img_s = 2 * cfg.batch_size / summary["batch_done_s"][1]
    finalize_s = summary["finalize_s"][:2]
    print(f"  run A (defaults, {CLI_IMAGES} images): {dt:.1f} s in main, "
          f"files complete, launches {counts} = {n_batches} x the 336 px "
          f"fused run's; CLI wall {img_s:.3f} img/s over the two full "
          "batches (JPEG decode, host finalize and file writes included) "
          f"on {card}; host finalize of each full batch on the worker "
          f"thread {finalize_s[0]:.3f} / {finalize_s[1]:.3f} s, the "
          f"batches done at {summary['batch_done_s'][0]:.3f} / "
          f"{summary['batch_done_s'][1]:.3f} s", flush=True)

    mtimes = {p: os.path.getmtime(p) for sub in HIST_DIRS
              for p in (os.path.join(out, sub, f)
                        for f in os.listdir(os.path.join(out, sub)))}
    summary, counts, dt = cli_run(args)
    if summary["images"] != 0 or any(counts.values()) or mtimes != {
            p: os.path.getmtime(p) for p in mtimes}:
        raise SystemExit(f"FAIL: CLI resume ran {summary['images']} images,"
                         f" launched {counts}, or rewrote files")
    print(f"  run B (same command): resume skipped all {CLI_IMAGES} images,"
          f" no launches, no file rewritten ({dt:.1f} s)", flush=True)
    loader_img_s = loader_alone(data, cfg)
    print(f"  the CLI's loader alone (decode, resizes, GT; 8 threads): "
          f"{loader_img_s:.3f} img/s over the first two batches", flush=True)
    return want, dict(img_per_s=img_s, images=2 * cfg.batch_size,
                      finalize_s=finalize_s, loader_img_per_s=loader_img_s)


def loader_alone(data: str, cfg) -> float:
    """img/s of the CLI's ``PrefetchLoader`` alone over the dataset, timed
    from its start to the second batch (no device work)."""
    from pnp_ovss_tpu_torch.data.datasets import make_dataset
    from pnp_ovss_tpu_torch.data.loader import PrefetchLoader

    records = list(make_dataset("voc", data).records())
    t0 = time.perf_counter()
    for i, _ in enumerate(PrefetchLoader(records, batch_size=cfg.batch_size,
                                         img_size=cfg.img_size,
                                         bucket=BUCKET)):
        if i == 1:
            dt = time.perf_counter() - t0
    return 2 * cfg.batch_size / dt


def cli_eval_at_bucket(tmp: str, data: str) -> None:
    """Run C: ``--eval_at_bucket --no_resume``. Every device hist equals
    numpy ``fast_hist`` over the same bucket labels (copied to the host
    for this check), tables and bucket GT, as integers; the files are the
    real rows' hists and the run totals their sums."""
    import numpy as np

    from pnp_ovss_tpu_torch.evalx.metrics import fast_hist
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

    calls = []
    make = SegmentationRunner.make_hist_fn

    def spy(self, n_class):
        fn = make(self, n_class)

        def hist_fn(labels, tables, gt):
            hists = fn(labels, tables, gt)
            calls.append([x.cpu().numpy() for x in (labels, tables, gt,
                                                    hists)])
            return hists

        return hist_fn

    out = os.path.join(tmp, "out_c")
    SegmentationRunner.make_hist_fn = spy
    try:
        cli_run(["--data_type", "voc", "--home_dir", data, "--save_path",
                 out, "--eval_at_bucket", "--no_resume"])
    finally:
        SegmentationRunner.make_hist_fn = make
    rows = 0
    for labels, tables, gt, hists in calls:
        pred = np.take_along_axis(
            tables, labels.reshape(len(labels), -1).astype(np.int64), 1)
        for i in range(len(labels)):
            want = fast_hist(gt[i].ravel(), pred[i], 21)
            if hists.dtype != np.int32 or not np.array_equal(hists[i], want):
                raise SystemExit(f"FAIL: device hist of row {i} differs "
                                 "from numpy fast_hist")
            rows += 1
    hists = read_hists(out, f"_bucket{BUCKET}")
    for variant, sub in zip(("r0", "agg"), HIST_DIRS):
        files = hists[sub]
        total = np.load(os.path.join(
            out, f"total_hist_{variant}_bucket{BUCKET}_rank0.npy"))
        if len(files) != CLI_IMAGES or any(
                h.sum() != BUCKET * BUCKET for h in files.values()) or \
                not np.array_equal(total, sum(files.values())):
            raise SystemExit(f"FAIL: --eval_at_bucket {variant}: files or "
                             "run total wrong")
    print(f"  run C (--eval_at_bucket): {rows} device hists (pad rows "
          f"included) equal numpy fast_hist exactly; {CLI_IMAGES} files a "
          "variant, run totals equal their sums", flush=True)
    return hists


def cli_checkpoint(tmp: str, data: str) -> None:
    """Run D: ``--checkpoint`` on a full-width LAVIS-layout state dict at
    384 px, ``--limit 35 --no_resume``, twice: the first run converts it
    (every parameter equal to the dict's, the position embeddings to
    ``interpolate_pos_embed`` of it) and caches it, the second reads the
    cache (no conversion; the cached tensors equal the converted ones)."""
    import numpy as np
    import torch

    from pnp_ovss_tpu_torch.models import cache, convert
    from pnp_ovss_tpu_torch.models.vit import interpolate_pos_embed

    cfg = full_config(336)
    t0 = time.perf_counter()
    sd = lavis_state_dict(cfg.model, seed=5, grid=CLI_CKPT_GRID)
    path = os.path.join(tmp, "model_large_retrieval.pth")
    torch.save({"model": {k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}}, path)
    size = os.path.getsize(path)
    print(f"  run D: LAVIS-layout checkpoint {size / 1e9:.2f} GB at "
          f"{CLI_CKPT_GRID * 16} px written in {time.perf_counter() - t0:.1f}"
          " s", flush=True)
    converted = []
    real = convert.load_torch_checkpoint

    def counting(*a, **kw):
        converted.append(real(*a, **kw))
        return converted[-1]

    home = os.environ.get("HOME")
    os.environ["HOME"] = os.path.join(tmp, "home")
    convert.load_torch_checkpoint = counting
    try:
        outs = []
        for run in (1, 2):
            out = os.path.join(tmp, f"out_d{run}")
            _, counts, dt = cli_run([
                "--data_type", "voc", "--home_dir", data, "--save_path", out,
                "--checkpoint", path, "--limit", "35", "--no_resume"])
            outs.append(read_hists(out))
            print(f"  run D{run}: {dt:.1f} s in main, conversions so far "
                  f"{len(converted)}", flush=True)
        store = cache.cache_path(path, cfg.model,
                                 (cfg.attribution.layer - 1,))
    finally:
        convert.load_torch_checkpoint = real
        if home is None:
            os.environ.pop("HOME")
        else:
            os.environ["HOME"] = home
    if len(converted) != 1:
        raise SystemExit(f"FAIL: {len(converted)} conversions in two runs; "
                         "the second must read the cache")
    for hists in outs:
        if any(len(h) != 35 for h in hists.values()):
            raise SystemExit("FAIL: a --checkpoint run wrote "
                             f"{[len(h) for h in hists.values()]} hists")
    params = converted[0].state_dict()
    cached = torch.load(store, map_location="cpu", weights_only=True)
    placed = 0
    for key, val in sd.items():
        name = convert.lavis_port_name(key)
        if name not in params:
            continue
        want = torch.from_numpy(np.asarray(val))
        if name == "visual_encoder.pos_embed":
            want = interpolate_pos_embed(want, cfg.model.vit.num_patches)
        got = params[name].cpu()
        if not (torch.equal(got, want.to(got.dtype))
                and torch.equal(cached[name], got)):
            raise SystemExit(f"FAIL: loaded {name} differs from {key}")
        placed += 1
    if placed != len(params) or sorted(cached) != sorted(params):
        raise SystemExit(f"FAIL: {placed} of {len(params)} parameters placed")
    print(f"  run D: all {placed} parameters equal the checkpoint's (pos "
          f"embed resampled {CLI_CKPT_GRID}x{CLI_CKPT_GRID} -> "
          f"{cfg.model.vit.grid}x{cfg.model.vit.grid}), {len(sd) - placed} "
          "keys dropped; the second run read the cache; 35 hists a run",
          flush=True)


def cli_phase(card: str) -> tuple:
    """Phase 6: the CLI's runs A-D in a temporary directory, deleted at
    the end. Returns (run A's launches, its row of the pipeline line, run
    C's per-image bucket hists)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="pnp_cli_")
    try:
        data = os.path.join(tmp, "voc")
        sizes = write_fake_voc(data, CLI_IMAGES)
        launches, row = cli_defaults(tmp, data, sizes, card)
        bucket_hists = cli_eval_at_bucket(tmp, data)
        cli_checkpoint(tmp, data)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, row | dict(
        note="python -m pnp_ovss_tpu_torch.cli.segment defaults over two "
             "full batches: JPEG decode, host finalize and file writes "
             "included"), bucket_hists


# Phase 7: the host parity CLI, the synthetic postprocess gate, the search.
PARITY_BATCH = 4  # two batches; each lattice CRF is re-run on the main
# thread, ~4 s a CRF at VOC size on one core
GATE_CONFIGS = ("strided_s4_b192", "exact_s1_b192")
GATE_SCENES = 48
SEARCH_IMAGES = 8
# Random weights give GradCAM maps far below the search's thresholds
# (0.05-0.45), so every mask is empty and every reward 0. GradCAM is
# linear in the ITM head; a power of two scales every map exactly.
SEARCH_ITM_SCALE = 2.0 ** 17
TOL_SEARCH_MAPS = 1e-6  # one computation through two captures
TOL_SEARCH_ITC = 0.01  # cosine similarities, bf16 towers, card vs CPU


def load_script(name: str):
    """A script of ``scripts/`` as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parity_cli(tmp: str, data: str, sizes: dict, card: str) -> tuple:
    """Run E: ``--postprocess_backend host --batch_size 4 --limit 8`` (two
    batches). The hist files are complete and sum to their pixels; the
    device launches are the 336 px fused run's per batch at batch 4 (the
    device postprocess still runs, as in the JAX package); every parity
    label map, computed off the main thread from host numpy, equals
    ``finalize_image_parity`` re-run on the main thread from the same grid
    maps. Then run F: the device CLI with the same flags, for its img/s.
    Returns (run E's launches, its row of the pipeline line)."""
    import threading

    import numpy as np

    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

    b = PARITY_BATCH
    cfg = dataclasses.replace(full_config(336), batch_size=b)
    flags = ["--data_type", "voc", "--home_dir", data, "--batch_size",
             str(b), "--limit", str(2 * b), "--no_resume"]
    calls = []
    real = SegmentationRunner.finalize_image_parity

    def spy(self, *args, **kw):
        out = real(self, *args, **kw)
        calls.append((self, args, kw, out, threading.current_thread()))
        return out

    out = os.path.join(tmp, "out_e")
    SegmentationRunner.finalize_image_parity = spy
    try:
        summary, counts, dt = cli_run(flags + [
            "--save_path", out, "--postprocess_backend", "host"])
    finally:
        SegmentationRunner.finalize_image_parity = real
    want = {k: 2 * v for k, v in expected_launches(cfg, _VIT_336).items()}
    if counts != want:
        raise SystemExit(f"FAIL: parity CLI launched {counts}, want {want}")
    ids = list(sizes)[: 2 * b]
    for sub, per_image in read_hists(out).items():
        if sorted(per_image) != sorted(ids) or any(
                h.sum() != np.prod(sizes[i]) for i, h in per_image.items()):
            raise SystemExit(f"FAIL: parity CLI {sub}: files incomplete or "
                             "not summing to the images' pixels")
    main = threading.main_thread()
    if len(calls) != 4 * b or any(t is main or not isinstance(a[0],
                                                              np.ndarray)
                                  for _, a, _, _, t in calls):
        raise SystemExit(f"FAIL: {len(calls)} parity calls, want {4 * b}, "
                         "all off the main thread on host numpy")
    t0 = time.perf_counter()
    for self, args, kw, got, _ in calls:
        if not np.array_equal(real(self, *args, **kw), got):
            raise SystemExit("FAIL: a parity label map differs from its "
                             "re-run on the main thread")
    rerun_s = (time.perf_counter() - t0) / len(calls)
    img_s = 2 * b / summary["batch_done_s"][1]
    print(f"  run E (--postprocess_backend host, 2 batches of {b}): "
          f"{dt:.1f} s in main, files complete, launches {counts} = 2 x "
          f"the 336 px fused run's at batch {b}; {len(calls)} parity label "
          "maps (worker threads, host numpy) equal their re-runs on the "
          f"main thread ({rerun_s:.3f} s a lattice CRF there); parity CLI "
          f"{img_s:.3f} img/s over the two batches on {card}; host "
          f"finalize {summary['finalize_s'][0]:.3f} / "
          f"{summary['finalize_s'][1]:.3f} s a batch", flush=True)
    summary_f, _, _ = cli_run(flags + ["--save_path",
                                       os.path.join(tmp, "out_f")])
    device_img_s = 2 * b / summary_f["batch_done_s"][1]
    print(f"  run F (the device CLI, same flags): {device_img_s:.3f} img/s "
          f"over the two batches; parity / device "
          f"{img_s / device_img_s:.3f}", flush=True)
    return want, dict(img_per_s=img_s, images=2 * b, batch=b,
                      device_cli_img_per_s=device_img_s,
                      finalize_s=summary["finalize_s"][:2],
                      lattice_crf_s=rerun_s)


def gate_check(card: str) -> tuple:
    """The synthetic postprocess gate at seed 0 x 48 scenes for the
    strided s = 4 default at bucket 192 and the exact CRF: each mean delta
    against the host anchor must be at least -0.3 mIoU points (the full
    5-seed run is ``scripts/synthetic_postprocess_gate_torch.py``), and
    the CRF launches are one image's per scene and config. Returns (its
    launches, its row of the pipeline line)."""
    import torch

    from pnp_ovss_tpu_torch.ops import _build

    gate = load_script("synthetic_postprocess_gate_torch")
    want = dict.fromkeys(_build.LAUNCHES, 0)
    for tag, mode, sub, bucket in gate.DEVICE_GRID:
        if tag in GATE_CONFIGS:
            base = full_config(336)
            cfg = dataclasses.replace(
                base, batch_size=GATE_SCENES,
                postprocess=dataclasses.replace(
                    base.postprocess, bilateral_mode=mode,
                    bilateral_subsample=sub))
            for k, v in expected_launches(cfg, (), bucket).items():
                want[k] += v
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    payload = gate.run_gate(scenes=GATE_SCENES, seeds=(0,),
                            configs=set(GATE_CONFIGS), device="cuda",
                            log=lambda m: print("  " + m, flush=True))
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    if counts != want:
        raise SystemExit(f"FAIL: gate launched {counts}, want {want}")
    deltas = {tag: payload["stats"][tag]["mean_pts"] for tag in GATE_CONFIGS}
    print(f"  gate, seed 0 x {GATE_SCENES} scenes: mean deltas {deltas} "
          f"mIoU points (bar -{payload['budget_pts']}), {wall:.1f} s on "
          f"{card} ({payload['anchor_threads']} anchor threads); launches "
          f"{counts}", flush=True)
    if payload["failures_mean"]:
        raise SystemExit(f"FAIL: gate {payload['failures_mean']} below "
                         f"-{payload['budget_pts']} points")
    return counts, dict(deltas_pts=deltas, wall_s=wall,
                        seconds=payload["seconds"])


def search_check(tmp: str, data: str, card: str) -> tuple:
    """Run G: ``cli.search --scorer itc --n_iter 4 --limit 8`` at full
    width with the 12-layer ensemble (random weights from seed 0, the ITM
    head scaled by ``SEARCH_ITM_SCALE``). Checks:

    - the search scores above 0 (some positive mask beats the black one);
    - each image's ensemble GradCAM at layer 8 equals, map for map,
      ``gradcam_from_embeds`` of a model capturing layer 8 alone on the
      same weights (within ``TOL_SEARCH_MAPS`` of the largest value);
    - the ITC similarities of one scorer call (its first positive images
      and first negative one) on the card within ``TOL_SEARCH_ITC`` of the
      same model's on the CPU;
    - K1 = K2 = K3 = 24 x the ``encode_image`` calls.

    Returns (its launches, its row of the pipeline line)."""
    import torch

    from pnp_ovss_tpu_torch.attribution.gradcam import gradcam_from_embeds
    from pnp_ovss_tpu_torch.cli import search
    from pnp_ovss_tpu_torch.models.blip_itm import BlipITM, init_blip_itm
    from pnp_ovss_tpu_torch.ops import _build

    encodes, recorded, scored, models = [0], [], [], []
    real_encode, real_itc = BlipITM.encode_image, BlipITM.itc
    real_fn, real_load = search.ensemble_gradcam_fn, search.load_model

    def load(args, cfg, capture, device):
        model = real_load(args, cfg, capture, device)
        model.itm_head.weight.mul_(SEARCH_ITM_SCALE)
        models.append(model)
        return model

    def encode(self, images):
        encodes[0] += 1
        return real_encode(self, images)

    def itc(self, images, ids, mask):
        sims = real_itc(self, images, ids, mask)
        scored.append((images.cpu(), ids.cpu(), mask.cpu(), sims.cpu()))
        return sims

    def ensemble(model):
        fn = real_fn(model)

        def recording(images, ids, mask):
            gc, logits = fn(images, ids, mask)
            recorded.append((images, ids, mask, gc[7].clone()))
            return gc, logits

        return recording

    patched = (encode, itc, ensemble, load)
    (BlipITM.encode_image, BlipITM.itc, search.ensemble_gradcam_fn,
     search.load_model) = patched
    try:
        summary, counts, dt = cli_run(
            ["--data_type", "voc", "--home_dir", data, "--save_path",
             os.path.join(tmp, "out_g"), "--scorer", "itc", "--n_iter", "4",
             "--limit", str(SEARCH_IMAGES)], entry=search.main)
    finally:
        (BlipITM.encode_image, BlipITM.itc, search.ensemble_gradcam_fn,
         search.load_model) = real_encode, real_itc, real_fn, real_load
    n = encodes[0]
    want = dict.fromkeys(_build.LAUNCHES, 0)
    want.update(dict.fromkeys(_VIT_336, 24 * n))
    if counts != want or len(recorded) != SEARCH_IMAGES or \
            n < 2 * SEARCH_IMAGES:
        raise SystemExit(f"FAIL: search launched {counts} over {n} encodes "
                         f"({len(recorded)} ensembles), want {want}")
    cfg = full_config(336).model
    single = init_blip_itm(cfg, capture_layers=(7,), seed=0, device="cuda")
    single.itm_head.weight.mul_(SEARCH_ITM_SCALE)
    worst = 0.0
    for images, ids, mask, gc8 in recorded:
        one, _ = gradcam_from_embeds(single, single.encode_image(images),
                                     ids, mask, grid=cfg.vit.grid)
        if not (torch.isfinite(gc8).all() and one.abs().max() > 0):
            raise SystemExit("FAIL: search GradCAM not finite or all zero")
        worst = max(worst, float((gc8 - one[0]).abs().max()
                                 / one.abs().max()))
    del single
    # The scorer call whose images differ most; its first positive images
    # and its first negative (black) one, on the CPU.
    images, ids, mask, sims = max(
        scored, key=lambda c: float((c[3] - c[3][-1]).abs().max()))
    k = ids.shape[0]
    rows = list(range(min(k, 2))) + [k]
    model = models[0].cpu()
    t0 = time.perf_counter()
    cpu = real_itc(model, images[rows], ids, mask)
    cpu_s = time.perf_counter() - t0
    itc_err = float((cpu - sims[rows]).abs().max())
    spread = float((sims[rows] - sims[k]).abs().max())
    del model, models[:]
    torch.cuda.empty_cache()
    ens_s = summary["ensemble_s"]
    eval_s = [t / SEARCH_IMAGES for t in summary["evaluation_s"]]
    print(f"  run G (cli.search --scorer itc, 12-layer ensemble, ITM head "
          f"x{SEARCH_ITM_SCALE:g}, {SEARCH_IMAGES} images, 4 steps): "
          f"{dt:.1f} s in main, best {summary['best']} score "
          f"{summary['score']:.4f}, history "
          f"{[round(sc, 4) for _, sc in summary['history']]}; layer-8 "
          f"GradCAM maps vs the single-layer capture max diff {worst:.4g} "
          f"of the largest (bar {TOL_SEARCH_MAPS:g}); ITC similarities of "
          f"{len(rows)} images x {k} texts, card vs CPU max diff "
          f"{itc_err:.4g} (bar {TOL_SEARCH_ITC:g}; positive vs negative "
          f"spread {spread:.4g}; CPU {cpu_s:.1f} s); {n} encodes, launches "
          f"{counts}; ensemble {[round(t, 4) for t in ens_s]} s an image, "
          f"{len(eval_s)} (layer, head, min_att) evaluations "
          f"{[round(t, 4) for t in eval_s]} s an image, on {card}",
          flush=True)
    if not summary["score"] > 0:
        raise SystemExit("FAIL: every search reward read 0")
    if worst > TOL_SEARCH_MAPS:
        raise SystemExit("FAIL: the ensemble's layer 8 differs from the "
                         "single-layer GradCAM")
    if itc_err > TOL_SEARCH_ITC:
        raise SystemExit("FAIL: the ITC scorer on the card differs from "
                         "the CPU")
    return counts, dict(ensemble_s_per_image=ens_s,
                        evaluation_s_per_image=eval_s, encodes=n,
                        score=summary["score"], layer8_rel_diff=worst,
                        itc_err=itc_err)


# Run H: the CLIP scorer's checkpoint, drawn from this seed.
SEARCH_CLIP_SEED = 2
_CLIP_BLOCK_KEYS = ("ln_1.weight", "ln_1.bias", "attn.in_proj_weight",
                    "attn.in_proj_bias", "attn.out_proj.weight",
                    "attn.out_proj.bias", "ln_2.weight", "ln_2.bias",
                    "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight",
                    "mlp.c_proj.bias")


def openai_clip_state_dict(cfg, seed: int) -> dict:
    """A CLIP of ``cfg`` in OpenAI's checkpoint layout (the keys of
    ``ViT-L-14-336px.pt``, ``logit_scale`` included), its weights drawn
    on the card by ``init_clip`` from ``seed``, in half precision on the
    host as OpenAI ships them."""
    import torch

    from pnp_ovss_tpu_torch.models.clip import init_clip
    from pnp_ovss_tpu_torch.models.convert import clip_port_name

    def norm(name):
        return [f"{name}.weight", f"{name}.bias"]

    def blocks(prefix, n):
        return [f"{prefix}.resblocks.{i}.{k}" for i in range(n)
                for k in _CLIP_BLOCK_KEYS]

    keys = (["visual.conv1.weight", "visual.class_embedding",
             "visual.positional_embedding"] + norm("visual.ln_pre")
            + blocks("visual.transformer", cfg.vision.num_layers)
            + norm("visual.ln_post") + ["visual.proj",
                                        "token_embedding.weight",
                                        "positional_embedding"]
            + blocks("transformer", cfg.text.num_layers) + norm("ln_final")
            + ["text_projection"])
    port = init_clip(cfg, seed=seed, device="cuda").state_dict()
    sd = {k: port[clip_port_name(k)].half().cpu() for k in keys}
    sd["logit_scale"] = torch.tensor(4.6052, dtype=torch.float16)
    return sd


def search_clip_check(tmp: str, data: str, card: str) -> tuple:
    """Run H: ``cli.search --scorer clip --n_iter 4 --limit 8`` at full
    width with ``--clip_checkpoint``, a ViT-L/14-336 state dict in
    OpenAI's layout drawn from ``SEARCH_CLIP_SEED`` (random BLIP weights
    from seed 0, the ITM head scaled by ``SEARCH_ITM_SCALE`` as in run G).
    Checks:

    - K1 = K3 = 24 x the BLIP encodes (one ensemble an image), K2 = 24 x
      (the BLIP encodes + the CLIP ``encode_image`` calls, one a scorer
      call), every other kernel 0;
    - every loaded CLIP parameter equal to the checkpoint's value in the
      parameter's dtype;
    - every probability row finite and summing to 1; every scorer call on
      the main thread (F5);
    - the cosine similarities of one scorer call (its first positive
      images and its first negative one, before the / 0.01) on the card
      within ``TOL_SEARCH_ITC`` of the same model's on the CPU, beside
      their positive-vs-negative spread.

    With random CLIP weights every reward may be 0, so no score is
    required. Returns (its launches, its row of the pipeline line)."""
    import threading

    import numpy as np
    import torch

    from pnp_ovss_tpu_torch.cli import search
    from pnp_ovss_tpu_torch.config import CLIPConfig
    from pnp_ovss_tpu_torch.models.blip_itm import BlipITM
    from pnp_ovss_tpu_torch.models.clip import CLIPModel
    from pnp_ovss_tpu_torch.models.convert import clip_port_name
    from pnp_ovss_tpu_torch.ops import _build

    t0 = time.perf_counter()
    sd = openai_clip_state_dict(CLIPConfig(), SEARCH_CLIP_SEED)
    path = os.path.join(tmp, "clip_vit_l14_336.pt")
    torch.save(sd, path)
    draw_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in sd.values())

    encodes, calls, probs, models, threads = [0], [], [], [], set()
    real = (BlipITM.encode_image, CLIPModel.encode_image,
            CLIPModel.encode_text, search.load_model, search.make_clip_scorer)
    real_encode, real_image, real_text, real_load, real_scorer = real

    def load(args, cfg, capture, device):
        model = real_load(args, cfg, capture, device)
        model.itm_head.weight.mul_(SEARCH_ITM_SCALE)
        return model

    def encode(self, images):
        encodes[0] += 1
        return real_encode(self, images)

    def clip_image(self, images):
        z = real_image(self, images)
        calls.append(dict(images=images.cpu(), img_z=z.cpu()))
        threads.add(threading.current_thread())
        return z

    def clip_text(self, ids):
        z = real_text(self, ids)
        calls[-1].update(ids=ids.cpu(), txt_z=z.cpu())
        return z

    def scorer(clip_model, bpe_tok, **kw):
        models.append(clip_model)
        fn = real_scorer(clip_model, bpe_tok, **kw)

        def recording(images, texts):
            p = fn(images, texts)
            probs.append(p)
            return p

        return recording

    (BlipITM.encode_image, CLIPModel.encode_image, CLIPModel.encode_text,
     search.load_model, search.make_clip_scorer) = (
        encode, clip_image, clip_text, load, scorer)
    try:
        summary, counts, dt = cli_run(
            ["--data_type", "voc", "--home_dir", data, "--save_path",
             os.path.join(tmp, "out_h"), "--scorer", "clip",
             "--clip_checkpoint", path, "--n_iter", "4", "--limit",
             str(SEARCH_IMAGES)], entry=search.main)
    finally:
        (BlipITM.encode_image, CLIPModel.encode_image,
         CLIPModel.encode_text, search.load_model,
         search.make_clip_scorer) = real
    n, n_clip = encodes[0], len(calls)
    want = dict.fromkeys(_build.LAUNCHES, 0)
    want.update(ln_matmul=24 * n, ln_mlp_residual=24 * n,
                flash_mha_flat_qkv=24 * (n + n_clip))
    if (counts != want or n != SEARCH_IMAGES or len(models) != 1
            or n_clip != SEARCH_IMAGES * len(summary["evaluation_s"])
            or n_clip != len(probs) or n_clip == 0):
        raise SystemExit(f"FAIL: CLIP search launched {counts} over {n} "
                         f"BLIP encodes and {n_clip} CLIP scorer calls, "
                         f"want {want}")
    model = models[0]
    loaded = model.state_dict()
    for key, val in sd.items():
        name = clip_port_name(key)
        if key != "logit_scale" and not torch.equal(
                loaded[name].cpu(), val.to(loaded[name].dtype)):
            raise SystemExit(f"FAIL: CLIP parameter {name} differs from the "
                             f"checkpoint's {key}")
    if threads != {threading.main_thread()}:
        raise SystemExit(f"FAIL: CLIP scorer calls ran on {threads}")
    for p in probs:
        if not (np.isfinite(p).all() and np.allclose(p.sum(-1), 1,
                                                      atol=1e-5)):
            raise SystemExit("FAIL: a CLIP probability row is not finite "
                             "or does not sum to 1")

    def spread(c):
        sims = c["img_z"] @ c["txt_z"].T
        k = c["ids"].shape[0]
        return float((sims[:k] - sims[k:]).abs().max())

    # The scorer call whose positives and negatives differ most; its
    # first positive images and its first negative one, on the CPU.
    c = max(calls, key=spread)
    k = c["ids"].shape[0]
    rows = list(range(min(k, 2))) + [k]
    card_sims = c["img_z"][rows] @ c["txt_z"].T
    model.cpu()
    t0 = time.perf_counter()
    cpu_sims = (model.encode_image(c["images"][rows])
                @ model.encode_text(c["ids"]).T)
    cpu_s = time.perf_counter() - t0
    clip_err = float((cpu_sims - card_sims).abs().max())
    clip_spread = float((card_sims - card_sims[-1]).abs().max())
    del model, models[:], calls[:], sd, loaded
    torch.cuda.empty_cache()
    ens_s = summary["ensemble_s"]
    eval_s = [t / SEARCH_IMAGES for t in summary["evaluation_s"]]
    print(f"  run H (cli.search --scorer clip, --clip_checkpoint: OpenAI-"
          f"layout ViT-L/14-336, {n_params / 1e6:.1f} M parameters in half "
          f"precision, {os.path.getsize(path) / 1e9:.3f} GB, drawn and "
          f"written in {draw_s:.1f} s; {SEARCH_IMAGES} images, 4 steps): "
          f"{dt:.1f} s in main, best {summary['best']} score "
          f"{summary['score']:.4f}, history "
          f"{[round(sc, 4) for _, sc in summary['history']]}; every loaded "
          f"parameter equal to the checkpoint's; {n_clip} scorer calls on "
          f"the main thread, every probability row finite and summing to "
          f"1; CLIP cosine similarities of {len(rows)} images x {k} texts, "
          f"card vs CPU max diff {clip_err:.4g} (bar {TOL_SEARCH_ITC:g}; "
          f"positive vs negative spread {clip_spread:.4g}; CPU "
          f"{cpu_s:.1f} s); {n} BLIP encodes, launches {counts}; ensemble "
          f"{[round(t, 4) for t in ens_s]} s an image, {len(eval_s)} "
          f"(layer, head, min_att) evaluations "
          f"{[round(t, 4) for t in eval_s]} s an image, on {card}",
          flush=True)
    if clip_err > TOL_SEARCH_ITC:
        raise SystemExit("FAIL: the CLIP scorer on the card differs from "
                         "the CPU")
    return counts, dict(ensemble_s_per_image=ens_s,
                        evaluation_s_per_image=eval_s, encodes=n,
                        clip_scorer_calls=n_clip, score=summary["score"],
                        clip_sims_err=clip_err, clip_sims_spread=clip_spread,
                        clip_parameters=n_params)


def parity_and_search_phase(card: str) -> tuple:
    """Phase 7: runs E-H on phase 6's synthetic VOC set (the same seed)
    and the gate, in a temporary directory deleted at the end. Returns
    ({run: launches}, {run: row of the pipeline line})."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="pnp_parity_")
    try:
        data = os.path.join(tmp, "voc")
        sizes = write_fake_voc(data, CLI_IMAGES)
        launches, rows = {}, {}
        launches["parity CLI 336 px"], rows["parity CLI 336 px"] = \
            parity_cli(tmp, data, sizes, card)
        launches["gate seed 0"], rows["gate seed 0"] = gate_check(card)
        launches["search 336 px ITC"], rows["search 336 px ITC"] = \
            search_check(tmp, data, card)
        launches["search 336 px CLIP"], rows["search 336 px CLIP"] = \
            search_clip_check(tmp, data, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, rows


# Phase 8: data, tensor and pipeline parallelism. Two ranks share the card
# through gloo (NCCL refuses two ranks on one device), so every wall time
# here is gloo's transport on one card, no speed result.
PP_MICROBATCHES = 5  # batch 35: the default M = pp = 2 does not divide it
NARROW_PP_M = 2
# Under TP a fused layer runs K1 twice (the replicated qkv; LN2 + the
# fc1 column slab) and no K3.
TP_NARROW = ("ln_matmul", "ln_matmul", "flash_mha")  # one local head: K9
TP_FULL = ("ln_matmul", "ln_matmul", "flash_mha_flat")  # 8 local heads: K2'
# Bars of the tensor-parallel runs. TP rounds where the unsharded run
# rounds, but its sums run in other orders: the row-parallel proj and
# mlp_fc2 are summed over the ranks, and LN2 + fc1 run in K1 where the
# unsharded block runs K3 (tests/test_torch_tensor_parallel.py holds TP
# to 1e-5 of JAX in f32). At full width, with random weights and noise
# images, any such change moves about half the labels: the port's own
# unfused block on the same weights agrees with the fused run on 52% /
# 71% of the labels r0 / agg. An image's class maps lie within about 1%
# of each other, and the CRF settles those near ties into confident
# labels either way, so neither a margin nor a rescaled head makes the
# labels decisive (scripts/tp_label_study_torch.py; PERF.md, PR 12), and
# the JAX package's 0.1% label bar cannot tell a faulty TP from a right
# one here. The runner's own round-0 encode and GradCAM can: a lost
# reduce or a wrong head slab moves them by orders of magnitude. So the
# timed TP runner's (``capture_round0``) are held to TP_YARDSTICK times
# the unfused runner's differences from the unsharded runner's, measured
# in the same run; its labels and map sums to the unfused run's agreement
# within TP_LABEL_MARGIN and TP_YARDSTICK. The narrow TP run against the
# CPU is held at each of TP_SEEDS to TP_VS_CPU: its labels' bar leaves
# 1.5x the worst disagreement of the five seeded H100 readings (seed 1:
# 0.0335 / 0.9598 / 0.9753, where the unsharded fused run reads 0.9641
# r0), its sums' bar 1.26x. The pipeline-parallel runs compute each row
# as the unsharded run does: equality.
TP_YARDSTICK = 1.5
TP_LABEL_MARGIN = 0.05
TP_VS_CPU = (0.042, 0.94)
TP_SEEDS = (1, 2, 3, 4, 5)


def expected_pp_launches(cfg, pp: int, m: int, bucket: int = BUCKET) -> dict:
    """Per-rank launches of a pipeline-parallel batch: each stage runs its
    L/pp layers on each of ``m`` microbatches in every drop round (K1,
    K2, K3); the CRF as unsharded."""
    want = expected_launches(cfg, _VIT_336, bucket)
    for name in _VIT_336:
        want[name] = cfg.model.vit.num_layers // pp * m * cfg.drop.num_rounds
    return want


def device_bytes(model) -> int:
    """Bytes of the model's parameters on the card."""
    return sum(p.numel() * p.element_size() for p in model.parameters()
               if p.device.type == "cuda")


def tp_narrow(mesh) -> dict:
    """Phase 8 on one rank: the narrow 192 px fused pipeline with the
    model Megatron-sharded over the model axis, on the card and on the
    CPU, at each of ``TP_SEEDS``."""
    cfg = narrow_config(192)
    out = {}
    for seed in TP_SEEDS:
        card, counts = narrow_run(cfg, "cuda", seed=seed, mesh=mesh)
        cpu, _ = narrow_run(cfg, "cpu", seed=seed, mesh=mesh)
        out[seed] = dict(cuda=card, cpu=cpu, launches=counts)
    return out


def pp_narrow(mesh) -> dict:
    """Phase 8 on one rank: the narrow 192 px fused pipeline with the ViT
    split into two stages, two microbatches, on the card."""
    cfg = narrow_config(192)
    card, counts = narrow_run(cfg, "cuda", mesh=mesh, encode_parallel="pp",
                              pp_microbatches=NARROW_PP_M)
    return dict(cuda=card, launches=counts)


def _full(mesh, per_batch, capture: bool = False, **parallel) -> dict:
    """One full-width run on this rank through ``run_pipeline``;
    ``capture``: rank 0 also returns its round-0 encode and GradCAM
    (``capture_round0``)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, runner, inputs = pipeline_setup(mesh=mesh, **parallel)
    setup_s = time.perf_counter() - t0
    round0, remove = capture_round0(runner, capture and mesh.rank == 0)
    try:
        counts, res = run_pipeline(cfg, runner, inputs, per_batch(cfg),
                                   SP_BATCHES)
    finally:
        remove()
    return dict(launches=counts, setup_s=setup_s,
                param_bytes=device_bytes(runner.model),
                max_allocated=torch.cuda.max_memory_allocated(),
                round0=round0, **res)


def tp_full(mesh) -> dict:
    """Phase 8 on one rank: the reference default under tensor
    parallelism over the model axis (8 of the ViT's 16 heads, 6 of
    BERT's 12 a rank), rank 0 capturing its round 0."""
    return _full(mesh, lambda cfg: expected_launches(cfg, TP_FULL),
                 capture=True)


def pp_full(mesh) -> dict:
    """Phase 8 on one rank: the reference default with the ViT split into
    two stages of 12 blocks, 5 microbatches of 7 images."""
    return _full(mesh, lambda cfg: expected_pp_launches(
        cfg, mesh.model, PP_MICROBATCHES), encode_parallel="pp",
        pp_microbatches=PP_MICROBATCHES)


MP_JOBS = {"tp_narrow": tp_narrow, "pp_narrow": pp_narrow,
           "tp_full": tp_full, "pp_full": pp_full}


def narrow_mp_check(ranks) -> dict:
    """Phase 8's narrow runs: exact launches on both ranks; TP at each of
    ``TP_SEEDS`` against the ranks' CPU run and the card's unsharded run,
    PP equal to the unsharded run; rank 1 equal to rank 0. Returns rank
    0's launches {run: counts}."""
    cfg = narrow_config(192)
    unsharded = {seed: narrow_run(cfg, "cuda", seed=seed)[0]
                 for seed in TP_SEEDS}
    want = {"tp_narrow": expected_launches(cfg, TP_NARROW, bucket=64),
            "pp_narrow": expected_pp_launches(cfg, SP, NARROW_PP_M,
                                              bucket=64)}
    for r, out in enumerate(ranks):
        runs = [("pp_narrow", out["pp_narrow"])] + [
            ("tp_narrow", out["tp_narrow"][seed]) for seed in TP_SEEDS]
        for job, run in runs:
            if run["launches"] != want[job]:
                raise SystemExit(f"FAIL: narrow {job} rank {r} launched "
                                 f"{run['launches']}, want {want[job]}")
    for job, w in want.items():
        print(f"  narrow 192 px fused {job[:2].upper()}, {SP} ranks on one "
              f"card (gloo): launches per rank {w}", flush=True)
    r0, r1 = ranks
    for seed in TP_SEEDS:
        tp = r0["tp_narrow"][seed]
        hold(f"narrow TP seed {seed} rank 0 card vs the ranks on the CPU",
             tp["cuda"], tp["cpu"], *TP_VS_CPU)
        hold(f"narrow TP seed {seed} rank 0 vs the card's unsharded run",
             tp["cuda"], unsharded[seed], *SP_VS_CPU)
        hold(f"narrow TP seed {seed} rank 1 vs rank 0",
             r1["tp_narrow"][seed]["cuda"], tp["cuda"], *SP_EXACT)
    hold("narrow PP rank 0 vs the card's unsharded run",
         r0["pp_narrow"]["cuda"], unsharded[1], *SP_EXACT)
    hold("narrow PP rank 1 vs rank 0", r1["pp_narrow"]["cuda"],
         r0["pp_narrow"]["cuda"], *SP_EXACT)
    return {"192 px fused TP narrow (rank 0)":
            r0["tp_narrow"][TP_SEEDS[0]]["launches"],
            "192 px fused PP narrow (rank 0)": r0["pp_narrow"]["launches"]}


def tp_yardstick_bars(unsharded: dict, unfused: dict) -> tuple:
    """(max relative map-sum difference, least share of equal labels) of
    phase 5's unfused run against its fused run on the same weights and
    inputs, widened by ``TP_YARDSTICK`` and ``TP_LABEL_MARGIN``."""
    import numpy as np

    rel = np.abs(unfused["sums_r0"] - unsharded["sums_r0"]).max() / max(
        np.abs(unsharded["sums_r0"]).max(), 1e-9)
    agree = min((unfused[k] == unsharded[k]).mean()
                for k in ("labels_r0", "labels_agg"))
    print(f"  yardstick, 336 px unfused vs fused (same weights): round-0 "
          f"map sums rel diff {rel:.4g}, labels equal at least "
          f"{agree:.4f}", flush=True)
    return TP_YARDSTICK * rel, agree - TP_LABEL_MARGIN


def tp_numerics_check(tp: dict, ref: dict, unf: dict) -> None:
    """The TP runner's round-0 encode and GradCAM no further from the
    unsharded runner's than ``TP_YARDSTICK`` times the unfused runner's
    (each captured by ``capture_round0`` on the same weights and
    inputs): max and mean |diff| of the encodes, max |diff| of the
    GradCAM maps."""
    def diffs(rec):
        enc = (rec["encode"] - ref["encode"]).abs()
        return dict(enc_max=enc.max().item(), enc_mean=enc.mean().item(),
                    gc_max=(rec["gradcam"] - ref["gradcam"]).abs().max()
                    .item())

    t, u = diffs(tp), diffs(unf)
    print(f"  336 px TP runner's round 0 vs the unsharded runner's: encode "
          f"max |diff| {t['enc_max']:.4g}, mean {t['enc_mean']:.4g} "
          f"(unfused runner: {u['enc_max']:.4g}, {u['enc_mean']:.4g}; max "
          f"|y| {ref['encode'].abs().max().item():.4g}); GradCAM head "
          f"max |diff| {t['gc_max']:.4g} (unfused runner {u['gc_max']:.4g},"
          f" max {ref['gradcam'].abs().max().item():.4g})", flush=True)
    for key in t:
        if t[key] > TP_YARDSTICK * u[key]:
            raise SystemExit(f"FAIL: TP {key} {t[key]:.4g} above "
                             f"{TP_YARDSTICK} x the unfused runner's "
                             f"{u[key]:.4g}")


def full_mp_check(ranks, unsharded: dict, unfused: dict, round0: dict,
                  card: str) -> dict:
    """Phase 8's full-width runs (each rank asserted its launches in
    ``run_pipeline``): TP against phase 5's unsharded 336 px run within
    the unfused run's yardstick (``tp_yardstick_bars``,
    ``tp_numerics_check`` on the runs' ``round0`` captures), PP equal to
    it, rank 1 equal to rank 0. Returns {run: row of the pipeline
    line}."""
    rows = {}
    tp_numerics_check(ranks[0]["tp_full"]["round0"],
                      round0["336 px fused"], round0["336 px unfused"])
    tp_bars = tp_yardstick_bars(unsharded, unfused)
    for job, bars in (("tp_full", tp_bars), ("pp_full", SP_EXACT)):
        kind = job[:2].upper()
        for r, out in enumerate(ranks):
            o = out[job]
            print(f"  336 px fused {kind} rank {r}: set-up "
                  f"{o['setup_s']:.1f} s (gloo on one card, no speed "
                  f"result), parameters on the card "
                  f"{o['param_bytes'] / 2**20:.1f} "
                  f"MiB, peak allocated {o['max_allocated'] / 2**30:.2f} "
                  f"GiB, on {card}", flush=True)
        hold(f"336 px fused {kind} rank 0 vs the unsharded run",
             ranks[0][job], unsharded, *bars)
        hold(f"336 px fused {kind} rank 1 vs rank 0", ranks[1][job],
             ranks[0][job], *SP_EXACT)
        o = ranks[0][job]
        rows[f"336 px fused {kind} (rank 0)"] = dict(
            batch=full_config(336).batch_size, batches=SP_BATCHES,
            param_bytes=o["param_bytes"],
            max_allocated=o["max_allocated"],
            note="gloo transport on one card, no speed result")
    return rows


def cli_dp_rank(rank: int, n: int, port: int, argv, out_dir: str) -> None:
    """One rank of the data-parallel CLI, with the environment torchrun
    gives it."""
    import torch

    from pnp_ovss_tpu_torch.cli import segment
    from pnp_ovss_tpu_torch.ops import _build

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    summary = segment.main(argv)
    torch.save(dict(summary=summary, launches=dict(_build.LAUNCHES),
                    seconds=time.perf_counter() - t0),
               os.path.join(out_dir, f"cli_rank{rank}.pt"))


def cli_dp_check(single: dict, card: str) -> tuple:
    """Phase 8's CLI run: ``cli.segment --distributed --mesh
    --eval_at_bucket --device cuda:0`` on two ranks over phase 6's
    synthetic VOC set (the same seed), against phase 6's single-process
    ``--eval_at_bucket`` run (``single``: its per-image hists): every
    per-image hist equal, both ranks' totals equal to each other and to
    the sum of every per-image hist, both ranks' synchronised averages
    equal. Returns (rank 0's launches, its row of the pipeline line)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pnp_ovss_tpu_torch.parallel.mesh import free_port, spawn

    tmp = tempfile.mkdtemp(prefix="pnp_dp_")
    try:
        data = os.path.join(tmp, "voc")
        write_fake_voc(data, CLI_IMAGES)
        out = os.path.join(tmp, "out")
        argv = ["--data_type", "voc", "--home_dir", data, "--save_path",
                out, "--eval_at_bucket", "--no_resume", "--distributed",
                "--mesh", "--device", "cuda:0"]
        t0 = time.perf_counter()
        spawn(cli_dp_rank, SP, (SP, free_port(), argv, tmp),
              timeout_s=RANKS_TIMEOUT_S)
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"cli_rank{r}.pt"),
                            weights_only=False) for r in range(SP)]
        hists = read_hists(out, f"_bucket{BUCKET}")
        totals = [[np.load(os.path.join(
            out, f"total_hist_{v}_bucket{BUCKET}_rank{r}.npy"))
            for v in ("r0", "agg")] for r in range(SP)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    images = [o["summary"]["images"] for o in ranks]
    if images != [38, 37]:
        raise SystemExit(f"FAIL: DP CLI ranks segmented {images} images, "
                         "want [38, 37] (the sampler's stride)")
    for sub in HIST_DIRS:
        if sorted(hists[sub]) != sorted(single[sub]):
            raise SystemExit(f"FAIL: DP CLI {sub}: other files than the "
                             "single-process run's")
        differ = [k for k, h in hists[sub].items()
                  if not np.array_equal(h, single[sub][k])]
        if differ:
            raise SystemExit(f"FAIL: DP CLI {sub}: {len(differ)} per-image"
                             f" hists differ from the single-process run's"
                             f" ({differ[:3]})")
    for i, sub in enumerate(HIST_DIRS):
        want = sum(hists[sub].values())
        if not all(np.array_equal(t[i], want) for t in totals):
            raise SystemExit(f"FAIL: DP CLI {sub}: a rank's total is not "
                             "the sum of every per-image hist")
    avgs = [o["summary"]["global_avg"] for o in ranks]
    if avgs[0] != avgs[1]:
        raise SystemExit(f"FAIL: DP CLI ranks log other averages {avgs}")
    cfg = full_config(336)
    per_batch = expected_launches(cfg, _VIT_336)
    for r, o in enumerate(ranks):
        n_batches = -(-images[r] // cfg.batch_size)
        want = {k: v * n_batches for k, v in per_batch.items()}
        if o["launches"] != want:
            raise SystemExit(f"FAIL: DP CLI rank {r} launched "
                             f"{o['launches']}, want {want}")
    print(f"  DP CLI, {SP} ranks on one card (gloo): images {images}, "
          f"{CLI_IMAGES} per-image hists a variant equal to the single-"
          f"process run's, both ranks' totals their sum, one synchronised"
          f" average {avgs[0]}; launches rank 0 {ranks[0]['launches']}; "
          f"wall {wall:.1f} s (rank 0 {ranks[0]['seconds']:.1f} s in main;"
          f" gloo on one card, no speed result) on {card}", flush=True)
    return ranks[0]["launches"], dict(
        images=images, wall_s=wall, rank_s=[o["seconds"] for o in ranks],
        note="gloo on one card, no speed result")


def parallel_phase(unsharded: dict, unfused: dict, round0: dict,
                   single_hists: dict, card: str) -> tuple:
    """Phase 8: the narrow TP and PP runs, the full-width TP and PP runs
    (two ranks, one spawn), the data-parallel CLI, and
    ``entry.dryrun_multichip(4)``. Returns ({run: launches}, {run: row of
    the pipeline line})."""
    import torch

    from pnp_ovss_tpu_torch import entry

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(["tp_narrow", "pp_narrow", "tp_full", "pp_full"],
                      "MP_JOBS")
    print(f"  TP and PP ranks: {time.perf_counter() - t0:.1f} s", flush=True)
    launches = narrow_mp_check(ranks)
    rows = full_mp_check(ranks, unsharded, unfused, round0, card)
    for job in ("tp_full", "pp_full"):
        launches[f"336 px fused {job[:2].upper()} (rank 0)"] = \
            ranks[0][job]["launches"]
    launches["DP CLI 336 px (rank 0)"], rows["DP CLI 336 px"] = \
        cli_dp_check(single_hists, card)
    t0 = time.perf_counter()
    entry.dryrun_multichip(4, "cuda", timeout_s=RANKS_TIMEOUT_S)
    rows["dryrun_multichip(4)"] = dict(
        wall_s=time.perf_counter() - t0,
        note="4 ranks on one card through gloo, no speed result")
    print(f"  dryrun_multichip(4): {rows['dryrun_multichip(4)']['wall_s']:.1f}"
          " s (gloo on one card, no speed result)", flush=True)
    return launches, rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from pnp_ovss_tpu_torch.ops import _build

    # IEEE f32 for every f32 matmul and convolution (the CRF's spatial
    # messages, resize, blur and pooling products): no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[1/8] card: {card}", flush=True)

    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"[2/8] built {len(paths)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    from pnp_ovss_tpu_torch.ops import crf_host

    t0 = time.perf_counter()
    crf_host._lib()  # raises with the compiler's output if g++ fails
    print(f"  the host parity path's lattice CRF ({crf_host.library_path()}"
          f") built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "arning")):
                print(f"  {name}: {line.strip()}", flush=True)
    # The flash kernel runs on wgmma, with no mma.sync and no cp.async.
    for name, n in flash_sass_counts(paths).items():
        print(f"  {name} SASS: {n['HGMMA']} HGMMA, {n['HMMA']} HMMA, "
              f"{n['LDGSTS']} LDGSTS", flush=True)
        if n["HGMMA"] == 0 or n["HMMA"] or n["LDGSTS"]:
            raise SystemExit(f"FAIL: {name} is not on wgmma alone: {n}")

    cfg, cfg768 = full_config(336), full_config(LEG_768[0])
    t0 = time.perf_counter()
    print("[3/8] kernels vs plain at the main paths' shapes", flush=True)
    rows = kernels_vs_plain(cfg)
    rows.update(fused_vit_kernels(cfg, cfg768))
    rows["gaussian_kernel_matmul"] = kernel_matmul_check(cfg)
    rows.update(xlen_and_bhsd_kernels(cfg, cfg768))
    # ``ms`` the kernel, ``plain_ms`` its plain version, ``library_ms``
    # one PyTorch call of the same function, ``unfused_ms`` the unfused
    # route, ``bound_ms`` port_bench/counting.py's least time.
    for row in rows.values():
        for sh in row.get("shapes", [row]):
            times = ", ".join(f"{k} {v:.4f}" for k, v in sh.items()
                              if k.endswith("ms") and v is not None)
            print(f"  {row['name']} {sh.get('shape', '')}: {times} (bound "
                  f"by {sh['bound_by']}), {sh['gb_per_s']:.1f} GB/s over "
                  "the bytes its inputs and output take", flush=True)
    print(f"  phase 3: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[4/8] CRF branches and narrow pipelines, card vs CPU", flush=True)
    for args in CRF_BRANCHES:
        crf_branch_check(*args)
    for args in NARROW_RUNS:
        counts = reference_check(*args)
        if "flash_mha" in args[3]:
            k9_counts = counts  # the one run whose path takes K9
    narrow_clip_check()
    sp_narrow_check(run_ranks(["narrow"]))
    print(f"  phase 4: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[5/8] full-width pipelines", flush=True)
    # Launches of each run, in the order the kernels line reads them.
    runs, summaries, launch_runs, round0 = {}, {}, {}, {}
    for name, size, fused, vit_kernels, post in FULL_RUNS:
        run_cfg, runner, inputs = pipeline_setup(image_size=size,
                                                 vit_fused=fused, post=post)
        print(f"  {name}: batch {run_cfg.batch_size}, "
              f"{run_cfg.model.vit.seq_len} tokens", flush=True)
        # phase 8's TP yardstick reads these two runs' round 0
        round0[name], remove = capture_round0(
            runner, name in ("336 px fused", "336 px unfused"))
        try:
            counts, summaries[name] = run_pipeline(
                run_cfg, runner, inputs,
                expected_launches(run_cfg, vit_kernels))
        finally:
            remove()
        launch_runs[name] = counts
        del runner
        torch.cuda.empty_cache()
    print(f"  336 px fused SP: {SP} ranks on one card (gloo)", flush=True)
    ranks = run_ranks(["full", "encode_768"])
    runs["336 px fused SP (rank 0)"] = sp_full_check(
        ranks, summaries["336 px fused"])
    launch_runs["336 px fused SP (rank 0)"] = ranks[0]["full"]["launches"]
    launch_runs["192 px unfused 3 heads (narrow)"] = k9_counts
    print(f"  phase 5: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[6/8] the segmentation CLI", flush=True)
    launch_runs["CLI 336 px"], runs["CLI 336 px"], bucket_hists = \
        cli_phase(card)
    print(f"  phase 6: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[7/8] the parity CLI, the postprocess gate, the search",
          flush=True)
    launches7, rows7 = parity_and_search_phase(card)
    launch_runs.update(launches7)
    runs.update(rows7)
    print(f"  phase 7: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[8/8] data, tensor and pipeline parallelism", flush=True)
    launches8, rows8 = parallel_phase(summaries["336 px fused"],
                                      summaries["336 px unfused"], round0,
                                      bucket_hists, card)
    launch_runs.update(launches8)
    runs.update(rows8)
    print(f"  phase 8: {time.perf_counter() - t0:.1f} s", flush=True)

    # Launches of each kernel in the first run whose path takes it (K4:
    # the 768 px run, K8: the exact CRF run, K7: the SP run, K9: the
    # 3-head narrow run), and in every run.
    for kname, row in rows.items():
        by_run = {r: counts[kname] for r, counts in launch_runs.items()}
        row["launches"] = next((n for n in by_run.values() if n), 0)
        row["launches_by_run"] = by_run
    print(json.dumps({"pipeline": runs | {"card": card}}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
