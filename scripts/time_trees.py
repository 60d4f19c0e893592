#!/usr/bin/env python3
"""Time the port's kernels in two checkouts on one card, in turns:

    python3 scripts/time_trees.py [--tree DIR] [--only k8,flash,crf]
        [--iters 20] [--images 5]

Each run is a child process with DIR (or this checkout) first on
``sys.path``, so that it runs that tree's ``pnp_ovss_tpu_torch`` and builds
its kernels into that tree's ``build/cuda``; inputs are seeded draws of
this checkout's ``chip_smoke.py``, bounds this checkout's
``port_bench/counting.py``'s. With ``--tree`` the runs are DIR, this,
this, DIR. Prints the card's name and power limit, then each measurement
with every tree's mean and runs, this / tree, and for the flash kernel
the largest difference between the trees' outputs.

- ``k8``: K8 at chip_smoke.py's five shapes (the exact CRF's message at
  C = 58 and 12 and its degree, both Nystrom products) through
  ``gaussian_kernel_matmul``, which packs the features every call
  (``one_shot_ms``), and through the closure
  of ``kernel_matmul_fn`` as the CRF calls it (``closure_ms``); then the
  closure on the first 4 and 8 slots of each variant of the exact CRF's
  2 x 29-slot state (C = 8, 16; strided [M, G, A] values) and its wgmma
  ``width``.
- ``flash``: the port's flash entries at the eight main-path shapes (K2 at
  336 px and at the CLIP scorer's [8, 577], K2' on a TP rank's 8 heads,
  K7 at Sq = 221 and 1153 over the gathered keys, K9 at [12, 16, 2305, 64]
  and [12, 8, 2305, 128], K2's entry on K4's 768 px qkv), then K4's whole
  entry (attention + proj); ``sdpa_ms`` for SDPA on the same heads, the
  least time ``bound_ms`` and what sets it.
- ``crf``: one image's fused CRF at the 336 px cell's shapes (two variants
  of 29 slots, 5 live; bf16 logits, bucket 192, a 500 x 375 ground truth),
  called as the runner calls it: its device operations in order with
  their us, ``host_ms`` a call over ``--images`` back-to-back calls
  (unblocked: the launch queue holds them), ``device_ms`` a call by the
  profiler and its split by kernel.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def k8(args):
    """The ``k8`` records of the tree first on ``sys.path``."""
    import torch

    import chip_smoke
    from pnp_ovss_tpu_torch.ops import bilateral

    cfg = chip_smoke.full_config(336)
    gen = torch.Generator(device="cuda").manual_seed(2)
    support = chip_smoke.k8_support(cfg, gen)
    for label, side_i, side_j, c, signed, _ in chip_smoke.K8_SHAPES:
        fi, fj = support[side_i], support[side_j]
        vals = chip_smoke.k8_values(fj.shape[0], c, signed, gen)
        fj_arg = None if side_i == side_j else fj
        fn = bilateral.kernel_matmul_fn(fi, fj_arg)
        yield dict(label=f"{label} N={fi.shape[0]} M={fj.shape[0]}",
                   one_shot_ms=chip_smoke.time_ms(
                       lambda: bilateral.gaussian_kernel_matmul(
                           fi, vals, fj_arg), args.iters),
                   closure_ms=chip_smoke.time_ms(lambda: fn(vals),
                                                 args.iters))
    pixels = support["pixels"]
    m = pixels.shape[0]
    state = chip_smoke.k8_values(m, 58, False, gen).t().reshape(2, 29, m)
    fn = bilateral.kernel_matmul_fn(pixels)
    for a in (4, 8):
        rows = state[:, :a].movedim(-1, 0)  # [M, 2, a], strided
        ms = chip_smoke.time_ms(lambda: fn(rows), args.iters)
        yield dict(label=f"exact C={2 * a} of 58 N={m} M={m}",
                   closure_ms=ms, width=fn.bufs[2 * a].width)


def flash(args):
    """The ``flash`` records of the tree first on ``sys.path``; each
    output is saved under ``args.out`` for the comparison of trees."""
    import torch
    from torch.nn import functional as F

    import chip_smoke
    from pnp_ovss_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(torch.bfloat16)

    def sdpa(q, k, v, d):  # on [B, S, n * d] as [B, n, S, d] views
        qh, kh, vh = (t.unflatten(-1, (-1, d)).transpose(1, 2)
                      for t in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qh, kh, vh)

    cfg = chip_smoke.full_config(336)
    vit = cfg.model.vit
    b, s, h, d = cfg.batch_size, vit.seq_len, vit.num_heads, vit.head_dim
    hd = h * d
    s768 = chip_smoke.full_config(768).model.vit.seq_len

    def cols(qkv, lo=0, w=hd):  # q, k, v: column views of one qkv array
        return [qkv[..., i * hd + lo:i * hd + lo + w] for i in range(3)]

    # Each case: (label, call, SDPA on the same heads, (bound ms, by)).
    def k2(label, qkv):
        bb, ss = qkv.shape[:2]
        return (label, lambda: fa.flash_mha_flat_qkv(qkv, num_heads=h),
                sdpa(*cols(qkv), d),
                chip_smoke.flash_least_ms(bb, h, ss, ss, d))

    def k7(px, bb, ss):  # rank 0's query rows over the gathered keys
        chunk = -(-ss // chip_smoke.SP)
        qkv = randn(bb, chunk * chip_smoke.SP, 3 * hd)
        kv = qkv[..., hd:].contiguous()
        q = qkv[:, :chunk].contiguous()[..., :hd]
        k, v = kv[..., :hd], kv[..., hd:]
        return (f"K7 {px} px Sq={chunk}",
                lambda: fa.flash_mha_flat_xlen(q, k, v, num_heads=h,
                                               true_kv_len=ss),
                sdpa(q, k[:, :ss], v[:, :ss], d),
                chip_smoke.flash_least_ms(bb, h, chunk, ss, d))

    def k9(hh, dd):  # [B, H, S, D] views of one array
        q, k, v = randn(12, s768, 3, hh, dd).permute(2, 0, 3, 1, 4)
        return (f"K9 [12, {hh}, {s768}, {dd}]", lambda: fa.flash_mha(q, k, v),
                lambda: F.scaled_dot_product_attention(q, k, v),
                chip_smoke.flash_least_ms(12, hh, s768, s768, dd))

    qkv336 = randn(b, s, 3 * hd)
    tp = cols(qkv336, hd // 2, hd // 2)  # a TP rank's 8 heads
    cases = [k2(f"K2 336 px [{b}, {s}, {3 * hd}]", qkv336),
             k2(f"K2 CLIP [8, 577, {3 * hd}]", randn(8, 577, 3 * hd)),
             (f"K2' TP rank [{b}, {s}, {h // 2} of {h} heads]",
              lambda: fa.flash_mha_flat(*tp, num_heads=h // 2),
              sdpa(*tp, d), chip_smoke.flash_least_ms(b, h // 2, s, s, d)),
             k7(336, b, s), k7(768, 12, s768), k9(h, d),
             k9(hd // 128, 128)]
    qkv768 = randn(12, s768, 3 * hd)
    cases.append(k2(f"K4 attention 768 px [12, {s768}, {3 * hd}]", qkv768))
    # K4's whole entry at 768 px: attention + proj + residual.
    x = randn(12, s768, hd, scale=0.1)
    wp, bp = randn(hd, hd, scale=hd**-0.5), randn(hd, scale=0.02)
    attn = sdpa(*cols(qkv768), d)
    cases.append((
        f"K4 entry 768 px [12, {s768}, {3 * hd}] + proj {hd}",
        lambda: fa.flash_mha_qkv_proj(qkv768, x, wp, bp, num_heads=h),
        lambda: x + F.linear(attn().transpose(1, 2).flatten(2), wp, bp),
        chip_smoke.flash_least_ms(
            12, h, s768, s768, d,
            nbytes=2 * (qkv768.numel() + 2 * x.numel() + wp.numel() + hd),
            products=2.0 * 12 * s768 * hd * hd)))

    for i, (label, call, library, (bms, by)) in enumerate(cases):
        saved = os.path.join(args.out, f"flash{i}.pt")
        torch.save(call().cpu(), saved)
        yield dict(label=label, ms=chip_smoke.time_ms(call, args.iters),
                   sdpa_ms=chip_smoke.time_ms(library, args.iters),
                   bound_ms=bms, bound_by=by, saved=saved)


def crf(args):
    """The ``crf`` record of the tree first on ``sys.path``."""
    import numpy as np
    import torch

    import chip_smoke
    from pnp_ovss_tpu_torch.config import CRFConfig
    from pnp_ovss_tpu_torch.ops import crf as crf_ops

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    hb, c = chip_smoke.BUCKET, 29
    gt_h, gt_w = 375, 500
    logits = torch.from_numpy(rng.randn(2, c, hb, hb).astype(np.float32))
    logits[:, 5:] = -1e30
    logits = logits.to(dev).to(torch.bfloat16)
    image = torch.from_numpy(rng.randint(0, 256, (hb, hb, 3)).astype(
        np.uint8)).to(dev)
    xy = torch.tensor([hb / gt_w, hb / gt_h], device=dev)
    valid = np.array([True] * 5 + [False] * (c - 5))

    def call():
        return crf_ops.mean_field_crf_variants(
            logits, image.float(), CRFConfig(), xy_scale=xy,
            channel_valid=valid)

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.images):
        call()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.images
    torch.cuda.synchronize()

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(args.images):
            call()
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    split = collections.Counter()
    for e in ops:
        split[e.name[:60]] += e.device_time_total / 1e3 / args.images
    ops = ops[:len(ops) // args.images]  # every call runs the same ops
    yield dict(label="one image's fused CRF, 336 px cell",
               device_ops=len(ops),
               op_names=collections.Counter(e.name[:60] for e in ops),
               ops_in_order=[(e.name[:60], round(e.device_time_total, 2))
                             for e in ops],
               host_ms=host_ms, device_ms=sum(split.values()),
               device_split_ms=dict(split.most_common()))


MEASURES = {"k8": k8, "flash": flash, "crf": crf}
# The fields that time a tree's own code, compared as this / tree.
TREE_TIMES = ("ms", "one_shot_ms", "closure_ms", "host_ms", "device_ms")


def child(args) -> int:
    # This checkout's inputs and roofline, imported before the tree's
    # package takes the front of the path.
    sys.path.insert(0, HERE)
    import chip_smoke  # noqa: F401
    import port_bench.counting  # noqa: F401

    sys.path.insert(0, args.child)
    import torch

    if not torch.cuda.is_available():
        print("time_trees: no CUDA device", file=sys.stderr)
        return 1
    for kind in args.only.split(","):
        for record in MEASURES[kind](args):
            print(json.dumps(dict(kind=kind, **record)), flush=True)
    return 0


def fmt(values) -> str:
    """A field's values over a tree's runs: times as the mean, then each
    run's; anything else as the first run gave it."""
    if not isinstance(values[0], float):
        return json.dumps(values[0])
    return (f"{sum(values) / len(values):.4f} "
            f"({' / '.join(f'{v:.4f}' for v in values)})")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None,
                    help="another checkout, timed beside this one")
    ap.add_argument("--only", default=",".join(MEASURES),
                    help=f"comma-separated, of {','.join(MEASURES)}")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--images", type=int, default=5)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not set(args.only.split(",")) <= set(MEASURES):
        raise SystemExit(f"time_trees: --only takes {','.join(MEASURES)}")
    if args.child:
        return child(args)

    sys.path.insert(0, HERE)
    import chip_smoke

    print(chip_smoke.card_line(), flush=True)
    trees = {"this": HERE}
    order = ["this"]
    if args.tree:
        trees = {"tree": os.path.abspath(args.tree), "this": HERE}
        order = ["tree", "this", "this", "tree"]
    print(" and ".join(f"{tag} = {path}" for tag, path in trees.items())
          + f", in turns {order}", flush=True)
    # {(kind, label): {tree: [record of each run]}}
    runs = collections.defaultdict(lambda: collections.defaultdict(list))
    with tempfile.TemporaryDirectory() as tmp:
        for i, tag in enumerate(order):
            out = os.path.join(tmp, str(i))
            os.makedirs(out)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 trees[tag], "--out", out, "--only", args.only, "--iters",
                 str(args.iters), "--images", str(args.images)],
                capture_output=True, text=True, timeout=1800)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-8000:],
                      file=sys.stderr)
                raise SystemExit(f"time_trees: {tag} run {i} failed "
                                 f"({proc.returncode})")
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    rec = json.loads(line)
                    runs[rec.pop("kind"), rec.pop("label")][tag].append(rec)
        for (kind, label), by_tree in runs.items():
            print(f"{kind} {label}:", flush=True)
            for field in by_tree[order[0]][0]:
                if field == "saved":
                    continue
                values = {tag: [r[field] for r in recs]
                          for tag, recs in by_tree.items()}
                if field in ("bound_ms", "bound_by"):  # this checkout's
                    print(f"  {field}: {values['this'][0]}", flush=True)
                    continue
                for tag, v in values.items():
                    print(f"  {field} {tag}: {fmt(v)}", flush=True)
                if field not in TREE_TIMES or len(values) < 2:
                    continue
                mean = {tag: sum(v) / len(v) for tag, v in values.items()}
                if mean["tree"] > 0:
                    print(f"  {field} this / tree "
                          f"{mean['this'] / mean['tree']:.3f}", flush=True)
            if kind == "flash" and len(by_tree) == 2:
                import torch

                a, b = (torch.load(by_tree[tag][0]["saved"])
                        for tag in ("this", "tree"))
                same = " (bit-equal)" if torch.equal(a, b) else ""
                print(f"  max |this - tree| "
                      f"{(a.float() - b.float()).abs().max().item():.3g}"
                      f"{same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
