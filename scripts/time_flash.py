#!/usr/bin/env python3
"""The flash kernel's time a launch through its C entries at the eight
main-path shapes: K2 at 336 px (BLIP, [35, 442, 3072]) and at the CLIP
scorer's [8, 577, 3072], K2' (a TP rank's 8 heads of the 336 px qkv), K7
at Sq = 221 (336 px) and Sq = 1153 (768 px) over the gathered keys, K9 at
[12, 16, 2305, 64] and [12, 8, 2305, 128], and K4's attention at 768 px
(K2's entry on the [12, 2305, 3072] qkv, as K4 launches it); then K4's
whole entry (attention + proj) at 768 px. ``--tree`` builds another
checkout's kernels as well (its ``_build.build_all``, into DIR/build/cuda)
and times both on the same inputs, in turns (DIR, this, this, DIR), so
that two trees are compared in one call:

    python3 scripts/time_flash.py [--tree DIR] [--iters 20]

The entries' C signatures are the same in both trees. Inputs are drawn as
chip_smoke.py's phase 3 draws them (standard normal bf16, seeded). Prints
the card's name and power limit, then one line per shape with each
tree's time, SDPA's on the same heads and the bound (chip_smoke.py's
``flash_bound_ms``: bytes, products and one expf a score).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_tree(tree: str) -> dict:
    """{source: library path} of ``tree``'s kernels, built by its own
    ``_build`` in a child process."""
    code = ("import json, sys; sys.path.insert(0, '.'); "
            "from pnp_ovss_tpu_torch.ops import _build; "
            "print(json.dumps({k: str(v) for k, v in "
            "_build.build_all().items()}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, check=True,
                         timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


def load(paths: dict, sources: dict) -> dict:
    libs = {}
    for name in ("flash_attention", "flash_qkv_proj"):
        lib = ctypes.CDLL(paths[name])
        for fn, argtypes in sources[name].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None,
                    help="another checkout whose flash kernel is timed "
                    "beside this one's")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    from torch.nn import functional as F

    import chip_smoke
    from pnp_ovss_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    trees = {"this": load({k: str(v) for k, v in _build.build_all().items()},
                          _build.SOURCES)}
    if args.tree:
        trees = {"tree": load(build_tree(os.path.abspath(args.tree)),
                              _build.SOURCES), **trees}
        print(f"timing {os.path.abspath(args.tree)} (tree) and {HERE} "
              "(this), in turns", flush=True)
    order = (["tree", "this", "this", "tree"] if args.tree else ["this"])

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(torch.bfloat16)

    cases = []

    def flat(label, qkv, h, lo_head=0, n_heads=None):
        """K2 / K2' on the column views of one qkv array (heads
        lo_head .. lo_head + n_heads)."""
        b, s, hd3 = qkv.shape
        hd, d = hd3 // 3, hd3 // 3 // h
        n = n_heads or h
        w = n * d
        views = [qkv[..., i * hd + lo_head * d:i * hd + lo_head * d + w]
                 for i in range(3)]
        out = torch.empty((b, s, w), dtype=torch.bfloat16, device=dev)
        rs, bs = 3 * hd, s * 3 * hd

        def call(libs):
            return libs["flash_attention"].flash_mha_flat_bf16(
                *(t.data_ptr() for t in views), out.data_ptr(), bs, rs, bs,
                rs, bs, rs, s * w, w, b, s, s, n, d, d**-0.5, stream)

        qh, kh, vh = (t.unflatten(-1, (n, d)).transpose(1, 2) for t in views)
        nbytes = 4 * b * s * w * 2 if n_heads else (qkv.numel() +
                                                     b * s * hd) * 2
        cases.append((label, call, out,
                      lambda: F.scaled_dot_product_attention(qh, kh, vh),
                      chip_smoke.flash_bound_ms(nbytes, b, n, s, s, d)[0]))

    def xlen(label, b, s, h, d):
        chunk = -(-s // chip_smoke.SP)
        hd = h * d
        qkv = randn(b, chunk * chip_smoke.SP, 3 * hd)
        kv = qkv[..., hd:].contiguous()
        k, v = kv[..., :hd], kv[..., hd:]
        q = qkv[:, :chunk].contiguous()[..., :hd]
        out = torch.empty((b, chunk, hd), dtype=torch.bfloat16, device=dev)

        def call(libs):
            return libs["flash_attention"].flash_mha_xlen_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), chunk * hd, hd, b, chunk,
                chunk * chip_smoke.SP, s, h, d, d**-0.5, stream)

        qh = q.unflatten(-1, (h, d)).transpose(1, 2)
        kh, vh = (t[:, :s].unflatten(-1, (h, d)).transpose(1, 2)
                  for t in (k, v))
        nbytes = 2 * (2 * b * chunk * hd + 2 * b * s * hd)
        cases.append((label, call, out,
                      lambda: F.scaled_dot_product_attention(qh, kh, vh),
                      chip_smoke.flash_bound_ms(nbytes, b, h, chunk, s,
                                                d)[0]))

    def bhsd(label, b, h, s, d):
        qkv = randn(b, s, 3, h, d)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = torch.empty((b, h, s, d), dtype=torch.bfloat16, device=dev)

        def call(libs):
            return libs["flash_attention"].flash_mha_bhsd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *[st for t in (q, k, v, out) for st in t.stride()[:3]],
                b, h, s, d, d**-0.5, stream)

        cases.append((label, call, out,
                      lambda: F.scaled_dot_product_attention(q, k, v),
                      chip_smoke.flash_bound_ms(8 * b * h * s * d, b, h, s,
                                                s, d)[0]))

    cfg = chip_smoke.full_config(336)
    vit = cfg.model.vit
    b, s, h, d = cfg.batch_size, vit.seq_len, vit.num_heads, vit.head_dim
    qkv336 = randn(b, s, 3 * h * d)
    flat(f"K2 336 px [{b}, {s}, {3 * h * d}]", qkv336, h)
    flat(f"K2 CLIP [8, 577, {3 * h * d}]", randn(8, 577, 3 * h * d), h)
    flat(f"K2' TP rank [{b}, {s}, 8 of {h} heads]", qkv336, h, h // 2,
         h // 2)
    s768 = chip_smoke.full_config(768).model.vit.seq_len
    xlen(f"K7 336 px Sq={-(-s // 2)}", b, s, h, d)
    xlen(f"K7 768 px Sq={-(-s768 // 2)}", 12, s768, h, d)
    bhsd(f"K9 [12, {h}, {s768}, {d}]", 12, h, s768, d)
    bhsd(f"K9 [12, {h * d // 128}, {s768}, 128]", 12, h * d // 128, s768,
         128)
    qkv768 = randn(12, s768, 3 * h * d)
    flat(f"K4 attention 768 px [12, {s768}, {3 * h * d}]", qkv768, h)

    # K4's whole entry at 768 px: attention + proj + residual.
    dm = h * d
    x = randn(12, s768, dm, scale=0.1)
    wp, bp = randn(dm, dm, scale=dm**-0.5), randn(dm, scale=0.02)
    attn = torch.empty((12, s768, dm), dtype=torch.bfloat16, device=dev)
    y = torch.empty_like(x)

    def k4(libs):
        return libs["flash_qkv_proj"].flash_mha_qkv_proj_bf16(
            qkv768.data_ptr(), x.data_ptr(), wp.data_ptr(), bp.data_ptr(),
            attn.data_ptr(), y.data_ptr(), 12, s768, s768, h, d, dm,
            d**-0.5, stream)

    qh, kh, vh = (qkv768[..., i * dm:(i + 1) * dm].unflatten(-1, (h, d))
                  .transpose(1, 2) for i in range(3))
    cases.append((
        f"K4 entry 768 px [12, {s768}, {3 * dm}] + proj {dm}", k4, y,
        lambda: x + F.linear(F.scaled_dot_product_attention(qh, kh, vh)
                             .transpose(1, 2).reshape(12, s768, dm), wp, bp),
        chip_smoke.flash_bound_ms(
            2 * (qkv768.numel() + 2 * x.numel() + wp.numel() + dm), 12, h,
            s768, s768, d, more_flops=2.0 * 12 * s768 * dm * dm)[0]))

    for label, call, out, sdpa, bms in cases:
        results = {}
        for name in trees:
            rc = call(trees[name])
            if rc != 0:
                raise SystemExit(f"{label}: {name} launch failed ({rc})")
            torch.cuda.synchronize()
            results[name] = out.clone()
        times = {name: [] for name in trees}
        for name in order:
            times[name].append(chip_smoke.time_ms(
                lambda name=name: call(trees[name]), args.iters))
        line = ", ".join(f"{name} {sum(t) / len(t):.4f} ms "
                         f"({' / '.join(f'{x:.4f}' for x in t)})"
                         for name, t in times.items())
        if args.tree:
            diff = (results["this"].float() - results["tree"].float()) \
                .abs().max().item()
            mean = {n: sum(t) / len(t) for n, t in times.items()}
            same = torch.equal(results["this"], results["tree"])
            line += (f"; this / tree {mean['this'] / mean['tree']:.3f}, "
                     f"max |this - tree| {diff:.3g}"
                     f"{' (bit-equal)' if same else ''}")
        sdpa_ms = chip_smoke.time_ms(sdpa, args.iters)
        print(f"{label}: {line}; SDPA {sdpa_ms:.4f} ms; bound {bms:.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
