#!/usr/bin/env python3
"""What bounds the fused ViT kernels K1 (ln_matmul) and K3 (ln_mlp_residual)
on one GPU: each is rebuilt with one part of its work taken out and timed
at the 336 px main-path shape beside the full kernel.

    python3 scripts/kernel_ablation.py [--out DIR]

Variants (built from the sources in ``pnp_ovss_tpu_torch/csrc`` with a
textual edit, into ``DIR``; their outputs are wrong by design and only
their times are read):

- K1: ``no_ln`` skips the LayerNorm pass, ``no_mma`` replaces the
  tensor-core products by a register update, ``no_w_loads`` stops
  streaming W tiles (the product reads stale shared memory);
- K3: ``no_gelu`` stores the fc1 output without the gelu, ``no_w_loads``
  stops streaming W1 / W2 tiles, ``no_fc2_mma`` drops fc2's products.

Also times cuBLAS on K1's product alone (``F.linear`` on the normalised
rows) as a yardstick. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# The 16816 product replaced by a cheap register update that keeps the
# operands live.
_NO_MMA = ("namespace {", "namespace {\n"
           "__device__ __forceinline__ void no_mma(float (&d)[4], "
           "const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {\n"
           "  d[0] += __uint_as_float(a[0] ^ b0 ^ b1);\n}")

VARIANTS = {
    "ln_matmul": {
        "full": [],
        "no_ln": [("  pnp::layer_norm_rows(xs, ldx, kBM, D, gamma, beta, "
                   "eps, warp,\n                       kThreads / 32, lane);",
                   "")],
        "no_mma": [_NO_MMA, ("pnp::mma_bf16_16816(acc", "no_mma(acc")],
        "no_w_loads": [("    if (it < total)\n      pnp::load_w_tile",
                        "    if (it < 0)\n      pnp::load_w_tile")],
    },
    "ln_mlp_residual": {
        "full": [],
        "no_gelu": [("pnp::pack_bf16x2(gelu_bf16(y0), gelu_bf16(y1))",
                     "pnp::pack_bf16x2(y0, y1)")],
        "no_w_loads": [("c < kBF * D / 8;", "c < 0;"),
                       ("c < D * kBF / 8;", "c < 0;")],
        "no_fc2_mma": [_NO_MMA, ("pnp::mma_bf16_16816(acc[i]",
                                 "no_mma(acc[i]")],
    },
}


def build(out_dir: str):
    """Compile every variant in parallel. Returns {(kernel, variant): lib}."""
    from pnp_ovss_tpu_torch.ops import _build

    procs = {}
    for src, variants in VARIANTS.items():
        text = (_build.CSRC / f"{src}.cu").read_text()
        for name, edits in variants.items():
            s = text
            for old, new in edits:
                if old not in s:
                    raise SystemExit(f"{src}/{name}: edit target not found")
                s = s.replace(old, new)
            cu = os.path.join(out_dir, f"{src}_{name}.cu")
            so = cu[:-3] + ".so"
            with open(cu, "w") as f:
                f.write(s)
            procs[(src, name)] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-o", so, cu], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{key}: nvcc failed\n{log}")
        libs[key] = ctypes.CDLL(so)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/ablation")
    args = ap.parse_args()

    import torch
    from torch.nn import functional as F

    import chip_smoke
    from pnp_ovss_tpu_torch.ops import vit_block

    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    libs = build(args.out)

    cfg = chip_smoke.full_config(336)
    vit = cfg.model.vit
    m, d = cfg.batch_size * vit.seq_len, vit.hidden_size
    n, f = 3 * d, int(d * vit.mlp_ratio)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(torch.bfloat16)

    x = randn(m, d)
    g = torch.ones(d, device=dev)
    b = torch.zeros(d, device=dev)
    w, bias = randn(n, d, scale=d**-0.5), randn(n, scale=0.02)
    w1, b1 = randn(f, d, scale=d**-0.5), randn(f, scale=0.02)
    w2, b2 = randn(d, f, scale=f**-0.5), randn(d, scale=0.02)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    z = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    print(f"336 px main-path shapes: M={m}, D={d}, N={n}, F={f}", flush=True)
    for (src, name), lib in libs.items():
        if src == "ln_matmul":
            fn = lib.ln_matmul_bf16
            fn.argtypes = [P] * 6 + [I] * 3 + [Fl, P]
            call = (lambda fn=fn: fn(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(),
                bias.data_ptr(), y.data_ptr(), m, d, n, 1e-6, stream))
            flops = 2.0 * m * d * n
        else:
            fn = lib.ln_mlp_residual_bf16
            fn.argtypes = [P] * 8 + [I] * 3 + [Fl, P]
            call = (lambda fn=fn: fn(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), z.data_ptr(),
                m, d, f, 1e-6, stream))
            flops = 4.0 * m * d * f
        ms = chip_smoke.time_ms(call, 10)
        print(f"{src} {name}: {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              "TFLOP/s of the full kernel's work)", flush=True)
    h = vit_block.layer_norm_f32(x, g, b, 1e-6).to(torch.bfloat16)
    ms = chip_smoke.time_ms(lambda: F.linear(h, w), 10)
    print(f"cuBLAS F.linear of K1's product alone: {ms:.4f} ms "
          f"({2.0 * m * d * n / ms / 1e9:.1f} TFLOP/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
