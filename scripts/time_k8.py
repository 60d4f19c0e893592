#!/usr/bin/env python3
"""K8's time a launch through both of its entries at chip_smoke.py's four
shapes (the exact CRF's message and degree, both Nystrom products):
``gaussian_kernel_matmul``, which packs the features on every call, and
the closure of ``kernel_matmul_fn``, which packs them once per image, as
the CRF calls it. Then the closure on the exact CRF's message over the
first 4 and 8 slots of each variant of the 2 x 29-slot state (C = 8 and
16), read through the strided view the CRF hands it, with the wgmma width
it ran at. ``--tree`` times another checkout's package on the same inputs,
so that two trees are compared in one call, in turns:

    python3 scripts/time_k8.py [--tree DIR] [--iters 10]

The inputs are phase 3's (this checkout's ``chip_smoke.py``, seeded); the
kernels of DIR build under DIR/build/cuda. Prints the card's name and
power limit, then one line per shape. DIR's K8 has to take [M, G, A]
values.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE,
                    help="checkout whose pnp_ovss_tpu_torch is timed "
                    "(default this one)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke  # imports no package of the repo at module level

    # Every later import of the port resolves to DIR's package.
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    from pnp_ovss_tpu_torch.ops import bilateral

    if not torch.cuda.is_available():
        print("time_k8: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    print(f"timing {bilateral.__file__}", flush=True)
    cfg = chip_smoke.full_config(336)
    gen = torch.Generator(device="cuda").manual_seed(2)
    support = chip_smoke.k8_support(cfg, gen)
    for label, side_i, side_j, c, signed, _ in chip_smoke.K8_SHAPES:
        fi, fj = support[side_i], support[side_j]
        vals = chip_smoke.k8_values(fj.shape[0], c, signed, gen)
        fj_arg = None if side_i == side_j else fj
        fn = bilateral.kernel_matmul_fn(fi, fj_arg)
        one_shot = chip_smoke.time_ms(
            lambda: bilateral.gaussian_kernel_matmul(fi, vals, fj_arg),
            args.iters)
        closure = chip_smoke.time_ms(lambda: fn(vals), args.iters)
        print(f"{label} N={fi.shape[0]} M={fj.shape[0]}: one-shot "
              f"{one_shot:.4f} ms, closure {closure:.4f} ms", flush=True)
    pixels = support["pixels"]
    m = pixels.shape[0]
    state = chip_smoke.k8_values(m, 58, False, gen).t().reshape(2, 29, m)
    fn = bilateral.kernel_matmul_fn(pixels)
    for a in (4, 8):
        rows = state[:, :a].movedim(-1, 0)  # [M, 2, a], strided
        closure = chip_smoke.time_ms(lambda: fn(rows), args.iters)
        print(f"exact C={2 * a} of 58 (width {fn.bufs[2 * a].width}) "
              f"N={m} M={m}: closure {closure:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
