#!/usr/bin/env python3
"""One image's fused CRF (the default materialised strided CRF) on the
card at the 336 px cell's shapes: two variants of 29 slots (background
and 4 classes live, 24 disabled at the runner's value), bf16 logits,
bucket 192, a 500 x 375 ground truth, called as the runner calls it
(the image's cast included). ``--tree`` runs another checkout's package
on the same inputs, so that two trees are compared in one call, each in
its own process, in turns:

    python3 scripts/time_crf.py [--tree DIR] [--images 5]

Prints the card's name and power limit, then one JSON line: the device
operations of one call (kernels, copies and fills, by the profiler), by
name and in order with their us; the host ms a call over ``--images``
back-to-back calls after a synchronisation (unblocked: the launch queue
holds them); the device ms a call (the profiler's kernel times, summed)
and its split by kernel name. The kernels of DIR build under DIR/build/cuda.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE,
                    help="checkout whose pnp_ovss_tpu_torch is run "
                    "(default this one)")
    ap.add_argument("--images", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke  # imports no package of the repo at module level

    # Every later import of the port resolves to DIR's package.
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    from pnp_ovss_tpu_torch.config import CRFConfig
    from pnp_ovss_tpu_torch.ops import crf

    if not torch.cuda.is_available():
        print("time_crf: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    print(f"running {crf.__file__}", flush=True)
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
        return crf.mean_field_crf_variants(
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

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.images):
            call()
        torch.cuda.synchronize()
    split = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            split[e.name[:60]] += e.device_time_total / 1e3 / args.images
    print(json.dumps(dict(
        tree=os.path.abspath(args.tree), device_ops=len(ops),
        op_names=collections.Counter(e.name[:60] for e in ops),
        ops_in_order=[(e.name[:60], round(e.device_time_total, 2))
                      for e in ops],
        host_ms=host_ms, device_ms=sum(split.values()),
        device_split_ms=dict(split.most_common()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
