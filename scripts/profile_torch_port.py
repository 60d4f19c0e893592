#!/usr/bin/env python3
"""Where the device time of the PyTorch/CUDA port goes, on one GPU.

    python3 scripts/profile_torch_port.py [--run "336 px fused"]
        [--batches 2] [--out DIR]

Runs one of chip_smoke.py's phase-5 pipelines of ``pnp_ovss_tpu_torch``
as it builds them (``chip_smoke.pipeline_setup``: BLIP-ITM-Large with
seeded random weights, 4 drop rounds, bucket 192, blur + 10-iteration
CRF; by default the reference default, 336 px, batch 35, fused ViT; also
"768 px fused", batch 12, "336 px unfused" and "336 px fused exact CRF",
the reference default with the exact CRF through K8) once to warm up, then
``--batches`` double-buffered batches without and then with
``torch.profiler`` tracing the device's kernels only (no host-side op
recording, which slows the host's dispatch). Prints the card, the wall
time per batch of both windows, the device's busy time (the union of
kernel intervals) and idle share of the traced window, the tracing's cost in wall time, and the
kernels that take the most device time. The full table is written to
``DIR/profile_torch_port_<run>.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def busy_us(events) -> float:
    """Union length of device kernel intervals (microseconds)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="336 px fused",
                    help="a run of chip_smoke.FULL_RUNS, by name")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {r[0]: r for r in chip_smoke.FULL_RUNS}
    if args.run not in runs:
        raise SystemExit(f"profile_torch_port: --run must be one of "
                         f"{sorted(runs)}")
    _, size, fused, _, post = runs[args.run]
    card = chip_smoke.card_line()
    cfg, runner, inputs = chip_smoke.pipeline_setup(image_size=size,
                                                    vit_fused=fused,
                                                    post=post)
    images, cap, rgb, gt = inputs
    runner.run_batch(images, cap, rgb, gt_sizes=gt)
    torch.cuda.synchronize()

    _, wall_plain = chip_smoke.timed_batches(runner, inputs, args.batches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = chip_smoke.timed_batches(runner, inputs, args.batches)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us(kernels) / 1e6
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    total_dev = sum(us for _, us in by_name.values()) or 1.0
    os.makedirs(args.out, exist_ok=True)
    slug = args.run.replace(" ", "_")
    with open(os.path.join(args.out, f"profile_torch_port_{slug}.txt"),
              "w") as f:
        f.write(card + "\n")
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    print(card)
    if busy <= 0.0:
        raise SystemExit("profile_torch_port: the trace holds no kernels")
    # Busy and wall time of the one traced window; the untraced window
    # says what the tracing cost.
    print(json.dumps({
        "run": args.run, "batches": args.batches,
        "batch_size": cfg.batch_size,
        "wall_s_per_batch": wall_plain / args.batches,
        "img_per_s": cfg.batch_size * args.batches / wall_plain,
        "traced_wall_s_per_batch": wall / args.batches,
        "traced_img_per_s": cfg.batch_size * args.batches / wall,
        "tracing_wall_cost": wall / wall_plain - 1.0,
        "device_busy_s_per_batch": busy / args.batches,
        "device_idle_share": 1.0 - busy / wall,
    }))
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    for name, (n, us) in top[:25]:
        print(json.dumps({
            "kernel": name[:90], "launches_per_batch": n / args.batches,
            "device_ms_per_batch": us / 1e3 / args.batches,
            "share_of_kernel_time": us / total_dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
