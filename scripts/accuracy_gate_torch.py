"""Real-checkpoint / real-dataset mIoU gate of the PyTorch/CUDA port (the
port's twin of ``scripts/accuracy_gate.py``).

The repository ships no model weights and no dataset, so this is the
ready-to-run gate for when they are present:

  python scripts/accuracy_gate_torch.py \\
      --checkpoint /path/model_large_retrieval_flickr.pth \\
      --vocab /path/bert-base-uncased-vocab.txt \\
      --home_dir /path/data_root   # VOCdevkit/ + GPT4o_classification/
      --save_path /tmp/gate_out [--limit 200] [--device cpu]

What it does:
 1. parity run: ``pnp_ovss_tpu_torch.cli.segment --postprocess_backend
    host``, per-image blur and the native permutohedral CRF at exact GT
    resolution (the reference's postprocess, script :1002-1074). Its mIoU
    is the anchor.
 2. device runs: the on-card postprocess over ``DEVICE_GRID``, the four
    strided configurations the JAX gate runs (s in 4, 2, 3 at bucket 224
    and s = 4 at bucket 192, the segmentation CLI's default).
 3. the mIoU delta of each against the anchor, PASS/FAIL against a
    one-sided budget (0.3 points by default), all of it written to
    ``gate_results.json`` under ``--save_path``; ``SystemExit`` naming
    the configurations that fail.

Each run is the CLI in a subprocess on ``--device`` (``cuda`` by
default). ``segment_args`` builds a run's arguments apart from
``run_segment``, so a caller can run them another way.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBDIR = "all_drop_hist_with_filtered_caption"

DEVICE_GRID = [
    # (tag, bilateral_mode, subsample, bucket)
    ("strided_s4_b224", "strided", 4, 224),
    ("strided_s2_b224", "strided", 2, 224),
    ("strided_s3_b224", "strided", 3, 224),
    ("strided_s4_b192", "strided", 4, 192),
]


def segment_args(args, out_dir: str, extra) -> list:
    """The segmentation CLI's arguments for one run of the gate."""
    argv = ["--data_type", args.data_type, "--home_dir", args.home_dir,
            "--save_path", out_dir, "--batch_size", str(args.batch_size),
            "--device", args.device]
    if args.checkpoint:
        argv += ["--checkpoint", args.checkpoint]
    if args.vocab:
        argv += ["--vocab", args.vocab]
    if args.limit:
        argv += ["--limit", str(args.limit)]
    return argv + list(extra)


def run_segment(argv) -> None:
    """One CLI run in a subprocess, from the repository's root."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, "-m", "pnp_ovss_tpu_torch.cli.segment"]
                   + list(argv), check=True, env=env, cwd=REPO)


def miou_of(save_path: str, data_type: str) -> float:
    from pnp_ovss_tpu_torch.evalx.aggregate import aggregate

    return aggregate(save_path, data_type)[SUBDIR]["Mean IoU"]


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", default=None,
                   help="LAVIS .pth; omit for a random-weight run of the "
                        "gate's machinery (no accuracy result)")
    p.add_argument("--vocab", default=None)
    p.add_argument("--home_dir", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--data_type", default="voc")
    p.add_argument("--batch_size", type=int, default=35)
    p.add_argument("--limit", type=int, default=None,
                   help="subset size (full VOC val = 1449)")
    p.add_argument("--budget", type=float, default=0.3,
                   help="one-sided budget in mIoU points: fail if "
                        "mIoU(device) < mIoU(parity) - budget")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> dict:
    """Run the gate; returns what it writes to ``gate_results.json``."""
    args = get_args_parser().parse_args(argv)
    if not args.checkpoint:
        print("[gate] WARNING: no --checkpoint, random weights: this "
              "checks the gate's machinery, not accuracy", flush=True)
    sys.path.insert(0, REPO)

    parity_dir = os.path.join(args.save_path, "parity_host")
    run_segment(segment_args(args, parity_dir,
                             ["--postprocess_backend", "host"]))
    anchor = miou_of(parity_dir, args.data_type)
    print(f"[gate] parity (host, exact GT resolution) mIoU = {anchor:.4f}",
          flush=True)

    results = {"parity_host": anchor}
    failures = []
    for tag, mode, sub, bucket in DEVICE_GRID:
        out = os.path.join(args.save_path, tag)
        run_segment(segment_args(args, out, [
            "--bucket_size", str(bucket), "--crf_mode", mode,
            "--crf_subsample", str(sub)]))
        m = miou_of(out, args.data_type)
        delta = (m - anchor) * 100
        results[tag] = m
        ok = delta >= -args.budget
        if not ok:
            failures.append(tag)
        print(f"[gate] {tag}: mIoU {m:.4f}  delta {delta:+.2f} pts  "
              f"{'PASS' if ok else 'FAIL'}", flush=True)

    payload = {"miou": results, "budget_pts": args.budget,
               "failures": failures, "device": args.device}
    with open(os.path.join(args.save_path, "gate_results.json"), "w") as f:
        json.dump(payload, f, indent=2)
    if failures:
        raise SystemExit(f"gate FAILED for: {failures}")
    print("[gate] all device configs within budget", flush=True)
    return payload


if __name__ == "__main__":
    main()
