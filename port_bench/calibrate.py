#!/usr/bin/env python3
"""Readings that the limits of a cell are set from, on the card, in one
process (the benchmark's own runs never run this):

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 3] [--out FILE]

For each seed: one short run of the cell (the system at the cell's own
size and load, judged as a benchmark run judges it), and, for a control
seed, the reference in the system's place one step below each stated
precision, on the same sampled images, judged the same way. Writes one
JSON line a reading (with each image's readings) to ``--out`` and prints
a summary: each number's least and largest reading on each side.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from port_bench import check, harness
    from port_bench.reference.precision import Rounding

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    p = harness.plan(args.workload, __import__("pathlib").Path(ROOT))
    control = Rounding.lower_than(p["precision"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "w") if args.out else None
    rows = []
    for seed in seeds:
        keep = {}
        t = time.perf_counter()
        res = harness.run_cell(p, seed=seed, seconds=args.seconds,
                               trace=False, device=device, t0=t,
                               log=lambda *a: None, keep=keep)
        row = {"seed": seed, "side": "system",
               "numbers": keep["numbers"],
               "img_s": res["metrics"].get("img_s", {}).get("value"),
               "images": keep["details"],
               "seconds": time.perf_counter() - t}
        rows.append(row)
        if seed in ctl:
            t = time.perf_counter()
            idx = [r["pool_index"] for r in keep["records"]]
            recs = check.control_records(
                p["config"], p["pipeline"], keep["pool"], keep["vocab"],
                idx, seed, device, control)
            details = []
            nums = check.judge(p["config"], p["pipeline"], p["precision"],
                               keep["pool"], keep["vocab"], recs, seed,
                               device, details)
            rows.append({"seed": seed, "side": "control", "numbers": nums,
                         "images": details,
                         "seconds": time.perf_counter() - t})
        for r in rows[-2:] if seed in ctl else rows[-1:]:
            line = json.dumps(r)
            if out:
                out.write(line + "\n")
                out.flush()
            print(json.dumps({k: r[k] for k in ("seed", "side", "numbers")}),
                  flush=True)
        torch.cuda.empty_cache()
    for side in ("system", "control"):
        got = [r["numbers"] for r in rows if r["side"] == side]
        if got:
            print(side, json.dumps({k: [min(g[k] for g in got),
                                        max(g[k] for g in got)]
                                    for k in got[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
