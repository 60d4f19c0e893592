"""Offline histogram aggregation — Calculate_mIoU.py drop-in equivalent
(the port's copy of ``pnp_ovss_tpu/evalx/aggregate.py``).

Walks ``{save_path}/hist_withfiltered_caption/`` and/or
``{save_path}/all_drop_hist_with_filtered_caption/`` (the directories the
runner writes, matching the reference layout, script :493-520), sums the
per-image confusion matrices and prints the metric table
(Calculate_mIoU.py:204-256). The .npy files are interchangeable with the
reference's, so either tool can aggregate either pipeline's output.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from pnp_ovss_tpu_torch.data.categories import get_dataset_meta
from pnp_ovss_tpu_torch.evalx.metrics import scores_from_hist

HIST_DIRS = (
    "hist_withfiltered_caption",
    "all_drop_hist_with_filtered_caption",
)


def sum_hist_dir(path: str) -> Optional[np.ndarray]:
    if not os.path.isdir(path):
        return None
    total = None
    for name in sorted(os.listdir(path)):
        if not name.endswith(".npy"):
            continue
        h = np.load(os.path.join(path, name))
        total = h if total is None else total + h
    return total


def aggregate(save_path: str, data_type: str) -> Dict[str, Dict]:
    meta = get_dataset_meta(data_type)
    results: Dict[str, Dict] = {}
    for sub in HIST_DIRS:
        hist = sum_hist_dir(os.path.join(save_path, sub))
        if hist is None:
            continue
        results[sub] = scores_from_hist(hist, meta.metric_class_names())
    return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--save_path", required=True)
    p.add_argument("--data_type", required=True)
    args = p.parse_args(argv)

    results = aggregate(args.save_path, args.data_type)
    if not results:
        print(f"no histogram directories found under {args.save_path}")
        return
    for sub, table in results.items():
        print(f"== {sub} ==")
        for k, v in table.items():
            if k == "Class IoU":
                continue
            print(f"  {k}: {v:.4f}")
        print("  Class IoU:", {
            k: round(float(v), 4)
            for k, v in table["Class IoU"].items()
            if np.isfinite(v)
        })


if __name__ == "__main__":
    main()
