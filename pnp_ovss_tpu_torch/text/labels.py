"""GPT-4o class-proposal cache parsing (the port's copy of
``pnp_ovss_tpu/text/labels.py``).

Reference: Load_predicted_classes (script :726-787). The GPT-4o labeler
(gpt_rewrite_label.py) caches raw model text per image id; at segmentation
time it is parsed as ``[id: 'name', ...], [id: prob%, ...]`` and classes
with prob > 70 are kept (:764-767); 1-indexed ids map into the dataset's
``nms`` table (:773-777); an empty result falls back to class 0 (:779-781).

Robustness divergence (documented): malformed entries that would crash the
reference's bare int() casts are skipped here.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple


def _normalise(raw: str) -> List[str]:
    """The reference's chain of replace() calls collapsing the two lists."""
    s = (
        raw.replace("]\n\n[", "], [")
        .replace("],\n\n[", "], [")
        .replace("], \n[", "], [ ")
        .replace("]\n[", "], [ ")
        .replace("],\n[", "], [ ")
    )
    return s.strip("][").split("], [")


def parse_gpt_classes(
    raw: str, num_dataset_classes: int, *, prob_cutoff: int = 70
) -> List[int]:
    """Raw GPT text -> 0-indexed class ids with prob > cutoff.

    Falls back to [0] when nothing parses (reference :779-781).
    """
    parts = _normalise(raw)
    picked: List[int] = []
    if len(parts) >= 2 and parts[0].strip():
        cls_entries = parts[0].split(",")
        prob_entries = parts[1].split(",")
        for ce, pe in zip(cls_entries, prob_entries):
            try:
                idx = int(ce.split(":")[0].strip())
                prob = int(pe.split(":")[-1].split("%")[0].strip())
            except (ValueError, IndexError):
                continue
            if prob > prob_cutoff and 1 <= idx <= num_dataset_classes:
                zero_idx = idx - 1
                if zero_idx not in picked:
                    picked.append(zero_idx)
    if not picked:
        picked = [0]
    return picked


class GPTLabelProvider:
    """Loads a GPT4o_classification/*.json cache and serves class lists."""

    def __init__(self, path: str, nms: Sequence[str], *, prob_cutoff: int = 70):
        with open(path, encoding="utf-8") as f:
            self.cache: Dict[str, str] = json.load(f)
        self.nms = list(nms)
        self.prob_cutoff = prob_cutoff

    def lookup(self, img_key: str) -> Tuple[List[int], List[str]]:
        raw = self.cache[img_key]
        idxs = parse_gpt_classes(
            raw, len(self.nms), prob_cutoff=self.prob_cutoff
        )
        return idxs, [self.nms[i] for i in idxs]
