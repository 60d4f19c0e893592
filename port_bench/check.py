"""What decides ``correct``: the plain reference judges what the timed
path produced for the sampled images, and each number is held against
its limit (``limits/<cell>.json``).

The reference runs once the window has closed and the system's state is
freed, one image at a time: it draws the weights again from the seed,
builds the captions, pooling matrices and drop masks itself, and follows
the system's own drop state round by round (``reference.segment.
judge_image``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import traffic as traffic_mod
from port_bench import weights
from port_bench.reference import segment as ref
from port_bench.reference.blip_itm import BlipItm
from port_bench.reference.precision import EXACT, Rounding

NUMBERS = ("encode_rel_err", "gradcam_err_ratio", "maps_rel_err",
           "blur_rel_err", "crf_err_ratio")
# A threshold decision whose normalised value lies this close to the
# threshold may go either way: float32 against float64 rounding.
THRESHOLD_BAND = 1e-5


def _inputs(pool: traffic_mod.Pool, idx: int, vocab, text_len: int,
            pipe: Dict, device):
    names = pool.class_lists[idx]
    ids, mask, pool_m = ref.caption(names, vocab, text_len,
                                    pipe["max_classes"])
    k = pipe["max_classes"]
    xy = ref.xy_scale_of(pool.gt_sizes[idx], pipe["bucket"]) \
        if pipe["postprocess"]["crf_xy_gt_scale"] else (1.0, 1.0)
    return dict(
        image_u8=torch.as_tensor(pool.images[idx], device=device),
        ids=torch.as_tensor(ids, device=device),
        mask=torch.as_tensor(mask, device=device),
        pool=torch.as_tensor(pool_m, device=device),
        class_valid=torch.arange(k, device=device) < len(names),
        bg_enable=ref.background_enabled(pipe["data_type"], len(names)),
        rgb=torch.as_tensor(pool.rgb[idx], device=device).float(),
        xy_scale=xy)


def reference_model(cfg: Dict, seed: int, device,
                    rounding: Rounding = EXACT) -> BlipItm:
    sd = weights.lavis_state_dict(cfg["model"], seed, device)
    model = BlipItm(sd, cfg["model"], device=device, rounding=rounding)
    del sd
    return model


def judge(cfg: Dict, pipe: Dict, precision: Dict, pool: traffic_mod.Pool,
          vocab, records: List[Dict], seed: int, device,
          details: Optional[List] = None) -> Dict[str, float]:
    """The numbers compared over the sampled images
    (``reference.segment.combine``); ``details`` collects each image's
    readings."""
    model = reference_model(cfg, seed, device)
    stated = reference_model(cfg, seed, device,
                             Rounding(model=precision["model"]))
    crf_stated = Rounding(crf_kernel=precision["crf_kernel"],
                          crf_state=precision["crf_state"])
    text_len = ref.caption_length(pool.class_lists,
                                  cfg["model"]["max_text_len"])
    images = []
    for rec in records:
        inp = _inputs(pool, rec["pool_index"], vocab, text_len, pipe, device)
        on_dev = {k: (v.to(device) if torch.is_tensor(v) else v)
                  for k, v in rec.items()}
        got = ref.judge_image(model, stated, on_dev, **inp, pipe=pipe,
                              crf_stated=crf_stated,
                              threshold_band=THRESHOLD_BAND)
        images.append(got)
        if details is not None:
            details.append(dict(got, pool_index=rec["pool_index"]))
    # A number that is not finite reads as the largest finite one.
    return {k: (v if np.isfinite(v) else 1e30)
            for k, v in ref.combine(images).items()}


def control_records(cfg: Dict, pipe: Dict, pool: traffic_mod.Pool, vocab,
                    images: List[int], seed: int, device,
                    rounding: Rounding) -> List[Dict]:
    """The reference in the system's place, in ``rounding``'s formats:
    the records it produces for these pool images."""
    model = reference_model(cfg, seed, device, rounding)
    text_len = ref.caption_length(pool.class_lists,
                                  cfg["model"]["max_text_len"])
    out = []
    for idx in images:
        inp = _inputs(pool, idx, vocab, text_len, pipe, device)
        rec = ref.run_image(model, **inp, pipe=pipe, rounding=rounding)
        rec = {k: v.detach().cpu() for k, v in rec.items()}
        rec["pool_index"] = idx
        out.append(rec)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, Dict]) -> Dict:
    """{name: {"value", "limit"}} of every number the cell's limits file
    compares (its readings and why stand beside each limit there)."""
    return {name: {"value": numbers[name], "limit": limits[name]["limit"]}
            for name in NUMBERS if name in limits}


def passed(checks: Dict) -> bool:
    """Every compared number within its limit; a cell that compares
    nothing is not correct."""
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values())
