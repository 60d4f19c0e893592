"""Search rewards: positive / negative masks scored by an image-text model,
and token contrast (the port's counterpart of
``pnp_ovss_tpu/search/reward.py``).

Reference semantics (Dataset.py:212-340, script :156-192, :1229-1311):

- per image and class, binarise the class's attention map at ``min_att``,
  resize to the image and blur, multiply into the image: the "positive"
  masked input; the "negative" input is an all-black image (the
  reference's prediction_mask_neg = zeros, Dataset.py:277);
- a scorer embeds the masked images and the class names; per class, a
  softmax over classes at temperature 0.01 (script :170-172); the reward
  counts the classes whose positive diagonal probability beats the
  negative one (pos_win_sum, :183-185);
- token contrast: the mean of the [K, K] cosine-similarity matrix of the
  per-class maps (TCSum) and its std (TCStd) (Dataset.py:165-210); the
  scaled reward is pos_win_sum * (1 - TCSum) (:1291-1292).

The scorer is any callable (images [N, H, W, 3], texts) -> probs
[N, len(texts)]; ``cli/search.py`` builds one from the BLIP ITC head. The
resize and blur are the pipeline's (``ops/resize.py``, ``ops/blur.py``) on
torch tensors on ``device``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pnp_ovss_tpu_torch.ops.blur import gaussian_blur2d
from pnp_ovss_tpu_torch.ops.resize import resize_bilinear_align_corners


def token_contrast(maps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """maps [B, K, h, w] -> (TCSum [B], TCStd [B]): mean and (population)
    std of each image's [K, K] cosine-similarity matrix between flattened
    maps (Dataset.py:165-210)."""
    b, k, h, w = maps.shape
    x = maps.reshape(b, k, h * w).float()
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    xn = x / torch.clamp(norm, min=1e-8)
    sim = torch.einsum("bkn,bln->bkl", xn, xn)
    return sim.mean(dim=(1, 2)), sim.std(dim=(1, 2), correction=0)


def build_pos_masks(class_maps: np.ndarray, image: np.ndarray,
                    min_att: float, *, blur_sigma: float = 2.0,
                    token_grid: int = 24,
                    device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """class_maps [K, g, g], image [H, W, 3] (CLIP-normalised) -> (masked
    images [K, H, W, 3], token maps [K, token_grid, token_grid]), host
    numpy: binarise at min_att, upsample to the image, blur, multiply
    (Dataset.py:253-268)."""
    h, w = image.shape[:2]
    binary = torch.as_tensor(
        (np.asarray(class_maps) > min_att).astype(np.float32), device=device)
    up = gaussian_blur2d(resize_bilinear_align_corners(binary, h, w),
                         blur_sigma)
    token = resize_bilinear_align_corners(up, token_grid, token_grid)
    masked = up[..., None] * torch.as_tensor(image, dtype=torch.float32,
                                             device=device)[None]
    return masked.cpu().numpy(), token.cpu().numpy()


def pos_win_reward(probs: np.ndarray, num_classes: int) -> Tuple[float, int]:
    """probs [2K, K] (rows: positive masks, then negative) ->
    (avg_negoverpos, pos_win_sum), reference :176-192."""
    pos = np.diagonal(probs[:num_classes, :])
    neg = np.diagonal(probs[num_classes:, :])
    pos_win = int(np.sum(pos > neg))
    avg_negoverpos = float(np.mean(neg / np.maximum(pos, 1e-12)))
    return avg_negoverpos, pos_win


class RewardEvaluator:
    """Evaluates one (layer, head, min_att) config over a set of images.

    ``gradcam_provider(layer, head)`` yields (image id, ([K_i, g, g] maps,
    [K_i] class names, image [H, W, 3])). ``scorer(images [N, H, W, 3],
    texts)`` -> probs [N, len(texts)]. Rewards are memoised per config as
    JSON (reference :1241-1247); ``token_contrast_dir`` receives the
    per-image token-contrast JSONs in the reference's layout.
    """

    def __init__(self, gradcam_provider, scorer, *,
                 cache_dir: Optional[str] = None,
                 scale_by_token_contrast: bool = False,
                 token_contrast_dir: Optional[str] = None, device="cpu"):
        self.gradcam_provider = gradcam_provider
        self.scorer = scorer
        self.cache_dir = cache_dir
        self.scale_by_token_contrast = scale_by_token_contrast
        self.token_contrast_dir = token_contrast_dir
        self.device = device

    def _write_token_contrast(self, layer: int, head: int, min_att: float,
                              img_id, tc_sum: float, tc_std: float):
        """Token_Contrast/max_att_block_num{L}_atthead{H}_withatt{T}/
        Token_contrast_sum/img_{id}.json with TCSum_ / TCStd_ keys
        (Dataset.py token_cos_sim_map, :166-210), which the reference's
        own search re-reads (script :1474-1478)."""
        if not self.token_contrast_dir:
            return
        d = os.path.join(
            self.token_contrast_dir,
            f"max_att_block_num{layer}_atthead{head}"
            f"_withatt{int(min_att * 100)}",
            "Token_contrast_sum")
        os.makedirs(d, exist_ok=True)
        payload = {
            f"TCSum_layer{layer}_head{head}_img_{img_id}": float(tc_sum),
            f"TCStd_layer{layer}_head{head}_img_{img_id}": float(tc_std),
        }
        with open(os.path.join(d, f"img_{img_id}.json"), "w") as f:
            json.dump(payload, f)

    def _cache_path(self, layer: int, head: int,
                    min_att: float) -> Optional[str]:
        if not self.cache_dir:
            return None
        d = os.path.join(self.cache_dir, f"layer{layer}_head{head}")
        os.makedirs(d, exist_ok=True)
        return os.path.join(
            d, f"reward_metric_dict_attthresh{int(min_att * 100)}.json")

    def __call__(self, config: Dict) -> float:
        layer, head = int(config["layer"]), int(config["head"])
        min_att = float(config["min_att"])
        path = self._cache_path(layer, head, min_att)
        key = f"total_pos_win_sum_layer{layer}_head{head}"
        skey = (f"total_pos_win_sum_scaleby_tokencontrast_layer{layer}"
                f"_head{head}")
        if path and os.path.exists(path):
            with open(path) as f:
                cached = json.load(f)
            return cached[skey if self.scale_by_token_contrast else key]

        total = 0.0
        total_scaled = 0.0
        detail: Dict[str, float] = {}
        for img_id, (maps, names, image) in self.gradcam_provider(layer,
                                                                  head):
            if len(names) == 0:
                continue
            masked, token_maps = build_pos_masks(maps, image, min_att,
                                                 device=self.device)
            tc_sum, tc_std = token_contrast(torch.from_numpy(token_maps)[None])
            tc_sum, tc_std = float(tc_sum[0]), float(tc_std[0])
            self._write_token_contrast(layer, head, min_att, img_id, tc_sum,
                                       tc_std)
            probs = self.scorer(
                np.concatenate([masked, np.zeros_like(masked)], axis=0),
                list(names))
            _, pos_win = pos_win_reward(np.asarray(probs), len(names))
            total += pos_win
            scaled = pos_win * (1.0 - tc_sum)
            total_scaled += scaled
            detail[f"{img_id}_pos_win_sum"] = pos_win
            detail[f"{img_id}_pos_win_sum_scaleby_tokencontrast"] = scaled

        detail[key] = total
        detail[skey] = total_scaled
        if path:
            # The reference sorts the reward dict by value before dumping
            # (script :1496); the totals sort to the end the same way.
            detail = {k: v for k, v in
                      sorted(detail.items(), key=lambda kv: kv[1])}
            with open(path, "w") as f:
                json.dump(detail, f)
        return total_scaled if self.scale_by_token_contrast else total
