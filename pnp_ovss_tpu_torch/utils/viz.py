"""Visualization: attention overlays and segmentation map rendering (the
port's copy of ``pnp_ovss_tpu/utils/viz.py``).

Reference: getAttMap debug overlays for a hard-coded image list (script
:330-341) and Draw_Segmentation_map prediction-vs-GT renders (:790-807,
coco :966-1001). Artifacts are written under ``{save_path}/viz/``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image


def _normalize01(x: np.ndarray) -> np.ndarray:
    mn, mx = float(x.min()), float(x.max())
    return (x - mn) / (mx - mn) if mx > mn else np.zeros_like(x)


def _jet(x: np.ndarray) -> np.ndarray:
    """Minimal jet colormap [H, W] in [0,1] -> [H, W, 3] floats."""
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return np.stack([r, g, b], -1)


def attention_overlay(
    image01: np.ndarray,  # [H, W, 3] in 0-1
    att_map: np.ndarray,  # [h, w] attention
    *,
    blur_sigma: Optional[float] = None,
    alpha: float = 0.7,
) -> np.ndarray:
    """Blend a jet-coloured attention map over the image (getAttMap)."""
    from scipy.ndimage import gaussian_filter, zoom

    h, w = image01.shape[:2]
    att = zoom(att_map, (h / att_map.shape[0], w / att_map.shape[1]), order=1)
    if blur_sigma:
        att = gaussian_filter(att, blur_sigma)
    att = _normalize01(att)
    heat = _jet(att)
    out = (1 - alpha * att[..., None]) * image01 + alpha * att[..., None] * heat
    return np.clip(out, 0, 1)


def label_colormap(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    cmap = rng.random((max(n, 1), 3))
    cmap[0] = 0.0  # background black
    return cmap


def render_segmentation(
    label_map: np.ndarray,  # [H, W] int category ids
    image01: Optional[np.ndarray] = None,
    *,
    num_classes: int = 256,
    alpha: float = 0.5,
) -> np.ndarray:
    """Colourise a label map, optionally blended over the image."""
    cmap = label_colormap(num_classes)
    colored = cmap[np.clip(label_map.astype(int), 0, num_classes - 1)]
    if image01 is None:
        return colored
    mask = (label_map > 0)[..., None]
    return np.where(mask, (1 - alpha) * image01 + alpha * colored, image01)


def save_image01(path: str, img01: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((np.clip(img01, 0, 1) * 255).astype(np.uint8)).save(path)


def dump_debug_artifacts(
    save_path: str,
    img_id: str,
    image01: np.ndarray,
    class_maps: np.ndarray,  # [K, g, g]
    class_names: Sequence[str],
    pred_labels: np.ndarray,  # [H, W] category ids
    gt_labels: Optional[np.ndarray] = None,
) -> None:
    """Per-image debug dump (reference Blip_reinferene_* / 0519_Segmentation)."""
    base = os.path.join(save_path, "viz")
    for k, name in enumerate(class_names):
        overlay = attention_overlay(image01, class_maps[k], blur_sigma=2.0)
        save_image01(
            os.path.join(base, f"attn_{img_id}_{name}.jpeg"), overlay
        )
    save_image01(
        os.path.join(base, f"seg_{img_id}.jpeg"),
        render_segmentation(pred_labels, image01),
    )
    if gt_labels is not None:
        save_image01(
            os.path.join(base, f"gt_{img_id}.jpeg"),
            render_segmentation(gt_labels, image01),
        )
