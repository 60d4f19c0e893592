"""Confusion-histogram metrics (Pixel Acc / Mean Acc / FW-IoU / mIoU), the
port's counterpart of ``pnp_ovss_tpu/evalx/metrics.py``.

Reference: _fast_hist/scores (script :1106-1146) and the offline aggregator
(Calculate_mIoU.py:204-256). The numpy functions are copies of the JAX
package's; ``fast_hist_t`` / ``batch_hist_t`` count on torch tensors on
their own device, as ``fast_hist_jnp`` counts in-graph (no Pallas kernel
there, so a plain torch op is the port).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def fast_hist(
    label_true: np.ndarray, label_pred: np.ndarray, n_class: int
) -> np.ndarray:
    """Reference _fast_hist (:1106-1112): bincount confusion matrix."""
    mask = (label_true >= 0) & (label_true < n_class)
    hist = np.bincount(
        n_class * label_true[mask].astype(int) + label_pred[mask].astype(int),
        minlength=n_class**2,
    ).reshape(n_class, n_class)
    return hist


def batch_hist_t(label_true: torch.Tensor, label_pred: torch.Tensor,
                 n_class: int) -> torch.Tensor:
    """Per-image confusion matrices: [B, ...] integer labels -> [B, n_class,
    n_class] int32, on the labels' device. As ``fast_hist_jnp``, predictions
    are clipped to [0, n_class) and out-of-range true labels go to an
    overflow bin that is dropped. One ``torch.bincount`` for the batch
    (each image offset by its own n_class² + 1 bins), counted in int64 and
    cast to int32 after counting."""
    b = label_true.shape[0]
    t = label_true.reshape(b, -1).long()
    p = label_pred.reshape(b, -1).long().clamp(0, n_class - 1)
    bins = n_class * n_class + 1
    valid = (t >= 0) & (t < n_class)
    idx = torch.where(valid, n_class * t + p, n_class * n_class)
    idx = idx + bins * torch.arange(b, device=t.device)[:, None]
    hist = torch.bincount(idx.reshape(-1), minlength=b * bins)
    return hist.reshape(b, bins)[:, :-1].reshape(
        b, n_class, n_class).to(torch.int32)


def fast_hist_t(label_true: torch.Tensor, label_pred: torch.Tensor,
                n_class: int) -> torch.Tensor:
    """``fast_hist_jnp`` on torch tensors: one image, any shape ->
    [n_class, n_class] int32."""
    return batch_hist_t(label_true.reshape(1, -1),
                        label_pred.reshape(1, -1), n_class)[0]


def scores_from_hist(
    hist: np.ndarray, class_names: Sequence[str]
) -> Dict[str, object]:
    """Reference scores (:1115-1146) from a summed confusion matrix."""
    hist = np.asarray(hist, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (
            hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist)
        )
        valid = hist.sum(axis=1) > 0
        mean_iu = np.nanmean(iu[valid])
        freq = hist.sum(axis=1) / hist.sum()
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    cls_iu = dict(zip(class_names, iu))
    return {
        "Pixel Accuracy": acc,
        "Mean Accuracy": acc_cls,
        "Frequency Weighted IoU": fwavacc,
        "Mean IoU": mean_iu,
        "Class IoU": cls_iu,
    }


def class_name_list(cats: Dict[int, str], n_class: int) -> list:
    """Channel-id -> name table with 'Background' at 0 (reference :1129-1136)."""
    return ["Background"] + [cats[i] for i in range(1, n_class)]
