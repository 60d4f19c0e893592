"""Bilinear resize with align_corners=True semantics, as two matrix
products (counterpart of ``pnp_ovss_tpu/ops/resize.py``; the reference
script resizes with ``F.interpolate(..., align_corners=True)``, :358-360).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pnp_ovss_tpu_torch import to_device


@functools.lru_cache(maxsize=256)
def _interp_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] align_corners=True bilinear interpolation weights."""
    a = np.zeros((n_out, n_in), np.float32)
    if n_in == 1:
        a[:, 0] = 1.0
        return a
    if n_out == 1:
        a[0, 0] = 1.0
        return a
    scale = (n_in - 1) / (n_out - 1)
    src = np.arange(n_out) * scale
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, n_in - 2)
    w = (src - lo).astype(np.float32)
    a[np.arange(n_out), lo] = 1.0 - w
    a[np.arange(n_out), lo + 1] += w
    return a


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """x [..., H, W] -> f32 [..., out_h, out_w]."""
    h, w = x.shape[-2:]
    ah = to_device(_interp_matrix_np(h, out_h), x.device)
    aw = to_device(_interp_matrix_np(w, out_w), x.device)
    return torch.matmul(torch.matmul(ah, x.float()), aw.transpose(0, 1))
