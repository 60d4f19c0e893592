"""Numpy postprocess helpers of the host parity path (the port's copy of
``pnp_ovss_tpu/ops/host_post.py``).

The parity path (``--postprocess_backend host``) reproduces the reference's
per-image CPU postprocess (reference script :348-379, :1002-1074):

  grid-resolution thresholded maps -> ONE bilinear resize to GT resolution
  (align_corners=True, :358-360) -> Scale_0_1 on the 1-drop variant only
  (:362 vs :441) -> background channel (:370) -> scipy-style Gaussian blur
  + min-max (:1149-1153) -> the native permutohedral DenseCRF
  (``ops/crf_host.py``).

Everything here is numpy on the calling thread: the CLI runs it on its
finalize worker, which must not touch the card (all device work stays on
the main thread). The interpolation and blur matrices are the device
formulations' (``ops/resize.py``, ``ops/blur.py``), applied as two BLAS
products in float64 and rounded to float32 once, where the JAX package
sums with ``np.einsum`` in float32. The float64 sums are those of scipy's
``gaussian_filter``, which sums in double, and sit within 1e-5 of the
float32 einsum. ``scripts/time_host_post.py`` times both formulations.
"""

from __future__ import annotations

import numpy as np

from pnp_ovss_tpu_torch.ops.blur import _blur_matrix_np
from pnp_ovss_tpu_torch.ops.resize import _interp_matrix_np


def _separable(ah: np.ndarray, aw: np.ndarray, x: np.ndarray) -> np.ndarray:
    """ah [oh, H] @ x [..., H, W] @ aw.T [W, ow] in float64 -> float32."""
    y = np.matmul(ah.astype(np.float64), np.asarray(x, np.float32))
    return np.matmul(y, aw.astype(np.float64).T).astype(np.float32)


def resize_bilinear_np(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[..., H, W] -> f32 [..., out_h, out_w], torch align_corners=True
    semantics (reference F.interpolate, script :358-360)."""
    h, w = x.shape[-2:]
    return _separable(_interp_matrix_np(h, out_h), _interp_matrix_np(w, out_w),
                      x)


def rescale_0_1_np(maps: np.ndarray) -> np.ndarray:
    """Per-map min-max to [0, 1] (reference Scale_0_1, :1080-1103); a
    constant map keeps its values less its minimum."""
    flat = maps.reshape(*maps.shape[:-2], -1)
    mn = flat.min(axis=-1)[..., None, None]
    mx = flat.max(axis=-1)[..., None, None]
    denom = mx - mn
    denom = np.where(denom > 0, denom, 1.0)
    return (maps - mn) / denom


def blur_and_minmax_np(x: np.ndarray, sigma: float) -> np.ndarray:
    """Reference ``blurring`` (script :1149-1153): scipy gaussian_filter
    (reflect boundary, truncate 4) then per-map min-max, on [..., H, W]."""
    h, w = x.shape[-2:]
    return rescale_0_1_np(_separable(_blur_matrix_np(h, float(sigma), 4.0),
                                     _blur_matrix_np(w, float(sigma), 4.0),
                                     x))
