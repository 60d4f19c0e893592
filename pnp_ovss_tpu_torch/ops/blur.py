"""Separable Gaussian blur matching scipy.ndimage.gaussian_filter
(counterpart of ``pnp_ovss_tpu/ops/blur.py``).

The reference blurs each class map with ``gaussian_filter(att, 0.05 *
max(H, W))`` and min-max normalises (reference script :1149-1153). The
1D filters (truncate 4.0, "reflect" boundary) are dense [N, N] band
matrices built in numpy and applied as two matrix products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pnp_ovss_tpu_torch import to_device


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _reflect_index(i: np.ndarray, n: int) -> np.ndarray:
    """scipy 'reflect' boundary: (d c b a | a b c d | d c b a)."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n
    i = np.mod(i, period)
    i = np.where(i < 0, i + period, i)
    return np.where(i < n, i, period - 1 - i)


@functools.lru_cache(maxsize=64)
def _blur_matrix_np(n: int, sigma: float, truncate: float) -> np.ndarray:
    """[n, n] matrix equivalent to 1D gaussian_filter with reflect mode."""
    radius = int(truncate * float(sigma) + 0.5)
    k = _gaussian_kernel1d(float(sigma), radius)
    a = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for t in range(-radius, radius + 1):
        src = _reflect_index(idx + t, n)
        np.add.at(a, (idx, src), k[t + radius])
    return a


def gaussian_blur2d(x: torch.Tensor, sigma: float, *,
                    truncate: float = 4.0) -> torch.Tensor:
    """Blur [..., H, W] -> f32. A bf16 input rounds the band matrices and
    the intermediate to bf16, with f32 sums, as the JAX package's bf16
    blur does; f32 input stays f32."""
    h, w = x.shape[-2:]
    lowp = x.dtype == torch.bfloat16

    def operand(a):
        return a.to(torch.bfloat16).float() if lowp else a.float()

    bh = operand(to_device(_blur_matrix_np(h, float(sigma), truncate),
                           x.device))
    bw = operand(to_device(_blur_matrix_np(w, float(sigma), truncate),
                           x.device))
    y = torch.matmul(bh, x.float())
    y = operand(y)
    return torch.matmul(y, bw.transpose(0, 1))


def blur_and_minmax(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Reference ``blurring``: blur, then min-max each map to [0, 1]."""
    y = gaussian_blur2d(x, sigma)
    flat = y.reshape(*y.shape[:-2], -1)
    mn = flat.amin(dim=-1)[..., None, None]
    mx = flat.amax(dim=-1)[..., None, None]
    denom = torch.where(mx - mn > 0, mx - mn, torch.ones_like(mx))
    return (y - mn) / denom
