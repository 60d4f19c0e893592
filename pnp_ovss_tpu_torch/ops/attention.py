"""Multi-head attention (counterpart of ``pnp_ovss_tpu/ops/attention.py``).

Two implementations behind ``mha``: ``plain`` (the JAX package's ``xla``),
PyTorch products with scores and softmax in float32, and ``flash`` (its
``pallas``), kernel K9 ``flash_attention.flash_mha`` for the shapes it takes.
The BERT fusion encoder's cross-attention probabilities are the GradCAM
signal and must be materialised, so it always runs the plain path.
"""

from __future__ import annotations

from typing import Optional

import torch

from pnp_ovss_tpu_torch.ops import flash_attention as _flash


def attention_probs(q: torch.Tensor, k: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, Tq, D], k [B, H, Tk, D] -> f32 probs [B, H, Tq, Tk]; ``bias``
    is additive (the reference's ``(1 - mask) * -10000``, med.py:851)."""
    d = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * (1.0 / d**0.5)
    if bias is not None:
        scores = scores + bias.float()
    return torch.softmax(scores, dim=-1)


def apply_probs(probs: torch.Tensor, v: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Context = probs @ v, split out so a gradient tap can sit on probs."""
    out = torch.matmul(probs, v.to(probs.dtype))
    return out.to(out_dtype or v.dtype)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v on [B, H, T, D] (``mha_xla``)."""
    out = torch.matmul(attention_probs(q, k, bias), v.float())
    return out.to(out_dtype or q.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor] = None, *, impl: str = "plain",
        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Attention on [B, H, T, D]. ``impl="flash"`` runs K9 where there is
    no bias and ``flash_attention.supported(q)``, the plain math
    otherwise, as the JAX package's ``mha(impl="pallas")`` does."""
    if impl not in ("plain", "flash"):
        raise ValueError(f"impl must be 'plain' or 'flash', got {impl!r}")
    if impl == "flash" and bias is None and _flash.supported(q):
        return _flash.flash_mha(q, k, v, out_dtype=out_dtype)
    return mha_plain(q, k, v, bias, out_dtype=out_dtype)
