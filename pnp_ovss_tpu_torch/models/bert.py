"""BERT fusion encoder ("med") with an explicit attention tap (counterpart
of ``pnp_ovss_tpu/models/bert.py``).

Post-LN layers (eps 1e-12): text self-attention with the additive bias
``(1 - mask) * -10000`` (med.py:851), cross-attention over the ViT
embeddings, then the GELU FFN. The captured layers (``capture_layers``,
an ascending tuple of 0-indexed layers: one for the segmentation pipeline,
all twelve for the search's ensemble, bert.py:229-243) return their
cross-attention probabilities; a
``cross_tap`` added to them after the softmax and before the context
product is where GradCAM takes its gradient (bert.py:90-95), all layers in
one forward and one backward. Layers before the first captured one carry
no tap gradient and run under ``torch.no_grad()``. With
``image_embeds=None`` the encoder runs text-only (the reference's
mode="text", no cross-attention; med.py:473-508), as ITC needs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from pnp_ovss_tpu_torch.config import BertConfig
from pnp_ovss_tpu_torch.models.layers import DTYPES, LayerNorm
from pnp_ovss_tpu_torch.ops import attention as attn_ops


def _heads(y: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = y.shape
    return y.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge(y: torch.Tensor) -> torch.Tensor:
    b, h, t, d = y.shape
    return y.transpose(1, 2).reshape(b, t, h * d)


class BertSelfAttentionBlock(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        dtype = DTYPES[cfg.dtype]
        d = cfg.hidden_size
        self.cfg = cfg
        self.query = nn.Linear(d, d, dtype=dtype)
        self.key = nn.Linear(d, d, dtype=dtype)
        self.value = nn.Linear(d, d, dtype=dtype)
        self.output_dense = nn.Linear(d, d, dtype=dtype)
        self.output_norm = LayerNorm(d, cfg.layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        h = self.cfg.num_heads
        ctx = attn_ops.mha(_heads(self.query(x), h), _heads(self.key(x), h),
                           _heads(self.value(x), h), bias,
                           out_dtype=DTYPES[self.cfg.dtype])
        return self.output_norm(self.output_dense(_merge(ctx)) + x)


class BertCrossAttentionBlock(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        dtype = DTYPES[cfg.dtype]
        d, e = cfg.hidden_size, cfg.encoder_width
        self.cfg = cfg
        self.query = nn.Linear(d, d, dtype=dtype)
        self.key = nn.Linear(e, d, dtype=dtype)
        self.value = nn.Linear(e, d, dtype=dtype)
        self.output_dense = nn.Linear(d, d, dtype=dtype)
        self.output_norm = LayerNorm(d, cfg.layer_norm_eps, dtype)

    def forward(self, x, kv, capture: bool, tap: Optional[torch.Tensor]):
        """x [B, T, h] text; kv [B, S, w] image embeds; tap [B, H, T, S].
        Returns (x, probs or None)."""
        h = self.cfg.num_heads
        probs = attn_ops.attention_probs(_heads(self.query(x), h),
                                         _heads(self.key(kv), h))
        if tap is not None:
            probs = probs + tap
        ctx = attn_ops.apply_probs(probs, _heads(self.value(kv), h),
                                   out_dtype=DTYPES[self.cfg.dtype])
        x = self.output_norm(self.output_dense(_merge(ctx)) + x)
        return x, (probs if capture else None)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        dtype = DTYPES[cfg.dtype]
        self.attention = BertSelfAttentionBlock(cfg)
        self.crossattention = BertCrossAttentionBlock(cfg)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                      dtype=dtype)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                      dtype=dtype)
        self.output_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                     dtype)

    def forward(self, x, bias, image_embeds, capture=False, tap=None):
        """image_embeds None: text-only (no cross-attention, nothing
        captured)."""
        x = self.attention(x, bias)
        captured = None
        if image_embeds is not None:
            x, captured = self.crossattention(x, image_embeds, capture, tap)
        h = self.output_dense(F.gelu(self.intermediate(x)))
        return self.output_norm(h + x), captured


class BertFusionEncoder(nn.Module):
    """(ids, mask, image_embeds, cross_tap) -> (last hidden, captured
    cross-attention probs). ``capture_layers``: an ascending tuple of L
    layers; probs and tap are [L, B, H, T, S], one slice per captured
    layer. Text-only mode returns no probs."""

    def __init__(self, cfg: BertConfig, capture_layers: Tuple[int, ...]):
        super().__init__()
        layers = tuple(capture_layers)
        if not layers or list(layers) != sorted(set(layers)) or \
                not 0 <= layers[0] <= layers[-1] < cfg.num_layers:
            raise ValueError(f"capture_layers {capture_layers}: want "
                             f"ascending layers in [0, {cfg.num_layers})")
        self.cfg = cfg
        self.capture_layers = layers
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size))
        self.embed_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    DTYPES[cfg.dtype])
        self.layers = nn.ModuleList(
            BertLayer(cfg) for _ in range(cfg.num_layers))

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, T] int64
        attention_mask: torch.Tensor,  # [B, T] {0, 1}
        image_embeds: Optional[torch.Tensor],  # [B, S, encoder_width]
        cross_tap: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        dtype = DTYPES[self.cfg.dtype]
        t = input_ids.shape[1]
        first = self.capture_layers[0]
        bias = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
        with torch.no_grad():  # nothing before the tap carries a gradient
            x = self.word_embeddings(input_ids).to(dtype) \
                + self.position_embeddings[:t].to(dtype)
            x = self.embed_norm(x)
            for layer in self.layers[:first]:
                x, _ = layer(x, bias, image_embeds)
        captured = []
        for i in range(first, self.cfg.num_layers):
            if i not in self.capture_layers:
                x, _ = self.layers[i](x, bias, image_embeds)
                continue
            tap = None if cross_tap is None \
                else cross_tap[self.capture_layers.index(i)]
            x, cap = self.layers[i](x, bias, image_embeds, capture=True,
                                    tap=tap)
            captured.append(cap)
        if image_embeds is None:
            return x, None
        return x, torch.stack(captured)
