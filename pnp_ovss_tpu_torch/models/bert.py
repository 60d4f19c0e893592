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

Tensor parallelism (``tp=group`` on an encoder whose linears
``parallel.tensor.shard_model`` cut, the JAX package's Megatron layout):
q/k/v of both attentions and ``intermediate`` are column slabs that read
Megatron's f of their input, every ``output_dense`` a row slab whose f32
partial product goes through g before the bias, the residual and the
LayerNorm. Attention runs on this rank's heads, so the cross-attention
tap and the captured probabilities are ``[L, B, H/tp, T, S]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from pnp_ovss_tpu_torch.config import BertConfig
from pnp_ovss_tpu_torch.models.layers import DTYPES, LayerNorm
from pnp_ovss_tpu_torch.ops import attention as attn_ops
from pnp_ovss_tpu_torch.parallel.mesh import AxisGroup
from pnp_ovss_tpu_torch.parallel.tensor import (
    check_heads, copy_to_model_group, reduce_from_model_group, row_partial,
)


def _heads(y: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = y.shape
    return y.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge(y: torch.Tensor) -> torch.Tensor:
    b, h, t, d = y.shape
    return y.transpose(1, 2).reshape(b, t, h * d)


def _local_heads(cfg: BertConfig, tp: Optional[AxisGroup]) -> int:
    return cfg.num_heads if tp is None else \
        check_heads(cfg.num_heads, tp.size, "BERT")


def _row_out(linear: nn.Linear, y: torch.Tensor, full: int,
             tp: Optional[AxisGroup]) -> torch.Tensor:
    """A row-parallel ``linear`` of ``y``: the plain product, or under
    tensor parallelism (when ``shard_model`` cut its input of width
    ``full``) this rank's partial sum through g, then the bias, rounded
    once to ``y``'s dtype."""
    if tp is None or linear.in_features == full:
        return linear(y)
    acc = reduce_from_model_group(row_partial(y, linear), tp)
    return (acc + linear.bias.float()).to(y.dtype)


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

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                tp: Optional[AxisGroup] = None) -> torch.Tensor:
        c = self.cfg
        h = _local_heads(c, tp)
        xin = copy_to_model_group(x, tp)
        ctx = attn_ops.mha(_heads(self.query(xin), h),
                           _heads(self.key(xin), h),
                           _heads(self.value(xin), h), bias,
                           out_dtype=DTYPES[c.dtype])
        out = _row_out(self.output_dense, _merge(ctx), c.hidden_size, tp)
        return self.output_norm(out + x)


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

    def forward(self, x, kv, capture: bool, tap: Optional[torch.Tensor],
                tp: Optional[AxisGroup] = None):
        """x [B, T, h] text; kv [B, S, w] image embeds (no gradient);
        tap [B, H/tp, T, S]. Returns (x, probs of this rank's heads or
        None)."""
        c = self.cfg
        h = _local_heads(c, tp)
        probs = attn_ops.attention_probs(
            _heads(self.query(copy_to_model_group(x, tp)), h),
            _heads(self.key(kv), h))
        if tap is not None:
            probs = probs + tap
        ctx = attn_ops.apply_probs(probs, _heads(self.value(kv), h),
                                   out_dtype=DTYPES[c.dtype])
        out = _row_out(self.output_dense, _merge(ctx), c.hidden_size, tp)
        x = self.output_norm(out + x)
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
        self.cfg = cfg

    def forward(self, x, bias, image_embeds, capture=False, tap=None,
                tp: Optional[AxisGroup] = None):
        """image_embeds None: text-only (no cross-attention, nothing
        captured)."""
        x = self.attention(x, bias, tp)
        captured = None
        if image_embeds is not None:
            x, captured = self.crossattention(x, image_embeds, capture, tap,
                                              tp)
        g = F.gelu(self.intermediate(copy_to_model_group(x, tp)))
        h = _row_out(self.output_dense, g, self.cfg.intermediate_size, tp)
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
        tp: Optional[AxisGroup] = None,
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
                x, _ = layer(x, bias, image_embeds, tp=tp)
        captured = []
        for i in range(first, self.cfg.num_layers):
            if i not in self.capture_layers:
                x, _ = self.layers[i](x, bias, image_embeds, tp=tp)
                continue
            tap = None if cross_tap is None \
                else cross_tap[self.capture_layers.index(i)]
            x, cap = self.layers[i](x, bias, image_embeds, capture=True,
                                    tap=tap, tp=tp)
            captured.append(cap)
        if image_embeds is None:
            return x, None
        return x, torch.stack(captured)
