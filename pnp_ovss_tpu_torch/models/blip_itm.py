"""BLIP image-text-matching model (counterpart of
``pnp_ovss_tpu/models/blip_itm.py``): ViT image encoder, BERT fusion encoder
over (text, image embeddings), ITM head Linear(hidden, 2) on the [ENC]
position (reference blip_image_text_matching.py:222-249).

Inference only: parameters never require grad, and the only gradient the
pipeline takes is GradCAM's, with respect to the cross-attention tap.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pnp_ovss_tpu_torch import resolve_device
from pnp_ovss_tpu_torch.config import ModelConfig
from pnp_ovss_tpu_torch.models.bert import BertFusionEncoder
from pnp_ovss_tpu_torch.models.layers import LayerNorm
from pnp_ovss_tpu_torch.models.vit import VisionTransformer


class BlipITM(nn.Module):
    def __init__(self, cfg: ModelConfig, capture_layer: int,
                 vit_fused: bool = True):
        """``capture_layer``: 0-indexed BERT layer whose cross-attention
        probabilities GradCAM reads (the reference's 1-indexed
        --max_att_block_num minus one). ``vit_fused``: the fused ViT
        block where the config allows it (the JAX package's default);
        False is its ``PNP_VIT_FUSED=0``."""
        super().__init__()
        self.cfg = cfg
        self.visual_encoder = VisionTransformer(cfg.vit, fused=vit_fused)
        self.text_encoder = BertFusionEncoder(cfg.bert, capture_layer)
        self.itm_head = nn.Linear(cfg.bert.hidden_size, 2)  # float32

    @torch.no_grad()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] normalised NHWC -> [B, S, width]."""
        return self.visual_encoder(images)

    def itm_from_embeds(self, image_embeds, input_ids, attention_mask,
                        cross_tap: Optional[torch.Tensor] = None):
        """-> (ITM logits [B, 2] f32, captured probs [B, H, T, S]). The
        embeddings are detached: no gradient may reach the ViT."""
        hidden, probs = self.text_encoder(
            input_ids, attention_mask, image_embeds.detach(), cross_tap)
        return self.itm_head(hidden[:, 0].float()), probs


def init_blip_itm(cfg: ModelConfig, *, capture_layer: int, seed: int = 0,
                  device="cuda", vit_fused: bool = True) -> BlipITM:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (benchmarks and smoke runs without a checkpoint):
    matrices N(0, 1/fan_in), embeddings N(0, 0.02^2), biases 0, norms 1.
    Both ViT blocks draw the same weights from the same seed."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = BlipITM(cfg, capture_layer, vit_fused=vit_fused)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, LayerNorm):
                continue  # keeps ones / zeros
            for name, p in mod.named_parameters(recurse=False):
                if name == "bias":
                    p.zero_()
                    continue
                if isinstance(mod, (nn.Linear, nn.Conv2d)):
                    std = 1.0 / math.sqrt(p[0].numel())
                else:  # embeddings, CLS token, position embeddings
                    std = 0.02
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)
    return model.requires_grad_(False).eval()
