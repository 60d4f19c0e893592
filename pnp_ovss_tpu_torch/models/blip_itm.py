"""BLIP image-text-matching model (counterpart of
``pnp_ovss_tpu/models/blip_itm.py``): ViT image encoder, BERT fusion encoder
over (text, image embeddings), ITM head Linear(hidden, 2) on the [ENC]
position (reference blip_image_text_matching.py:222-249), and the ITC
heads ``vision_proj`` / ``text_proj`` to ``embed_dim`` (:251-263), which
the hyper-parameter search scores with.

Inference only: parameters never require grad, and the only gradient the
pipeline takes is GradCAM's, with respect to the cross-attention tap.

``tp``: the model axis a ``parallel.tensor.shard_model`` call cut the
linears over (None: the whole model). Every forward passes it to the ViT
and the BERT encoder; the ITM head and the ITC projections stay
replicated.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from pnp_ovss_tpu_torch import resolve_device
from pnp_ovss_tpu_torch.config import ModelConfig
from pnp_ovss_tpu_torch.models.bert import BertFusionEncoder
from pnp_ovss_tpu_torch.models.layers import LayerNorm
from pnp_ovss_tpu_torch.models.vit import VisionTransformer
from pnp_ovss_tpu_torch.parallel.mesh import AxisGroup


class BlipITM(nn.Module):
    def __init__(self, cfg: ModelConfig, capture_layers: Tuple[int, ...],
                 vit_fused: bool = True):
        """``capture_layers``: the ascending 0-indexed BERT layers whose
        cross-attention probabilities GradCAM reads: one for the pipeline
        (the reference's 1-indexed --max_att_block_num minus one), all of
        them for the search's ensemble. Probs and tap carry a leading
        layer axis.
        ``vit_fused``: the fused ViT block where the config allows it (the
        JAX package's default); False is its ``PNP_VIT_FUSED=0``."""
        super().__init__()
        self.cfg = cfg
        self.visual_encoder = VisionTransformer(cfg.vit, fused=vit_fused)
        self.text_encoder = BertFusionEncoder(cfg.bert, capture_layers)
        self.itm_head = nn.Linear(cfg.bert.hidden_size, 2)  # float32
        self.vision_proj = nn.Linear(cfg.vit.hidden_size, cfg.embed_dim)
        self.text_proj = nn.Linear(cfg.bert.hidden_size, cfg.embed_dim)
        self.tp: Optional[AxisGroup] = None

    @torch.no_grad()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] normalised NHWC -> [B, S, width]."""
        return self.visual_encoder(images, tp=self.tp)

    def itm_from_embeds(self, image_embeds, input_ids, attention_mask,
                        cross_tap: Optional[torch.Tensor] = None):
        """-> (ITM logits [B, 2] f32, captured probs [L, B, H/tp, T, S]).
        The embeddings are detached: no gradient may reach the ViT."""
        hidden, probs = self.text_encoder(
            input_ids, attention_mask, image_embeds.detach(), cross_tap,
            tp=self.tp)
        return self.itm_head(hidden[:, 0].float()), probs

    def forward(self, images, input_ids, attention_mask,
                cross_tap: Optional[torch.Tensor] = None):
        """ITM from images: the ViT without a gradient, then
        ``itm_from_embeds``."""
        return self.itm_from_embeds(self.encode_image(images), input_ids,
                                    attention_mask, cross_tap)

    @torch.no_grad()
    def itm_rank(self, image_embeds, input_ids) -> torch.Tensor:
        """ITM match probability for ranking (reference itm_rank
        :267-295): the first 3 tokens dropped, position 0 set to [ENC],
        the mask on non-pad tokens -> softmax(itm)[:, 1]."""
        bert = self.cfg.bert
        ids = input_ids[:, 3:].clone()
        ids[:, 0] = bert.enc_token_id
        mask = (ids != bert.pad_token_id).to(torch.int32)
        logits, _ = self.itm_from_embeds(image_embeds, ids, mask)
        return F.softmax(logits, dim=1)[:, 1]

    @torch.no_grad()
    def itc(self, images, input_ids, attention_mask) -> torch.Tensor:
        """ITC similarity matrix [B_img, B_txt] (reference :251-263):
        L2-normalised projections of the image CLS and of the text CLS of
        the text-only encoder."""
        img = self.vision_proj(self.encode_image(images)[:, 0].float())
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        hidden, _ = self.text_encoder(input_ids, attention_mask, None,
                                      tp=self.tp)
        txt = self.text_proj(hidden[:, 0].float())
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        return img @ txt.T


def init_blip_itm(cfg: ModelConfig, *,
                  capture_layers: Tuple[int, ...], seed: int = 0,
                  device="cuda", vit_fused: bool = True) -> BlipITM:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (benchmarks and smoke runs without a checkpoint):
    matrices N(0, 1/fan_in), embeddings N(0, 0.02^2), biases 0, norms 1.
    Both ViT blocks draw the same weights from the same seed."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = BlipITM(cfg, capture_layers, vit_fused=vit_fused)
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
