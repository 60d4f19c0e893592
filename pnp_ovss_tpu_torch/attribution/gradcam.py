"""Cross-attention GradCAM through an explicit tap (counterpart of
``pnp_ovss_tpu/attribution/gradcam.py``).

Reference (blip_image_text_matching.py:386-457):

    loss    = itm_logits[:, 1].sum()
    grads   = d loss / d cross_attention_probs
    gradcam = relu(cams[..., 1:] * relu(grads[..., 1:]) * text_mask)
    then drop the [ENC] token row.

A zeros tap is added to the captured layers' probabilities after the
softmax; ``torch.autograd.grad`` with respect to it yields exactly the
gradient the reference's hooks capture, for every captured layer in one
backward pass. The tap sits after the ViT, so the backward pass never
reaches the image encoder, which runs without a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F


def gradcam_from_embeds(model, image_embeds: torch.Tensor,
                        input_ids: torch.Tensor,
                        attention_mask: torch.Tensor, *, grid: int):
    """-> (gradcam [L, B, H, T-1, grid, grid] f32, logits [B, 2]) for the
    model's L captured BERT layers, every head."""
    b, t = input_ids.shape
    s = image_embeds.shape[1]
    heads = model.cfg.bert.num_heads
    n_layers = len(model.text_encoder.capture_layers)
    tap = torch.zeros((n_layers, b, heads, t, s), dtype=torch.float32,
                      device=image_embeds.device, requires_grad=True)
    with torch.enable_grad():
        logits, cams = model.itm_from_embeds(image_embeds, input_ids,
                                             attention_mask, cross_tap=tap)
        (grads,) = torch.autograd.grad(logits[:, 1].sum(), tap)
    mask = attention_mask.float()[:, None, :, None]
    gc = cams.detach()[..., 1:] * F.relu(grads[..., 1:]) * mask
    gc = F.relu(gc)[..., 1:, :]  # drop the [ENC] token row
    return (gc.reshape(n_layers, b, heads, t - 1, grid, grid),
            logits.detach())


def gradcam_from_tap(model, images: torch.Tensor, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor, *, grid: int):
    """GradCAM from images (``pnp_ovss_tpu/attribution/gradcam.py:28``):
    the ViT encode without a gradient, then the tap's forward and backward
    -> (gradcam [L, B, H, T-1, grid, grid], ITM logits [B, 2])."""
    return gradcam_from_embeds(model, model.encode_image(images), input_ids,
                               attention_mask, grid=grid)


def make_gradcam_fn(model, *, layer: int, head: Optional[int] = None):
    """A single-(layer[, head]) GradCAM closure over ``model``, which must
    capture ``layer - 1`` (``layer`` is the reference's 1-indexed
    --max_att_block_num; ``head`` its 0-indexed --prune_att_head, None
    keeps every head). Returns fn(images, input_ids, attention_mask) ->
    (gradcam [B, T-1, g, g] or [B, H, T-1, g, g], logits)."""
    idx = model.text_encoder.capture_layers.index(layer - 1)
    grid = model.cfg.vit.grid

    def fn(images, input_ids, attention_mask):
        gc, logits = gradcam_from_tap(model, images, input_ids,
                                      attention_mask, grid=grid)
        gc = gc[idx]
        return (gc if head is None else gc[:, head]), logits

    return fn
