"""Iterative salience drop (counterpart of ``pnp_ovss_tpu/pipeline/drop.py``;
reference script :564-722).

Per round: zero the pixels of every patch dropped so far, encode and take
GradCAM, zero the GradCAM at dropped patches, sum it over the class-token
rows [3:-1] and drop the top ``patches_per_round`` patches not dropped yet.
Dropped patches score -inf so they are never picked again; ties go to the
lower patch index, as ``jax.lax.top_k``. The aggregate keeps the
reference's round-0 double count (reference script :716-721).
"""

from __future__ import annotations

import torch

from pnp_ovss_tpu_torch.config import DropConfig
from pnp_ovss_tpu_torch.utils.tracing import TRACER


def expand_patch_mask_to_pixels(keep: torch.Tensor,
                                patch_size: int) -> torch.Tensor:
    """[B, g, g] {0,1} patch keep-mask -> [B, g*ps, g*ps, 1] pixel mask."""
    m = keep.repeat_interleave(patch_size, dim=1)
    return m.repeat_interleave(patch_size, dim=2)[..., None]


def make_split_round_step(embed_fn, bert_gradcam_fn, *, cfg: DropConfig,
                          grid: int, patch_size: int):
    """Round step (dropped, images, ids, mask) -> (dropped, gradcam).

    ``embed_fn(images)`` encodes masked images; ``bert_gradcam_fn(embeds,
    ids, mask)`` returns (gradcam [B, T-1, g, g], logits)."""
    num_patches = grid * grid
    k_drop = min(cfg.patches_per_round, num_patches)

    def round_step(dropped, images, input_ids, attention_mask):
        b = images.shape[0]
        keep = 1.0 - dropped.reshape(b, grid, grid)
        masked = images * expand_patch_mask_to_pixels(keep, patch_size)
        with TRACER.span("vit.encode"):
            embeds = embed_fn(masked)
        del masked  # freed before BERT runs
        with TRACER.span("bert.gradcam"):
            gc, _ = bert_gradcam_fn(embeds, input_ids, attention_mask)
        with TRACER.span("drop.select"):
            gc = gc * keep[:, None, :, :]
            salience = gc[:, 3:-1].sum(dim=1).reshape(b, num_patches)
            salience = salience.masked_fill(dropped > 0, float("-inf"))
            top = torch.sort(salience, dim=1, descending=True,
                             stable=True).indices[:, :k_drop]
            new = torch.zeros_like(dropped).scatter_(1, top, 1.0)
            return torch.clamp(dropped + new, 0.0, 1.0), gc

    return round_step


def run_drop_rounds(round_step, images, input_ids, attention_mask, *,
                    cfg: DropConfig, num_patches: int):
    """-> (gradcam of round 0, aggregate over rounds), each [B, T-1, g, g]."""
    b = images.shape[0]
    dropped = torch.zeros((b, num_patches), dtype=torch.float32,
                          device=images.device)
    gc0 = agg = None
    for r in range(cfg.num_rounds):
        with TRACER.span("drop.round", r=r):
            dropped, gc = round_step(dropped, images, input_ids,
                                     attention_mask)
        if r == 0:
            gc0 = agg = gc
        else:
            agg = agg + gc
    if cfg.double_count_round0:
        agg = agg + gc0
    return gc0, agg
