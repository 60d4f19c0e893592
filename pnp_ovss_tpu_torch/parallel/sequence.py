"""Sequence-parallel ViT encode (counterpart of
``pnp_ovss_tpu/parallel/sequence.py``).

The token axis of the ViT encode is split over the ranks of a sequence
group (``parallel/mesh.py``): the patch embed runs on every rank, each rank
keeps a contiguous chunk of tokens, every block's LayerNorms, products and
MLP touch its own rows only, and each layer's attention gathers K/V from
every rank, so that each query row sees the whole sequence through kernel
K7 (``models/vit.py``). Each query row visits the keys in the unsharded
kernel's order, so the sharded encode matches the unsharded one.
"""

from __future__ import annotations

import torch

from pnp_ovss_tpu_torch.models.vit import VisionTransformer
from pnp_ovss_tpu_torch.parallel.mesh import SequenceGroup


@torch.no_grad()
def encode_images_sp(vit: VisionTransformer, images: torch.Tensor,
                     group: SequenceGroup) -> torch.Tensor:
    """[B, H, W, 3] normalised NHWC images, the same on every rank of
    ``group`` -> the full [B, seq_len, hidden] embeddings on every rank."""
    return vit(images, sp=group)
