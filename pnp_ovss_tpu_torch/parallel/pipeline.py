"""Pipeline-parallel ViT encode (counterpart of
``pnp_ovss_tpu/parallel/pipeline.py``).

GPipe over the ViT's block stack: the ``pp`` ranks of a model group are
stages, stage ``s`` owns blocks ``[s * L/pp, (s + 1) * L/pp)``, and the
batch flows through them in ``M`` microbatches over ``M + pp - 1`` steps
(bubble ``(pp - 1) / (M + pp - 1)``). At step ``t`` stage ``s`` runs
microbatch ``t - s`` when there is one: stage 0 cuts it from the stem's
output, later stages receive it from the stage before, and every stage
but the last sends its result on. The last stage applies the final
LayerNorm to the whole batch and broadcasts it over the group, so every
stage returns the whole encode, as the unsharded encode does. Each stage
runs the unsharded encode's block modules on its microbatch rows, so
its rows are computed as the unsharded encode computes them.

The stage hand-off is a named transport chosen by the backend: NCCL
sends CUDA tensors card to card; gloo, which sends no CUDA tensors, sends
a host copy, and the receiving stage moves it back to its card. The
kernels run on the card under both. The JAX package's stem runs on every
stage (SPMD); here only stage 0, which uses it, runs it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import distributed as dist
from torch import nn

from pnp_ovss_tpu_torch.models.layers import DTYPES
from pnp_ovss_tpu_torch.models.vit import VisionTransformer
from pnp_ovss_tpu_torch.parallel.mesh import AxisGroup, ProcessMesh


def _stage_span(vit: VisionTransformer, pp: int, stage: int):
    layers = vit.cfg.num_layers
    if layers % pp:
        raise ValueError(f"num_layers={layers} not divisible by pp={pp}")
    n = layers // pp
    return stage * n, (stage + 1) * n


def keep_stage_blocks(vit: VisionTransformer,
                      stages: AxisGroup) -> VisionTransformer:
    """Drop, in place, every block this stage does not own (the JAX
    package's layer-sharded ``pipeline`` strategy): a model moved to the
    card afterwards holds 1/pp of the block stack there."""
    lo, hi = _stage_span(vit, stages.size, stages.rank)
    vit.blocks = nn.ModuleList(vit.blocks[lo:hi])
    return vit


class _Transport:
    """Stage-to-stage sends and the result's broadcast on one backend."""

    def __init__(self, stages: AxisGroup, device: torch.device):
        self.stages = stages
        self.device = device
        self.host = dist.get_backend(stages.group) != "nccl" and \
            device.type == "cuda"

    def send(self, x: torch.Tensor, stage: int) -> None:
        dist.send(x.cpu() if self.host else x.contiguous(),
                  self.stages.global_rank(stage))

    def recv(self, shape, dtype, stage: int) -> torch.Tensor:
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if self.host else self.device)
        dist.recv(buf, self.stages.global_rank(stage))
        return buf.to(self.device)

    def broadcast(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        dist.broadcast(x, self.stages.global_rank(stage),
                       group=self.stages.group)
        return x


@torch.no_grad()
def pipeline_encode(vit: VisionTransformer, images: torch.Tensor,
                    stages: AxisGroup, *,
                    num_microbatches: Optional[int] = None) -> torch.Tensor:
    """[B, H, W, 3] normalised NHWC images, the same on every stage of
    ``stages`` (a model axis) -> the whole [B, seq_len, hidden] encode on
    every stage. ``vit`` holds this stage's blocks (``keep_stage_blocks``).
    ``num_microbatches`` defaults to the pipeline depth."""
    c = vit.cfg
    pp, stage = stages.size, stages.rank
    b = images.shape[0]
    m = num_microbatches if num_microbatches is not None else pp
    if b % m:
        raise ValueError(f"per-device batch {b} not divisible by "
                         f"num_microbatches={m}")
    mb = b // m
    dtype = DTYPES[c.dtype]  # the stem's and the blocks' output dtype
    shape = (mb, c.seq_len, c.hidden_size)
    link = _Transport(stages, images.device)
    x = vit.embed(images) if stage == 0 else None
    out = torch.empty((b,) + shape[1:], dtype=dtype, device=images.device)
    for t in range(m + pp - 1):
        i = t - stage
        if not 0 <= i < m:
            continue  # the bubble: no microbatch at this stage yet
        cur = x[i * mb:(i + 1) * mb] if stage == 0 else \
            link.recv(shape, dtype, stage - 1)
        for blk in vit.blocks:
            cur = blk(cur)
        if stage == pp - 1:
            out[i * mb:(i + 1) * mb] = cur
        else:
            link.send(cur, stage + 1)
    if stage == pp - 1:
        out = vit.norm(out)
    return link.broadcast(out, pp - 1)


def encode_images_pp(vit: VisionTransformer, images: torch.Tensor,
                     mesh: ProcessMesh, *,
                     num_microbatches: Optional[int] = None) -> torch.Tensor:
    """The JAX package's entry: ``images`` [B, H, W, 3] is the global
    batch, the same on every rank; data rank ``d`` encodes rows ``[d *
    B/dp, (d + 1) * B/dp)`` through the pipeline over its model group.
    Returns those rows' [B/dp, seq_len, hidden] encode on every stage: a
    rank holds its data index's rows, as a DDP rank does, where the JAX
    function returns the global array sharded over ``data``. ``vit`` is
    cut to this stage's blocks in place, as the runner cuts it."""
    pp, dp = mesh.model, mesh.data
    _stage_span(vit, pp, 0)
    b = images.shape[0]
    if b % dp:
        raise ValueError(f"batch {b} not divisible by dp={dp}")
    bl = b // dp
    rows = images[mesh.data_rank * bl:(mesh.data_rank + 1) * bl]
    keep_stage_blocks(vit, mesh.model_axis)
    return pipeline_encode(vit, rows, mesh.model_axis,
                           num_microbatches=num_microbatches)
