"""The segmentation runner's GradCAM replayed from CUDA graphs.

Every drop round makes one call of fixed shape: the BERT forward over the
round's image embeddings, the tap backward (``torch.autograd.grad``), the
GradCAM combine of ``gradcam_at_tap`` and the selection of the runner's
layer and head. Launched op by op through autograd, that call costs the
host more time than the card spends on it, so the host sets the pace of
a batch. ``GradcamGraphs`` captures it once per input shape and replays
it in every later round.

Capture follows PyTorch's whole-network recipe: a few warm-up calls on a
side stream, then ``torch.cuda.graph`` into one private memory pool that
all of a holder's graphs share, with static inputs and a static zero tap
allocated once per shape. A call copies its inputs into the static ones,
replays on the current stream (in order with the work queued around it,
so a replay never overtakes the reads of the previous one) and returns
clones of the static outputs: nothing the caller keeps lies in the pool.
At most ``MAX_GRAPHS`` shapes are kept; a call of any further shape runs
eagerly.

Only an unsharded model on a CUDA device is graphed (``graphable``). Under
tensor parallelism GradCAM gathers heads over the model group, and that
call stays eager; the CPU runs eagerly too. The sequence- and pipeline-
parallel encodes split only the ViT, so their BERT is whole and graphed.

Counters: ``bert.graph_captures`` (graphs captured), ``bert.graph_replays``
(graphed calls), ``bert.graph_eager`` (calls past the cached shapes, run
eagerly); the span ``bert.capture`` covers a capture and its warm-up.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from pnp_ovss_tpu_torch.attribution.gradcam import gradcam_at_tap, zero_tap
from pnp_ovss_tpu_torch.utils.tracing import TRACER

# Shapes kept: the CLI's full batch and its last short one, and one more.
MAX_GRAPHS = 3
# Eager calls on a side stream before a capture (lazy cuBLAS and autograd
# set-up happen outside the graph).
WARMUP_CALLS = 3


def graphable(model, device) -> bool:
    """Whether the runner's GradCAM of ``model`` on ``device`` is replayed
    from graphs: a CUDA device and no tensor parallelism."""
    return torch.device(device).type == "cuda" and \
        getattr(model, "tp", None) is None


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]  # static embeds, ids, mask
    tap: torch.Tensor  # static zero tap
    outputs: Tuple[torch.Tensor, torch.Tensor]  # gradcam, logits (pool)


class GradcamGraphs:
    """fn(embeds [B, S, w], ids [B, T], mask [B, T]) -> (gradcam [B, T-1,
    grid, grid] f32 of ``head`` in the model's first captured layer,
    logits [B, 2]): ``gradcam_from_embeds`` and that selection, replayed
    from a CUDA graph per input shape."""

    def __init__(self, model, *, grid: int, head: int):
        self.model, self.grid, self.head = model, grid, head
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None

    def _call(self, tap, embeds, ids, mask):
        gc, logits = gradcam_at_tap(self.model, tap, embeds, ids, mask,
                                    grid=self.grid)
        return gc[0, :, self.head], logits

    def __call__(self, embeds: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor):
        key = tuple((tuple(x.shape), x.dtype) for x in (embeds, ids, mask))
        entry = self._graphs.get(key)
        if entry is None:
            if len(self._graphs) >= MAX_GRAPHS:
                TRACER.count("bert.graph_eager")
                b, t = ids.shape
                tap = zero_tap(self.model, b, t, embeds.shape[1],
                               embeds.device)
                return self._call(tap, embeds, ids, mask)
            with TRACER.span("bert.capture"):
                entry = self._graphs[key] = self._capture(embeds, ids, mask)
            TRACER.count("bert.graph_captures")
        for static, x in zip(entry.inputs, (embeds, ids, mask)):
            static.copy_(x)
        entry.graph.replay()
        TRACER.count("bert.graph_replays")
        return tuple(out.clone(memory_format=torch.contiguous_format)
                     for out in entry.outputs)

    def _capture(self, embeds, ids, mask) -> _Graph:
        inputs = tuple(x.clone() for x in (embeds, ids, mask))
        b, t = ids.shape
        tap = zero_tap(self.model, b, t, embeds.shape[1], embeds.device)
        here = torch.cuda.current_stream(embeds.device)
        side = torch.cuda.Stream(embeds.device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self._call(tap, *inputs)
        here.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            outputs = self._call(tap, *inputs)
        return _Graph(graph, inputs, tap, outputs)
