"""The runner's GradCAM call and its CUDA-graph holder, and the port's
host-to-device copy, on the CPU.

The CPU and a tensor-parallel model stay eager: the runner's
``_bert_gradcam`` there is ``gradcam_from_embeds`` with the layer and head
selection, bit for bit. ``GradcamGraphs``' bookkeeping (a graph per input
shape, at most ``MAX_GRAPHS``, eager calls past them, clones handed back,
its counters and span) runs here with a stand-in graph whose replay
computes the captured call eagerly into the static outputs. The real
capture and replay are held to the eager call on the card
(``tests/test_torch_cuda.py``), as is ``to_device``'s copy through pinned
memory without a wait.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pnp_ovss_tpu_torch import to_device
from pnp_ovss_tpu_torch.attribution import gradcam_graph
from pnp_ovss_tpu_torch.attribution.gradcam import (
    gradcam_at_tap, gradcam_from_embeds, zero_tap,
)
from pnp_ovss_tpu_torch.attribution.gradcam_graph import (
    MAX_GRAPHS, GradcamGraphs, graphable,
)
from pnp_ovss_tpu_torch.config import PipelineConfig
from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm
from pnp_ovss_tpu_torch.parallel.mesh import AxisGroup, ProcessMesh
from pnp_ovss_tpu_torch.parallel.tensor import shard_model
from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner
from pnp_ovss_tpu_torch.utils.tracing import TRACER

HEAD = 1


def _cfg():
    cfg = PipelineConfig.tiny()
    return dataclasses.replace(
        cfg, attribution=dataclasses.replace(cfg.attribution, layer=1,
                                             head=HEAD))


def _model(seed=0, layers=(0,)):
    return init_blip_itm(_cfg().model, capture_layers=layers, seed=seed,
                         device="cpu")


def _inputs(b, t=12, seed=0):
    """Image embeddings of the tiny ViT's shape, caption ids and a mask
    with padded tails."""
    m = _cfg().model
    gen = torch.Generator().manual_seed(seed)
    embeds = torch.randn((b, m.vit.seq_len, m.bert.encoder_width),
                         generator=gen)
    ids = torch.randint(5, m.bert.vocab_size - 2, (b, t), generator=gen)
    ids[:, 0] = m.bert.enc_token_id
    mask = torch.ones((b, t), dtype=torch.int32)
    for i in range(b):
        mask[i, t - 1 - (i % 4):] = 0
    return embeds, ids, mask


def _selected(model, embeds, ids, mask):
    gc, logits = gradcam_from_embeds(model, embeds, ids, mask,
                                     grid=_cfg().model.vit.grid)
    return gc[0, :, HEAD], logits


def test_cpu_runner_bert_gradcam_is_the_eager_selection():
    cfg = _cfg()
    runner = SegmentationRunner(cfg, _model(), device="cpu", bucket_size=32)
    assert runner._graphs is None
    embeds, ids, mask = _inputs(3)
    gc, logits = runner._bert_gradcam(embeds, ids, mask)
    want_gc, want_logits = _selected(runner.model, embeds, ids, mask)
    assert gc.shape == (3, ids.shape[1] - 1, cfg.model.vit.grid,
                        cfg.model.vit.grid)
    assert gc.abs().max() > 0
    assert torch.equal(gc, want_gc) and torch.equal(logits, want_logits)


@pytest.mark.parametrize("layers", [(0,), (0, 1)])
def test_gradcam_at_a_reused_tap_equals_gradcam_from_embeds(layers):
    """One zero tap serves call after call: it is only read, so it stays
    zero and gathers no gradient."""
    model = _model(layers=layers)
    grid = _cfg().model.vit.grid
    embeds, ids, mask = _inputs(2)
    tap = zero_tap(model, 2, ids.shape[1], embeds.shape[1], "cpu")
    assert tap.shape == (len(layers), 2, 2, ids.shape[1], embeds.shape[1])
    for seed in (0, 1):
        embeds, ids, mask = _inputs(2, seed=seed)
        got = gradcam_at_tap(model, tap, embeds, ids, mask, grid=grid)
        want = gradcam_from_embeds(model, embeds, ids, mask, grid=grid)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert tap.grad is None and not tap.any()


def _tp_model(tp):
    model = _model()
    axis = AxisGroup(group=None, size=tp, rank=0)
    mesh = ProcessMesh(world_size=tp, rank=0, data=1, model=tp,
                       backend="gloo", data_axis=AxisGroup(None, 1, 0),
                       model_axis=axis)
    return shard_model(model, mesh)


@pytest.mark.parametrize("device,tp,want", [
    ("cuda", None, True), ("cuda:1", None, True), ("cpu", None, False),
    ("cuda", 1, True), ("cuda", 2, False), ("cpu", 2, False)])
def test_only_an_unsharded_model_on_cuda_is_graphed(device, tp, want):
    """Under tensor parallelism GradCAM gathers heads over the model
    group, so a sharded model (tp = 2) never takes a graph; a model axis of
    one leaves the model whole."""
    model = _model() if tp is None else _tp_model(tp)
    assert (model.tp is not None) == (tp == 2)
    assert graphable(model, torch.device(device)) is want


class _StandInGraph:
    """Replays the captured call eagerly into its static outputs, in
    place, as a CUDA graph writes its pool."""

    def __init__(self, holder, inputs, tap):
        self.run = lambda: holder._call(tap, *inputs)
        self.outputs = tuple(x.clone() for x in self.run())

    def replay(self):
        for static, x in zip(self.outputs, self.run()):
            static.copy_(x)


@pytest.fixture
def holder(monkeypatch):
    def capture(self, embeds, ids, mask):
        inputs = tuple(x.clone() for x in (embeds, ids, mask))
        b, t = ids.shape
        tap = zero_tap(self.model, b, t, embeds.shape[1], embeds.device)
        graph = _StandInGraph(self, inputs, tap)
        return gradcam_graph._Graph(graph, inputs, tap, graph.outputs)

    monkeypatch.setattr(GradcamGraphs, "_capture", capture)
    TRACER.drain()
    TRACER.enable()
    yield GradcamGraphs(_model(), grid=_cfg().model.vit.grid, head=HEAD)
    TRACER.disable()
    TRACER.drain()


def test_holder_returns_results_that_the_next_replay_leaves_alone(holder):
    first_in, second_in = _inputs(2, seed=0), _inputs(2, seed=1)
    first = holder(*first_in)
    kept = [x.clone() for x in first]
    second = holder(*second_in)
    (entry,) = holder._graphs.values()
    for got, want, static in zip(second, _selected(holder.model, *second_in),
                                 entry.outputs):
        assert torch.equal(got, want) and got.is_contiguous()
        assert got.untyped_storage().data_ptr() != \
            static.untyped_storage().data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert not torch.equal(first[0], second[0])


def test_holder_keeps_a_graph_a_shape_and_runs_past_them_eagerly(holder):
    """Batch sizes 1 .. MAX_GRAPHS + 1, then the first again: a capture
    for each of the first MAX_GRAPHS, one eager call, replays for the
    rest; every result equals the eager selection."""
    sizes = list(range(1, MAX_GRAPHS + 2)) + [1]
    for b in sizes:
        inputs = _inputs(b, seed=b)
        got = holder(*inputs)
        want = _selected(holder.model, *inputs)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert len(holder._graphs) == MAX_GRAPHS
    data = TRACER.drain()
    assert data["counters"] == {"bert.graph_captures": MAX_GRAPHS,
                                "bert.graph_replays": len(sizes) - 1,
                                "bert.graph_eager": 1}
    assert [s["name"] for s in data["spans"]] == \
        ["bert.capture"] * MAX_GRAPHS
    # Another text length is another shape, past the cache: eager.
    holder(*_inputs(1, t=9))
    assert TRACER.drain()["counters"] == {"bert.graph_eager": 1}


@pytest.mark.parametrize("x", [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.arange(12, dtype=np.float32).reshape(3, 4)[:, ::2],
    np.full((2, 5, 5, 3), 7, np.uint8), np.asarray(2.5),
    [[True, False, True]], np.arange(6, dtype=np.int64)],
    ids=["f32", "strided", "uint8", "0-d", "bool list", "int64"])
def test_to_device_on_the_cpu_keeps_values_dtype_and_shape(x):
    a = np.asarray(x)
    t = to_device(x, "cpu")
    assert t.device.type == "cpu" and tuple(t.shape) == a.shape
    np.testing.assert_array_equal(t.numpy(), a)
    assert t.numpy().dtype == a.dtype
