"""The port's Megatron tensor parallelism against the JAX package's
(``tests/test_tensor_parallel.py``).

The port's copy of the partition table is held against the JAX
``param_partition_specs`` leaf for leaf; the GradCAM step and the whole
runner run on spawned gloo CPU ranks (one spawn of four for the module,
``tests/test_torch_sp_ranks.py``), each ``parallel.tensor.shard_model``
-ed over the model axis, against the JAX package's unsharded functions on
the same weights (``from_jax_params``). Bars are the JAX test's: 1e-5 on
f32 GradCAM and logits, labels within 0.1%. TP sums the row-parallel
products in another order than the unsharded product, so it is not bit
for bit equal. The narrow fused ViT block under TP is held against the
port's unsharded block, with the attention route each local head count
takes (K2' for two local heads, K9 for one).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.attribution.gradcam import gradcam_from_tap
from pnp_ovss_tpu.models.blip_itm import BlipITM, init_params
from pnp_ovss_tpu.parallel import mesh as jax_mesh
from pnp_ovss_tpu.pipeline.runner import SegmentationRunner as JaxRunner
from pnp_ovss_tpu.text.captions import build_caption_batch
from pnp_ovss_tpu.text.wordpiece import WordPieceTokenizer
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.models.convert import from_jax_params
from pnp_ovss_tpu_torch.models.vit import VisionTransformer
from pnp_ovss_tpu_torch.parallel import mesh as port_mesh
from pnp_ovss_tpu_torch.parallel.tensor import shard_model
from test_torch_sp_ranks import run_ranks

NMS = ["dog", "cat", "grass", "sky"]
B = 8
HEAD = 1


def _tiny4(mod):
    """ModelConfig.tiny() with 4 heads in the ViT and BERT (of width 8),
    so that tp = 2 and 4 divide the head counts."""
    tiny = mod.ModelConfig.tiny()
    return dataclasses.replace(
        tiny, vit=dataclasses.replace(tiny.vit, num_heads=4),
        bert=dataclasses.replace(tiny.bert, num_heads=4))


def _gradcam_inputs(cfg):
    rng = np.random.RandomState(0)
    images = rng.rand(B, cfg.vit.image_size, cfg.vit.image_size,
                      3).astype(np.float32)
    ids = np.zeros((B, cfg.max_text_len), np.int32)
    mask = np.zeros_like(ids)
    ids[:, :8] = rng.randint(3, 100, (B, 8))
    ids[:, 0] = cfg.bert.enc_token_id
    mask[:, :8] = 1
    return images, ids, mask


def _runner_cfg(mod):
    cfg = mod.PipelineConfig.tiny()
    return dataclasses.replace(
        cfg,
        attribution=dataclasses.replace(cfg.attribution, layer=1, head=1),
        postprocess=mod.PostprocessConfig(
            mode="blur+crf", crf=mod.CRFConfig(num_iters=2)),
        batch_size=B)


def _runner_inputs(cfg):
    tok = WordPieceTokenizer.toy(["a", "picture", "of"] + NMS)
    rng = np.random.RandomState(0)
    images = rng.rand(B, cfg.img_size, cfg.img_size, 3).astype(np.float32)
    cap = build_caption_batch(
        [[NMS[i % 3], NMS[(i + 1) % 4]] for i in range(B)], tok,
        max_text_len=cfg.model.max_text_len, max_classes=cfg.max_classes)
    rgb = rng.randint(0, 255, (B, 32, 32, 3)).astype(np.float32)
    return images, cap, rgb


def _narrow_vit(heads):
    return pcfg_mod.ViTConfig(image_size=192, hidden_size=64 * heads,
                              num_layers=2, num_heads=heads,
                              dtype="float32")


# --- rank functions (run in the spawned ranks) -------------------------


def rank_gradcam(mesh, model, inputs, model_parallel):
    """The GradCAM step (layer 1, head ``HEAD``) with the model sharded
    over a (data, model = ``model_parallel``) mesh of this world."""
    from pnp_ovss_tpu_torch.attribution.gradcam import gradcam_from_tap \
        as port_gradcam

    if mesh.model != model_parallel:
        mesh = port_mesh.make_mesh_2d(model_parallel,
                                      ["cpu"] * mesh.world_size,
                                      rank=mesh.rank, init_method=None)
    shard_model(model, mesh)
    images, ids, mask = (torch.from_numpy(x) for x in inputs)
    gc, logits = port_gradcam(model, images, ids.long(), mask,
                              grid=model.cfg.vit.grid)
    return dict(gc=gc[0, :, HEAD].numpy(), logits=logits.numpy(),
                qkv=tuple(model.visual_encoder.blocks[0].attn.qkv.weight
                          .shape),
                query=tuple(model.text_encoder.layers[0].attention.query
                            .weight.shape))


def rank_runner(mesh, cfg, model, inputs):
    """One batch of the runner over data 2 x model 2: each data index on
    its half of the batch."""
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

    mesh = port_mesh.make_mesh_2d(2, ["cpu"] * mesh.world_size,
                                  rank=mesh.rank, init_method=None)
    images, cap, rgb = inputs
    half = B // mesh.data
    rows = slice(mesh.data_rank * half, (mesh.data_rank + 1) * half)
    cap = dataclasses.replace(cap, **{
        k: getattr(cap, k)[rows] for k in (
            "input_ids", "attention_mask", "pool_matrix", "class_valid",
            "num_classes")}, class_names=cap.class_names[rows])
    runner = SegmentationRunner(cfg, model, device="cpu", bucket_size=32,
                                mesh=mesh)
    res = runner.run_batch(images[rows], cap, rgb[rows],
                           gt_sizes=[(40, 52)] * half)
    return dict(rows=(rows.start, rows.stop), labels_r0=res.labels_r0,
                labels_agg=res.labels_agg)


def rank_vit_route(mesh, vit, images):
    """The narrow fused encode with the ViT sharded over a model axis of
    2, and which attention entry each layer took."""
    from pnp_ovss_tpu_torch.models import vit as vit_mod
    from pnp_ovss_tpu_torch.ops import flash_attention

    if mesh.model != 2:
        mesh = port_mesh.make_mesh_2d(2, ["cpu"] * mesh.world_size,
                                      rank=mesh.rank, init_method=None)
    calls = {"flash_mha_flat": 0, "flash_mha": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    flat, bhsd = vit_mod.flash_mha_flat, flash_attention.flash_mha
    vit_mod.flash_mha_flat = spy("flash_mha_flat", flat)
    flash_attention.flash_mha = spy("flash_mha", bhsd)
    try:
        shard_model(vit, mesh)
        with torch.no_grad():
            out = vit(images, tp=mesh.model_axis)
    finally:
        vit_mod.flash_mha_flat, flash_attention.flash_mha = flat, bhsd
    return dict(out=out.numpy(), calls=calls)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of four CPU ranks for every case, with the JAX and the
    port's unsharded references made here."""
    tmp = tmp_path_factory.mktemp("tp")
    tasks, want = {}, {}

    jcfg = _tiny4(jcfg_mod)
    pcfg = _tiny4(pcfg_mod)
    params = init_params(jax.random.PRNGKey(0), jcfg, capture_layers=(0,),
                         attn_impl="xla")
    inputs = _gradcam_inputs(jcfg)
    model = BlipITM(jcfg, capture_layers=(0,), attn_impl="xla")

    def step(p, im, i, m):
        gc, logits = gradcam_from_tap(
            lambda p_, im_, i_, m_, cross_tap: model.apply(
                p_, im_, i_, m_, cross_tap=cross_tap),
            p, im, i, m, num_capture_layers=1,
            num_heads=jcfg.bert.num_heads,
            num_image_tokens=jcfg.vit.seq_len, grid=jcfg.vit.grid)
        return gc[0, :, HEAD], logits

    gc, logits = jax.jit(step)(params, *(jnp.asarray(x) for x in inputs))
    want["gradcam"] = (np.asarray(gc), np.asarray(logits))
    np_params = jax.tree.map(np.asarray, params)
    for tp in (2, 4):
        tasks[f"gradcam{tp}"] = (
            "call", rank_gradcam,
            from_jax_params(np_params, pcfg, capture_layers=(0,),
                            device="cpu", vit_fused=False), inputs, tp)

    jr = _runner_cfg(jcfg_mod)
    pr = _runner_cfg(pcfg_mod)
    rparams = init_params(jax.random.PRNGKey(0), jr.model,
                          capture_layers=(0,))
    rinputs = _runner_inputs(jr)
    want["runner"] = JaxRunner(jr, rparams, attn_impl="xla", bucket_size=32,
                               bilateral_impl="reference").run_batch(
        *rinputs, gt_sizes=[(40, 52)] * B)
    tasks["runner"] = ("call", rank_runner, pr, from_jax_params(
        jax.tree.map(np.asarray, rparams), pr.model, capture_layers=(0,),
        device="cpu", vit_fused=False), rinputs)

    images = torch.from_numpy(np.random.RandomState(3).rand(
        2, 192, 192, 3).astype(np.float32))
    for heads in (2, 4):
        torch.manual_seed(heads)
        vit = VisionTransformer(_narrow_vit(heads)).requires_grad_(False)
        assert vit.fused
        for p in vit.parameters():
            p.normal_(0, 0.05)
        with torch.no_grad():
            want[f"vit{heads}"] = vit(images).numpy()
        tasks[f"vit{heads}"] = ("call", rank_vit_route, vit, images)
    return run_ranks(tasks, ["cpu"] * 4, tmp), want


def test_partition_specs_match_jax_leaf_for_leaf():
    """The port's table on the tiny ``init_params`` draw gives the axis
    of each JAX spec, at tp = 2 and at tp = 5 (indivisible leaves
    replicate)."""
    params = init_params(jax.random.PRNGKey(0), jcfg_mod.ModelConfig.tiny(),
                         capture_layers=(1,), attn_impl="xla")
    for tp in (2, 5):
        specs = jax_mesh.param_partition_specs(params, model_parallel=tp)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))
        want = {"/".join(k.key for k in path): (
            spec.index("model") if "model" in spec else None)
            for path, spec in flat}
        got = port_mesh.param_partition_specs(
            jax.tree.map(np.asarray, params), tp)
        assert got == want
        assert any(v is not None for v in got.values()) == (tp == 2)


@pytest.mark.parametrize("path,shape,want", [
    ("enc/key/kernel", (8, 8), 1),
    ("enc/key_pool/kernel", (8, 8), None),
    ("enc/value_head/bias", (8,), None),
    ("blocks/attn/proj/kernel", (8, 8), 0),
    ("blocks/proj/kernel", (8, 8), None),
    ("query/kernel_stats/scale", (8, 8), None),
])
def test_partition_spec_segment_matching(path, shape, want):
    """Rules match whole path segments (``tests/test_tensor_parallel.py``
    :79-92): 'key_pool' is not 'key', 'attn/proj' needs its 'attn'
    parent, 'kernel' must be the leaf."""
    assert port_mesh._leaf_spec(path, shape, 2) == want
    jax_spec = jax_mesh._leaf_spec(path, shape, 2)
    assert (jax_spec.index("model") if "model" in jax_spec else None) == want


@pytest.mark.parametrize("tp", [2, 4])
def test_gradcam_step_matches_unsharded_jax(ranks, tp):
    """tp ranks (data = 4/tp) each hold 4/tp heads and 1/tp of every
    column and row slab; every rank returns the unsharded JAX GradCAM
    and logits within 1e-5."""
    outs, want = ranks
    gc_want, logits_want = want["gradcam"]
    assert np.abs(gc_want).max() > 1e-3
    for out in outs:
        got = out[f"gradcam{tp}"]
        assert got["qkv"] == (96, 32)  # the ViT's fused qkv: replicated
        assert got["query"] == (32 // tp, 32)  # BERT q: column slab
        np.testing.assert_allclose(got["gc"], gc_want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["logits"], logits_want, rtol=0,
                                   atol=1e-5)


def test_runner_dp_tp_matches_unsharded_jax(ranks):
    """data 2 x model 2: each data index's labels against the JAX
    unsharded runner's rows, within 0.1%; the model ranks agree."""
    outs, want = ranks
    ref = want["runner"]
    for r, out in enumerate(outs):
        got = out["runner"]
        lo, hi = got["rows"]
        assert (lo, hi) == ((0, 4) if r < 2 else (4, 8))
        for name in ("labels_r0", "labels_agg"):
            assert (got[name] != getattr(ref, name)[lo:hi]).mean() <= 0.001
        partner = outs[r ^ 1]["runner"]
        np.testing.assert_array_equal(got["labels_agg"],
                                      partner["labels_agg"])


@pytest.mark.parametrize("heads,route", [(2, "flash_mha"),
                                         (4, "flash_mha_flat")])
def test_fused_block_under_tp_matches_unsharded(ranks, heads, route):
    """The narrow fused ViT (192 px, heads of 64, f32) at tp = 2 against
    its unsharded encode: K1's replicated qkv, attention on the local
    heads, LN2 + the fc1 slab through K1, proj and mlp_fc2 as reduced row
    slabs. Two heads leave one a
    rank, which the flat kernel's head-pair rule sends to K9; four leave
    two, K2' on the column views (one call a layer)."""
    outs, want = ranks
    for out in outs:
        got = out[f"vit{heads}"]
        assert got["calls"] == {"flash_mha_flat": 0, "flash_mha": 0,
                                route: 2}
        np.testing.assert_allclose(got["out"], want[f"vit{heads}"],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("vit_heads,bert_heads,tp", [
    (2, 2, 4), (16, 12, 8), (16, 12, 3)])
def test_tp_must_divide_the_head_counts(vit_heads, bert_heads, tp):
    """GSPMD reshards split heads; the port raises instead, before any
    collective (so no process group is needed here)."""
    tiny = pcfg_mod.ModelConfig.tiny()
    cfg = dataclasses.replace(
        tiny, vit=dataclasses.replace(tiny.vit, num_heads=vit_heads,
                                      hidden_size=8 * vit_heads),
        bert=dataclasses.replace(tiny.bert, num_heads=bert_heads,
                                 hidden_size=8 * bert_heads))
    from pnp_ovss_tpu_torch.models.blip_itm import BlipITM as PortBlip

    model = PortBlip(cfg, capture_layers=(0,))
    axis = port_mesh.AxisGroup(None, tp, 0)
    mesh = port_mesh.ProcessMesh(world_size=tp, rank=0, data=1, model=tp,
                                 backend="gloo", data_axis=axis,
                                 model_axis=axis)
    with pytest.raises(ValueError, match="does not divide"):
        shard_model(model, mesh)
    assert model.visual_encoder.blocks[0].mlp_fc1.weight.shape[0] == \
        32 * vit_heads
