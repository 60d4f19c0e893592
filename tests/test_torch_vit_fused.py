"""The port's fused ViT block (kernels K1, K3, K4) vs the JAX package.

Inputs are numpy arrays from a seed, handed to both packages. The JAX side
runs at its default settings, so its fused ViT path is on, with the Pallas
kernels in interpret mode on the CPU; the port runs the kernels' plain
versions (CPU tensors). The CUDA kernels themselves are held against the
same plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.models import vit as jax_vit
from pnp_ovss_tpu.models.blip_itm import BlipITM as JaxBlipITM
from pnp_ovss_tpu.models.blip_itm import init_params
from pnp_ovss_tpu.ops import flash_attention as jax_flash
from pnp_ovss_tpu.ops import vit_block_pallas as jax_vbp
from pnp_ovss_tpu.pipeline.runner import SegmentationRunner as JaxRunner
from pnp_ovss_tpu.text.captions import build_caption_batch
from pnp_ovss_tpu.text.wordpiece import WordPieceTokenizer
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.models import vit as port_vit
from pnp_ovss_tpu_torch.models.convert import from_jax_params
from pnp_ovss_tpu_torch.ops import flash_attention as port_flash
from pnp_ovss_tpu_torch.ops import vit_block as port_vb
from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

NMS = ["dog", "cat", "grass", "sky"]
# Whole encodes in f32: LayerNorm, softmax and product sums are taken in
# other orders on the two sides (tests/test_vit_fused.py's bar).
TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of O(1) values


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _bf16_np(x):
    """float32 numpy -> the bf16 values as float32 numpy (both sides then
    start from the same bf16 inputs)."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16() \
        .float().numpy()


def _ln_inputs(rng, m, d):
    x = rng.randn(m, d).astype(np.float32)
    g = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_matmul_plain_matches_jax_kernel(dtype):
    """K1 plain vs ``ln_matmul``: ragged m = 300 (not a row-block
    multiple). f32 at tests/test_vit_fused.py's 2e-5; bf16 1e-2."""
    rng = np.random.RandomState(3)
    m, d, n = 300, 128, 384
    x, g, b = _ln_inputs(rng, m, d)
    w = (rng.randn(d, n) * 0.05).astype(np.float32)
    bias = (rng.randn(n) * 0.05).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    if dtype == "bfloat16":
        x, w, bias = _bf16_np(x), _bf16_np(w), _bf16_np(bias)
    want = np.asarray(jax_vbp.ln_matmul(
        jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b),
        jnp.asarray(w, jdt), jnp.asarray(bias, jdt), out_dtype=jdt),
        np.float32)
    got = port_vb.ln_matmul(_t(x).to(tdt), _t(g), _t(b), _t(w.T).to(tdt),
                            _t(bias).to(tdt))
    assert got.shape == (m, n) and got.dtype == tdt
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_mlp_residual_plain_matches_jax_kernel(dtype):
    """K3 plain vs ``ln_mlp_residual``: the same erf on both sides, so f32
    differs only in summation order (1e-4); bf16 1e-2."""
    rng = np.random.RandomState(4)
    m, d, f = 520, 128, 512
    x, g, b = _ln_inputs(rng, m, d)
    w1 = (rng.randn(d, f) * 0.05).astype(np.float32)
    b1 = (rng.randn(f) * 0.05).astype(np.float32)
    w2 = (rng.randn(f, d) * 0.05).astype(np.float32)
    b2 = (rng.randn(d) * 0.05).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    if dtype == "bfloat16":
        x, w1, b1, w2, b2 = map(_bf16_np, (x, w1, b1, w2, b2))
    want = np.asarray(jax_vbp.ln_mlp_residual(
        jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b),
        jnp.asarray(w1, jdt), jnp.asarray(b1, jdt), jnp.asarray(w2, jdt),
        jnp.asarray(b2, jdt), out_dtype=jdt), np.float32)
    got = port_vb.ln_mlp_residual(
        _t(x).to(tdt), _t(g), _t(b), _t(w1.T).to(tdt), _t(b1).to(tdt),
        _t(w2.T).to(tdt), _t(b2).to(tdt))
    assert got.shape == (m, d) and got.dtype == tdt
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _all_finite_bf16():
    codes = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    y = torch.from_numpy(codes.view(np.int16)).view(torch.bfloat16)
    return y[torch.isfinite(y)]


def test_bf16_gelu_matches_jax_on_every_finite_code():
    """The bf16 gelu against the JAX kernels' ``_gelu_exact`` run op by op
    (each step rounded to bf16, as its source reads) on all finite bf16
    codes: bit-equal wherever the result is a normal number. XLA on the
    CPU flushes subnormals to zero, so the 508 codes that differ all have
    results at most the smallest normal f32 on both sides."""
    y = _all_finite_bf16()
    want = np.asarray(jax_vbp._gelu_exact(
        jnp.asarray(y.float().numpy(), jnp.bfloat16)), np.float32)
    got = port_vb.gelu_exact(y).float().numpy()
    tiny = np.finfo(np.float32).tiny
    diff = got != want
    assert diff.sum() <= 508, diff.sum()
    assert np.abs(got[diff]).max() <= tiny
    assert np.abs(want[diff]).max() <= tiny


def test_bf16_gelu_vs_jitted_jax():
    """Under ``jax.jit`` XLA may keep bf16 intermediates in f32 (excess
    precision), and then the jitted ``_gelu_exact``, as the interpret-mode
    kernel runs it, and the port (and the op-by-op JAX function above)
    round differently: on 85 codes with normal results, all at |y| < 2.5,
    by at most 7.8e-3 absolute (one bf16 ulp of gelu(1.94) = 1.89); every
    other normal code is bit-equal."""
    y = _all_finite_bf16()
    want = np.asarray(jax.jit(jax_vbp._gelu_exact)(
        jnp.asarray(y.float().numpy(), jnp.bfloat16)), np.float32)
    got = port_vb.gelu_exact(y).float().numpy()
    tiny = np.finfo(np.float32).tiny
    yn = y.float().numpy()
    normal = (np.abs(yn) >= tiny) & (np.abs(want) >= tiny) \
        & (np.abs(got) >= tiny)
    diff = normal & (got != want)
    assert diff.sum() <= 85, diff.sum()
    assert np.abs(got[diff] - want[diff]).max() <= 7.9e-3
    assert np.abs(yn[diff]).max() < 2.5


def test_f32_gelu_matches_jax():
    """The f32 gelu (erf with the erfc tail) within 2e-6 of JAX's, across
    and beyond the bf16 clamp zone."""
    ys = np.concatenate([np.linspace(-8, 8, 8001),
                         np.linspace(2.9, 3.5, 2001)]).astype(np.float32)
    want = np.asarray(jax_vbp._gelu_exact(jnp.asarray(ys)))
    got = port_vb.gelu_exact(torch.from_numpy(ys)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,d,dm,tl", [(1, 160, 4, 64, 256, 145),
                                           (2, 577, 2, 64, 128, None)],
                         ids=["one_block", "multi_block"])
def test_qkv_proj_plain_matches_jax_kernel(b, s, h, d, dm, tl, dtype):
    """K4 plain vs ``flash_mha_qkv_proj``, with a padded carry (true_len
    < S) and at 577 tokens (two k-blocks); tests/test_ops.py's bars."""
    rng = np.random.RandomState(1)
    qkv = rng.randn(b, s, 3 * h * d).astype(np.float32)
    x = rng.randn(b, s, dm).astype(np.float32)
    pk = (rng.randn(h * d, dm) * 0.02).astype(np.float32)
    pb = (rng.randn(dm) * 0.02).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    if dtype == "bfloat16":
        qkv, x, pk, pb = map(_bf16_np, (qkv, x, pk, pb))
    want = np.asarray(jax_flash.flash_mha_qkv_proj(
        jnp.asarray(qkv, jdt), jnp.asarray(x, jdt), jnp.asarray(pk, jdt),
        jnp.asarray(pb, jdt), num_heads=h, out_dtype=jdt, true_len=tl),
        np.float32)
    got = port_flash.flash_mha_qkv_proj(
        _t(qkv).to(tdt), _t(x).to(tdt), _t(pk.T).to(tdt), _t(pb).to(tdt),
        num_heads=h, true_len=tl)
    rows = tl or s
    assert got.shape == (b, s, dm) and got.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got[:, :rows].float().numpy(),
                               want[:, :rows], **tol)


def test_proj_fold_routing_matches_jax():
    """K4 is on iff the true length needs more than one 512-key block,
    as the JAX package's auto rule decides."""
    for tl in (145, 442, 443, 512, 513, 577, 2305):
        assert port_flash.proj_fold_enabled(tl) == \
            jax_flash.proj_fold_enabled(tl), tl
    assert not port_flash.proj_fold_enabled(442)
    assert port_flash.proj_fold_enabled(2305)


def _configs(image_size: int):
    """Narrow configs the fused kernels take: width 128, 2 heads of 64;
    192 px -> 145 tokens (K1/K2/K3), 384 px -> 577 tokens (K1/K4/K3)."""
    tiny = jcfg_mod.ModelConfig.tiny()
    vit_kw = dict(dataclasses.asdict(tiny.vit), image_size=image_size,
                  hidden_size=128, num_heads=2)
    bert_kw = dict(dataclasses.asdict(tiny.bert), encoder_width=128)
    jcfg = jcfg_mod.ModelConfig(vit=jcfg_mod.ViTConfig(**vit_kw),
                                bert=jcfg_mod.BertConfig(**bert_kw),
                                embed_dim=16, max_text_len=16)
    pcfg = pcfg_mod.ModelConfig(vit=pcfg_mod.ViTConfig(**vit_kw),
                                bert=pcfg_mod.BertConfig(**bert_kw),
                                max_text_len=16)
    return jcfg, pcfg


@pytest.fixture(scope="module", params=[192, 384], ids=["192px", "384px"])
def encodes(request):
    """JAX fused encode, port fused and unfused encodes, same weights."""
    jcfg, pcfg = _configs(request.param)
    assert jax_vit.fused_path_supported(jcfg.vit, "pallas")
    assert port_vit.fused_path_supported(pcfg.vit)
    params = init_params(jax.random.PRNGKey(0), jcfg, capture_layers=(0,))
    jmodel = JaxBlipITM(jcfg, capture_layers=(0,), attn_impl="pallas")
    images = np.random.RandomState(0).randn(
        2, request.param, request.param, 3).astype(np.float32)
    fn = jax.jit(functools.partial(jmodel.apply,
                                   method=JaxBlipITM.encode_image))
    want = np.asarray(fn(params, jnp.asarray(images)), np.float32)
    tree = jax.tree.map(np.asarray, params)
    got = {}
    for fused in (True, False):
        model = from_jax_params(tree, pcfg, capture_layer=0, device="cpu",
                                vit_fused=fused)
        assert model.visual_encoder.fused == fused
        got[fused] = model.encode_image(torch.from_numpy(images)).numpy()
    return pcfg, want, got


def test_fused_encode_matches_jax(encodes):
    pcfg, want, got = encodes
    assert got[True].shape == (2, pcfg.vit.seq_len, pcfg.vit.hidden_size)
    np.testing.assert_allclose(got[True], want, **TOL)


def test_fused_encode_matches_unfused(encodes):
    _, _, got = encodes
    np.testing.assert_allclose(got[True], got[False], **TOL)


def test_tiny_config_takes_the_unfused_block():
    """Width 32 is not a 128 multiple: both packages route the tiny config
    to the unfused block, whatever the switch says."""
    jcfg, pcfg = jcfg_mod.ModelConfig.tiny(), pcfg_mod.ModelConfig.tiny()
    assert not jax_vit.fused_path_supported(jcfg.vit, "pallas")
    assert not port_vit.fused_path_supported(pcfg.vit)
    enc = port_vit.VisionTransformer(pcfg.vit, fused=True)
    assert not enc.fused
    assert all(type(b) is port_vit.ViTBlock for b in enc.blocks)
    _, narrow = _configs(192)
    enc = port_vit.VisionTransformer(narrow.vit)
    assert enc.fused
    assert all(isinstance(b, port_vit.ViTBlockFused) for b in enc.blocks)


B, BUCKET = 4, 32


@pytest.fixture(scope="module")
def pipelines():
    """The narrow fused pipeline (192 px ViT) through both runners at
    their defaults, blur + strided s=4 CRF at bucket 32."""
    jmodel_cfg, pmodel_cfg = _configs(192)
    out = []
    for mod, model_cfg in ((jcfg_mod, jmodel_cfg), (pcfg_mod, pmodel_cfg)):
        cfg = mod.PipelineConfig.tiny()
        out.append(dataclasses.replace(
            cfg, batch_size=B, model=model_cfg,
            attribution=dataclasses.replace(cfg.attribution, layer=1,
                                            head=1)))
    jcfg, pcfg = out
    params = init_params(jax.random.PRNGKey(0), jcfg.model,
                         capture_layers=(0,))
    tok = WordPieceTokenizer.toy(["a", "picture", "of"] + NMS)
    cap = build_caption_batch(
        [["dog", "grass"], ["cat"], ["sky", "dog", "cat"], ["grass"]], tok,
        max_text_len=jcfg.model.max_text_len, max_classes=jcfg.max_classes)
    rng = np.random.RandomState(42)
    images = rng.randint(0, 256, (B, jcfg.img_size, jcfg.img_size, 3)) \
        .astype(np.uint8)
    rgb = rng.randint(0, 255, (B, BUCKET, BUCKET, 3)).astype(np.float32)
    gt = [(375, 500), (500, 375), (300, 300), (240, 320)]
    jrun = JaxRunner(jcfg, params, attn_impl="pallas", bucket_size=BUCKET,
                     bilateral_impl="pallas")
    want = jrun.run_batch(images, cap, rgb, return_maps=True, gt_sizes=gt)
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg.model,
                            capture_layer=0, device="cpu")
    assert model.visual_encoder.fused
    prun = SegmentationRunner(pcfg, model, device="cpu", bucket_size=BUCKET)
    got = prun.run_batch(images, cap, rgb, return_maps=True, gt_sizes=gt)
    return want, got


def test_fused_pipeline_maps_match_jax_runner(pipelines):
    """tests/test_golden.py's bar: map sums within rtol 1e-3."""
    want, got = pipelines
    for name in ("maps_r0", "maps_agg"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape == (B, 4, BUCKET, BUCKET)
        assert np.abs(b).sum() > 0
        np.testing.assert_allclose(a.sum(axis=(2, 3)), b.sum(axis=(2, 3)),
                                   rtol=1e-3, atol=1e-5)


def test_fused_pipeline_labels_match_jax_runner(pipelines):
    """More than 99.5% of labels equal (top-k and threshold ties may flip
    a few)."""
    want, got = pipelines
    for name in ("labels_r0", "labels_agg"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape == (B, BUCKET, BUCKET)
        assert (a == b).mean() > 0.995, (name, (a == b).mean())
    assert len(np.unique(got.labels_agg)) > 1


def test_runner_at_grid_48_matches_jax_runner():
    """bench.py's 768 px leg at narrow width: 48 x 48 patches + CLS =
    2305 tokens, so the fused ViT runs K1 / K4 / K3 on both sides, and
    the drop masks, pooling and GradCAM work on a grid of 48."""
    jmodel_cfg, pmodel_cfg = _configs(768)
    cfgs = []
    for mod, model_cfg in ((jcfg_mod, jmodel_cfg), (pcfg_mod, pmodel_cfg)):
        cfg = mod.PipelineConfig.tiny()
        cfgs.append(dataclasses.replace(
            cfg, batch_size=1, model=model_cfg,
            attribution=dataclasses.replace(cfg.attribution, layer=1,
                                            head=1)))
    jcfg, pcfg = cfgs
    assert pcfg.model.vit.grid == 48 and pcfg.model.vit.seq_len == 2305
    params = init_params(jax.random.PRNGKey(0), jcfg.model,
                         capture_layers=(0,))
    tok = WordPieceTokenizer.toy(["a", "picture", "of"] + NMS)
    cap = build_caption_batch([["dog", "grass", "sky"]], tok,
                              max_text_len=jcfg.model.max_text_len,
                              max_classes=jcfg.max_classes)
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (1, 768, 768, 3)).astype(np.uint8)
    rgb = rng.randint(0, 255, (1, BUCKET, BUCKET, 3)).astype(np.float32)
    gt = [(375, 500)]
    want = JaxRunner(jcfg, params, attn_impl="pallas", bucket_size=BUCKET,
                     bilateral_impl="pallas").run_batch(
        images, cap, rgb, return_maps=True, gt_sizes=gt)
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg.model,
                            capture_layer=0, device="cpu")
    got = SegmentationRunner(pcfg, model, device="cpu",
                             bucket_size=BUCKET).run_batch(
        images, cap, rgb, return_maps=True, gt_sizes=gt)
    for name in ("maps_r0", "maps_agg"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape == (1, 4, BUCKET, BUCKET)
        assert np.abs(b).sum() > 0
        np.testing.assert_allclose(a.sum(axis=(2, 3)), b.sum(axis=(2, 3)),
                                   rtol=1e-3, atol=1e-5)
    for name in ("labels_r0", "labels_agg"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a == b).mean() > 0.995, (name, (a == b).mean())
