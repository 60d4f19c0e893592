"""Port models (pnp_ovss_tpu_torch) vs the JAX package on the same weights.

``from_jax_params`` loads the JAX package's Flax tree into the port; both
then see the same numpy inputs from a seed. The JAX side runs the unfused
ViT block (``PNP_VIT_FUSED=0``, the configuration this port covers) with
its Pallas kernels in interpret mode, and the port its counterpart
(``vit_fused=False``). Two configurations: the tiny one
(head dim 16: plain attention on both sides) and a narrow one that reaches
the flat flash kernel (hidden 128, 2 heads of 64, 192 px -> 145 tokens).
"""

import ast
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.attribution.gradcam import gradcam_from_embeds as jax_gc
from pnp_ovss_tpu.models.blip_itm import BlipITM as JaxBlipITM
from pnp_ovss_tpu.models.blip_itm import init_params
from pnp_ovss_tpu.text.captions import build_caption_batch
from pnp_ovss_tpu.text.wordpiece import WordPieceTokenizer
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.attribution.gradcam import gradcam_from_embeds
from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm
from pnp_ovss_tpu_torch.models.convert import from_jax_params

PKG = pathlib.Path(__file__).resolve().parent.parent / "pnp_ovss_tpu_torch"
NMS = ["dog", "cat", "grass", "sky"]
# f32 on both sides; LayerNorm variance and attention sums are taken in
# different orders (one-pass in Flax, two-pass in torch).
TOL = dict(rtol=2e-4, atol=2e-4)


def _configs(narrow: bool):
    tiny = jcfg_mod.ModelConfig.tiny()
    vit_kw = dataclasses.asdict(tiny.vit)
    bert_kw = dataclasses.asdict(tiny.bert)
    if narrow:
        vit_kw.update(image_size=192, hidden_size=128, num_heads=2)
        bert_kw.update(encoder_width=128)
    jcfg = jcfg_mod.ModelConfig(vit=jcfg_mod.ViTConfig(**vit_kw),
                                bert=jcfg_mod.BertConfig(**bert_kw),
                                embed_dim=16, max_text_len=16)
    pcfg = pcfg_mod.ModelConfig(vit=pcfg_mod.ViTConfig(**vit_kw),
                                bert=pcfg_mod.BertConfig(**bert_kw),
                                embed_dim=16, max_text_len=16)
    return jcfg, pcfg


@pytest.fixture(scope="module", params=[False, True], ids=["tiny", "narrow"])
def pair(request):
    """(jax model, jax params, port model, inputs) on shared weights."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PNP_VIT_FUSED", "0")
    jcfg, pcfg = _configs(request.param)
    layer = 0  # a last-layer GradCAM is structurally zero
    params = init_params(jax.random.PRNGKey(0), jcfg, capture_layers=(layer,))
    jmodel = JaxBlipITM(jcfg, capture_layers=(layer,), attn_impl="pallas")
    pmodel = from_jax_params(jax.tree.map(np.asarray, params), pcfg,
                             capture_layers=(layer,), device="cpu",
                             vit_fused=False)
    rng = np.random.RandomState(0)
    images = rng.randn(2, jcfg.vit.image_size, jcfg.vit.image_size, 3) \
        .astype(np.float32)
    tok = WordPieceTokenizer.toy(["a", "picture", "of"] + NMS)
    cap = build_caption_batch([["dog", "grass"], ["cat"]], tok,
                              max_text_len=16, max_classes=4)
    yield jmodel, params, pmodel, images, cap, jcfg
    mp.undo()


def _encode(jmodel, params, images):
    fn = jax.jit(functools.partial(jmodel.apply,
                                   method=JaxBlipITM.encode_image))
    return np.array(fn(params, jnp.asarray(images)))  # writable copy


def test_vit_encode_matches_jax(pair):
    jmodel, params, pmodel, images, _, jcfg = pair
    want = _encode(jmodel, params, images)
    got = pmodel.encode_image(torch.from_numpy(images)).numpy()
    assert got.shape == (2, jcfg.vit.seq_len, jcfg.vit.hidden_size)
    np.testing.assert_allclose(got, want, **TOL)


def test_itm_logits_and_captured_probs_match_jax(pair):
    jmodel, params, pmodel, images, cap, _ = pair
    embeds = _encode(jmodel, params, images)
    fn = jax.jit(functools.partial(jmodel.apply,
                                   method=JaxBlipITM.itm_from_embeds))
    logits, probs = fn(params, jnp.asarray(embeds),
                       jnp.asarray(cap.input_ids),
                       jnp.asarray(cap.attention_mask))
    with torch.no_grad():
        p_logits, p_probs = pmodel.itm_from_embeds(
            torch.from_numpy(embeds), torch.from_numpy(cap.input_ids).long(),
            torch.from_numpy(cap.attention_mask))
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(logits), **TOL)
    assert p_probs.shape == np.asarray(probs).shape
    np.testing.assert_allclose(p_probs.numpy(), np.asarray(probs),
                               rtol=1e-4, atol=1e-6)


def test_gradcam_matches_jax(pair):
    """GradCAM through the tap: same formula, same gradients; the
    embeddings carry no gradient (the backward never reaches the ViT)."""
    jmodel, params, pmodel, images, cap, jcfg = pair
    embeds = _encode(jmodel, params, images)

    def apply_embeds(p, e, i, m, cross_tap):
        return jmodel.apply(p, e, i, m, cross_tap=cross_tap,
                            method=JaxBlipITM.itm_from_embeds)

    fn = jax.jit(lambda p, e, i, m: jax_gc(
        apply_embeds, p, e, i, m, num_capture_layers=1,
        num_heads=jcfg.bert.num_heads, grid=jcfg.vit.grid))
    want, want_logits = fn(params, jnp.asarray(embeds),
                           jnp.asarray(cap.input_ids),
                           jnp.asarray(cap.attention_mask))
    e = torch.from_numpy(embeds).requires_grad_(True)
    got, logits = gradcam_from_embeds(
        pmodel, e, torch.from_numpy(cap.input_ids).long(),
        torch.from_numpy(cap.attention_mask), grid=jcfg.vit.grid)
    assert e.grad is None
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TOL)


def test_init_is_seeded():
    _, pcfg = _configs(False)
    a = init_blip_itm(pcfg, capture_layers=(1,), seed=3, device="cpu")
    b = init_blip_itm(pcfg, capture_layers=(1,), seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert not x.requires_grad
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=n)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port stands alone: no ``jax`` and no
    ``pnp_ovss_tpu`` import anywhere in it, nor in the scripts that drive
    it on the card (``chip_smoke.py``, the port's profiling and timing
    scripts and its synthetic postprocess gate)."""
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    assert PKG / "parallel" / "sequence.py" in files
    assert PKG / "cli" / "segment.py" in files
    for new in ("ops/host_post.py", "ops/crf_host.py", "cli/search.py",
                "cli/token_contrast.py", "search/reward.py",
                "search/optimizer.py"):
        assert PKG / new in files, new
    repo = PKG.parent
    card_scripts = [repo / "chip_smoke.py",
                    repo / "scripts" / "profile_torch_port.py",
                    repo / "scripts" / "kernel_ablation.py",
                    repo / "scripts" / "time_k8.py",
                    repo / "scripts" / "time_host_post.py",
                    repo / "scripts" / "synthetic_postprocess_gate_torch.py"]
    assert all(p.exists() for p in card_scripts)
    for path in files + card_scripts:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "pnp_ovss_tpu"), \
                    f"{path}: imports {name}"


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card the default device raises; nothing falls back."""
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pcfg_mod.PipelineConfig.tiny()
    cfg = dataclasses.replace(
        cfg, attribution=dataclasses.replace(cfg.attribution, layer=1))
    model = init_blip_itm(cfg.model, capture_layers=(0,), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        SegmentationRunner(cfg, model)
    with pytest.raises(RuntimeError, match="cuda"):
        init_blip_itm(cfg.model, capture_layers=(0,))
