"""The port's CLIP reward model, its BPE tokenizer and loaders against the
JAX package's, on the CPU with one set of weights.

- configs field for field; BPE ids exactly, through both token patterns
  (the ``regex`` module's and the ASCII ``re`` fallback's), from ``toy()``
  and from a gzip merge table;
- ``CLIPBlock`` on each route: the flat kernel K2 (its plain version here)
  against the JAX block with ``impl="pallas"`` (the Pallas kernel in
  interpret mode) and ``"xla"``, the causal text block, and the 3-head
  block's K9 route; the towers at the tiny config and the narrow 168 px
  flat-path vision tower, in f32 and bf16;
- the OpenAI-layout loader against ``convert_clip_state_dict`` ->
  ``from_jax_clip_params``, parameter for parameter, from a plain state
  dict and from a TorchScript archive; the position-embedding resample;
  keys that cannot be placed;
- ``make_clip_scorer`` against the JAX scorer with a 40 -> 28 resize.

Tolerances: f32 embeddings within 2e-6 (seeded reading ~3e-7: products
summed in another order), f32 block outputs (up to ~4) within 1e-5
(~2.4e-6), bf16 within 1e-2 of unit-norm embeddings (~2.4e-3:
bf16 roundings in another order), loaded parameters equal.
"""

import dataclasses
import gzip
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.cli.search import make_clip_scorer as jax_make_scorer
from pnp_ovss_tpu.models import clip as jclip
from pnp_ovss_tpu.models.convert import convert_clip_state_dict
from pnp_ovss_tpu.models.convert import load_clip_checkpoint as jax_load
from pnp_ovss_tpu.text import bpe as jbpe
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.cli.search import make_clip_scorer
from pnp_ovss_tpu_torch.models import clip as pclip
from pnp_ovss_tpu_torch.models.convert import (
    _flatten, from_jax_clip_params, from_openai_clip_state_dict,
    load_clip_checkpoint,
)
from pnp_ovss_tpu_torch.ops import flash_attention
from pnp_ovss_tpu_torch.text import bpe as pbpe
from tests.test_clip import _tiny_clip_state_dict

TOL_F32 = dict(rtol=0, atol=2e-6)
TOL_BLOCK = dict(rtol=0, atol=1e-5)  # outputs up to ~4: reading 2.4e-6
TOL_BF16 = dict(rtol=0, atol=1e-2)
WORDS = ["dog", "cat", "grass", "tv", "monitor", "potted", "plant", "sky"]
TEXTS = ["A Dog and a CAT", "dog, cat; grass!", "tv 2 monitor 1080p",
         "dog &amp; cat &lt;3", "potted-plant's café", "  sky\t\n grass ",
         " ".join(WORDS * 4)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _narrow(mod, dtype):
    """The narrow configuration: 168 px at patch 14 (145 tokens, the flat
    path), width 128 with 2 heads of 64, 2 layers each tower."""
    return mod.CLIPConfig(
        vision=mod.CLIPVisionConfig(
            image_size=168, patch_size=14, hidden_size=128, num_layers=2,
            num_heads=2, embed_dim=64, dtype=dtype),
        text=mod.CLIPTextConfig(
            vocab_size=1024, context_length=16, hidden_size=128,
            num_layers=2, num_heads=2, embed_dim=64, dtype=dtype))


def _ids(n, t=16, eot=1001):
    ids = np.zeros((n, t), np.int32)
    ids[:, 0] = 1000
    rng = np.random.RandomState(5)
    for i in range(n):
        k = 2 + i % (t - 3)
        ids[i, 1:k] = rng.randint(1, 999, k - 1)
        ids[i, k] = eot
    return ids


def test_configs_match_field_for_field():
    for name in ("CLIPVisionConfig", "CLIPTextConfig", "CLIPConfig"):
        assert [f.name for f in dataclasses.fields(getattr(pcfg_mod, name))] \
            == [f.name for f in dataclasses.fields(getattr(jcfg_mod, name))]
    for make in (lambda m: m.CLIPConfig(), lambda m: m.CLIPConfig.tiny()):
        assert dataclasses.asdict(make(pcfg_mod)) == \
            dataclasses.asdict(make(jcfg_mod))
    v = pcfg_mod.CLIPConfig().vision
    assert (v.num_patches + 1, v.num_heads, v.head_dim) == (577, 16, 64)
    assert v.layer_norm_eps == 1e-5


@pytest.mark.parametrize("context", [8, 16, 77])
def test_bpe_ids_match_jax(context):
    got = pbpe.CLIPBPETokenizer.toy(WORDS)
    want = jbpe.CLIPBPETokenizer.toy(WORDS)
    assert got.encoder == want.encoder and got.bpe_ranks == want.bpe_ranks
    for text in TEXTS:
        assert got.encode(text) == want.encode(text), text
    ids = got.encode_batch(TEXTS, context)
    np.testing.assert_array_equal(ids, want.encode_batch(TEXTS, context))
    assert ids.shape == (len(TEXTS), context) and ids.dtype == np.int32
    assert (ids.argmax(-1) == (ids == got.eot_id).argmax(-1)).all()
    assert ids.max() < pcfg_mod.CLIPConfig.tiny().text.vocab_size


def _fresh(path: Path, name: str, monkeypatch):
    """A new module object of ``path`` imported with ``regex`` hidden, so
    its token pattern takes the ASCII ``re`` branch."""
    monkeypatch.setitem(sys.modules, "regex", None)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bpe_ascii_fallback_matches_jax(monkeypatch):
    port = _fresh(Path(pbpe.__file__), "_bpe_port_ascii", monkeypatch)
    ref = _fresh(Path(jbpe.__file__), "_bpe_jax_ascii", monkeypatch)
    assert port._re is __import__("re") and ref._re is port._re
    got = port.CLIPBPETokenizer.toy(WORDS)
    want = ref.CLIPBPETokenizer.toy(WORDS)
    for context in (8, 77):
        np.testing.assert_array_equal(got.encode_batch(TEXTS, context),
                                      want.encode_batch(TEXTS, context))


def test_bpe_from_merges_file_matches_jax(tmp_path):
    merges = ["d o", "do g</w>", "c a", "ca t</w>", "g r", "gr a", "gra s",
              "gras s</w>", "t v</w>", "s k", "sk y</w>"]
    path = tmp_path / "bpe_tiny.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2"] + merges) + "\n")
    got = pbpe.CLIPBPETokenizer.from_merges_file(str(path))
    want = jbpe.CLIPBPETokenizer.from_merges_file(str(path))
    assert got.encoder == want.encoder and got.bpe_ranks == want.bpe_ranks
    assert len(got.encoder) == 512 + len(merges) + 2
    assert got.decoder[got.encode("Dog")[0]] == "dog</w>"
    np.testing.assert_array_equal(got.encode_batch(TEXTS, 16),
                                  want.encode_batch(TEXTS, 16))


def test_bpe_merge_order_is_rank_greedy():
    """The lowest-rank merge applies first, not the leftmost."""
    vocab = list(pbpe.bytes_to_unicode().values())
    vocab += [c + "</w>" for c in vocab]
    merges = [("b", "c"), ("a", "bc"), ("abc", "d</w>")]
    vocab += ["bc", "abc", "abcd</w>", pbpe.CLIPBPETokenizer.SOT,
              pbpe.CLIPBPETokenizer.EOT]
    got = pbpe.CLIPBPETokenizer(merges, vocab)
    want = jbpe.CLIPBPETokenizer(merges, vocab)
    for word in ("abcd", "ba", "bcbc", "abcabcd"):
        assert got.bpe(word) == want.bpe(word)
    assert got.bpe("abcd") == "abcd</w>" and got.bpe("ba") == "b a</w>"


def _port_block(params, **kw):
    blk = pclip.CLIPBlock(**kw)
    flat = {}
    _flatten(params["params"], "", flat)
    blk.load_state_dict({k: torch.tensor(v) for k, v in flat.items()},
                        strict=True)
    return blk.eval()


def _block_pair(b, s, hidden, heads, causal, impl, seed=0):
    """(JAX block output, the port block's) on one seeded input."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, s, hidden) * 0.5).astype(np.float32)
    kw = dict(hidden_size=hidden, num_heads=heads, mlp_ratio=4.0, eps=1e-5,
              dtype="float32", causal=causal)
    jblk = jclip.CLIPBlock(impl=impl, **kw)
    params = _np(jblk.init(jax.random.PRNGKey(seed), x))
    want = np.asarray(jblk.apply(params, x))
    with torch.no_grad():
        got = _port_block(params, **kw)(torch.from_numpy(x)).numpy()
    return want, got


def _spy(monkeypatch, owner, name):
    calls = []
    real = getattr(owner, name)

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(owner, name, spy)
    return calls


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_flat_block_matches_jax(impl, monkeypatch):
    """s = 150, width 128, 2 heads of 64: the port's K2 route against the
    JAX block's Pallas kernel (interpret mode) and its einsum path."""
    k2 = _spy(monkeypatch, pclip, "flash_mha_flat_qkv")
    want, got = _block_pair(2, 150, 128, 2, causal=False, impl=impl)
    assert k2 == [(2, 150, 384)]
    np.testing.assert_allclose(got, want, **TOL_BLOCK)


@pytest.mark.parametrize("s,hidden,heads", [(16, 32, 2), (130, 128, 2)])
def test_causal_block_matches_jax(s, hidden, heads, monkeypatch):
    """The text block: plain attention with the -1e9 upper-triangular
    bias, never a kernel, even where the flat kernel takes the shape."""
    k2 = _spy(monkeypatch, pclip, "flash_mha_flat_qkv")
    k9 = _spy(monkeypatch, flash_attention, "flash_mha")
    want, got = _block_pair(2, s, hidden, heads, causal=True,
                            impl="pallas", seed=1)
    assert k2 == [] and k9 == []
    np.testing.assert_allclose(got, want, **TOL_BLOCK)


def test_three_head_block_takes_k9_and_matches_jax(monkeypatch):
    """3 heads of 64 at S = 130: not the flat kernel's shape (heads in
    pairs), so ``mha(impl="flash")`` sends it to K9, as the JAX block's
    ``mha(impl="pallas")`` sends it to its ``flash_mha``."""
    k2 = _spy(monkeypatch, pclip, "flash_mha_flat_qkv")
    k9 = _spy(monkeypatch, flash_attention, "flash_mha")
    want, got = _block_pair(2, 130, 192, 3, causal=False, impl="pallas",
                            seed=2)
    assert k2 == [] and k9 == [(2, 3, 130, 64)]
    np.testing.assert_allclose(got, want, **TOL_BLOCK)


def test_tiny_clip_matches_jax():
    jcfg, pcfg = jcfg_mod.CLIPConfig.tiny(), pcfg_mod.CLIPConfig.tiny()
    params = _np(jclip.init_clip_params(jax.random.PRNGKey(0), jcfg))
    model = from_jax_clip_params(params, pcfg, device="cpu")
    rng = np.random.RandomState(0)
    images = rng.randn(3, 28, 28, 3).astype(np.float32)
    ids = _ids(3)
    want_i, want_t = jclip.CLIPModel(jcfg).apply(params, images, ids)
    with torch.no_grad():
        got_i, got_t = model(torch.from_numpy(images),
                             torch.from_numpy(ids).long())
    assert got_i.dtype == got_t.dtype == torch.float32
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), **TOL_F32)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL_F32)
    np.testing.assert_allclose(torch.linalg.vector_norm(got_i, dim=-1), 1,
                               rtol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL_F32),
                                       ("bfloat16", TOL_BF16)])
def test_narrow_flat_path_clip_matches_jax(dtype, tol, monkeypatch):
    """The narrow 168 px towers (phase 4 of ``chip_smoke.py`` runs the same
    configuration on the card): K2 twice per ``encode_image``, against
    the JAX towers with ``impl="pallas"``."""
    jcfg, pcfg = _narrow(jcfg_mod, dtype), _narrow(pcfg_mod, dtype)
    params = _np(jclip.init_clip_params(jax.random.PRNGKey(1), jcfg))
    model = from_jax_clip_params(params, pcfg, device="cpu")
    rng = np.random.RandomState(1)
    images = rng.randn(2, 168, 168, 3).astype(np.float32)
    ids = _ids(3)
    want_i, want_t = jclip.CLIPModel(jcfg, impl="pallas").apply(
        params, images, ids)
    k2 = _spy(monkeypatch, pclip, "flash_mha_flat_qkv")
    with torch.no_grad():
        got_i = model.encode_image(torch.from_numpy(images))
        got_t = model.encode_text(torch.from_numpy(ids).long())
    assert k2 == [(2, 145, 384)] * 2
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), **tol)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **tol)


def _assert_same_params(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for name in sa:
        assert sa[name].dtype == sb[name].dtype, name
        torch.testing.assert_close(sa[name], sb[name], rtol=0, atol=0,
                                   msg=name)


def test_openai_state_dict_loads_like_the_jax_route():
    jcfg, pcfg = jcfg_mod.CLIPConfig.tiny(), pcfg_mod.CLIPConfig.tiny()
    sd = _tiny_clip_state_dict(jcfg, np.random.RandomState(3))
    sd["logit_scale"] = np.float32(4.6)
    got = from_openai_clip_state_dict(sd, pcfg, device="cpu")
    want = from_jax_clip_params(
        _np(convert_clip_state_dict(sd, jcfg)), pcfg, device="cpu")
    _assert_same_params(got, want)
    torch.testing.assert_close(
        got.visual.patch_embed.weight,
        torch.from_numpy(sd["visual.conv1.weight"]), rtol=0, atol=0)


def _torchscript_archive(sd, path):
    """``sd`` as a TorchScript archive of buffers, the way OpenAI ships
    its checkpoints (``torch.load`` refuses or redirects it)."""

    class Holder(torch.nn.Module):
        def forward(self):
            return 0

    root = Holder()
    for key, val in sd.items():
        *parts, leaf = key.split(".")
        mod = root
        for p in parts:
            if not hasattr(mod, p):
                mod.add_module(p, Holder())
            mod = getattr(mod, p)
        mod.register_buffer(leaf, torch.tensor(np.asarray(val)))
    torch.jit.save(torch.jit.script(root), str(path))


@pytest.mark.parametrize("layout", ["torchscript", "state_dict", "nested",
                                    "half"])
def test_load_clip_checkpoint(layout, tmp_path):
    jcfg, pcfg = jcfg_mod.CLIPConfig.tiny(), pcfg_mod.CLIPConfig.tiny()
    sd = _tiny_clip_state_dict(jcfg, np.random.RandomState(4))
    path = tmp_path / "clip.pt"
    if layout == "torchscript":
        _torchscript_archive(sd, path)
    else:
        tensors = {k: torch.tensor(v) for k, v in sd.items()}
        if layout == "half":
            tensors = {k: v.half() for k, v in tensors.items()}
            sd = {k: v.float().numpy() for k, v in tensors.items()}
        torch.save({"state_dict": tensors} if layout == "nested"
                   else tensors, path)
    got = load_clip_checkpoint(str(path), pcfg, device="cpu")
    _assert_same_params(got,
                        from_openai_clip_state_dict(sd, pcfg, device="cpu"))
    if layout != "half":  # the JAX loader reads no half-precision file
        want = jax.tree_util.tree_leaves_with_path(
            _np(convert_clip_state_dict(sd, jcfg)))
        loaded = jax.tree_util.tree_leaves_with_path(
            _np(jax_load(str(path), jcfg)))
        for (pw, w), (pl, leaf) in zip(want, loaded):
            assert pw == pl
            np.testing.assert_array_equal(leaf, w)


def test_position_embeddings_resampled_like_jax():
    """A checkpoint at a 3 x 3 grid (42 px) loaded at the tiny config's
    2 x 2 (28 px): the class entry kept, the grid resampled bicubically
    as the JAX converter resamples it."""
    jcfg, pcfg = jcfg_mod.CLIPConfig.tiny(), pcfg_mod.CLIPConfig.tiny()
    big = dataclasses.replace(
        jcfg, vision=dataclasses.replace(jcfg.vision, image_size=42))
    sd = _tiny_clip_state_dict(big, np.random.RandomState(6))
    assert sd["visual.positional_embedding"].shape[0] == 10
    got = from_openai_clip_state_dict(sd, pcfg, device="cpu")
    want = np.asarray(convert_clip_state_dict(
        sd, jcfg)["params"]["visual"]["pos_embed"])
    assert got.visual.pos_embed.shape == (5, 32)
    np.testing.assert_allclose(got.visual.pos_embed.numpy(), want,
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.visual.pos_embed[0].numpy(),
                                  sd["visual.positional_embedding"][0])


def test_unplaceable_missing_and_misfit_keys_raise():
    jcfg, pcfg = jcfg_mod.CLIPConfig.tiny(), pcfg_mod.CLIPConfig.tiny()
    sd = _tiny_clip_state_dict(jcfg, np.random.RandomState(7))
    with pytest.raises(KeyError, match="visual.transformer.extra"):
        from_openai_clip_state_dict(
            {**sd, "visual.transformer.extra": np.zeros(3, np.float32)},
            pcfg, device="cpu")
    missing = {k: v for k, v in sd.items() if k != "ln_final.bias"}
    with pytest.raises(KeyError, match="text.ln_final.bias"):
        from_openai_clip_state_dict(missing, pcfg, device="cpu")
    misfit = {**sd, "text_projection": np.zeros((32, 8), np.float32)}
    with pytest.raises(ValueError, match="text_projection"):
        from_openai_clip_state_dict(misfit, pcfg, device="cpu")


def test_init_clip_is_seeded():
    cfg = pcfg_mod.CLIPConfig.tiny()
    a = pclip.init_clip(cfg, seed=3, device="cpu")
    b = pclip.init_clip(cfg, seed=3, device="cpu")
    c = pclip.init_clip(cfg, seed=4, device="cpu")
    _assert_same_params(a, b)
    assert not torch.equal(a.visual.proj, c.visual.proj)
    assert not any(p.requires_grad for p in a.parameters())
    assert float(a.visual.blocks[0].qkv.bias.abs().max()) == 0
    assert float(a.text.ln_final.weight.min()) == 1
    assert 0.015 < float(a.visual.class_embedding.std()) < 0.025


def test_clip_scorer_matches_jax():
    """Images at 40 px, resized to the tiny tower's 28 inside. The token
    embeddings are scaled by 0.1, so that the texts' embeddings lie close
    enough for the softmax at temperature 0.01 not to saturate."""
    jcfg, pcfg = jcfg_mod.CLIPConfig.tiny(), pcfg_mod.CLIPConfig.tiny()
    sd = _tiny_clip_state_dict(jcfg, np.random.RandomState(8))
    sd["token_embedding.weight"] *= 0.1
    texts = ["dog", "cat", "grass"]
    want_fn = jax_make_scorer(
        jclip.CLIPModel(jcfg), _np(convert_clip_state_dict(sd, jcfg)),
        jbpe.CLIPBPETokenizer.toy(texts), image_size=28, context_length=16)
    got_fn = make_clip_scorer(
        from_openai_clip_state_dict(sd, pcfg, device="cpu"),
        pbpe.CLIPBPETokenizer.toy(texts), image_size=28, context_length=16,
        device="cpu")
    images = np.random.RandomState(0).rand(4, 40, 40, 3).astype(np.float32)
    with torch.no_grad():
        got = got_fn(images, texts)
    want = want_fn(images, texts)
    assert got.shape == (4, 3)
    assert 0.01 < want.max() < 0.99  # not saturated
    np.testing.assert_allclose(got.sum(-1), 1, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
