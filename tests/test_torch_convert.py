"""LAVIS BLIP-ITM state dicts into the port, against the JAX package's route.

A tiny LAVIS-layout state dict (``tests/test_convert.py``'s builder, every
tensor random, with the retrieval checkpoint's extra keys of
``tests/test_convert.py:72-109``) goes straight into the port
(``from_lavis_state_dict``) and through the JAX package
(``convert_state_dict``, then the port's ``from_jax_params``): every
tensor must be equal. ``interpolate_pos_embed`` is held against the JAX
function within 1e-5, and the parameter cache must convert once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.models.convert import convert_state_dict
from pnp_ovss_tpu.models.vit import interpolate_pos_embed as jax_interp
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.models import cache, convert
from pnp_ovss_tpu_torch.models.convert import (
    from_jax_params, from_lavis_state_dict, lavis_port_name,
    load_torch_checkpoint,
)
from pnp_ovss_tpu_torch.models.vit import interpolate_pos_embed
from tests.test_convert import (
    _retrieval_checkpoint_extras, _tiny_torch_state_dict,
)

JCFG = jcfg_mod.ModelConfig.tiny()
PCFG = pcfg_mod.ModelConfig.tiny()


def _lavis_sd(seed=0):
    """(ITM-only state dict, its retrieval-checkpoint extras)."""
    rng = np.random.RandomState(seed)
    sd = _tiny_torch_state_dict(JCFG, rng)
    for k, v in sd.items():
        if np.all(v == 0) or np.all(v == 1):  # norms and zero biases
            sd[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    return sd, _retrieval_checkpoint_extras(JCFG, sd, rng)


def _bert_prefixed(sd):
    return {(k.replace("text_encoder.", "text_encoder.bert.", 1)
             if k.startswith("text_encoder.") else k): v
            for k, v in sd.items()}


def _assert_same_params(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("capture_layers", [
    pytest.param((0,), id="0"), pytest.param((1,), id="1"),
    pytest.param((0, 1), id="capture_layer2")])
@pytest.mark.parametrize("layout", ["itm", "retrieval", "bert_prefix"])
def test_lavis_load_equals_the_jax_route(layout, capture_layers):
    """Also for the search's all-layer capture, whose JAX tree has
    ``layer_{i}`` for every layer."""
    sd, extras = _lavis_sd()
    full = dict(sd)
    if layout != "itm":
        full.update(extras)
    if layout == "bert_prefix":
        full = _bert_prefixed(full)
    got = from_lavis_state_dict(full, PCFG, capture_layers=capture_layers,
                                device="cpu")
    tree = convert_state_dict(sd, JCFG, capture_layers=capture_layers)
    want = from_jax_params(jax.tree.map(np.asarray, tree), PCFG,
                           capture_layers=capture_layers, device="cpu")
    _assert_same_params(got, want)
    # And straight from the dict: every tensor, the ITC projections
    # included, lands under its name.
    params = got.state_dict()
    for k, v in sd.items():
        name = lavis_port_name(k)
        assert torch.equal(params[name], torch.tensor(v)), k


def test_pth_checkpoint_loads_like_the_state_dict(tmp_path):
    sd, extras = _lavis_sd(1)
    path = tmp_path / "model.pth"
    torch.save({"model": {k: torch.tensor(v) for k, v in
                          {**sd, **extras}.items()}, "epoch": 5}, path)
    got = load_torch_checkpoint(str(path), PCFG, (0,), device="cpu")
    _assert_same_params(got, from_lavis_state_dict(
        sd, PCFG, capture_layers=(0,), device="cpu"))
    assert not got.training and not any(
        p.requires_grad for p in got.parameters())


@pytest.mark.parametrize("grids", [(24, 21), (21, 24)])
def test_interpolate_pos_embed_matches_jax(grids):
    src, dst = grids
    x = np.random.RandomState(src).randn(1, src * src + 1, 16) \
        .astype(np.float32)
    got = interpolate_pos_embed(torch.tensor(x), dst * dst).numpy()
    want = np.asarray(jax_interp(jnp.asarray(x), dst * dst))
    assert got.shape == want.shape == (1, dst * dst + 1, 16)
    np.testing.assert_array_equal(got[:, 0], x[:, 0])  # CLS kept
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_checkpoint_at_another_grid_resamples_pos_embed():
    """A checkpoint trained at 64 px (4x4 grid) loaded at 48 px (3x3), as
    the 384 px BLIP-ITM-Large checkpoint is at 336 px."""
    sd, _ = _lavis_sd(2)
    rng = np.random.RandomState(3)
    sd["visual_encoder.pos_embed"] = rng.randn(1, 17, 32).astype(np.float32)
    got = from_lavis_state_dict(sd, PCFG, capture_layers=(0,), device="cpu")
    want = jax_interp(jnp.asarray(sd["visual_encoder.pos_embed"]), 9)
    np.testing.assert_allclose(got.visual_encoder.pos_embed.numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)


def test_param_cache_converts_once(tmp_path, monkeypatch):
    sd, _ = _lavis_sd(4)
    path = str(tmp_path / "model.pth")
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    calls = []
    real = convert.load_torch_checkpoint

    def counting(*args, **kw):
        calls.append(args[0])
        return real(*args, **kw)

    monkeypatch.setattr(convert, "load_torch_checkpoint", counting)
    kw = dict(cache_dir=str(tmp_path / "cache"), device="cpu")
    first = cache.load_params_cached(path, PCFG, (0,), **kw)
    second = cache.load_params_cached(path, PCFG, (0,), **kw)
    assert calls == [path]
    _assert_same_params(first, second)
    store = cache.cache_path(path, PCFG, (0,), cache_dir=kw["cache_dir"])
    assert store.startswith(kw["cache_dir"]) and tmp_path.joinpath(
        "cache", "params").exists()
    # Another captured layer is another conversion, and so are the
    # search's all-layer capture and another ITC width (conversions from
    # before the ITC projections were kept have no place to go).
    assert cache.cache_path(path, PCFG, (1,),
                            cache_dir=kw["cache_dir"]) != store
    cache.load_params_cached(path, PCFG, (1,), **kw)
    assert calls == [path, path]
    assert len({cache.cache_path(path, cfg, layer) for cfg, layer in (
        (PCFG, (0,)), (PCFG, (0, 1)),
        (dataclasses.replace(PCFG, embed_dim=8), (0,)))}) == 3


def test_unknown_key_raises_and_names_it():
    sd, _ = _lavis_sd(5)
    sd["visual_encoder.adapter.weight"] = np.zeros((4, 4), np.float32)
    with pytest.raises(KeyError, match="visual_encoder.adapter.weight"):
        from_lavis_state_dict(sd, PCFG, capture_layers=(0,), device="cpu")


def test_unknown_itc_projection_key_raises():
    """The ITC projections are kept, so a stray key under their names
    raises like any other."""
    sd, _ = _lavis_sd(5)
    sd["vision_proj.scale"] = np.zeros((4,), np.float32)
    with pytest.raises(KeyError, match="vision_proj.scale"):
        from_lavis_state_dict(sd, PCFG, capture_layers=(0,), device="cpu")


def test_missing_key_raises_and_names_it():
    sd, _ = _lavis_sd(6)
    del sd["text_encoder.encoder.layer.1.output.dense.bias"]
    with pytest.raises(KeyError, match=r"text_encoder\.layers\.1\."
                                       r"output_dense\.bias"):
        from_lavis_state_dict(sd, PCFG, capture_layers=(0,), device="cpu")


def test_shape_that_does_not_fit_raises_and_names_it():
    sd, _ = _lavis_sd(7)
    sd["itm_head.weight"] = np.zeros((3, 32), np.float32)
    with pytest.raises(ValueError, match="itm_head.weight"):
        from_lavis_state_dict(sd, PCFG, capture_layers=(0,), device="cpu")


def test_both_bert_prefixes_raise():
    sd, _ = _lavis_sd(8)
    sd["text_encoder.bert.embeddings.LayerNorm.bias"] = \
        sd["text_encoder.embeddings.LayerNorm.bias"]
    with pytest.raises(KeyError, match="a second time"):
        from_lavis_state_dict(sd, PCFG, capture_layers=(0,), device="cpu")
