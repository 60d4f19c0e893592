"""The port's search-path model surface against the JAX package's.

One ``init_params`` draw of the tiny config with every BERT layer captured
(``capture_layers=(0, 1)``, the tiny counterpart of the search's
``tuple(range(12))``) goes into the port through ``from_jax_params``; the
same seeded numpy images and ids go through both. Checked: the all-layer
GradCAM ensemble (``gradcam_from_tap``, one forward and one backward)
within ``tests/test_gradcam.py`` / ``tests/test_torch_models.py``'s bars
(rtol 1e-3, atol 1e-4 of the largest value; layer 0 of the 2-layer BERT
is the non-zero case, the last layer is structurally zero, F7), the ITM
logits from images, ``make_gradcam_fn``, ITC (the text-only encoder) and
``itm_rank``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.attribution.gradcam import gradcam_from_tap as jax_tap
from pnp_ovss_tpu.attribution.gradcam import make_gradcam_fn as jax_make
from pnp_ovss_tpu.models.blip_itm import BlipITM as JaxBlipITM
from pnp_ovss_tpu.models.blip_itm import init_params
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.attribution.gradcam import (
    gradcam_from_embeds, gradcam_from_tap, make_gradcam_fn,
)
from pnp_ovss_tpu_torch.models.blip_itm import BlipITM
from pnp_ovss_tpu_torch.models.convert import from_jax_params

JCFG = jcfg_mod.ModelConfig.tiny()
PCFG = pcfg_mod.ModelConfig.tiny()
LAYERS = (0, 1)
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_torch_models.py's


def _inputs(b=2, n_tok=8):
    rng = np.random.RandomState(7)
    images = rng.randn(b, JCFG.vit.image_size, JCFG.vit.image_size, 3) \
        .astype(np.float32)
    t = JCFG.max_text_len
    ids = np.zeros((b, t), np.int32)
    mask = np.zeros((b, t), np.int32)
    ids[:, :n_tok] = rng.randint(5, JCFG.bert.vocab_size - 2, (b, n_tok))
    ids[:, 0] = JCFG.bert.enc_token_id
    mask[:, :n_tok] = 1
    return images, ids, mask


@pytest.fixture(scope="module")
def pair():
    params = init_params(jax.random.PRNGKey(0), JCFG, capture_layers=LAYERS)
    jmodel = JaxBlipITM(JCFG, capture_layers=LAYERS, attn_impl="xla")
    pmodel = from_jax_params(jax.tree.map(np.asarray, params), PCFG,
                             capture_layers=LAYERS, device="cpu",
                             vit_fused=False)
    return jmodel, params, pmodel


def _t(x, long=False):
    t = torch.from_numpy(np.asarray(x))
    return t.long() if long else t


def _bars(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale)


def test_ensemble_gradcam_matches_jax(pair):
    jmodel, params, pmodel = pair
    images, ids, mask = _inputs()

    def apply_fn(p, im, i, m, cross_tap):
        return jmodel.apply(p, im, i, m, cross_tap=cross_tap)

    want, want_logits = jax.jit(lambda p, im, i, m: jax_tap(
        apply_fn, p, im, i, m, num_capture_layers=len(LAYERS),
        num_heads=JCFG.bert.num_heads, num_image_tokens=JCFG.vit.seq_len,
        grid=JCFG.vit.grid))(params, jnp.asarray(images), jnp.asarray(ids),
                             jnp.asarray(mask))
    got, logits = gradcam_from_tap(pmodel, _t(images), _t(ids, True),
                                   _t(mask), grid=PCFG.vit.grid)
    want = np.asarray(want)
    g = PCFG.vit.grid
    assert got.shape == want.shape == (2, 2, 2, JCFG.max_text_len - 1, g, g)
    _bars(got[0].numpy(), want[0])  # layer 0: the non-zero case (F7)
    # The last layer only reaches the loss through the [ENC] row, which
    # GradCAM drops: structurally zero on both sides.
    assert np.abs(want[1]).max() < 1e-6 and got[1].abs().max() < 1e-6
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TOL)
    assert got[0, :, :, 7:].abs().max() == 0  # padded tokens' rows


def test_ensemble_layer_equals_the_single_layer_capture(pair):
    """Layer 0 of the ensemble against a model capturing layer 0 alone,
    on the same weights and embeddings: one computation, so within f32
    rounding."""
    jmodel, params, pmodel = pair
    single = from_jax_params(jax.tree.map(np.asarray, params), PCFG,
                             capture_layers=(0,), device="cpu",
                             vit_fused=False)
    images, ids, mask = _inputs()
    embeds = pmodel.encode_image(_t(images))
    ens, le = gradcam_from_embeds(pmodel, embeds, _t(ids, True), _t(mask),
                                  grid=PCFG.vit.grid)
    one, lo = gradcam_from_embeds(single, embeds, _t(ids, True), _t(mask),
                                  grid=PCFG.vit.grid)
    assert ens.shape[0] == 2 and one.shape == (1,) + ens.shape[1:]
    torch.testing.assert_close(ens[0], one[0], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(le, lo, rtol=1e-6, atol=1e-7)


def test_make_gradcam_fn_matches_jax(pair):
    """One (layer, head) of the ensemble model against the JAX closure
    over a model capturing that layer alone (same tree: the captured
    layers are unrolled either way)."""
    _, params, pmodel = pair
    images, ids, mask = _inputs()
    jsingle = JaxBlipITM(JCFG, capture_layers=(0,), attn_impl="xla")
    want, want_logits = jax_make(jsingle, params, layer=1, head=1)(
        jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask))
    got, logits = make_gradcam_fn(pmodel, layer=1, head=1)(
        _t(images), _t(ids, True), _t(mask))
    assert got.shape == want.shape
    _bars(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TOL)


def test_itm_from_images_matches_jax(pair):
    jmodel, params, pmodel = pair
    images, ids, mask = _inputs()
    want, _ = jmodel.apply(params, jnp.asarray(images), jnp.asarray(ids),
                           jnp.asarray(mask))
    got, probs = pmodel(_t(images), _t(ids, True), _t(mask))
    assert probs.shape[0] == len(LAYERS)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def test_itc_matches_jax(pair):
    """The ITC similarity matrix: image CLS through ``vision_proj``, the
    text CLS of the text-only encoder through ``text_proj``."""
    jmodel, params, pmodel = pair
    images, ids, mask = _inputs(b=3)
    want = jmodel.apply(params, jnp.asarray(images), jnp.asarray(ids[:2]),
                        jnp.asarray(mask[:2]), method=JaxBlipITM.itc)
    got = pmodel.itc(_t(images), _t(ids[:2], True), _t(mask[:2]))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    hidden, probs = pmodel.text_encoder(_t(ids, True), _t(mask), None)
    assert probs is None and hidden.shape[:2] == ids.shape


def test_itm_rank_matches_jax(pair):
    jmodel, params, pmodel = pair
    images, ids, mask = _inputs()
    ids[:, 8:11] = ids[:, 1:4]  # a body past the 3 stripped tokens
    embeds = jmodel.apply(params, jnp.asarray(images),
                          method=JaxBlipITM.encode_image)
    want = jmodel.apply(params, embeds, jnp.asarray(ids),
                        method=JaxBlipITM.itm_rank)
    got = pmodel.itm_rank(_t(np.array(embeds)), _t(ids, True))
    assert got.shape == (2,) and bool(((got > 0) & (got < 1)).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_from_jax_params_carries_the_itc_projections(pair):
    _, params, pmodel = pair
    p = params["params"]
    for name in ("vision_proj", "text_proj"):
        lin = getattr(pmodel, name)
        np.testing.assert_array_equal(lin.weight.numpy(),
                                      np.asarray(p[name]["kernel"]).T)
        np.testing.assert_array_equal(lin.bias.numpy(),
                                      np.asarray(p[name]["bias"]))
    assert pmodel.text_encoder.capture_layers == LAYERS


@pytest.mark.parametrize("layers", [(1, 0), (0, 0), (0, 2), ()])
def test_capture_layers_must_ascend_within_the_bert(layers):
    cfg = dataclasses.replace(PCFG)
    with pytest.raises(ValueError, match="capture_layers"):
        BlipITM(cfg, layers)
