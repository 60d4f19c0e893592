"""Port attention (pnp_ovss_tpu_torch) vs the JAX package.

The port's CPU path is the plain version of the flash kernels (K2 flat, K9
on [B, H, S, D]); the JAX side runs its Pallas kernels in interpret mode on
the CPU. Inputs are numpy arrays from a seed, handed to both. The CUDA
kernels themselves are held against the same plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.models.blip_itm import BlipITM as JaxBlipITM
from pnp_ovss_tpu.models.blip_itm import init_params
from pnp_ovss_tpu.ops import attention as jax_attn
from pnp_ovss_tpu.ops import flash_attention as jax_flash
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.models.convert import from_jax_params
from pnp_ovss_tpu_torch.ops import attention as port_attn
from pnp_ovss_tpu_torch.ops import flash_attention as port_flash

# f32 on both sides; only the summation order differs (online softmax in
# the JAX kernel, one softmax in the plain version).
TOL = dict(rtol=2e-4, atol=2e-4)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("s,true_len", [(151, None), (160, 147)])
def test_flat_qkv_plain_matches_jax_kernel(s, true_len):
    """K2 plain vs flash_mha_flat_qkv: d=64, h=2, S not a multiple of 16;
    with a padded carry (true_len < S) only rows < true_len are defined."""
    b, h, d = 2, 2, 64
    qkv = np.random.RandomState(1).randn(b, s, 3 * h * d).astype(np.float32)
    want = np.asarray(jax_flash.flash_mha_flat_qkv(
        jnp.asarray(qkv), num_heads=h, true_len=true_len))
    got = port_flash.flash_mha_flat_qkv(_t(qkv), num_heads=h,
                                        true_len=true_len).numpy()
    rows = true_len or s
    assert got.shape == (b, s, h * d)
    np.testing.assert_allclose(got[:, :rows], want[:, :rows], **TOL)


@pytest.mark.parametrize("true_len", [None, 140])
def test_flat_sliced_plain_matches_jax_kernel(true_len):
    """K2' (three separate [B, S, H*D] arrays) vs flash_mha_flat."""
    b, s, h, d = 2, 149, 2, 64
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(b, s, h * d).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_flash.flash_mha_flat(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=h,
        true_len=true_len))
    got = port_flash.flash_mha_flat(_t(q), _t(k), _t(v), num_heads=h,
                                    true_len=true_len).numpy()
    rows = true_len or s
    np.testing.assert_allclose(got[:, :rows], want[:, :rows], **TOL)


def test_padded_keys_do_not_leak():
    """Fault F3: garbage in rows >= true_len must not reach real rows."""
    b, s, h, d, tl = 1, 150, 2, 64, 133
    rng = np.random.RandomState(3)
    qkv = rng.randn(b, s, 3 * h * d).astype(np.float32)
    noisy = qkv.copy()
    noisy[:, tl:] = 1e3 * rng.randn(b, s - tl, 3 * h * d)
    a = port_flash.flash_mha_flat_qkv(_t(qkv), num_heads=h, true_len=tl)
    c = port_flash.flash_mha_flat_qkv(_t(noisy), num_heads=h, true_len=tl)
    np.testing.assert_array_equal(a[:, :tl].numpy(), c[:, :tl].numpy())


def test_mha_and_probs_match_jax():
    """BERT attention pieces (no kernel): probs with the additive text bias,
    the context product and the fused plain attention."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 3, 7, 16).astype(np.float32) for _ in range(3))
    mask = (rng.rand(2, 7) > 0.3).astype(np.float32)
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :]
    want_p = np.asarray(jax_attn.attention_probs(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(bias)))
    got_p = port_attn.attention_probs(_t(q), _t(k), _t(bias)).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        port_attn.apply_probs(_t(got_p), _t(v)).numpy(),
        np.asarray(jax_attn.apply_probs(jnp.asarray(want_p),
                                        jnp.asarray(v))), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        port_attn.mha(_t(q), _t(k), _t(v), _t(bias)).numpy(),
        np.asarray(jax_attn.mha_xla(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(bias))),
        rtol=1e-5, atol=1e-5)


def test_flat_supported_and_true_len_checks():
    assert port_flash.flat_supported(443, 16, 64)
    assert not port_flash.flat_supported(443, 3, 64)  # heads in pairs
    assert not port_flash.flat_supported(10, 2, 16)
    x = torch.zeros(1, 130, 3 * 128)
    with pytest.raises(ValueError):
        port_flash.flash_mha_flat_qkv(x, num_heads=2, true_len=131)


_GRID = [(s, h, d) for s in (127, 128, 442) for h in (2, 3, 16)
         for d in (32, 64, 128)]


@pytest.mark.parametrize("s,h,d", _GRID)
def test_route_predicates_match_jax(s, h, d):
    """The port's routing by shape against the JAX package's: K2's rule
    and K9's are the JAX rules; K7's leaves out the head-pair lane rule
    (the port's kernel takes any head count), so for an odd head count it
    holds where the JAX rule holds at h + 1."""
    assert port_flash.flat_supported(s, h, d) == \
        jax_flash.flat_supported(s, h, d)
    q = torch.zeros(1, h, s, d)
    assert port_flash.supported(q) == jax_flash.supported(
        jnp.zeros((1, h, s, d)))
    for sq, skv in ((s, 2 * s), (max(s // 4, 1), s)):
        want = jax_flash.xlen_supported(sq, skv, h + h % 2, d)
        assert port_flash.xlen_supported(sq, skv, h, d) == want


def test_flash_mha_plain_matches_jax_kernel():
    """K9 plain vs the JAX ``flash_mha`` (interpret mode) at
    tests/test_ops.py's shape (S = 300, no multiple of either kernel's
    tiles), and the same through ``mha(impl="flash")``."""
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(2, 2, 300, 64).astype(np.float32)
               for _ in range(3))
    assert port_flash.supported(_t(q))
    want = np.asarray(jax_flash.flash_mha(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v)))
    got = port_flash.flash_mha(_t(q), _t(k), _t(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    via_mha = port_attn.mha(_t(q), _t(k), _t(v), impl="flash")
    np.testing.assert_array_equal(via_mha.numpy(), got.numpy())


def test_mha_dispatch():
    """``impl="flash"`` takes K9 only without a bias and for shapes it
    supports; anything else runs the plain math, and an unknown impl
    raises."""
    calls = []
    real = port_flash.flash_mha

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    rng = np.random.RandomState(8)
    big = _t(rng.randn(1, 3, 130, 64).astype(np.float32))
    small = _t(rng.randn(1, 3, 20, 64).astype(np.float32))
    mp = pytest.MonkeyPatch()
    mp.setattr(port_flash, "flash_mha", counting)
    try:
        port_attn.mha(big, big, big, impl="flash")
        port_attn.mha(big, big, big, torch.zeros(130), impl="flash")
        port_attn.mha(small, small, small, impl="flash")
        port_attn.mha(big, big, big)
    finally:
        mp.undo()
    assert calls == [big.shape]
    with pytest.raises(ValueError):
        port_attn.mha(big, big, big, impl="pallas")


def test_three_head_vit_takes_k9_and_matches_jax(monkeypatch):
    """The unfused ViT with 3 heads of 64 (hidden 192, 192 px: 145 tokens):
    the JAX package sends it through ``mha(impl="pallas")`` to its
    ``flash_mha``, the port through ``mha(impl="flash")`` to K9 (its plain
    version here), once per layer, and never to K2."""
    monkeypatch.setenv("PNP_VIT_FUSED", "0")
    tiny = jcfg_mod.ModelConfig.tiny()
    vit_kw = dict(dataclasses.asdict(tiny.vit), image_size=192,
                  hidden_size=192, num_heads=3)
    bert_kw = dict(dataclasses.asdict(tiny.bert), encoder_width=192)
    jcfg = jcfg_mod.ModelConfig(vit=jcfg_mod.ViTConfig(**vit_kw),
                                bert=jcfg_mod.BertConfig(**bert_kw),
                                embed_dim=16, max_text_len=16)
    pcfg = pcfg_mod.ModelConfig(vit=pcfg_mod.ViTConfig(**vit_kw),
                                bert=pcfg_mod.BertConfig(**bert_kw),
                                max_text_len=16)
    params = init_params(jax.random.PRNGKey(0), jcfg, capture_layers=(0,))
    jmodel = JaxBlipITM(jcfg, capture_layers=(0,), attn_impl="pallas")
    images = np.random.RandomState(0).randn(2, 192, 192, 3) \
        .astype(np.float32)
    fn = jax.jit(functools.partial(jmodel.apply,
                                   method=JaxBlipITM.encode_image))
    want = np.asarray(fn(params, jnp.asarray(images)))
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg,
                            capture_layer=0, device="cpu")
    assert not model.visual_encoder.fused
    calls = {"flash_mha": 0}
    real = port_flash.flash_mha

    def counting(*a, **kw):
        calls["flash_mha"] += 1
        return real(*a, **kw)

    def no_flat(*a, **kw):
        raise AssertionError("K2 must not run for 3 heads")

    monkeypatch.setattr(port_flash, "flash_mha", counting)
    monkeypatch.setattr("pnp_ovss_tpu_torch.models.vit.flash_mha_flat_qkv",
                        no_flat)
    got = model.encode_image(torch.from_numpy(images)).numpy()
    assert calls["flash_mha"] == pcfg.vit.num_layers
    assert got.shape == (2, 145, 192)
    np.testing.assert_allclose(got, want, **TOL)
