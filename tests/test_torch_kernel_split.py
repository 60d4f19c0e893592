"""The splits that the card's K1 and K4 run, pinned on the CPU.

On the card K1 (``ln_matmul``) is a row LayerNorm into bf16 rows, then a
GEMM whose epilogue adds the bias to the f32 sum and rounds once. K4
(``flash_mha_qkv_proj``) is K2's flash kernel into bf16 head outputs, then
a GEMM whose epilogue rounds the f32 sum, adds the bias, rounds, adds x and
rounds: the value flow of the sequence-parallel block's
``x + (F.linear(out, Wp) + bp)`` (``models/vit.py``). The tests below hold
the plain versions to those compositions bit for bit, so a drift between
the plain versions and the split (or between the fused and the
sequence-parallel block) fails here before it moves chip_smoke.py's
equality bar on the 768 px sequence-parallel encode. Then the plain
versions are held against the JAX package's Pallas kernels (interpret
mode) at the widths and head shapes the split adds: D = 384, 768 for K1 and
K3 (the widths ``vit_block.supported`` routes to them), head dim 128 and
16 heads of 64 for K4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from pnp_ovss_tpu.ops import flash_attention as jax_flash
from pnp_ovss_tpu.ops import vit_block_pallas as jax_vbp
from pnp_ovss_tpu_torch.ops import flash_attention as port_flash
from pnp_ovss_tpu_torch.ops import vit_block as port_vb

BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of O(1) values


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).bfloat16()


def _norm(rng, d):
    g = torch.from_numpy((1 + 0.1 * rng.randn(d)).astype(np.float32))
    return g, torch.from_numpy((0.1 * rng.randn(d)).astype(np.float32))


def _j(t):
    """A bf16 tensor as the same bf16 values in JAX."""
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _sp_block_proj(out, x, w, b):
    """The sequence-parallel block's proj + residual,
    ``x + (F.linear(out, w) + b)`` in bf16. The card's bf16 product sums
    in f32 and rounds once; the CPU's bf16 ``F.linear`` sums in another
    order than an f32 product (about one value in 1e4 lands one ulp
    apart), so
    here the product is summed in f32 and rounded, and every rounding
    after it is the block's own."""
    acc = F.linear(out.float(), w.float()).to(out.dtype)
    return x + (acc + b)


@pytest.mark.parametrize("tail", [0, 37], ids=["full", "padded"])
@pytest.mark.parametrize("h", [2, 16])
@pytest.mark.parametrize("d", [64, 128])
def test_qkv_proj_plain_is_attention_then_sp_proj(d, h, tail):
    """K4's plain version == K2's plain attention into bf16 head outputs,
    then the sequence-parallel block's proj + residual, bit for bit, with
    every key (true_len = S) and with keys >= true_len masked."""
    rng = np.random.RandomState(11)
    b, s, dm = 2, 150, 256
    hd = h * d
    qkv = _bf16(rng, b, s, 3 * hd)
    x = _bf16(rng, b, s, dm)
    w = _bf16(rng, dm, hd, scale=hd**-0.5)
    bp = _bf16(rng, dm, scale=0.1)
    tl = s - tail
    want = port_flash.qkv_proj_plain(qkv, x, w, bp, num_heads=h,
                                     true_len=tl)
    out = port_flash.attention_plain(
        qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:], num_heads=h,
        true_len=tl, out_dtype=torch.bfloat16)
    got = _sp_block_proj(out, x, w, bp)
    assert torch.equal(got, want)
    # The wrapper on CPU tensors is the plain version.
    assert torch.equal(port_flash.flash_mha_qkv_proj(
        qkv, x, w, bp, num_heads=h, true_len=tl), want)


@pytest.mark.parametrize("d", [128, 384, 1024])
def test_ln_matmul_plain_is_layer_norm_then_bias_gemm(d):
    """K1's plain version == the row LayerNorm rounded to bf16, then
    bf16(xn @ W^T + b) with the sum and the bias in f32, bit for bit."""
    rng = np.random.RandomState(12)
    m, n = 77, 3 * d
    x = _bf16(rng, m, d)
    g, be = _norm(rng, d)
    w = _bf16(rng, n, d, scale=d**-0.5)
    bias = _bf16(rng, n, scale=0.1)
    xn = port_vb.layer_norm_f32(x, g, be, 1e-6).to(torch.bfloat16)
    got = (xn.float() @ w.float().T + bias.float()).to(torch.bfloat16)
    want = port_vb.ln_matmul_plain(x, g, be, w, bias, eps=1e-6)
    assert torch.equal(got, want)
    assert torch.equal(port_vb.ln_matmul(x, g, be, w, bias), want)


@pytest.mark.parametrize("d", [384, 768])
def test_ln_matmul_plain_matches_jax_kernel_at_new_widths(d):
    """K1 plain vs the Pallas ``ln_matmul`` at widths that are 128- but
    not 256-multiples, N = 3 D, ragged M (bf16, one rounding)."""
    rng = np.random.RandomState(13)
    m, n = 77, 3 * d
    x = _bf16(rng, m, d)
    g, be = _norm(rng, d)
    w = _bf16(rng, d, n, scale=d**-0.5)  # the JAX layout, [D, N]
    bias = _bf16(rng, n, scale=0.1)
    want = np.asarray(jax_vbp.ln_matmul(
        _j(x), jnp.asarray(g.numpy()), jnp.asarray(be.numpy()), _j(w),
        _j(bias), out_dtype=jnp.bfloat16), np.float32)
    got = port_vb.ln_matmul(x, g, be, w.T.contiguous(), bias)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_ln_mlp_residual_plain_matches_jax_kernel_at_width_384():
    """K3 plain vs the Pallas ``ln_mlp_residual`` at D = 384 (F = 4 D),
    a width the row LayerNorm now takes (bf16)."""
    rng = np.random.RandomState(14)
    m, d = 77, 384
    f = 4 * d
    x = _bf16(rng, m, d)
    g, be = _norm(rng, d)
    w1 = _bf16(rng, d, f, scale=d**-0.5)
    b1 = _bf16(rng, f, scale=0.1)
    w2 = _bf16(rng, f, d, scale=f**-0.5)
    b2 = _bf16(rng, d, scale=0.1)

    want = np.asarray(jax_vbp.ln_mlp_residual(
        _j(x), jnp.asarray(g.numpy()), jnp.asarray(be.numpy()), _j(w1),
        _j(b1), _j(w2), _j(b2), out_dtype=jnp.bfloat16), np.float32)
    got = port_vb.ln_mlp_residual(x, g, be, w1.T.contiguous(), b1,
                                  w2.T.contiguous(), b2)
    # The MLP output is rounded to bf16 before x is added: where the two
    # packages' sums land one ulp apart at |out| < 8 and x nearly cancels
    # out, the results differ by up to that ulp, 2^-5, at any size.
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=2**-5)


@pytest.mark.parametrize("h,d", [(2, 128), (16, 64)])
def test_qkv_proj_plain_matches_jax_kernel_at_new_heads(h, d):
    """K4 plain vs the Pallas ``flash_mha_qkv_proj`` at head dim 128 and
    at ViT-L's 16 heads of 64, keys >= true_len masked (bf16)."""
    rng = np.random.RandomState(15)
    b, s, dm, tl = 1, 160, 256, 145
    hd = h * d
    qkv = _bf16(rng, b, s, 3 * hd)
    x = _bf16(rng, b, s, dm)
    pk = _bf16(rng, hd, dm, scale=0.02)  # the JAX layout, [H*D, Dm]
    pb = _bf16(rng, dm, scale=0.02)

    want = np.asarray(jax_flash.flash_mha_qkv_proj(
        _j(qkv), _j(x), _j(pk), _j(pb), num_heads=h, out_dtype=jnp.bfloat16,
        true_len=tl), np.float32)
    got = port_flash.flash_mha_qkv_proj(qkv, x, pk.T.contiguous(), pb,
                                        num_heads=h, true_len=tl)
    np.testing.assert_allclose(got[:, :tl].float().numpy(), want[:, :tl],
                               **BF16_TOL)
