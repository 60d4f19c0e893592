"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without an NVIDIA GPU (decided inside
the ``cuda`` fixture). The file imports neither JAX nor ``pnp_ovss_tpu``,
so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

It covers the shapes and code paths ``chip_smoke.py`` does not reach at
the main path's shapes: head dim 128, ragged sequence and pixel counts,
row-padded anchors, one variant and fewer than 64 state rows; for the
fused ViT kernels (K1, K3, K4) row counts that are no multiple of the
row tile, narrow widths, masked keys and several key tiles; for K8 ragged
N and M, M != N, 1 to 150 channels, strided values, 8 features, the split
over j, bit-equal launches, empty inputs and the stalled ring's trap; the
CRF's exact, Nystrom and general-loop branches on the card against the
CPU; K7 at
ragged chunks against K2's rows, K9 at odd S, and a two-rank
sequence-parallel encode with both ranks on the one card (gloo); the
evaluation path on the card (``make_hist_fn`` over ragged batches against
numpy, labels kept on the card by ``result(materialize_labels=False)``)
and the tiny-width CLI on the card against the same run on the CPU; the
synthetic postprocess gate's device side (strided s=4 and exact, bucket
192) on the card against the CPU, and the search's all-layer GradCAM
ensemble at odd text lengths.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pnp_ovss_tpu_torch.config import CRFConfig, ViTConfig
from pnp_ovss_tpu_torch.models.vit import VisionTransformer
from pnp_ovss_tpu_torch.ops import (
    _build, bilateral, crf, flash_attention, vit_block,
)
from test_torch_sp_ranks import run_ranks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


@pytest.mark.parametrize("d,s,true_len", [(64, 130, None), (64, 200, 171),
                                          (128, 150, None), (128, 77, 60)])
def test_flash_kernel_matches_plain(cuda, d, s, true_len):
    """bf16 P in the P.V product and a bf16 output: ~2^-8 relative on
    outputs of O(1)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, h = 3, 4
    qkv = _randn(gen, b, s, 3 * h * d).to(torch.bfloat16)
    before = _build.LAUNCHES["flash_mha_flat_qkv"]
    out = flash_attention.flash_mha_flat_qkv(qkv, num_heads=h,
                                             true_len=true_len)
    assert _build.LAUNCHES["flash_mha_flat_qkv"] == before + 1
    hd = h * d
    ref = flash_attention.attention_plain(
        qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:], num_heads=h,
        true_len=true_len or s, out_dtype=torch.float32)
    rows = true_len or s
    err = (out[:, :rows].float() - ref[:, :rows]).abs().max().item()
    assert err < 2e-2, err


def test_flash_sliced_views_match_qkv_entry(cuda):
    """K2' on strided q/k/v views equals the qkv entry bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, s, h, d = 2, 143, 2, 64
    big = _randn(gen, b, s, 4 * h * d).to(torch.bfloat16)
    qkv = big[..., :3 * h * d].contiguous()
    hd = h * d
    a = flash_attention.flash_mha_flat_qkv(qkv, num_heads=h)
    c = flash_attention.flash_mha_flat(big[..., :hd], big[..., hd:2 * hd],
                                       big[..., 2 * hd:3 * hd], num_heads=h)
    torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_flash_kernel_refuses_f32(cuda):
    qkv = torch.zeros(1, 130, 3 * 128, device=cuda)
    with pytest.raises(TypeError):
        flash_attention.flash_mha_flat_qkv(qkv, num_heads=2)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("entry", ["qkv", "flat", "xlen", "bhsd"])
def test_flash_entries_match_plain_across_the_ring(cuda, entry, d):
    """Every entry of the flash kernel (qkv views, three sliced arrays, a
    query chunk over more keys, [B, H, S, D]) at S and true_len that are
    no multiple of the 64-key tile or of any query tile, over more key
    tiles than the ring has stages, against its plain version: bf16 P in
    the P.V product and a bf16 output."""
    from pnp_ovss_tpu_torch.ops.attention import mha_plain

    gen = torch.Generator(device=cuda).manual_seed(13)
    b, h, s, tl = 2, 3, 517, 483
    hd = h * d
    qkv = _randn(gen, b, s, 3 * hd).to(torch.bfloat16)
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    lo, hi = 37, 400  # the xlen entry's query chunk
    counter = {"qkv": "flash_mha_flat_qkv", "flat": "flash_mha_flat_qkv",
               "xlen": "flash_mha_flat_xlen", "bhsd": "flash_mha"}[entry]
    before = _build.LAUNCHES[counter]
    if entry == "bhsd":
        qh, kh, vh = (x.unflatten(-1, (h, d)).transpose(1, 2)
                      for x in (q, k, v))
        out = flash_attention.flash_mha(qh, kh, vh)
        ref = mha_plain(qh, kh, vh, out_dtype=torch.float32)
        rows = s
    elif entry == "xlen":
        out = flash_attention.flash_mha_flat_xlen(
            q[:, lo:hi], k, v, num_heads=h, true_kv_len=tl)
        ref = flash_attention.attention_plain(
            q[:, lo:hi], k, v, num_heads=h, true_len=tl,
            out_dtype=torch.float32)
        rows = hi - lo
    else:
        out = (flash_attention.flash_mha_flat_qkv(qkv, num_heads=h,
                                                  true_len=tl)
               if entry == "qkv" else
               flash_attention.flash_mha_flat(q.contiguous(), k.contiguous(),
                                              v.contiguous(), num_heads=h,
                                              true_len=tl))
        ref = flash_attention.attention_plain(q, k, v, num_heads=h,
                                              true_len=tl,
                                              out_dtype=torch.float32)
        rows = tl
    assert _build.LAUNCHES[counter] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    err = (out[..., :rows, :].float() - ref[..., :rows, :]).abs().max() \
        if entry == "bhsd" else \
        (out[:, :rows].float() - ref[:, :rows]).abs().max()
    assert err.item() < 5e-3, err.item()


def _feats(gen, n):
    u = torch.rand((n, 5), generator=gen, device=gen.device)
    return u * torch.tensor([10, 10, 51, 51, 51], device=gen.device)


@pytest.mark.parametrize("m,n", [(37, 150), (300, 4096), (2304, 36864)])
def test_materialize_kernel_matches_plain(cuda, m, n):
    """Realistic feature magnitudes (rgb/5 up to 51); N=150 takes the
    kernel's unaligned store path, M=37 and 300 leave pad rows, and
    2304 x 36864 is the main path's shape. Codes may differ from plain by
    one where k*255 sits at a rounding boundary (the exponent's
    arithmetic differs from torch.exp's); the share that differs is
    printed and held to 1e-3."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    fj, fi = _feats(gen, m), _feats(gen, n)
    kt = bilateral.gaussian_kernel_materialize(fj, fi)
    m_pad = kt.shape[0]
    assert m_pad % 128 == 0 and not kt[m:].any()
    ref = bilateral.materialize_plain(fj, fi, m_pad, torch.uint8)
    assert (kt.int() - ref.int()).abs().max().item() <= 1
    share = (kt != ref).sum().item() / kt.numel()
    print(f"M={m} N={n}: {share:.3g} of the codes differ from plain")
    assert share <= 1e-3
    del kt, ref
    kf = bilateral.gaussian_kernel_materialize(fj, fi,
                                               out_dtype=torch.float32)
    reff = bilateral.materialize_plain(fj, fi, m_pad, torch.float32)
    assert (kf - reff).abs().max().item() < 1e-6


@pytest.mark.parametrize("v,c,r,m,n", [
    (1, 5, 16, 256, 1024), (2, 20, 48, 256, 1024), (2, 29, 64, 256, 1024),
    (2, 13, 32, 256, 1024),  # R = 16, 32, 48, 64
    (1, 5, 64, 256, 1024),  # pad rows beyond v*c rounded up
    (2, 29, 64, 2304 + 32, 1024),  # M % 64 != 0: a half k-step
    (2, 29, 64, 256, 1152),  # N not a multiple of 256 (9 x 128)
    (2, 29, 64, 256, 4096),  # bucket 64, the narrow runs' shape
    (2, 29, 64, 2304, 36864),  # the main path's shape
])
def test_crf_iteration_kernel_matches_plain(cuda, v, c, r, m, n):
    """Probabilities rounded to bf16 once: within 2 ulps at 1.0."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    kt = torch.randint(0, 256, (m, n), generator=gen, device=cuda,
                       dtype=torch.uint8)
    # y = qsub @ codes keeps the same scale at every M.
    qsub = torch.rand((r, m), generator=gen, device=cuda) * 0.05 * 256 / m
    qsub[v * c:] = 0
    u_neg = torch.log(torch.rand((r, n), generator=gen, device=cuda) + 1e-3)
    u_neg[v * c:] = 0
    msp = torch.rand((r, n), generator=gen, device=cuda) * 7
    nb = torch.rand((1, n), generator=gen, device=cuda) * 0.01
    args = (qsub.to(torch.bfloat16), kt, u_neg.to(torch.bfloat16),
            msp.to(torch.bfloat16), nb)
    out = bilateral.crf_fused_iteration(*args, v=v, c=c)
    ref = bilateral.crf_iteration_plain(*args, v=v, c=c,
                                        out_dtype=torch.bfloat16)
    assert (out.float() - ref.float()).abs().max().item() < 1e-2
    assert not out[v * c:].any()
    # N % 128 != 0 is refused on the card, never run by the plain version.
    cut = [t[:, :n - 64].contiguous() for t in args[1:]]
    with pytest.raises(ValueError):
        bilateral.crf_fused_iteration(args[0], *cut, v=v, c=c)


def _photo_features(gen, shift=0.0):
    """Bilateral features of a 192 px photo-like scene (smooth texture
    with noise) scaled as the runner scales them for a 500x375 GT, the
    colours shifted by ``shift`` feature units: the exact CRF's features
    at the main path's magnitudes."""
    hb = 192
    yy, xx = torch.meshgrid(
        torch.arange(hb, dtype=torch.float32, device=gen.device),
        torch.arange(hb, dtype=torch.float32, device=gen.device),
        indexing="ij")
    img = torch.stack([120 + 60 * torch.sin(xx / 9) + 40 * yy / hb,
                       100 + 50 * torch.cos(yy / 7) + 30 * xx / hb,
                       90 + 45 * torch.sin((xx + yy) / 11)], -1)
    img = (img + 12 * _randn(gen, hb, hb, 3)).clamp(0, 255)
    cfg = CRFConfig()
    scale = torch.tensor([hb / 375, hb / 500], device=gen.device)
    feats = crf.bilateral_features(img, cfg.bi_xy_std * scale, cfg.bi_rgb_std)
    feats[:, 2:] += shift
    return feats


def _matmul_vs_plain(fi, vals, fj=None):
    """K8 through the wrapper (one counted launch) against its plain
    version: max |K8 - plain| over max |plain|."""
    before = _build.LAUNCHES["gaussian_kernel_matmul"]
    out = bilateral.gaussian_kernel_matmul(fi, vals, fj)
    assert _build.LAUNCHES["gaussian_kernel_matmul"] == before + 1
    ref = bilateral.kernel_matmul_plain(fi, vals, fj)
    assert out.shape == ref.shape and out.dtype == torch.float32
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _plan(fi, fj, c):
    sms = torch.cuda.get_device_properties(fi.device).multi_processor_count
    return bilateral.matmul_plan(fi.shape[0], fj.shape[0], c, sms)


@pytest.mark.parametrize("n,m,c,view,scene", [
    (1000, None, 1, False, "clustered"), (1000, None, 58, False, "clustered"),
    (777, 130, 82, False, "clustered"), (130, 777, 58, True, "clustered"),
    (1000, None, 150, True, "clustered"),
    (2000, 36864, 58, False, "photo+40")])
def test_kernel_matmul_matches_plain(cuda, n, m, c, view, scene):
    """K8 at ragged N and M (no multiple of the 128-row tile or the
    64-column stage), M != N both ways, C = 1 (the degree), 58 (two
    variants of 29), 82 (--max_classes 40) and 150 (two 128-channel
    chunks), and values as a strided transposed view; and on the exact
    CRF's photo-like features with every colour shifted by +40 units
    (2000 rows against all 36864 pixels), where the uncentred expansion
    would lose ~2e-3 in the exponent. Both round k to bf16, so a k code
    may flip where the exponent's rounding differs: one bf16 ulp of one
    term, bounded by 5e-3 of the largest output."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    if scene == "photo+40":
        fj = _photo_features(gen, 40.0)
        fi = fj[torch.randperm(fj.shape[0], generator=gen, device=cuda)[:n]]
        vals = torch.softmax(_randn(gen, m, 2, c // 2), -1).reshape(m, c)
    else:
        fi = _feats(gen, n)
        fj = None if m is None else _feats(gen, m)
        # Clustered colours so that many pairs interact, not only the self
        # term.
        for f in (fi, fj):
            if f is not None:
                f[:, 2:] = (f[:, 2:] / 8).round() * 8 + 0.3 * _randn(
                    gen, f.shape[0], 3)
        rows = n if m is None else m
        if view:
            vals = _randn(gen, c, 2 * rows)[:, ::2].t()
            assert not vals.is_contiguous()
        else:
            vals = _randn(gen, rows, c)
    err = _matmul_vs_plain(fi, vals, fj)
    assert err <= 5e-3, err


@pytest.mark.parametrize("n,m", [(300, 20037), (2304, 36864 - 40)])
def test_kernel_matmul_split_over_j(cuda, n, m):
    """Few row tiles against many columns (the Nystrom K_AN shape: 18
    row tiles for 132 SMs) split j into chunks summed by the last unit of
    each row tile; M is no multiple of a chunk or of a stage."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    fi, fj = _feats(gen, n), _feats(gen, m)
    vals = _randn(gen, m, 58)
    assert _plan(fi, fj, 58)[2] > 1
    assert _matmul_vs_plain(fi, vals, fj) <= 5e-3


def test_kernel_matmul_exact_shape_fills_the_card(cuda):
    """The exact CRF's shape (N = M = 36864, C = 58): 288 row tiles split
    over j into units that give every SM within 5% of the same count, and
    the first 1024 rows against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    feats = _photo_features(gen)
    n = feats.shape[0]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    width, chunks, split = bilateral.matmul_plan(n, n, 58, sms)
    units = -(-n // 128) * chunks * split
    print(f"exact shape on {sms} SMs: width {width}, split {split}, "
          f"{units} units, {units / sms:.3f} an SM")
    assert (width, chunks) == (64, 1)
    assert -(-units // sms) <= 1.05 * units / sms
    vals = torch.softmax(_randn(gen, n, 2, 29), -1).reshape(n, 58)
    out = bilateral.gaussian_kernel_matmul(feats, vals)
    ref = bilateral.kernel_matmul_plain(feats[:1024], vals, feats)
    err = ((out[:1024] - ref).abs().max() / ref.abs().max()).item()
    assert err <= 5e-3, err


def test_kernel_matmul_degree_runs_n8(cuda):
    """The degree launch (C = 1) runs wgmma's n = 8, with a split."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    fi = _feats(gen, 4096)
    assert _plan(fi, fi, 1)[:2] == (8, 1)
    assert _matmul_vs_plain(fi, torch.ones((4096, 1), device=cuda)) <= 5e-3


@pytest.mark.parametrize("c,width,chunks", [(150, 96, 2), (82, 96, 1),
                                            (129, 96, 2), (33, 48, 1)])
def test_kernel_matmul_channel_chunks(cuda, c, width, chunks):
    """C = 150 and 129 in two equal chunks (n = 96 each), C = 82 in one of
    n = 96, C = 33 at n = 48."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    fi, fj = _feats(gen, 700), _feats(gen, 900)
    assert _plan(fi, fj, c)[:2] == (width, chunks)
    assert _matmul_vs_plain(fi, _randn(gen, 900, c), fj) <= 5e-3


@pytest.mark.parametrize("f", [6, 8])
def test_kernel_matmul_eight_features(cuda, f):
    """F = 6..8 runs the 8-feature build (zeros beyond F)."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    fi = torch.rand((900, f), generator=gen, device=cuda) * 12
    fj = torch.rand((1300, f), generator=gen, device=cuda) * 12
    assert _matmul_vs_plain(fi, _randn(gen, 1300, 58), fj) <= 5e-3


def test_kernel_matmul_is_deterministic(cuda):
    """Two launches on the same inputs, at shapes with and without a
    split over j, are bit-equal (the partials are summed in a fixed
    order; no float atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    feats = _photo_features(gen)
    anchors = feats.reshape(192, 192, 5)[::4, ::4].reshape(-1, 5)
    for fi, fj, c in ((anchors, feats, 58), (feats, None, 58),
                      (feats, None, 1), (feats[:500], feats[:300], 58)):
        fn = bilateral.kernel_matmul_fn(fi, fj)
        vals = torch.rand(((fi if fj is None else fj).shape[0], c),
                          generator=gen, device=cuda)
        a, b = fn(vals), fn(vals)
        assert torch.equal(a, b)
        assert torch.equal(a, bilateral.gaussian_kernel_matmul(fi, vals, fj))


def test_kernel_matmul_stalled_ring_traps(cuda):
    """A ring stage whose bytes never arrive ends the launch with an error
    (the stage wait traps after ~2 s), not a hang. It runs in a child
    process, since a trap leaves the CUDA context unusable."""
    code = (
        "import torch\n"
        "from pnp_ovss_tpu_torch.ops import _build\n"
        "lib = _build.library('crf_matmul')\n"
        "torch.zeros(1, device='cuda')\n"
        "rc = lib.gaussian_kernel_matmul_stall("
        "torch.cuda.current_stream().cuda_stream)\n"
        "print('launched:', rc)\n"
        "try:\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('trapped:', e)\n")
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert "launched: 0" in res.stdout, res.stdout + res.stderr
    assert "trapped:" in res.stdout, res.stdout + res.stderr


def test_kernel_matmul_refuses_mixed_devices(cuda):
    f = torch.zeros(64, 5, device=cuda)
    with pytest.raises(ValueError):
        bilateral.gaussian_kernel_matmul(f, torch.zeros(64, 3))


def test_kernel_matmul_empty_inputs(cuda):
    """No rows (N = 0) give an empty [0, C] result and no columns (M = 0)
    zeros [N, C] on the card, as the plain version gives them on the CPU,
    without a launch."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    fi, vals = _feats(gen, 300), _randn(gen, 300, 58)
    before = _build.LAUNCHES["gaussian_kernel_matmul"]
    for rows, cols, v in ((fi[:0], fi, vals),
                          (fi, fi[:0], torch.zeros((0, 58), device=cuda))):
        out = bilateral.gaussian_kernel_matmul(rows, v, cols)
        ref = bilateral.kernel_matmul_plain(rows.cpu(), v.cpu(), cols.cpu())
        assert out.device == v.device and out.dtype == torch.float32
        assert torch.equal(out.cpu(), ref)
    assert _build.LAUNCHES["gaussian_kernel_matmul"] == before


def _crf_scene(seed, size, c, noise):
    """A textured image and two variants of noisy logits over ``c``
    channels, the first two favoured in one half each."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    image = np.stack([120 + 60 * np.sin(xx / 9.0), 100 + 50 * np.cos(yy / 7.0),
                      90 + 45 * np.sin((xx + yy) / 11.0)], -1)
    image = np.clip(image + rng.randn(size, size, 3) * noise, 0, 255)
    logits = rng.randn(2, c, size, size).astype(np.float32) * 0.5
    logits[:, 0, : size // 2] += 0.8
    logits[:, 1, size // 2:] += 0.8
    return torch.from_numpy(logits), torch.from_numpy(image.astype(np.float32))


def _crf_card_vs_cpu(cuda, logits, image, **kw):
    """Labels of mean_field_crf_variants on the CPU and on the card, and
    the card run's launches of each kernel."""
    labels = {}
    for dev in ("cpu", cuda):
        _build.reset_launch_counts()
        labels[str(dev)] = crf.mean_field_crf_variants(
            logits.to(dev), image.to(dev), CRFConfig(), xy_scale=(0.4, 0.5),
            **kw).cpu()
    agree = (labels["cpu"] == labels["cuda"]).float().mean().item()
    return agree, dict(_build.LAUNCHES)


@pytest.mark.parametrize("kw", [dict(bilateral_subsample=1),
                                dict(bilateral_subsample=4,
                                     bilateral_mode="nystrom")])
def test_k8_crf_on_card_matches_cpu(cuda, kw):
    """The exact and Nystrom CRFs on the card (K8; Nystrom's K_AA from K5
    in f32) against the CPU (plain versions) on a textured scene."""
    agree, launches = _crf_card_vs_cpu(cuda, *_crf_scene(9, 48, 4, 4), **kw)
    nystrom = kw.get("bilateral_mode") == "nystrom"
    assert launches["gaussian_kernel_matmul"] == \
        (2 if nystrom else 1) * (CRFConfig().num_iters + 1)
    assert launches["gaussian_kernel_materialize"] == int(nystrom)
    assert agree > 0.99, agree


@pytest.mark.parametrize("size,c", [(64, 33), (40, 4)])
def test_general_loop_crf_on_card_matches_cpu(cuda, size, c):
    """The general mean-field loop on the card (K5's uint8 kernel cast to
    f32, the state rounded to bf16, torch.matmul) against the CPU (f32
    products): 2 x 33 = 66 state rows, beyond K6's 64, and N = 1600, not a
    multiple of 128. K5 launches once, K6 and K8 never."""
    agree, launches = _crf_card_vs_cpu(cuda, *_crf_scene(10, size, c, 12))
    assert launches["gaussian_kernel_materialize"] == 1
    assert launches["crf_fused_iteration"] == 0
    assert launches["gaussian_kernel_matmul"] == 0
    assert agree > 0.99, agree


def test_crf_on_card_matches_cpu(cuda):
    """The whole default CRF branch on the card (K5 + K6, bf16 products)
    against the CPU (plain versions, f32 products) on a textured scene."""
    agree, launches = _crf_card_vs_cpu(cuda, *_crf_scene(4, 64, 4, 12))
    assert launches["crf_fused_iteration"] == CRFConfig().num_iters
    assert agree > 0.99, agree


def _norm_params(gen, d):
    g = 1 + 0.1 * _randn(gen, d)
    return g, 0.1 * _randn(gen, d)


# The fused ViT kernels round to bf16 where their plain versions do, but
# sum in another order, so a value may land one rounding step away (plus
# a second rounding for the residual): 1e-2 relative and absolute on
# outputs of O(1).
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("n", ["128", "384", "3d"])
@pytest.mark.parametrize("d", [128, 256, 768, 1024])
@pytest.mark.parametrize("m", [1, 127, 129, 15470])
def test_ln_matmul_kernel_matches_plain(cuda, m, d, n):
    """K1 (row LayerNorm, then the wgmma GEMM with the bias epilogue) at
    one row, on both sides of one 128-row tile and at the 336 px main
    path's M = 35 x 442; widths up to ViT-L's, N = 128, 384 and the qkv
    projection's 3 D. One bf16 rounding after sums taken in another order
    (and the LayerNorm's in another order too): BF16_TOL."""
    n = 3 * d if n == "3d" else int(n)
    gen = torch.Generator(device=cuda).manual_seed(15)
    x = _randn(gen, m, d).to(torch.bfloat16)
    g, b = _norm_params(gen, d)
    w = (_randn(gen, n, d) / d**0.5).to(torch.bfloat16)
    bias = (0.1 * _randn(gen, n)).to(torch.bfloat16)
    before = dict(_build.LAUNCHES)
    out = vit_block.ln_matmul(x, g, b, w, bias)
    assert _build.LAUNCHES == {**before,
                               "ln_matmul": before["ln_matmul"] + 1}
    ref = vit_block.ln_matmul_plain(x, g, b, w, bias, eps=1e-6)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)


@pytest.mark.parametrize("d", [64, 192])
def test_ln_kernels_take_every_64_multiple(cuda, d):
    """K1 and K3 take D % 64 == 0 (K1's contract), not only the
    128-multiples that ``vit_block.supported`` routes to them."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    m, f = 129, 4 * d
    x = _randn(gen, m, d).to(torch.bfloat16)
    g, b = _norm_params(gen, d)
    w = (_randn(gen, 384, d) / d**0.5).to(torch.bfloat16)
    bias = (0.1 * _randn(gen, 384)).to(torch.bfloat16)
    torch.testing.assert_close(
        vit_block.ln_matmul(x, g, b, w, bias).float(),
        vit_block.ln_matmul_plain(x, g, b, w, bias, eps=1e-6).float(),
        **BF16_TOL)
    w1 = (_randn(gen, f, d) / d**0.5).to(torch.bfloat16)
    b1 = (0.1 * _randn(gen, f)).to(torch.bfloat16)
    w2 = (_randn(gen, d, f) / f**0.5).to(torch.bfloat16)
    b2 = (0.1 * _randn(gen, d)).to(torch.bfloat16)
    torch.testing.assert_close(
        vit_block.ln_mlp_residual(x, g, b, w1, b1, w2, b2).float(),
        vit_block.ln_mlp_residual_plain(x, g, b, w1, b1, w2, b2,
                                        eps=1e-6).float(), **BF16_TOL)


def test_ln_kernels_refuse_widths_above_1024(cuda):
    d = 1088
    x = torch.zeros(8, d, device=cuda, dtype=torch.bfloat16)
    g = torch.ones(d, device=cuda)
    w = torch.zeros(128, d, device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros(128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        vit_block.ln_matmul(x, g, g, w, bias)
    w1 = torch.zeros(256, d, device=cuda, dtype=torch.bfloat16)
    w2 = torch.zeros(d, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        vit_block.ln_mlp_residual(x, g, g, w1, w1[:, 0], w2, w2[:, 0])


@pytest.mark.parametrize("m,d,f", [(77, 128, 512), (300, 256, 1024),
                                   (1001, 1024, 4096), (300, 256, 160)])
def test_ln_mlp_residual_kernel_matches_plain(cuda, m, d, f):
    """F = 160 runs fc1's last 256-wide column tile and fc2's last 64-deep
    k-step past F (zero-filled by TMA, never stored)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _randn(gen, m, d).to(torch.bfloat16)
    g, b = _norm_params(gen, d)
    w1 = (_randn(gen, f, d) / d**0.5).to(torch.bfloat16)
    b1 = (0.1 * _randn(gen, f)).to(torch.bfloat16)
    w2 = (_randn(gen, d, f) / f**0.5).to(torch.bfloat16)
    b2 = (0.1 * _randn(gen, d)).to(torch.bfloat16)
    before = _build.LAUNCHES["ln_mlp_residual"]
    out = vit_block.ln_mlp_residual(x, g, b, w1, b1, w2, b2)
    assert _build.LAUNCHES["ln_mlp_residual"] == before + 1
    ref = vit_block.ln_mlp_residual_plain(x, g, b, w1, b1, w2, b2, eps=1e-6)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)


@pytest.mark.parametrize("m", [1, 127, 15470])
@pytest.mark.parametrize("d", [128, 256, 384, 512, 640, 768, 896, 1024])
def test_ln_mlp_residual_kernel_every_width(cuda, d, m):
    """K3 at every width ``vit_block.supported`` routes to it (D % 128 ==
    0 up to 1024), at one row, at a row count below one 128-row tile and
    at the 336 px main path's M = 35 x 442, F = 4 D.
    The MLP output is rounded to bf16 before x is added, and the kernel
    sums it in another order than the plain version: where it lands one
    ulp apart at |out| in [4, 8) and x nearly cancels it, the result
    differs by 2^-5 at any size. So: at most 1e-5 of the values outside
    BF16_TOL, and none more than 2^-4 (chip_smoke.py's K3 bar) apart."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    f = 4 * d
    x = _randn(gen, m, d).to(torch.bfloat16)
    g, b = _norm_params(gen, d)
    w1 = (_randn(gen, f, d) / d**0.5).to(torch.bfloat16)
    b1 = (0.1 * _randn(gen, f)).to(torch.bfloat16)
    w2 = (_randn(gen, d, f) / f**0.5).to(torch.bfloat16)
    b2 = (0.1 * _randn(gen, d)).to(torch.bfloat16)
    out = vit_block.ln_mlp_residual(x, g, b, w1, b1, w2, b2).float()
    ref = vit_block.ln_mlp_residual_plain(x, g, b, w1, b1, w2, b2,
                                          eps=1e-6).float()
    diff = (out - ref).abs()
    outside = diff > BF16_TOL["atol"] + BF16_TOL["rtol"] * ref.abs()
    assert outside.float().mean().item() <= 1e-5, outside.sum().item()
    assert diff.max().item() <= 0.0625, diff.max().item()


def test_k3_and_flash_refuse_f32_and_mixed_devices(cuda):
    d, f = 128, 512
    x = torch.zeros(64, d, device=cuda)
    g = torch.ones(d, device=cuda)
    w1, b1 = torch.zeros(f, d, device=cuda), torch.zeros(f, device=cuda)
    w2, b2 = torch.zeros(d, f, device=cuda), torch.zeros(d, device=cuda)
    with pytest.raises(TypeError):
        vit_block.ln_mlp_residual(x, g, g, w1, b1, w2, b2)
    bf = [t.bfloat16() for t in (x, w1, b1, w2, b2)]
    with pytest.raises(ValueError):
        vit_block.ln_mlp_residual(bf[0], g, g, bf[1], bf[2], bf[3].cpu(),
                                  bf[4])
    qkv = torch.zeros(1, 130, 3 * 128, device=cuda)
    with pytest.raises(TypeError):
        flash_attention.flash_mha_flat(qkv[..., :128], qkv[..., 128:256],
                                       qkv[..., 256:], num_heads=2)
    qb = qkv.bfloat16()
    with pytest.raises(ValueError):
        flash_attention.flash_mha_flat(qb[..., :128], qb[..., 128:256].cpu(),
                                       qb[..., 256:], num_heads=2)


def test_gelu_kernel_matches_plain_on_every_code(cuda):
    """The plain gelu that K3 is checked against computes on the card
    what it computes on the CPU (where the tests hold it to JAX), bit for
    bit on every finite bf16 code."""
    codes = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    y = codes.view(torch.bfloat16)
    y = y[torch.isfinite(y)]
    torch.testing.assert_close(vit_block.gelu_exact(y.to(cuda)).cpu(),
                               vit_block.gelu_exact(y), rtol=0, atol=0)


@pytest.mark.parametrize("b,s,h,d,dm,true_len", [
    (2, 300, 4, 64, 256, 260), (1, 577, 2, 64, 128, None),
    (2, 200, 2, 128, 256, 171), (1, 130, 16, 64, 1024, None),
    (12, 2305, 16, 64, 1024, None)])
def test_qkv_proj_kernel_matches_plain(cuda, b, s, h, d, dm, true_len):
    """Several 64-key tiles, keys >= true_len masked, head dim 128, the 16
    heads of ViT-L and the 768 px main path's shape; rows >= true_len are
    garbage by contract. Within BF16_TOL of the plain version, and equal
    bit for bit to the card's K2 followed by the sequence-parallel block's
    ``x + (F.linear(out, Wp) + bp)``: K4's head outputs come from K2's
    kernel, and its proj sums in cuBLAS's k order and rounds where the
    block rounds. One K4 launch is counted, and no K2 launch."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    qkv = _randn(gen, b, s, 3 * h * d).to(torch.bfloat16)
    x = _randn(gen, b, s, dm).to(torch.bfloat16)
    pw = (_randn(gen, dm, h * d) / (h * d)**0.5).to(torch.bfloat16)
    pb = (0.1 * _randn(gen, dm)).to(torch.bfloat16)
    before = dict(_build.LAUNCHES)
    out = flash_attention.flash_mha_qkv_proj(qkv, x, pw, pb, num_heads=h,
                                             true_len=true_len)
    assert _build.LAUNCHES == {
        **before, "flash_mha_qkv_proj": before["flash_mha_qkv_proj"] + 1}
    tl = true_len or s
    ref = flash_attention.qkv_proj_plain(qkv, x, pw, pb, num_heads=h,
                                         true_len=tl)
    torch.testing.assert_close(out[:, :tl].float(), ref[:, :tl].float(),
                               **BF16_TOL)
    heads = flash_attention.flash_mha_flat_qkv(qkv, num_heads=h,
                                               true_len=true_len)
    split = x + (torch.nn.functional.linear(heads, pw) + pb)
    assert torch.equal(out[:, :tl], split[:, :tl])


def test_fused_kernels_refuse_f32(cuda):
    x = torch.zeros(64, 128, device=cuda)
    g = torch.ones(128, device=cuda)
    with pytest.raises(TypeError):
        vit_block.ln_matmul(x, g, g, torch.zeros(128, 128, device=cuda),
                            torch.zeros(128, device=cuda))


@pytest.mark.parametrize("d,s,true_len,lo,hi", [
    (64, 442, 442, 221, 442), (64, 300, 261, 0, 150), (128, 200, 171, 77, 200),
    (128, 130, 130, 5, 90)])
def test_xlen_rows_bit_equal_to_flat_kernel(cuda, d, s, true_len, lo, hi):
    """K7 on the query chunk [lo, hi) over all S keys, keys >= true_len
    masked, equals K2's rows [lo, hi) over the whole sequence bit for bit
    (rows >= true_len are garbage by contract), and its plain version
    within K2's bar. Chunks start and end off the 64-row tile."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    b, h = 2, 3
    hd = h * d
    qkv = _randn(gen, b, s, 3 * hd).to(torch.bfloat16)
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    full = flash_attention.flash_mha_flat(q, k, v, num_heads=h,
                                          true_len=true_len)
    before = _build.LAUNCHES["flash_mha_flat_xlen"]
    part = flash_attention.flash_mha_flat_xlen(
        q[:, lo:hi], k, v, num_heads=h, true_kv_len=true_len)
    assert _build.LAUNCHES["flash_mha_flat_xlen"] == before + 1
    rows = min(hi, true_len) - lo
    torch.testing.assert_close(part[:, :rows], full[:, lo:lo + rows],
                               rtol=0, atol=0)
    ref = flash_attention.attention_plain(
        q[:, lo:hi], k, v, num_heads=h, true_len=true_len,
        out_dtype=torch.float32)
    assert (part[:, :rows].float() - ref[:, :rows]).abs().max().item() < 2e-2


@pytest.mark.parametrize("b,h,s,d", [(2, 3, 145, 64), (1, 2, 301, 128),
                                     (3, 1, 77, 64)])
def test_bhsd_kernel_matches_plain(cuda, b, h, s, d):
    """K9 on [B, H, S, D] at odd S, contiguous and as the unfused ViT
    passes it (strided head views of one qkv array), against
    ``mha_plain``: bf16 P and output, K2's bar."""
    from pnp_ovss_tpu_torch.ops.attention import mha_plain

    gen = torch.Generator(device=cuda).manual_seed(12)
    qkv = _randn(gen, b, s, 3, h, d).to(torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    before = _build.LAUNCHES["flash_mha"]
    out = flash_attention.flash_mha(q, k, v)
    assert _build.LAUNCHES["flash_mha"] == before + 1
    assert out.shape == (b, h, s, d) and out.dtype == torch.bfloat16
    ref = mha_plain(q, k, v, out_dtype=torch.float32)
    assert (out.float() - ref).abs().max().item() < 2e-2
    dense = flash_attention.flash_mha(q.contiguous(), k.contiguous(),
                                      v.contiguous())
    torch.testing.assert_close(dense, out, rtol=0, atol=0)


def test_xlen_and_bhsd_refuse_f32_and_mixed_devices(cuda):
    q = torch.zeros(1, 16, 130, 3 * 64, device=cuda)[..., :64]
    with pytest.raises(TypeError):
        flash_attention.flash_mha(q, q, q)
    with pytest.raises(ValueError):
        flash_attention.flash_mha(q.bfloat16(), q.bfloat16(),
                                  q.bfloat16().cpu())
    x = torch.zeros(1, 130, 128, device=cuda)
    with pytest.raises(TypeError):
        flash_attention.flash_mha_flat_xlen(x, x, x, num_heads=2)
    with pytest.raises(ValueError):
        flash_attention.flash_mha_flat_xlen(
            x.bfloat16(), x.bfloat16().cpu(), x.bfloat16(), num_heads=2)


def test_two_rank_sp_encode_on_one_card(cuda, tmp_path):
    """The fused narrow ViT (width 128, 2 heads, 192 px: 145 tokens) split
    over two ranks that share the card through gloo equals the unsharded
    encode on the card bit for bit: K7's rows are K2's, K1 and K3 are
    row-local, and cuBLAS sums the proj in the same order over 73 rows as
    over 145 (chip_smoke.py holds the full-width runs to the same). Each
    rank launches K7 once per layer and never K2 or K4."""
    cfg = ViTConfig(image_size=192, hidden_size=128, num_layers=2,
                    num_heads=2)
    torch.manual_seed(0)
    vit = VisionTransformer(cfg).to(cuda).requires_grad_(False)
    for p in vit.parameters():
        p.normal_(0, 0.05)
    images = torch.rand((2, 192, 192, 3), device=cuda)
    with torch.no_grad():
        want = vit(images)
    ranks = run_ranks({"vit": ("encode", vit, images)}, [str(cuda)] * 2,
                      tmp_path)
    for out in ranks:
        got = out["vit"]
        assert got.shape == want.shape == (2, 145, 128)
        torch.testing.assert_close(got, want.cpu(), rtol=0, atol=0)
        n = out["launches"]
        assert n["flash_mha_flat_xlen"] == cfg.num_layers
        assert n["flash_mha_flat_qkv"] == n["flash_mha_qkv_proj"] == 0


def _tiny_runner(device):
    """The tiny pipeline (capture layer 0 of 2) on ``device``."""
    from pnp_ovss_tpu_torch.config import PipelineConfig
    from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

    cfg = PipelineConfig.tiny()
    cfg = dataclasses.replace(
        cfg, attribution=dataclasses.replace(cfg.attribution, layer=1,
                                             head=1))
    model = init_blip_itm(cfg.model, capture_layers=(0,), device=device)
    return cfg, SegmentationRunner(cfg, model, device=device, bucket_size=32)


@pytest.mark.parametrize("b,nb", [(5, 5), (6, 1)])
def test_make_hist_fn_on_the_card_equals_numpy(cuda, b, nb):
    """Per-image hists on the card for a batch whose last ``b - nb`` rows
    are padding (tables all 0), against numpy ``fast_hist``."""
    from pnp_ovss_tpu_torch.evalx.metrics import fast_hist

    _, runner = _tiny_runner(cuda)
    rng = np.random.RandomState(b)
    labels = rng.randint(0, 6, (b, 40, 40)).astype(np.uint8)
    tables = np.zeros((b, 7), np.int32)
    tables[:nb, 1:6] = rng.randint(1, 21, (nb, 5))
    gt = rng.randint(0, 21, (b, 40, 40)).astype(np.int32)
    gt[rng.rand(b, 40, 40) < 0.1] = 255
    got = runner.make_hist_fn(21)(
        torch.as_tensor(labels, device=cuda),
        torch.as_tensor(tables, device=cuda), torch.as_tensor(gt, device=cuda))
    assert got.is_cuda and got.dtype == torch.int32
    for i in range(b):
        keep = gt[i] < 21
        pred = tables[i][labels[i].astype(np.int64)]
        want = fast_hist(gt[i][keep], pred[keep], 21)
        np.testing.assert_array_equal(got[i].cpu().numpy(), want)


def test_result_keeps_labels_on_the_card(cuda):
    from pnp_ovss_tpu_torch.text.captions import build_caption_batch
    from pnp_ovss_tpu_torch.text.wordpiece import WordPieceTokenizer

    cfg, runner = _tiny_runner(cuda)
    tok = WordPieceTokenizer.toy(["a", "picture", "of", "dog", "cat"])
    cap = build_caption_batch([["dog", "cat"], ["cat"]], tok,
                              max_text_len=16, max_classes=cfg.max_classes)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 48, 48, 3)).astype(np.uint8)
    rgb = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.float32)
    pending = runner.submit_batch(images, cap, rgb)
    kept = pending.result(materialize_labels=False)
    assert kept.labels_r0.is_cuda and kept.labels_agg.is_cuda
    assert kept.labels_agg.shape == (2, 32, 32)
    host = pending.result()
    np.testing.assert_array_equal(host.labels_agg,
                                  kept.labels_agg.cpu().numpy())


def test_tiny_cli_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """The port's CLI at the tiny widths on a fake VOC directory (five
    VOC-sized images, batch 4: a ragged tail of one) from one tiny
    LAVIS-layout checkpoint, ``--device cuda`` against ``--device cpu``:
    per image, hists within 1% of the image's pixels in L1 (the CPU
    test's bar against the JAX CLI)."""
    import chip_smoke
    from pnp_ovss_tpu_torch.cli import segment
    from pnp_ovss_tpu_torch.config import ModelConfig

    real = segment.build_config

    def tiny(args):
        cfg = real(args)
        model = ModelConfig.tiny()
        model = dataclasses.replace(
            model, vit=dataclasses.replace(model.vit,
                                           image_size=args.img_size),
            max_text_len=args.max_txt_len)
        return dataclasses.replace(
            cfg, model=model,
            drop=dataclasses.replace(cfg.drop, patches_per_round=2))

    monkeypatch.setattr(segment, "build_config", tiny)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    data = str(tmp_path / "voc")
    sizes = chip_smoke.write_fake_voc(data, 5)
    ckpt = tmp_path / "model.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                chip_smoke.lavis_state_dict(ModelConfig.tiny(), 3).items()},
               ckpt)
    args = ["--data_type", "voc", "--home_dir", data, "--checkpoint",
            str(ckpt), "--img_size", "48", "--batch_size", "4",
            "--drop_iter", "2", "--bucket_size", "32", "--max_txt_len", "32",
            "--max_att_block_num", "1", "--prune_att_head", "1",
            "--max_classes", "4"]
    for dev in ("cuda", "cpu"):
        segment.main(args + ["--save_path", str(tmp_path / dev),
                             "--device", dev])
    card = chip_smoke.read_hists(str(tmp_path / "cuda"))
    cpu = chip_smoke.read_hists(str(tmp_path / "cpu"))
    for sub in chip_smoke.HIST_DIRS:
        assert sorted(card[sub]) == sorted(cpu[sub]) == sorted(sizes)
        for img_id, h in card[sub].items():
            pixels = sizes[img_id][0] * sizes[img_id][1]
            assert h.sum() == pixels
            l1 = np.abs(h - cpu[sub][img_id]).sum()
            assert l1 <= 0.01 * pixels, (sub, img_id, l1)


def _gate():
    import chip_smoke

    return chip_smoke.load_script("synthetic_postprocess_gate_torch")


@pytest.mark.parametrize("tag", ["strided_s4_b192", "exact_s1_b192"])
def test_gate_device_side_on_the_card_matches_the_cpu(cuda, tag):
    """The synthetic gate's device side (``_post`` at bucket 192, then
    the nearest upsample to GT) on the card against the CPU on the gate's
    first two scenes of seed 0: GT-resolution labels equal on at least
    99% of pixels (the card's CRF products are bf16, the CPU's f32;
    phase 4 of chip_smoke holds each CRF branch alone at 0.999 at 64 x
    64)."""
    from pnp_ovss_tpu_torch.config import PipelineConfig
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

    gate = _gate()
    _, mode, sub, bucket = next(c for c in gate.DEVICE_GRID if c[0] == tag)
    base = PipelineConfig()
    cfg = dataclasses.replace(base, postprocess=dataclasses.replace(
        base.postprocess, bilateral_mode=mode, bilateral_subsample=sub))
    scenes = gate.make_scenes(0, 2, 6, base.model.vit.grid)
    tgrids = [gate.threshold_grid(m, k, base) for (_, _, m), _, k in scenes]
    _build.reset_launch_counts()
    card = gate.device_labels(SegmentationRunner(cfg, None, device=cuda,
                                                 bucket_size=bucket),
                              scenes, tgrids)
    kernel = "crf_fused_iteration" if sub > 1 else "gaussian_kernel_matmul"
    assert _build.LAUNCHES[kernel] > 0
    cpu = gate.device_labels(SegmentationRunner(cfg, None, device="cpu",
                                                bucket_size=bucket),
                             scenes, tgrids)
    for a, b in zip(card, cpu):
        assert a.shape == b.shape and len(np.unique(a)) > 1
        assert (a == b).mean() >= 0.99, (a == b).mean()


@pytest.mark.parametrize("text_len", [13, 29])
def test_ensemble_gradcam_on_the_card_at_odd_text_lengths(cuda, text_len):
    """The all-layer GradCAM ensemble of a narrow model whose ViT the
    fused kernels take (192 px, width 128, 2 heads of 64) at text lengths
    that are no multiple of 8, on the card against the same weights on
    the CPU: GradCAM map sums within phase 4's 0.04 of the largest,
    logits within 0.05; one encode launches K1 = K2 = K3 = 2 (layers)."""
    import chip_smoke
    from pnp_ovss_tpu_torch.attribution.gradcam import gradcam_from_tap
    from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm

    cfg = chip_smoke.narrow_config(192).model
    layers = tuple(range(cfg.bert.num_layers))
    model = init_blip_itm(cfg, capture_layers=layers, seed=2, device=cuda)
    rng = np.random.RandomState(text_len)
    images = torch.tensor(rng.randn(2, 192, 192, 3).astype(np.float32))
    ids = torch.tensor(rng.randint(5, cfg.bert.vocab_size - 2,
                                   (2, text_len)))
    ids[:, 0] = cfg.bert.enc_token_id
    mask = torch.ones(2, text_len, dtype=torch.int32)
    mask[1, text_len - 4:] = 0
    _build.reset_launch_counts()
    got, logits = gradcam_from_tap(model, images.to(cuda), ids.to(cuda),
                                   mask.to(cuda), grid=cfg.vit.grid)
    assert {k: _build.LAUNCHES[k] for k in chip_smoke._VIT_336} == \
        dict.fromkeys(chip_smoke._VIT_336, 2)
    model.cpu()
    want, want_logits = gradcam_from_tap(model, images, ids, mask,
                                         grid=cfg.vit.grid)
    assert got.shape == want.shape == (2, 2, 2, text_len - 1, 12, 12)
    a, b = got.cpu().sum((-2, -1)), want.sum((-2, -1))
    assert torch.isfinite(got).all() and b[0].abs().max() > 0
    assert (a - b).abs().max() <= 0.04 * b.abs().max()
    torch.testing.assert_close(logits.cpu(), want_logits, rtol=0.05,
                               atol=0.05)
