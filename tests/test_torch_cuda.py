"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without an NVIDIA GPU (decided inside
the ``cuda`` fixture). The file imports neither JAX nor ``pnp_ovss_tpu``,
so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

It covers the shapes and code paths ``chip_smoke.py`` does not reach at
the main path's shapes: the flash kernel at edge tiles (one row, one key,
a row past a query tile), with NaN and Inf in the keys past true_len and
with a stalled ring; head dim 128, ragged sequence and pixel counts,
row-padded anchors, one variant and fewer than 64 state rows; for the
fused ViT kernels (K1, K3, K4) row counts that are no multiple of the
row tile, narrow widths, masked keys and several key tiles; for K8 ragged
N and M, M != N, 1 to 150 channels, strided values, 8 features, the split
over j, the symmetric schedule (against the plain version and the general
schedule, at every block side), bit-equal launches, empty inputs and the
stalled ring's trap; the
CRF's exact, Nystrom and general-loop branches on the card against the
CPU; K7 at ragged chunks against K2's rows, K9 at odd S, K8 and the
exact CRF on the distinct slots of a padded state against the full
launch, and a two-rank sequence-parallel encode with both ranks on the
one card (gloo); the
evaluation path on the card (``make_hist_fn`` over ragged batches against
numpy, labels kept on the card by ``result(materialize_labels=False)``)
and the tiny-width CLI on the card against the same run on the CPU; the
synthetic postprocess gate's device side (strided s=4 and exact, bucket
192) on the card against the CPU, the search's all-layer GradCAM
ensemble at odd text lengths, K2 at the CLIP vision tower's 577 tokens
(keys masked past 535 too) and the narrow CLIP's ``encode_image`` on the
card against the CPU; the runner's GradCAM replayed from CUDA graphs
against the eager call (tiny and 336 px full widths; results the next
replay leaves alone; a graph per batch size, eager past the cache; the
tiny pipeline graphed against eager); ``to_device`` and a whole
``submit_batch`` without one synchronisation.
"""

import ctypes
import dataclasses
import json
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
    counter = {"qkv": "flash_mha_flat_qkv", "flat": "flash_mha_flat",
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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("entry", ["qkv", "xlen", "qkv_proj"])
def test_flash_ignores_nan_and_inf_past_true_len(cuda, entry, d):
    """NaN, Inf and -Inf written into the K and V rows at and beyond
    true_len never reach an output row (the kernel's K / V tensor maps end
    at true_len, so TMA writes zeros there and reads nothing): every row,
    those past true_len too, is finite and equal bit for bit to the run on
    clean rows."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    b, h, s, tl, dm = 2, 2, 300, 171, 256
    hd = h * d
    clean = _randn(gen, b, s, 3 * hd).to(torch.bfloat16)
    dirty = clean.clone()
    for i, bad in enumerate((float("nan"), float("inf"), float("-inf"))):
        dirty[:, tl + i::3, hd:] = bad
    x = _randn(gen, b, s, dm).to(torch.bfloat16)
    pw = (_randn(gen, dm, hd) / hd**0.5).to(torch.bfloat16)
    pb = (0.1 * _randn(gen, dm)).to(torch.bfloat16)

    def run(qkv):
        if entry == "qkv":
            return flash_attention.flash_mha_flat_qkv(qkv, num_heads=h,
                                                      true_len=tl)
        if entry == "xlen":
            return flash_attention.flash_mha_flat_xlen(
                qkv[:, 37:250, :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:],
                num_heads=h, true_kv_len=tl)
        return flash_attention.flash_mha_qkv_proj(qkv, x, pw, pb,
                                                  num_heads=h, true_len=tl)

    want, got = run(clean), run(dirty)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,true_len", [(1, None), (40, 1), (65, None),
                                        (129, None), (257, 129)])
def test_flash_kernel_at_edge_tiles(cuda, d, s, true_len):
    """One query row (S = 1), one key (L = 1: every row is v's row 0,
    exactly), S one row past a 64- and a 128-row query tile and L one key
    past a 128-key tile, against the plain version (bf16 P and output, the
    bar of the small shapes above); K7 on rows [1, S) equals K2's rows bit
    for bit."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    b, h = 2, 3
    hd = h * d
    qkv = _randn(gen, b, s, 3 * hd).to(torch.bfloat16)
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    tl = true_len or s
    out = flash_attention.flash_mha_flat_qkv(qkv, num_heads=h,
                                             true_len=true_len)
    assert torch.isfinite(out).all()
    if tl == 1:
        assert torch.equal(out, v[:, :1].expand_as(out))
    ref = flash_attention.attention_plain(q, k, v, num_heads=h, true_len=tl,
                                          out_dtype=torch.float32)
    err = (out[:, :tl].float() - ref[:, :tl]).abs().max().item()
    assert err < 2e-2, err
    if s > 1:
        part = flash_attention.flash_mha_flat_xlen(
            q[:, 1:], k, v, num_heads=h, true_kv_len=tl)
        assert torch.equal(part, out[:, 1:])


def test_flash_stalled_ring_traps(cuda):
    """A ring stage of the flash kernel's library whose bytes never arrive
    ends the launch with an error (its waits trap after ~2 s), not a
    hang. It runs in a child process, since a trap leaves the CUDA context
    unusable."""
    code = (
        "import torch\n"
        "from pnp_ovss_tpu_torch.ops import _build\n"
        "lib = _build.library('flash_attention')\n"
        "torch.zeros(1, device='cuda')\n"
        "rc = lib.flash_mha_stall(torch.cuda.current_stream().cuda_stream)\n"
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


def _sym_plan(f, c):
    sms = torch.cuda.get_device_properties(f.device).multi_processor_count
    return bilateral.symmetric_plan(f.shape[0], c, sms)


def _sym_inputs(gen, n, c):
    """The exact CRF's features at ``n`` pixels (the photo-like scene's
    first n, or clustered colours below 4097) and values as it passes them:
    ones for the degree, two variants' probabilities for a message."""
    if n >= 4097:
        f = _photo_features(gen)[:n]
    else:
        f = _feats(gen, n)
        f[:, 2:] = (f[:, 2:] / 8).round() * 8 + 0.3 * _randn(gen, n, 3)
    if c == 1:
        return f, torch.ones((n, 1), device=gen.device)
    return f, torch.softmax(_randn(gen, n, 2, c // 2), -1).reshape(n, c)


@pytest.mark.parametrize("c", [1, 6, 12, 58])
@pytest.mark.parametrize("n", [500, 4097, 36864])
def test_kernel_matmul_symmetric_matches_plain(cuda, n, c):
    """K8 without ``features_j`` (the exact CRF's call) against its plain
    version at N = 500, 4097 (no multiple of the row tile or the stage)
    and the cell's 36864, for the degree (C = 1), messages at wgmma n = 8
    and 16 (C = 6, 12: the symmetric schedule) and C = 58 (n = 64: the
    general schedule, where the J-side sums would outgrow a block). At
    36864 the plain version checks 2048 rows, the first and the last
    1024. Both round k to bf16, so a k code may flip where the exponent's
    rounding differs: one bf16 ulp of one term, bounded by 5e-3 of the
    largest output."""
    from pnp_ovss_tpu_torch.utils.tracing import TRACER

    gen = torch.Generator(device=cuda).manual_seed(17)
    f, vals = _sym_inputs(gen, n, c)
    TRACER.drain()
    TRACER.enable()
    try:
        out = _matmul_rows_vs_plain(f, vals)
        counted = TRACER.drain()["counters"]
    finally:
        TRACER.disable()
    symmetric = c <= 16
    assert counted == ({"crf.k8_symmetric_launches": 1} if symmetric
                       else {})
    assert out <= 5e-3, out


def _matmul_rows_vs_plain(f, vals, fj=None):
    """As ``_matmul_vs_plain``, on the first and last 1024 rows where N
    is above 4097 (the plain version at N x N takes seconds)."""
    n = f.shape[0]
    if n <= 4097:
        return _matmul_vs_plain(f, vals, fj)
    out = bilateral.gaussian_kernel_matmul(f, vals, fj)
    rows = torch.cat([torch.arange(1024), torch.arange(n - 1024, n)]) \
        .to(f.device)
    ref = bilateral.kernel_matmul_plain(f[rows], vals,
                                        f if fj is None else fj)
    return ((out[rows] - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("c", [1, 6, 12])
@pytest.mark.parametrize("n", [500, 4097, 36864])
def test_kernel_matmul_symmetric_matches_general(cuda, n, c):
    """The symmetric schedule against the general one forced by
    ``features_j=features`` on the same inputs. The k codes are the same
    bits (f_j - f_i is the exact negation of f_i - f_j, the squares sum in
    the same order), so only the order of the f32 sums differs: held to
    1e-5 of the largest output (the non-negative terms' sums each carry a
    few hundred roundings of 2^-24 at most)."""
    gen = torch.Generator(device=cuda).manual_seed(18)
    f, vals = _sym_inputs(gen, n, c)
    sym = bilateral.kernel_matmul_fn(f)
    gen_fn = bilateral.kernel_matmul_fn(f, f)
    a, b = sym(vals), gen_fn(vals)
    assert sym.bufs[c].unit_tiles > 0 and gen_fn.bufs[c].unit_tiles == 0
    err = ((a - b).abs().max() / b.abs().max()).item()
    print(f"N={n} C={c}: symmetric vs general {err:.3g}")
    assert err <= 1e-5, err


@pytest.mark.parametrize("n,unit_tiles", [(4097, 8), (4097, 2),
                                          (36824, 8), (36824, 3)])
def test_kernel_matmul_symmetric_at_every_block_size(cuda, n, unit_tiles):
    """The symmetric schedule at block sides the plan would not pick (the
    last block partial; one block of 5 row tiles' worth; a side of 3 that
    divides nothing), through its C entry, against the plain version at
    C = 12: the units, the diagonal tiles, the J-side sums and the block
    partials are right whatever the side."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    f, vals = _sym_inputs(gen, n, 12)
    plan = _sym_plan(f, 12)
    row_tiles = -(-n // 128)
    blocks = -(-row_tiles // unit_tiles)
    plan = plan._replace(unit_tiles=unit_tiles, blocks=blocks,
                         units=blocks * (blocks + 1) // 2,
                         ws_floats=row_tiles * blocks * 128 * plan.width)
    bufs = bilateral.symmetric_bufs(n, 12, cuda, plan)
    lib = _build.library("crf_matmul")
    rc, out = bilateral.launch_matmul_symmetric(
        lib.gaussian_kernel_matmul_symmetric, bilateral.pack_features(f), 5,
        vals, _build.stream_ptr(f), bufs)
    _build.check(lib, rc, "gaussian_kernel_matmul_symmetric")
    rows = torch.arange(0, n, 7, device=cuda)[:2048]
    ref = bilateral.kernel_matmul_plain(f[rows], vals, f)
    err = ((out[rows] - ref).abs().max() / ref.abs().max()).item()
    assert err <= 5e-3, err
    assert not bufs.counters.any()  # left 0 for the next launch


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


@pytest.mark.parametrize("a,width", [(4, 8), (8, 16)])
def test_kernel_matmul_on_distinct_rows_equals_the_full_launch(cuda, a,
                                                               width):
    """At the exact CRF's shape (N = M = 36864), K8 on the first ``a``
    slots of each variant of a 2 x 29-slot state, read through a strided
    [M, 2, a] view, runs at wgmma n = 8 or 16. On the general schedule
    (``features_j`` given) it is bit-equal to the same columns of the
    58-channel launch at n = 64: the columns are summed independently and
    the j split does not depend on C. On the symmetric schedule (the
    exact CRF's call) the strided view gives the bits of its contiguous
    copy: the gather rides in the copy into v^T."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    feats = _photo_features(gen)
    n = feats.shape[0]
    state = torch.softmax(_randn(gen, 2, 29, n), 1)
    fn = bilateral.kernel_matmul_fn(feats, feats)
    full = fn(state.reshape(58, n).t())
    before = _build.LAUNCHES["gaussian_kernel_matmul"]
    rows = fn(state[:, :a].movedim(-1, 0))
    assert _build.LAUNCHES["gaussian_kernel_matmul"] == before + 1
    assert fn.bufs[58].width == 64 and fn.bufs[2 * a].width == width
    assert fn.bufs[58].split == fn.bufs[2 * a].split
    assert torch.equal(rows, full.reshape(n, 2, 29)[:, :, :a]
                       .reshape(n, 2 * a))
    sym = bilateral.kernel_matmul_fn(feats)
    view = state[:, :a].movedim(-1, 0)
    rows = sym(view)
    assert sym.bufs[2 * a].width == width and sym.bufs[2 * a].unit_tiles > 0
    assert torch.equal(rows, sym(view.contiguous()))


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


@pytest.mark.parametrize("rows,cols,c", [
    ("anchors", "pixels", 58), ("pixels", None, 58), ("pixels", None, 1),
    (500, 300, 58), (4097, None, 6), (36863, None, 12), (500, None, 12)])
def test_kernel_matmul_is_deterministic(cuda, rows, cols, c):
    """Two launches on the same inputs, at shapes with and without a
    split over j and on the symmetric schedule at odd N (the exact CRF's
    C = 6 and 12 at N = 4097, 36863 and 500), are bit-equal (the partials
    are summed in a fixed order; no float atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    feats = _photo_features(gen)
    sides = {"pixels": feats,
             "anchors": feats.reshape(192, 192, 5)[::4, ::4].reshape(-1, 5)}
    fi = sides[rows] if isinstance(rows, str) else feats[:rows]
    fj = (sides[cols] if isinstance(cols, str) else feats[:cols]) \
        if cols is not None else None
    fn = bilateral.kernel_matmul_fn(fi, fj)
    vals = torch.rand(((fi if fj is None else fj).shape[0], c),
                      generator=gen, device=cuda)
    a, b = fn(vals), fn(vals)
    assert fn.bufs[c].unit_tiles == (0 if fj is not None or c > 16 else
                                     _sym_plan(fi, c).unit_tiles)
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


def _spatial_state(gen, r, rows, h, w, s=4, sigma=None):
    """A bf16 state of ``rows`` live rows of probabilities and R - rows
    pad rows of ones (the kernel must not read them), norm_bi in K5's
    range, sigma for a 500 x 375 ground truth at this bucket (the runner's
    scale) unless given, and M_pad as K5 pads it."""
    n = h * w
    q = torch.ones((r, n), device=gen.device)
    q[:rows] = torch.rand((rows, n), generator=gen, device=gen.device)
    norm_bi = torch.rand((1, n), generator=gen, device=gen.device) * 0.25 \
        + 0.05
    if sigma is None:
        sigma = (3.0 * h / 375, 3.0 * w / 500)
    m_pad = -(-(-(-h // s) * -(-w // s)) // 128) * 128
    return (q.to(torch.bfloat16), norm_bi,
            torch.tensor(sigma, device=gen.device), m_pad)


@pytest.mark.parametrize("r,rows,h,w,sigma", [
    (64, 58, 192, 192, None),  # the main path: V = 2, C = 29, bucket 192
    (16, 10, 192, 192, None),
    (64, 58, 96, 256, None),  # non-square; two x-tiles, one with a halo
    (16, 5, 32, 100, None),  # w % 16 != 0: partial runs, scalar stores
    (32, 29, 64, 64, None),  # bucket 64, the narrow runs' shape
    (16, 6, 128, 96, (5.0, 3.0)),  # bands past 32 taps: the generic loops
    (16, 6, 40, 320, (0.3, 40.0)),  # one tap down h; w's band > one chunk
])
def test_spatial_operands_kernel_matches_plain(cuda, r, rows, h, w, sigma):
    """qsub bit-equal to the plain product rounded once; msp before its
    rounding within 1e-5 relative L2 of the plain f32 product, and after
    it within one bf16 ulp (msp >= 0, so the bit patterns are ordered);
    pad rows 0 without reading the state there."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, norm_bi, sig, m_pad = _spatial_state(gen, r, rows, h, w, sigma=sigma)
    kw = dict(h=h, w=w, s=4, m_pad=m_pad, pos_w=7.0)
    _build.reset_launch_counts()
    msp, qsub = crf.crf_spatial_operands(q, norm_bi, sig, rows=rows, **kw)
    msp32, qsub2 = crf.crf_spatial_operands(q, norm_bi, sig, rows=rows,
                                            msp_dtype=torch.float32, **kw)
    assert _build.LAUNCHES["crf_spatial_operands"] == 2
    want16, want_qsub = crf.spatial_operands_plain(q, norm_bi, sig, **kw)
    want32, _ = crf.spatial_operands_plain(q, norm_bi, sig,
                                           msp_dtype=torch.float32, **kw)
    live = slice(0, rows)
    assert torch.equal(qsub[live], want_qsub[live])
    assert torch.equal(qsub, qsub2)
    rel = ((msp32[live] - want32[live]).norm()
           / want32[live].norm()).item()
    print(f"R={r} h={h} w={w} sigma={sigma}: msp f32 rel L2 {rel:.3g}")
    assert rel <= 1e-5
    bits = (msp[live].view(torch.int16).int()
            - want16[live].view(torch.int16).int()).abs()
    assert bits.max().item() <= 1
    assert not msp[rows:].any() and not msp32[rows:].any()
    assert not qsub[rows:].any()


@pytest.mark.parametrize("v,c,r,m,n,dtype", [
    (2, 29, 64, 2304, 36864, torch.bfloat16),  # the main path's
    (1, 5, 16, 128, 1000, torch.bfloat16),  # ragged pixels: byte loads
    (2, 8, 16, 256, 4096, torch.float32),  # no pad rows
])
def test_first_state_kernel_matches_plain(cuda, v, c, r, m, n, dtype):
    """The fused loop's first state and minus-unary from the logits
    (slots of the runner's disabled value included) against the plain
    softmax, clamp and log, each within one bf16 ulp (the f32 exp and sum
    may differ in their last bits), pad rows 0; norm_bi and nb from
    K^T's column sums within 1e-6 relative (the sums are exact, rsqrt may
    differ in its last bit)."""
    from pnp_ovss_tpu_torch.pipeline.runner import _DISABLED

    gen = torch.Generator(device=cuda).manual_seed(9)
    logits = _randn(gen, v, c, n) * 3
    logits[:, c // 2 + 1:, : n // 2] = _DISABLED
    logits = logits.to(dtype)
    kt = torch.randint(0, 256, (m, n), generator=gen, device=cuda,
                       dtype=torch.uint8)
    _build.reset_launch_counts()
    got, norms = crf.crf_first_state(logits, kt, r, 10.0 / 255)
    assert _build.LAUNCHES["crf_first_state"] == 1
    want, want_norms = crf.first_state_plain(logits, kt, r, 10.0 / 255)
    for i, name in enumerate(("state", "log state")):
        bits = (got[i].view(torch.int16).int()
                - want[i].view(torch.int16).int()).abs()
        print(f"{name}: {(bits > 0).sum().item()} of {bits.numel()} "
              "differ by one bf16 ulp")
        assert bits.max().item() <= 1
    assert not got[:, v * c:].any()
    rel = ((norms - want_norms).abs() / want_norms).max().item()
    print(f"norm_bi, nb: max relative difference {rel:.3g}")
    assert rel <= 1e-6


def test_spatial_operands_kernel_refuses_mixed_devices(cuda):
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, norm_bi, sig, m_pad = _spatial_state(gen, 16, 10, 32, 32)
    with pytest.raises(ValueError):
        crf.crf_spatial_operands(q, norm_bi.cpu(), sig, h=32, w=32, s=4,
                                 m_pad=m_pad, rows=10, pos_w=7.0)


def _glue_fused_loop(logits, kt, pos_xy_std, cfg, h, w, s):
    """The fused loop as the port ran it before ``crf_first_state`` and
    ``crf_spatial_operands``: the unary, K^T's column sums, the band
    matrices built per image, the f32 separable product (cuBLAS), the
    strided take and the casts in PyTorch, then K6. Returns its states."""
    q0 = torch.softmax(logits.float(), dim=1)
    deg_bi = kt.sum(dim=0, dtype=torch.float32)[None] / 255.0
    v, c = q0.shape[:2]
    n, vc = h * w, v * c
    m_pad = kt.shape[0]
    norm_bi = torch.rsqrt(torch.clamp(deg_bi, min=1e-20))
    kh, kw = crf.spatial_band_matrices(h, w, pos_xy_std)
    nh = torch.rsqrt(torch.clamp(kh.sum(1), min=1e-20))
    nw = torch.rsqrt(torch.clamp(kw.sum(1), min=1e-20))
    khp = nh[:, None] * kh * nh[None, :]
    kwp = nw[:, None] * kw * nw[None, :]
    r_rows = -(-vc // 16) * 16
    pad = (0, 0, 0, r_rows - vc)
    u_neg = torch.nn.functional.pad(
        torch.log(torch.clamp(q0, 1e-5, 1.0)).reshape(vc, n), pad) \
        .to(torch.bfloat16)
    nb = (cfg.bi_w / bilateral.KT_QUANT_SCALE * norm_bi).contiguous()

    def take_j_pad(x):
        xs = x.unflatten(-1, (h, w))[..., ::s, ::s].flatten(-2)
        return torch.nn.functional.pad(xs, (0, m_pad - xs.shape[-1]))

    norm_j = take_j_pad(norm_bi)
    q = torch.nn.functional.pad(q0.reshape(vc, n), pad).to(torch.bfloat16)
    states = []
    for _ in range(cfg.num_iters):
        msp = cfg.pos_w * crf._apply_separable(
            khp, kwp, q.reshape(r_rows, h, w)).reshape(r_rows, n)
        qsub = take_j_pad(q) * norm_j
        q = bilateral.crf_fused_iteration(
            qsub.to(torch.bfloat16).contiguous(), kt, u_neg,
            msp.to(torch.bfloat16), nb, v=v, c=c)
        states.append(q)
    return states


def _cell_crf_inputs(cuda, seed):
    """One image's CRF inputs at the 336 px cell's shapes: two variants of
    29 slots (background and 4 live classes, 24 disabled at the runner's
    value), bf16 as the runner passes them, bucket 192, a 500 x 375 ground
    truth."""
    from pnp_ovss_tpu_torch.pipeline.runner import _DISABLED

    logits, image = _crf_scene(seed, 192, 29, 12)
    logits[:, 5:] = _DISABLED
    xy = torch.tensor([192 / 500, 192 / 375], device=cuda)
    return logits.to(cuda).to(torch.bfloat16), image.to(cuda), xy


def test_fused_crf_on_card_matches_the_pytorch_glue(cuda, monkeypatch):
    """The whole fused CRF (K5 and ``crf_first_state``, then
    ``crf_spatial_operands`` and K6 ten times) against the same loop with
    the first state and the operands made in PyTorch, at
    the 336 px cell's shapes: every iteration's state within 2^-8, labels
    equal on >= 99.9% of the pixels; each returned state a distinct tensor
    that later iterations leave unchanged."""
    logits, image, xy = _cell_crf_inputs(cuda, 11)
    args, states, copies = {}, [], []
    real_loop, real_k6 = crf._fused_loop, crf.crf_fused_iteration

    def loop_spy(*a):
        args["a"] = a
        return real_loop(*a)

    def k6_spy(*a, **kw):
        out = real_k6(*a, **kw)
        states.append(out)
        copies.append(out.clone())
        return out

    monkeypatch.setattr(crf, "_fused_loop", loop_spy)
    monkeypatch.setattr(crf, "crf_fused_iteration", k6_spy)
    _build.reset_launch_counts()
    labels = crf.mean_field_crf_variants(logits, image, CRFConfig(),
                                         xy_scale=xy)
    assert _build.LAUNCHES["crf_first_state"] == 1
    assert _build.LAUNCHES["crf_spatial_operands"] == 10
    assert _build.LAUNCHES["crf_fused_iteration"] == 10
    glue = _glue_fused_loop(*args["a"])
    assert len(states) == len(glue) == 10
    for i, (got, want) in enumerate(zip(states, glue)):
        err = (got.float() - want.float()).abs().max().item()
        print(f"iteration {i + 1}: max abs diff {err:.3g}")
        assert err <= 2 ** -8, (i, err)
    want_labels = torch.argmax(glue[-1][:58].reshape(2, 29, -1), 1) \
        .reshape(labels.shape)
    agree = (labels == want_labels).float().mean().item()
    print(f"labels agree on {agree:.6f} of the pixels")
    assert agree >= 0.999
    assert len({st.data_ptr() for st in states}) == 10
    assert all(torch.equal(st, cp) for st, cp in zip(states, copies))


def test_fused_crf_launches_at_the_cell_shape(cuda):
    """One image's fused CRF at the 336 px cell's shapes (the runner's
    call, the image's cast included) launches at most 70 device
    operations (kernels, copies, fills) by the profiler's count, two of
    them an iteration; ``crf.spatial_launches`` counts 10. It runs in a
    child process, so that its profiler session cannot touch another
    test's."""
    code = (
        "import numpy as np, torch\n"
        "from pnp_ovss_tpu_torch.config import CRFConfig\n"
        "from pnp_ovss_tpu_torch.ops import crf\n"
        "from pnp_ovss_tpu_torch.utils.tracing import TRACER\n"
        "g = torch.Generator(device='cuda').manual_seed(12)\n"
        "logits = torch.randn((2, 29, 192, 192), generator=g,"
        " device='cuda')\n"
        "logits[:, 5:] = -1e30\n"
        "logits = logits.to(torch.bfloat16)\n"
        "image = torch.randint(0, 256, (192, 192, 3), generator=g,"
        " device='cuda', dtype=torch.uint8)\n"
        "xy = torch.tensor([192 / 500, 192 / 375], device='cuda')\n"
        "valid = np.array([True] * 5 + [False] * 24)\n"
        "def run():\n"
        "    crf.mean_field_crf_variants(logits, image.float(), CRFConfig(),"
        " xy_scale=xy, channel_valid=valid)\n"
        "run()\n"
        "torch.cuda.synchronize()\n"
        "acts = [torch.profiler.ProfilerActivity.CPU,"
        " torch.profiler.ProfilerActivity.CUDA]\n"
        "TRACER.enable()\n"
        "with torch.profiler.profile(activities=acts) as prof:\n"
        "    run()\n"
        "    torch.cuda.synchronize()\n"
        "TRACER.disable()\n"
        "ops = [e for e in prof.events()"
        " if e.device_type == torch.autograd.DeviceType.CUDA]\n"
        "print('device operations:', len(ops))\n"
        "print('counters:', TRACER.drain()['counters'])\n")
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    print(res.stdout)
    lines = dict(line.split(": ", 1) for line in res.stdout.splitlines()
                 if ": " in line)
    assert "device operations" in lines, res.stdout + res.stderr
    assert 20 <= int(lines["device operations"]) <= 70
    assert lines["counters"] == "{'crf.spatial_launches': 10}"


def test_fused_crf_makes_no_stream_synchronisation(cuda):
    """At the 336 px cell's shapes, behind queued work, a fused CRF call
    waits for nothing (sync debug mode "error")."""
    logits, image, xy = _cell_crf_inputs(cuda, 13)
    valid = np.array([True] * 5 + [False] * 24)
    crf.mean_field_crf_variants(logits, image, CRFConfig(), xy_scale=xy,
                                channel_valid=valid)
    torch.cuda._sleep(100_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        crf.mean_field_crf_variants(logits, image, CRFConfig(), xy_scale=xy,
                                    channel_valid=valid)
    finally:
        torch.cuda.set_sync_debug_mode("default")


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


def test_exact_crf_on_distinct_slots_on_card(cuda, monkeypatch):
    """The exact CRF at the bucket's 192 x 192 with 2 x 29 slots, 4 of them
    live, with and without ``channel_valid``: each iteration's K8 message
    on the distinct slots (10 rows: the symmetric schedule) equals the
    58-row message of the same state (the general schedule) up to the
    order of its f32 sums, held to 1e-5 of the largest; the f32 band
    product of the spatial message sums in an order cuBLAS may choose by
    its batch count, so it is held to 1e-6 of the largest; the labels are
    equal. The keyword adds no synchronisation with the host (the sync
    debug mode raises on one) and no K8 launch."""
    logits, image = _crf_scene(17, 192, 29, 12)
    valid = np.arange(29) < 4
    logits[:, ~torch.from_numpy(valid)] = -1e30
    logits, image = logits.to(cuda), image.to(cuda)
    xy = torch.tensor([0.4, 0.5], device=cuda)
    calls, real = [], crf._normalised_apply

    def spy(fn, q, norm):
        out = real(fn, q, norm)
        calls.append((fn, q.clone(), norm, out))
        return out

    monkeypatch.setattr(crf, "_normalised_apply", spy)
    runs = {}
    for key, cv in (("all", None), ("distinct", valid)):
        calls.clear()
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            labels = crf.mean_field_crf_variants(
                logits, image, CRFConfig(), bilateral_subsample=1,
                xy_scale=xy, channel_valid=cv)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        runs[key] = (labels, list(calls),
                     _build.LAUNCHES["gaussian_kernel_matmul"])
    (want, full, k8_all), (got, part, k8_part) = runs["all"], \
        runs["distinct"]
    assert k8_all == k8_part == CRFConfig().num_iters + 1
    assert len(part) == 2 * CRFConfig().num_iters
    err, state_err = [0.0, 0.0], 0.0  # bilateral, spatial
    for i, ((fn, q, norm, out), (_, q_all, _, _)) in enumerate(
            zip(part, full)):
        assert q.shape == (58, 192 * 192)
        ref = real(full[i % 2][0], q, norm)
        err[i % 2] = max(err[i % 2], ((out - ref).abs().max()
                                      / ref.abs().max()).item())
        state_err = max(state_err, (q - q_all).abs().max().item())
    print(f"bilateral message max rel err {err[0]:.3g}, spatial {err[1]:.3g}"
          f", state max abs diff {state_err:.3g}")
    assert err[0] <= 1e-5 and err[1] <= 1e-6
    assert torch.equal(got, want)


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


@pytest.fixture(scope="module")
def k3_cooperative_fc1(tmp_path_factory):
    """K3's C entry rebuilt with fc1 on the cooperative schedule (its gelu
    in the epilogue warps), as ``scripts/kernel_ablation.py``'s
    ``fc1_cooperative`` builds it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    src = (_build.CSRC / "ln_mlp_residual.cu").read_text()
    flag = "static constexpr bool kPingPong = true;"
    assert src.count(flag) == 1
    out = tmp_path_factory.mktemp("k3_cooperative_fc1")
    cu, so = out / "ln_mlp_residual.cu", out / "ln_mlp_residual.so"
    cu.write_text(src.replace(flag, flag.replace("true", "false")))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).ln_mlp_residual_bf16
    fn.argtypes = _build.SOURCES["ln_mlp_residual"]["ln_mlp_residual_bf16"]
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("m,f", [(1, 4096), (110, 4096), (15470, 4096),
                                 (27660, 4096), (300, 4000)])
def test_k3_fc1_ping_pong_equals_cooperative(cuda, k3_cooperative_fc1, m,
                                             f):
    """fc1 on the ping-pong schedule (bias and gelu in the consumers'
    registers) gives the gelu hidden and K3's output bit for bit as on the
    cooperative schedule: at ViT-L's D = 1024, one row, 110 rows, both
    main paths' M (tails of the 128-row tile but at 27660) and F = 4000
    (the last 128-column tile of fc1 and 64-deep k-step of fc2 partly past
    F)."""
    d = 1024
    gen = torch.Generator(device=cuda).manual_seed(22)
    x = _randn(gen, m, d).to(torch.bfloat16)
    g, b = _norm_params(gen, d)
    w1 = (_randn(gen, f, d) / d**0.5).to(torch.bfloat16)
    b1 = (0.1 * _randn(gen, f)).to(torch.bfloat16)
    w2 = (_randn(gen, d, f) / f**0.5).to(torch.bfloat16)
    b2 = (0.1 * _randn(gen, d)).to(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    runs = []
    for fn in (_build.library("ln_mlp_residual").ln_mlp_residual_bf16,
               k3_cooperative_fc1):
        xn, out = torch.empty_like(x), torch.empty_like(x)
        hidden = torch.empty((m, f), dtype=torch.bfloat16, device=cuda)
        assert fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(),
                  b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), xn.data_ptr(),
                  hidden.data_ptr(), out.data_ptr(), m, d, f, 1e-6,
                  stream) == 0
        runs.append((hidden, out))
    torch.cuda.synchronize()
    (hidden, out), (hidden_c, out_c) = runs
    assert torch.equal(hidden, hidden_c)
    assert torch.equal(out, out_c)


def test_k3_fc1_gelu_every_code(cuda, k3_cooperative_fc1):
    """With W1 = 0 fc1's staged value is b1 itself, so a b1 of every
    finite bf16 code makes the gelu hidden gelu(code) for all of them:
    the ping-pong schedule's (pairs in the consumers' registers) equal bit
    for bit to the cooperative schedule's and to the plain gelu's."""
    codes = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    codes = codes.view(torch.bfloat16)
    codes = codes[torch.isfinite(codes)].to(cuda)
    m, d, f = 2, 64, codes.numel()
    assert f % 128 == 0
    gen = torch.Generator(device=cuda).manual_seed(24)
    x = _randn(gen, m, d).to(torch.bfloat16)
    g, b = _norm_params(gen, d)
    w1 = torch.zeros((f, d), dtype=torch.bfloat16, device=cuda)
    w2 = (_randn(gen, d, f) / f**0.5).to(torch.bfloat16)
    b2 = torch.zeros(d, dtype=torch.bfloat16, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    hidden = []
    for fn in (_build.library("ln_mlp_residual").ln_mlp_residual_bf16,
               k3_cooperative_fc1):
        xn, out = torch.empty_like(x), torch.empty_like(x)
        h = torch.empty((m, f), dtype=torch.bfloat16, device=cuda)
        assert fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(),
                  codes.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  xn.data_ptr(), h.data_ptr(), out.data_ptr(), m, d, f,
                  1e-6, stream) == 0
        hidden.append(h)
    torch.cuda.synchronize()
    assert torch.equal(hidden[0], hidden[1])
    assert torch.equal(hidden[0][0], vit_block.gelu_exact(codes))


def test_gemm_epilogues_keep_their_schedules(cuda, tmp_path):
    """Only K3's fc1 (gelu) takes the ping-pong schedule's 128 x 128
    tiles; K1's bias, K3's fc2 + residual and K4's projection keep the
    cooperative schedule's 128 x 256. At 128 rows and N = 512 the GEMM
    launches one block a tile: 4 on the ping-pong schedule, 2 on the
    cooperative one (the grids in the profiler's trace). The calls run
    in a child process, so that its profiler session cannot touch
    another test's."""
    trace = tmp_path / "trace.json"
    code = (
        "import torch\n"
        "from pnp_ovss_tpu_torch.ops import flash_attention, vit_block\n"
        "g = torch.Generator(device='cuda').manual_seed(23)\n"
        "def randn(*shape):\n"
        "    return torch.randn(shape, generator=g, device='cuda')\n"
        "def lin(n_out, n_in):\n"
        "    return ((randn(n_out, n_in) / n_in**0.5).bfloat16(),\n"
        "            (0.1 * randn(n_out)).bfloat16())\n"
        "m, d = 128, 512\n"
        "x = randn(m, d).bfloat16()\n"
        "gamma, beta = 1 + 0.1 * randn(d), 0.1 * randn(d)\n"
        "w, bias = lin(512, d)\n"
        "w1, b1 = lin(512, d)\n"
        "w2, b2 = lin(d, 512)\n"
        "qkv = randn(1, m, 3 * 256).bfloat16()\n"
        "pw, pb = lin(d, 256)\n"
        "acts = [torch.profiler.ProfilerActivity.CUDA]\n"
        "with torch.profiler.profile(activities=acts) as prof:\n"
        "    vit_block.ln_matmul(x, gamma, beta, w, bias)\n"
        "    vit_block.ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2)\n"
        "    flash_attention.flash_mha_qkv_proj(qkv, x[None], pw, pb,"
        " num_heads=4)\n"
        "    torch.cuda.synchronize()\n"
        f"prof.export_chrome_trace({str(trace)!r})\n")
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert res.returncode == 0, res.stdout + res.stderr
    grids = {ev["name"].split("gemm_kernel<")[1].split(">")[0]:
             ev["args"]["grid"]
             for ev in json.loads(trace.read_text())["traceEvents"]
             if ev.get("cat") == "kernel" and "gemm_kernel<" in ev["name"]}
    assert grids == {"pnp::k1::Bias": [2, 1, 1],
                     "pnp::k3::Fc1Gelu": [4, 1, 1],
                     "pnp::k3::Fc2Residual": [2, 1, 1],
                     "pnp::k4::ProjResidual": [2, 1, 1]}


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


@pytest.mark.parametrize("true_len", [577, 535])
def test_flash_kernel_at_the_clip_vision_shape(cuda, true_len):
    """K2 at the CLIP scorer's shape (ViT-L/14 at 336 px: 8 images x 577
    tokens, 16 heads of 64), whose ragged tail passes every key and query
    tile; with keys masked past 535 no masked key may leak into a row
    (trap F3). chip_smoke's ``TOL_FLASH``."""
    import chip_smoke

    gen = torch.Generator(device=cuda).manual_seed(577)
    b, s, h, d = 8, 577, 16, 64
    hd = h * d
    qkv = _randn(gen, b, s, 3 * hd).to(torch.bfloat16)
    _build.reset_launch_counts()
    out = flash_attention.flash_mha_flat_qkv(qkv, num_heads=h,
                                             true_len=true_len)
    assert _build.LAUNCHES["flash_mha_flat_qkv"] == 1
    ref = flash_attention.attention_plain(
        qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:], num_heads=h,
        true_len=true_len, out_dtype=torch.float32)
    err = (out[:, :true_len].float() - ref[:, :true_len]).abs().max().item()
    assert err <= chip_smoke.TOL_FLASH, err


def test_narrow_clip_encode_image_on_the_card_matches_cpu(cuda):
    """chip_smoke's narrow CLIP (168 px, width 128, 2 heads of 64, bf16):
    ``encode_image`` on the card launches K2 once a layer and nothing
    else, and agrees with the same weights on the CPU within chip_smoke's
    ``TOL_CLIP_NARROW``."""
    import chip_smoke
    from pnp_ovss_tpu_torch.models.clip import init_clip

    cfg = chip_smoke.narrow_clip_config()
    model = init_clip(cfg, seed=3, device=cuda)
    images, _ = chip_smoke.narrow_clip_inputs(cfg, seed=3)
    _build.reset_launch_counts()
    got = model.encode_image(images.to(cuda)).cpu()
    assert {k: n for k, n in _build.LAUNCHES.items() if n} == \
        {"flash_mha_flat_qkv": cfg.vision.num_layers}
    want = model.cpu().encode_image(images)
    assert torch.isfinite(got).all() and got.shape == (4, 64)
    assert (got - want).abs().max().item() <= chip_smoke.TOL_CLIP_NARROW


def test_flash_flat_on_a_head_slab_at_an_odd_offset(cuda):
    """K2' as tensor parallelism calls it: q, k and v are strided views
    of two heads starting at head 1 of a 5-head qkv projection (a rank's
    slab at an odd head offset), against the plain version; counted as
    ``flash_mha_flat``."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    b, s, h, d, lo, n = 2, 150, 5, 64, 1, 2
    hd = h * d
    qkv = _randn(gen, b, s, 3 * hd).to(torch.bfloat16)
    q, k, v = (qkv[..., i * hd + lo * d:i * hd + (lo + n) * d]
               for i in range(3))
    before = _build.LAUNCHES["flash_mha_flat"]
    out = flash_attention.flash_mha_flat(q, k, v, num_heads=n)
    assert _build.LAUNCHES["flash_mha_flat"] == before + 1
    ref = flash_attention.attention_plain(q, k, v, num_heads=n, true_len=s,
                                          out_dtype=torch.float32)
    assert out.shape == (b, s, n * d)
    err = (out.float() - ref).abs().max().item()
    assert err < 5e-3, err


@pytest.mark.parametrize("fused", [True, False])
def test_tp_block_on_one_rank_matches_unsharded(cuda, fused):
    """The tensor-parallel block's value flow on a model axis of one rank
    (both reduces are the identity there): K1's replicated qkv, K2' on
    the column views, proj as a row product and (fused) LN2 + fc1 in K1
    and fc2 as a row product, against the block's own unsharded forward
    (K2 + cuBLAS proj + K3). The sums run in other orders: within four
    bf16 ulps of the largest output. K3 is not launched under tensor
    parallelism."""
    from pnp_ovss_tpu_torch.models.vit import ViTBlock, ViTBlockFused
    from pnp_ovss_tpu_torch.parallel.mesh import AxisGroup

    cfg = ViTConfig(image_size=192, hidden_size=256, num_layers=1,
                    num_heads=4)
    torch.manual_seed(2)
    blk = (ViTBlockFused if fused else ViTBlock)(cfg).to(cuda)
    blk.requires_grad_(False)
    for p in blk.parameters():
        p.normal_(0, 0.05)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = _randn(gen, 2, cfg.seq_len, 256).to(torch.bfloat16)
    with torch.no_grad():
        want = blk(x)
        _build.reset_launch_counts()
        got = blk(x, tp=AxisGroup(None, 1, 0))
    n = dict(_build.LAUNCHES)
    assert n["flash_mha_flat"] == 1 and n["flash_mha_flat_qkv"] == 0
    assert n["ln_mlp_residual"] == 0
    assert n["ln_matmul"] == (2 if fused else 0)
    ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs().max())) - 7)
    err = (got.float() - want.float()).abs().max()
    assert err <= 4 * ulp, (err.item(), ulp.item())


def test_tracer_spans_share_the_device_trace_clock(cuda):
    """A span stamped by the port's tracer and the kineto events of a
    ``torch.profiler`` trace with CUDA activity lie on one clock: the span
    around a launch of a ~2 ms spin kernel and ``synchronize()`` holds the
    launch call (the runtime event with the kernel's correlation id) and
    the kernel's device interval, to within 50 us."""
    from torch.profiler import ProfilerActivity, profile

    from pnp_ovss_tpu_torch.utils.tracing import Tracer

    tracer = Tracer()
    tracer.enable()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with tracer.span("sleep"):
                torch.cuda._sleep(3_000_000)
                torch.cuda.synchronize()
    spans = tracer.drain()["spans"]
    events = list(prof.profiler.kineto_results.events())
    kernels = [e for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "spin" in e.name()]
    # The runtime's calls; the profiler's own host events may share ids.
    calls = {e.correlation_id(): e for e in events
             if e.device_type() != torch.autograd.DeviceType.CUDA
             and e.name().startswith("cu")}
    assert len(kernels) == len(spans) == 3
    for k, s in zip(sorted(kernels, key=lambda e: e.start_ns()), spans):
        call = calls[k.correlation_id()]
        print(f"{call.name()}: launch {call.start_ns() - s['start_ns']} ns "
              f"after the span's start; kernel [{k.start_ns() - s['start_ns']}"
              f", {k.end_ns() - s['start_ns']}] ns, span's end "
              f"{s['end_ns'] - s['start_ns']} ns")
        assert s["start_ns"] <= call.start_ns() <= call.end_ns() \
            <= s["end_ns"]
        assert s["start_ns"] - 50_000 <= k.start_ns() < k.end_ns() \
            <= s["end_ns"] + 50_000


def _gradcam_case(cuda, size, b=None):
    """(model, grid, head, inputs(seed, b) -> (embeds, ids, mask)) at the
    tiny config (capture layer 0 of 2, head 1, T = 12) or at 336 px full
    widths (layer 8, head 9; B = 35, T = 64, S = 442, width 1024, bf16):
    random weights, embeddings of the ViT output's scale and masks with
    padded tails."""
    from pnp_ovss_tpu_torch.config import PipelineConfig
    from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm

    if size == "tiny":
        cfg, t, b0 = PipelineConfig.tiny(), 12, 2
        layer, head = 1, 1
    else:
        cfg, t, b0 = PipelineConfig.reference_default(), 64, 35
        layer, head = cfg.attribution.layer, cfg.attribution.head
    m = cfg.model
    model = init_blip_itm(m, capture_layers=(layer - 1,), seed=3,
                          device=cuda)
    dtype = model.text_encoder.embed_norm.out_dtype

    def inputs(seed, b=b0):
        gen = torch.Generator().manual_seed(seed)
        embeds = torch.randn((b, m.vit.seq_len, m.bert.encoder_width),
                             generator=gen).to(dtype)
        ids = torch.randint(5, m.bert.vocab_size - 2, (b, t), generator=gen)
        ids[:, 0] = m.bert.enc_token_id
        mask = torch.ones((b, t), dtype=torch.int32)
        for i in range(b):
            mask[i, t - 1 - (i % (t // 2)):] = 0
        return tuple(x.to(cuda) for x in (embeds, ids, mask))

    return model, m.vit.grid, head, inputs


def _eager_selection(model, grid, head, embeds, ids, mask):
    from pnp_ovss_tpu_torch.attribution.gradcam import gradcam_from_embeds

    gc, logits = gradcam_from_embeds(model, embeds, ids, mask, grid=grid)
    return gc[0, :, head], logits


@pytest.mark.parametrize("size", ["tiny", "336"])
def test_graphed_gradcam_equals_eager(cuda, size):
    """The runner's BERT forward, tap backward and GradCAM combine of one
    layer and head, replayed from a CUDA graph, equal the eager call bit
    for bit (the same kernels on the same shapes): at the capture's first
    replay, at a later replay, and at 336 px full widths."""
    from pnp_ovss_tpu_torch.attribution.gradcam_graph import GradcamGraphs

    model, grid, head, inputs = _gradcam_case(cuda, size)
    graphs = GradcamGraphs(model, grid=grid, head=head)
    for seed in (0, 1):
        x = inputs(seed)
        want = _eager_selection(model, grid, head, *x)
        got = graphs(*x)
        assert want[0].abs().max() > 0
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g, w), (g - w).abs().max().item()
    assert len(graphs._graphs) == 1


def test_graph_replay_leaves_returned_results_alone(cuda):
    """Two calls queued back to back with other inputs: the second gives
    its own results, and the first call's tensors (clones outside the
    graph's pool) read the same after it."""
    from pnp_ovss_tpu_torch.attribution.gradcam_graph import GradcamGraphs

    model, grid, head, inputs = _gradcam_case(cuda, "336")
    graphs = GradcamGraphs(model, grid=grid, head=head)
    a_in, b_in = inputs(0), inputs(1)
    a = graphs(*a_in)
    b = graphs(*b_in)
    want_a = _eager_selection(model, grid, head, *a_in)
    want_b = _eager_selection(model, grid, head, *b_in)
    (entry,) = graphs._graphs.values()
    pool = {t.untyped_storage().data_ptr() for t in entry.outputs}
    for got, want in zip(a + b, want_a + want_b):
        assert torch.equal(got, want)
        assert got.untyped_storage().data_ptr() not in pool
    assert not torch.equal(a[0], b[0])


def test_graph_cache_captures_each_batch_size_then_runs_eager(cuda):
    """Batch sizes 1 .. MAX_GRAPHS + 1, then 1 again, with the tracer on:
    a capture (and a ``bert.capture`` span) for each of the first
    MAX_GRAPHS sizes, one eager call past them, a replay for every graphed
    call; each result equal to the eager call's."""
    from pnp_ovss_tpu_torch.attribution.gradcam_graph import (
        MAX_GRAPHS, GradcamGraphs,
    )
    from pnp_ovss_tpu_torch.utils.tracing import TRACER

    model, grid, head, inputs = _gradcam_case(cuda, "tiny")
    graphs = GradcamGraphs(model, grid=grid, head=head)
    sizes = list(range(1, MAX_GRAPHS + 2)) + [1]
    TRACER.drain()
    TRACER.enable()
    try:
        for b in sizes:
            x = inputs(b, b)
            got = graphs(*x)
            want = _eager_selection(model, grid, head, *x)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    finally:
        TRACER.disable()
    data = TRACER.drain()
    assert len(graphs._graphs) == MAX_GRAPHS
    assert data["counters"] == {"bert.graph_captures": MAX_GRAPHS,
                                "bert.graph_replays": len(sizes) - 1,
                                "bert.graph_eager": 1}
    assert [s["name"] for s in data["spans"]] == \
        ["bert.capture"] * MAX_GRAPHS


def test_graphed_runner_matches_the_eager_runner(cuda):
    """The tiny pipeline on the card, two batches in flight, with its
    GradCAM from graphs and with the eager call: maps and labels equal;
    one graph captured, one replay a drop round."""
    from pnp_ovss_tpu_torch.text.captions import build_caption_batch
    from pnp_ovss_tpu_torch.text.wordpiece import WordPieceTokenizer
    from pnp_ovss_tpu_torch.utils.tracing import TRACER

    cfg, runner = _tiny_runner(cuda)
    assert runner._graphs is not None
    tok = WordPieceTokenizer.toy(["a", "picture", "of", "dog", "cat"])
    cap = build_caption_batch([["dog", "cat"], ["cat"]], tok,
                              max_text_len=16, max_classes=cfg.max_classes)
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 256, (2, 48, 48, 3)).astype(np.uint8),
                rng.randint(0, 256, (2, 32, 32, 3)).astype(np.float32))
               for _ in range(2)]

    def run():
        pending = [runner.submit_batch(img, cap, rgb, return_maps=True)
                   for img, rgb in batches]
        return [p.result() for p in pending]

    TRACER.drain()
    TRACER.enable()
    try:
        graphed = run()
    finally:
        TRACER.disable()
    counters = TRACER.drain()["counters"]
    assert counters["bert.graph_captures"] == len(runner._graphs._graphs) \
        == 1
    assert counters["bert.graph_replays"] == 2 * cfg.drop.num_rounds
    runner._graphs = None
    eager = run()
    for g, e in zip(graphed, eager):
        for name in ("labels_r0", "labels_agg", "maps_r0", "maps_agg"):
            np.testing.assert_array_equal(getattr(g, name), getattr(e, name),
                                          err_msg=name)


def test_to_device_queues_the_copy_without_a_wait(cuda):
    """A host array goes to the card behind ~0.1 s of queued work without
    any synchronisation (sync debug mode "error" raises on one), and
    arrives whole although its numpy source is overwritten at once and
    more copies of the same size follow (the pinned buffer is kept until
    its copy has run)."""
    from pnp_ovss_tpu_torch import to_device

    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (35, 336, 336, 3)).astype(np.uint8)
    want = a.copy()
    torch.cuda._sleep(200_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = to_device(a, cuda)
        a[:] = 0
        more = [to_device(rng.randint(0, 256, a.shape).astype(np.uint8),
                          cuda) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.dtype == torch.uint8 and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert not torch.equal(more[0], got)


@pytest.mark.parametrize("subsample", [4, 1], ids=["strided", "exact"])
def test_submit_batch_never_waits_for_the_card(cuda, subsample):
    """After the first batch (which captures the GradCAM graph), a whole
    tiny-pipeline submit queues its work without one synchronisation
    (sync debug mode "error"), and its labels equal the first batch's on
    the same inputs."""
    from pnp_ovss_tpu_torch.text.captions import build_caption_batch
    from pnp_ovss_tpu_torch.text.wordpiece import WordPieceTokenizer

    cfg, runner = _tiny_runner(cuda)
    runner.cfg = cfg = dataclasses.replace(
        cfg, postprocess=dataclasses.replace(
            cfg.postprocess, bilateral_subsample=subsample))
    tok = WordPieceTokenizer.toy(["a", "picture", "of", "dog", "cat"])
    cap = build_caption_batch([["dog", "cat"], ["cat"]], tok,
                              max_text_len=16, max_classes=cfg.max_classes)
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, 48, 48, 3)).astype(np.uint8)
    rgb = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.float32)
    first = runner.submit_batch(images, cap, rgb, gt_sizes=[(40, 30)] * 2) \
        .result()
    torch.cuda._sleep(100_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = runner.submit_batch(images, cap, rgb,
                                      gt_sizes=[(40, 30)] * 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    second = pending.result()
    np.testing.assert_array_equal(second.labels_agg, first.labels_agg)
    np.testing.assert_array_equal(second.labels_r0, first.labels_r0)


def test_336px_submit_never_waits_for_the_card(cuda):
    """A full-width 336 px batch (35 images, strided s = 4 CRF through
    ``crf_spatial_operands`` and K6) submits without one stream
    synchronisation after a warm-up batch, and its labels equal the
    warm-up's on the same inputs."""
    import chip_smoke

    _, runner, (images, cap, rgb, gt) = chip_smoke.pipeline_setup()
    first = runner.submit_batch(images, cap, rgb, gt_sizes=gt).result()
    _build.reset_launch_counts()
    torch.cuda._sleep(100_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = runner.submit_batch(images, cap, rgb, gt_sizes=gt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    second = pending.result()
    assert _build.LAUNCHES["crf_spatial_operands"] == 35 * 10
    np.testing.assert_array_equal(second.labels_agg, first.labels_agg)
    np.testing.assert_array_equal(second.labels_r0, first.labels_r0)
