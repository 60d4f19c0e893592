"""Port CRF (pnp_ovss_tpu_torch) vs the JAX package.

The port's CPU path runs the plain versions of kernels K8
(gaussian_kernel_matmul), K5 (gaussian_kernel_materialize) and K6
(crf_fused_iteration); the JAX side runs its Pallas kernels in interpret
mode. Inputs are numpy arrays from a seed, handed to both. chip_smoke.py
holds the CUDA kernels against the same plain versions on the card.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_ovss_tpu.config import CRFConfig as JaxCRFConfig
from pnp_ovss_tpu.ops import bilateral_pallas as jax_bp
from pnp_ovss_tpu.ops import blur as jax_blur
from pnp_ovss_tpu.ops import crf as jax_crf
from pnp_ovss_tpu_torch.config import CRFConfig
from pnp_ovss_tpu_torch.ops import bilateral as port_bp
from pnp_ovss_tpu_torch.ops import blur as port_blur
from pnp_ovss_tpu_torch.ops import crf as port_crf


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _feats(rng, n):
    """Realistic magnitudes: positions/sxy up to 10, rgb/5 up to 51."""
    return np.concatenate([rng.rand(n, 2) * 10, rng.rand(n, 3) * 51],
                          axis=1).astype(np.float32)


def _scene(rng, h, w):
    """Photo-like texture and blob logits (tests/test_crf.py's scene)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    image = np.stack([
        120 + 60 * np.sin(xx / 9.0) + 40 * (yy / h),
        100 + 50 * np.cos(yy / 7.0) + 30 * (xx / w),
        90 + 45 * np.sin((xx + yy) / 11.0),
    ], -1)
    image = np.clip(image + rng.randn(h, w, 3) * 12, 0, 255)
    logits = rng.randn(4, h, w).astype(np.float32) * 0.5
    logits[0, : h // 2] += 0.8
    logits[1, h // 2:] += 0.8
    blob = ((yy - h * 0.6) ** 2 + (xx - w * 0.7) ** 2) < (h // 4) ** 2
    logits[2][blob] += 1.2
    return image.astype(np.float32), logits


def test_materialize_f32_matches_jax_kernel():
    """K5 plain (explicit differences) vs the Pallas build (f32 expansion
    at HIGHEST precision): at ||f||^2 ~ 8e3 the expansion's cancellation
    leaves ~1e-3 relative error in k, which bounds the tolerance."""
    rng = np.random.RandomState(11)
    fj, fi = _feats(rng, 37), _feats(rng, 150)
    want = np.asarray(jax_bp.gaussian_kernel_materialize(
        jnp.asarray(fj), jnp.asarray(fi), out_dtype=jnp.float32,
        keep_padded_rows=True))
    got = port_bp.gaussian_kernel_materialize(
        _t(fj), _t(fi), out_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (128, 150)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-6)
    assert np.all(got[37:] == 0.0)


def test_materialize_uint8_matches_jax_kernel():
    """uint8 codes round(k*255) (half to even); a code may differ by one
    where the two exponent formulations straddle a rounding boundary."""
    rng = np.random.RandomState(13)
    fj, fi = _feats(rng, 37), _feats(rng, 256)
    want = np.asarray(jax_bp.gaussian_kernel_materialize(
        jnp.asarray(fj), jnp.asarray(fi), out_dtype=jnp.uint8,
        keep_padded_rows=True))
    got = port_bp.gaussian_kernel_materialize(_t(fj), _t(fi)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (128, 256)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert np.all(got[37:] == 0)
    # Against a float64 oracle: the plain version rounds exactly.
    d2 = ((fj[:, None].astype(np.float64) - fi[None]) ** 2).sum(-1)
    oracle = np.round(np.exp(-0.5 * d2) * 255)
    assert np.abs(got[:37] - oracle).max() <= 1


@pytest.mark.parametrize("v,c", [(2, 29), (1, 5)])
def test_fused_iteration_matches_jax_kernel(v, c):
    """K6 plain vs crf_fused_iteration with bf16 state (u, msp, out), uint8
    kernel and R rows as the pipeline packs them (v*c rounded up to 16).
    Both compute in f32 from the same bf16 inputs and round once to bf16:
    at most one bf16 ulp apart (2^-8 at 1.0)."""
    rng = np.random.RandomState(5)
    r = -(-(v * c) // 16) * 16
    m, n = 256, 1024
    kt = rng.randint(0, 256, (m, n)).astype(np.uint8)
    kt[200:] = 0  # pad rows
    qsub = (rng.rand(r, m) * 0.05).astype(np.float32)
    qsub[:, 200:] = 0.0
    qsub[v * c:] = 0.0
    u_neg = np.log(rng.rand(r, n) + 1e-3).astype(np.float32)
    u_neg[v * c:] = 0.0
    msp = (rng.rand(r, n) * 7).astype(np.float32)
    nb = np.broadcast_to((rng.rand(1, n) * 0.01).astype(np.float32),
                         (8, n)).copy()
    u_bf, msp_bf = (jnp.asarray(x, jnp.bfloat16) for x in (u_neg, msp))
    want = np.asarray(jax_bp.crf_fused_iteration(
        jnp.asarray(qsub), jnp.asarray(kt), u_bf, msp_bf, jnp.asarray(nb),
        v=v, c=c, out_dtype=jnp.bfloat16).astype(jnp.float32))
    got = port_bp.crf_fused_iteration(
        _t(qsub), _t(kt), _t(u_neg).to(torch.bfloat16),
        _t(msp).to(torch.bfloat16), _t(nb), v=v, c=c)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -8)
    assert np.all(got[v * c:] == 0.0)


def test_mean_field_crf_matches_jax_fused_path():
    """Whole default CRF branch (materialised strided s=4, uint8 K^T,
    fused iteration, bf16 state, rank-1 fold) on a 64x64 scene with two
    variants: labels agree on > 99.9% of pixels, the bar the JAX package's
    own fused-vs-unfused test uses."""
    cfg_j, cfg_p = JaxCRFConfig(num_iters=10), CRFConfig(num_iters=10)
    h, w = 64, 64
    image, logits = _scene(np.random.RandomState(3), h, w)
    logits2 = np.stack([logits, logits[::-1]], 0)
    want = np.asarray(jax_crf.mean_field_crf_variants(
        jnp.asarray(logits2), jnp.asarray(image), cfg_j,
        bilateral_impl="pallas", bilateral_subsample=4,
        xy_scale=jnp.asarray([0.4, 0.5])))
    got = port_crf.mean_field_crf_variants(
        _t(logits2), _t(image), cfg_p, bilateral_subsample=4,
        xy_scale=torch.tensor([0.4, 0.5])).numpy()
    assert got.shape == (2, h, w)
    assert (got == want).mean() > 0.999, (got == want).mean()
    assert len(np.unique(got)) > 1


def test_bilateral_features_axis_order():
    """Fault F6: x is divided by sxy[0] and y by sxy[1]."""
    rng = np.random.RandomState(6)
    img = (rng.rand(5, 7, 3) * 255).astype(np.float32)
    want = np.asarray(jax_crf.bilateral_features(
        jnp.asarray(img), jnp.asarray([2.0, 3.0]), 5.0))
    got = port_crf.bilateral_features(_t(img), [2.0, 3.0], 5.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blur_and_minmax_matches_jax(dtype):
    rng = np.random.RandomState(7)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_blur.blur_and_minmax(jnp.asarray(x, jdt), 1.6))
    got = port_blur.blur_and_minmax(_t(x).to(dtype), 1.6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _two_colour(rng, h, w, noise):
    """tests/test_crf.py's structured scene: two colour halves, noisy
    logits favouring each half's class."""
    image = np.zeros((h, w, 3), np.float32)
    image[:, : w // 2] = [200, 40, 40]
    image[:, w // 2:] = [40, 40, 200]
    image += rng.randn(h, w, 3) * noise
    logits = rng.randn(3, h, w).astype(np.float32) * 0.5
    logits[0, :, : w // 2] += 1.5
    logits[1, :, w // 2:] += 1.5
    return image.astype(np.float32), logits


@pytest.mark.parametrize("n,m,c", [(600, None, 1), (600, None, 58),
                                   (600, 300, 1), (600, 300, 58)])
def test_kernel_matmul_matches_jax_kernel(n, m, c):
    """K8 plain (explicit f32 differences) vs the Pallas kernel (f32
    expansion at HIGHEST precision), at realistic feature magnitudes with
    self support (m None) and with a separate features_j, N not a multiple
    of the 512-row tile; C = 1 is the degree launch (ones), C = 58 signed
    values. Both round k and v to bf16, so a k code may flip where the two
    exponent formulations straddle a rounding boundary: one bf16 ulp
    (2^-8) of one term k|v| <= |v|. Seeded readings: max abs differences
    1.9e-6, 5.1e-7, 9.5e-7, 8.1e-8 (|out| up to 3.9). Against a float64
    oracle, each term carries two bf16 roundings of at most 2^-8 relative
    each, so the plain version is within 2^-7 * (K @ |v|) of the exact
    message."""
    rng = np.random.RandomState(21)
    fi = _feats(rng, n)
    fj = None if m is None else _feats(rng, m)
    rows = n if m is None else m
    vals = (np.ones((rows, c), np.float32) if c == 1
            else rng.randn(rows, c).astype(np.float32))
    want = np.asarray(jax_bp.gaussian_kernel_matmul(
        jnp.asarray(fi), jnp.asarray(vals),
        None if fj is None else jnp.asarray(fj)))
    got = port_bp.gaussian_kernel_matmul(
        _t(fi), _t(vals), None if fj is None else _t(fj))
    assert got.dtype == torch.float32 and got.shape == (n, c)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -8 * np.abs(vals).max())
    fj64 = (fi if fj is None else fj).astype(np.float64)
    k = np.exp(-0.5 * ((fi[:, None].astype(np.float64) - fj64[None]) ** 2)
               .sum(-1))
    assert np.all(np.abs(got - k @ vals) <= 2 ** -7 * (k @ np.abs(vals))
                  + 1e-6)


def _photo_features(shift, rng):
    """Bilateral features of the exact CRF at the main path's scale: a
    192 px photo-like scene (``_scene``'s texture and noise) scaled as the
    runner scales it for a 500x375 GT, the colours shifted by ``shift``
    feature units."""
    image, _ = _scene(rng, 192, 192)
    cfg = CRFConfig()
    feats = port_crf.bilateral_features(
        _t(image), cfg.bi_xy_std * torch.tensor([192 / 375, 192 / 500]),
        cfg.bi_rgb_std)
    feats[:, 2:] += shift
    return feats


def _expansion_exponent(f):
    """log2 k by the f32 expansion K8 does not take (the ablation's
    ``expansion`` build): x = (-|b|^2 + sum_d a_d * 2 b_d) - |a|^2 over the
    scaled features less their midrange, each FMA rounded to f32 once."""
    a = f.float() * (0.5 / np.log(2.0)) ** 0.5
    a = a - (a.amin(0) + a.amax(0)) * 0.5
    norm = -a.double().square().sum(1).float()
    x = norm[None, :].expand(a.shape[0], -1)
    for d in range(a.shape[1]):
        x = (a[:, d, None].double() * (2.0 * a[None, :, d]).double()
             + x).float()
    return x + norm[:, None]


@pytest.mark.parametrize("shift", [0.0, 40.0])
def test_kernel_matmul_exponent_is_f1_safe(shift):
    """ROADMAP F1 for K8's exponent: explicit f32 differences of the
    prescaled features (``kernel_matmul_exponent``, the kernel's
    arithmetic) against the float64 exponent -||f_i - f_j||^2 / (2 ln 2)
    over all pairs of 2000 pixels of the photo-like scene, as is and with
    every colour shifted by +40 units. Bounds: 1e-5 on pairs with k > 1/2
    (where a flipped bf16 code costs the most), 2e-4 on pairs with
    k > 2^-30 (the ones a sum can see), 1e-3 on all. Seeded readings (as
    is / shifted): 2.7e-6 / 6.6e-6, 3.9e-5 / 8.5e-5, 3.7e-4 / 5.8e-4. The
    f32 expansion 2a.b - |a|^2 - |b|^2 over features centred at their
    midrange reads 6.1e-5 on pairs with k > 1/2, past the first bound
    (uncentred: 4.9e-4 / 2.0e-3): on the card it moved the exact message
    1.4e-3 from the plain version against chip_smoke's bar of 7e-4, so K8
    keeps explicit differences."""
    rng = np.random.RandomState(41)
    feats = _photo_features(shift, rng)
    f = feats[torch.from_numpy(rng.choice(feats.shape[0], 2000,
                                          replace=False))]
    scaled = f.double() * (0.5 / np.log(2.0)) ** 0.5
    exact = -((scaled[:, None] - scaled[None]) ** 2).sum(-1)
    large, seen = exact > -1, exact > -30
    err = (port_bp.kernel_matmul_exponent(f).double() - exact).abs()
    print(f"shift {shift}: max |x - exact| {err[large].max().item():.3g} "
          f"where k > 1/2, {err[seen].max().item():.3g} where k > 2^-30, "
          f"{err.max().item():.3g} over all pairs")
    assert err[large].max().item() <= 1e-5
    assert err[seen].max().item() <= 2e-4
    assert err.max().item() <= 1e-3
    expanded = _expansion_exponent(f)
    assert (expanded.double() - exact).abs()[large].max().item() > 1e-5


@pytest.mark.parametrize("n,m,c,want,units", [
    (36864, 36864, 58, (64, 1, 5), 1440),  # exact message
    (36864, 36864, 1, (8, 1, 5), 1440),  # exact degree: n = 8
    (2304, 36864, 58, (64, 1, 22), 396),  # Nystrom K_AN
    (36864, 2304, 58, (64, 1, 2), 576),  # Nystrom K_NA: 36 stages a tile
    (1000, 1000, 150, (96, 2, 4), 64),  # two 96-channel chunks
    (777, 130, 82, (96, 1, 1), 7),  # --max_classes 40, 3 stages: no split
])
def test_kernel_matmul_plan(n, m, c, want, units):
    """K8's launch shape on the H100's 132 SMs: C = 58 at wgmma n = 64, the
    degree at n = 8, more than 128 channels in equal chunks, and j split
    so that every SM runs close to the same number of units: the exact
    shape's 288 row tiles x 5 = 1440 units, 10.9 an SM (a third tile on
    24 SMs without the split), K_AN's 18 row tiles x 22 = 396, 3 an SM;
    where a unit would hold few stages (K_NA's 36) the partial sums cost
    more than the balance gains, and the split stays small or 1."""
    width, chunks, split = port_bp.matmul_plan(n, m, c, 132)
    assert (width, chunks, split) == want
    assert width * chunks >= c and split <= -(-m // 64)
    assert -(-n // 128) * chunks * split == units


@pytest.mark.parametrize("n,unit_tiles", [
    (36864, 8), (36864, 3), (4097, 1), (4097, 8), (500, 2), (1100, 8),
    (64, 1)])
def test_symmetric_schedule_covers_every_pair_once(n, unit_tiles):
    """K8's symmetric schedule at N a multiple of the 128-row tile and
    not, at block sides that divide the row tiles and not: every ordered
    pair of 64-pixel stages (a output, b input) gets its contribution
    exactly once, from a computed exponent tile directly (rows of a
    against columns of b) or transposed (the tile of b's rows against a's
    columns); each exponent tile is computed once, the unordered pairs'
    half plus the 128-pixel diagonal tiles; every pixel's partial from
    every block is written once, by one unit."""
    stages, row_tiles = -(-n // 64), -(-n // 128)
    blocks = -(-row_tiles // unit_tiles)
    got = collections.Counter()
    tiles = collections.Counter()
    for p, q, rt, s, both in port_bp.symmetric_schedule(n, unit_tiles):
        assert p <= q and rt // unit_tiles == p and s // (2 * unit_tiles) \
            == q
        tiles[rt, s] += 1
        for a in (2 * rt, 2 * rt + 1):
            if a < stages:
                got[a, s] += 1
                if both:
                    got[s, a] += 1
    assert got == collections.Counter(
        {(a, b): 1 for a in range(stages) for b in range(stages)})
    assert max(tiles.values()) == 1
    # Exponent tiles: the diagonal 128 x 128 tiles and one of each
    # off-diagonal pair of 128-pixel row tile and 64-pixel stage.
    diag = sum(min(2, stages - 2 * rt) for rt in range(row_tiles))
    assert sum(tiles.values()) == diag + sum(
        max(0, stages - 2 * rt - 2) for rt in range(row_tiles))
    # Partials: unit (P, Q) writes rows of P (I side, slot Q) unless it
    # is the diagonal, and rows of Q (J side, or both on the diagonal,
    # slot P).
    written = collections.Counter()
    units = sorted({(p, q) for p, q, *_ in
                    port_bp.symmetric_schedule(n, unit_tiles)})
    assert units == [(p, q) for p in range(blocks)
                     for q in range(p, blocks)]
    for p, q in units:
        for rt in range(p * unit_tiles, min((p + 1) * unit_tiles, row_tiles)):
            if p != q:
                written[rt, q] += 1
        for rt in range(q * unit_tiles, min((q + 1) * unit_tiles, row_tiles)):
            written[rt, p] += 1
    assert written == collections.Counter(
        {(rt, b): 1 for rt in range(row_tiles) for b in range(blocks)})


@pytest.mark.parametrize("n,c,want", [
    (36864, 1, (8, 6, 48, 1176)),  # the exact CRF's degree
    (36864, 6, (8, 6, 48, 1176)),  # a message, 1 class
    (36864, 12, (16, 4, 72, 2628)),  # a message, 4 classes
    (36864, 58, None),  # 28 classes: the general schedule
    (4097, 12, (16, 2, 17, 153)),  # few pixels: small blocks
    (500, 1, (8, 1, 4, 10)),
])
def test_symmetric_plan(n, c, want):
    """The symmetric launch shape on the H100's 132 SMs: wgmma's n (8 or
    16; none above 16 channels) and the block side the cost model picks
    (at the exact CRF's 36864 pixels: 6 row tiles at n = 8, 1176 units
    with 3 blocks an SM; 4 at n = 16, where larger sides hold 2 blocks an
    SM), the workspace of one f32 partial a pixel, channel and block
    (56.6 MB at n = 8, 169.9 at n = 16) and the units an SM."""
    plan = port_bp.symmetric_plan(n, c, 132)
    if want is None:
        assert plan is None and port_bp.symmetric_width(c) is None
        return
    assert (plan.width, plan.unit_tiles, plan.blocks, plan.units) == want
    assert plan.ws_floats == -(-n // 128) * plan.blocks * 128 * plan.width
    assert plan.units_per_sm == plan.units / 132
    if n == 36864:
        assert plan.ws_floats * 4 == {8: 56623104,
                                      16: 169869312}[plan.width]


@pytest.mark.parametrize("width,unit_tiles,smem,resident", [
    (8, 6, 66608, 3), (8, 8, 70704, 3), (16, 4, 73768, 3),
    (16, 5, 81960, 2)])
def test_symmetric_smem_bytes(width, unit_tiles, smem, resident):
    """A symmetric block's shared memory (the kernel's sym_smem_bytes) and
    the blocks an H100 SM holds: the reduction's 64 KB bound n = 8 up to 7
    row tiles a side; at n = 16 the J-side sums of 5 row tiles leave room
    for 2 blocks only."""
    got = port_bp.symmetric_smem_bytes(width, unit_tiles)
    assert got == smem
    assert 233472 // (got + 1024) == resident


@pytest.mark.parametrize("branch,want", [
    ("exact", CRFConfig().num_iters + 1), ("nystrom", 0),
    ("unmaterialised", 0)])
def test_k8_symmetric_launches_counter(monkeypatch, branch, want):
    """``crf.k8_symmetric_launches`` counts the K8 calls that take the
    symmetric schedule (the plain version's on the CPU): the exact CRF's
    degree and every message (10 rows: a live background and 3 classes
    of each variant), and none of the Nystrom's or the unmaterialised
    strided CRF's, whose j side is the strided support."""
    from pnp_ovss_tpu_torch.utils.tracing import TRACER

    valid = np.asarray(_MASKS["classes_dead"])
    logits, image = _masked_logits(np.random.RandomState(55), 24, valid)
    kw = {"exact": dict(bilateral_subsample=1),
          "nystrom": dict(bilateral_subsample=4, bilateral_mode="nystrom"),
          "unmaterialised": dict(bilateral_subsample=4)}[branch]
    if branch == "unmaterialised":
        monkeypatch.setattr(port_crf, "_MATERIALIZE_LIMIT", 0)
    TRACER.drain()
    TRACER.enable()
    try:
        port_crf.mean_field_crf_variants(logits, image, CRFConfig(),
                                         channel_valid=valid, **kw)
        counted = TRACER.drain()["counters"]
    finally:
        TRACER.disable()
    assert counted.get("crf.k8_symmetric_launches", 0) == want
    assert counted["crf.rows_run"] == 2 * CRFConfig().num_iters * 2 * 5


def test_kernel_matmul_reads_strided_values():
    """The CRF hands K8 transposed and strided views of its [C', N] state;
    the result equals that of a contiguous copy."""
    rng = np.random.RandomState(22)
    f = _t(_feats(rng, 96))
    state = _t(rng.rand(7, 192).astype(np.float32))
    view = state[:, ::2].t()  # [96, 7], strides (2, 192)
    torch.testing.assert_close(
        port_bp.gaussian_kernel_matmul(f, view),
        port_bp.gaussian_kernel_matmul(f, view.contiguous()), rtol=0, atol=0)


def test_spatial_gaussian_apply_matches_jax():
    rng = np.random.RandomState(23)
    q = rng.rand(3, 12, 17).astype(np.float32)
    want = np.asarray(jax_crf.spatial_gaussian_apply(
        jnp.asarray(q), jnp.asarray([2.0, 3.5])))
    got = port_crf.spatial_gaussian_apply(_t(q), [2.0, 3.5]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _branch_inputs(case):
    """(logits [V, C, H, W], image, keyword arguments) of one branch."""
    rng = np.random.RandomState(31)
    size, kw = {
        "exact_s1": (48, dict(bilateral_subsample=1)),
        "unmaterialised_s2": (48, dict(bilateral_subsample=2)),
        "many_classes": (32, dict(bilateral_subsample=4)),
        "ragged_n": (40, dict(bilateral_subsample=4)),
        "nystrom_s4": (48, dict(bilateral_subsample=4,
                                bilateral_mode="nystrom")),
    }[case]
    image, logits = _scene(rng, size, size)
    if case == "many_classes":  # v * c = 80 > 64 state rows
        extra = rng.randn(36, size, size).astype(np.float32) * 0.5
        logits = np.concatenate([logits, extra])
    return np.stack([logits, logits[::-1]]), image, kw


@pytest.mark.parametrize("case,bar", [
    ("exact_s1", 0.999), ("unmaterialised_s2", 0.999),
    ("many_classes", 0.999), ("ragged_n", 0.999), ("nystrom_s4", 0.995)])
def test_crf_branch_matches_jax(case, bar, monkeypatch):
    """Each branch of mean_field_crf_variants beside the default one (which
    test_mean_field_crf_matches_jax_fused_path covers), against the JAX
    function at bilateral_impl="pallas" (K8 and K5 in interpret mode), two
    variants, 10 iterations, anisotropic xy_scale. exact_s1 and
    unmaterialised_s2 run K8 once per message (unmaterialised_s2 with the
    port's 7e8-entry materialisation limit set to 0, and the JAX function
    at materialize_kernel=False), nystrom_s4 twice; many_classes (v*c =
    80 > 64) and ragged_n (N = 1600, not a multiple of 128) run the
    materialised kernel under the unfused loop. Labels agree on more than
    99.9% of pixels; Nystrom more than 99.5%, since K_AA^-1 amplifies
    rounding by its condition number. Seeded readings: 1.0 in every
    case."""
    logits, image, kw = _branch_inputs(case)
    jax_kw = dict(kw)
    if case == "unmaterialised_s2":
        monkeypatch.setattr(port_crf, "_MATERIALIZE_LIMIT", 0)
        jax_kw["materialize_kernel"] = False
    want = np.asarray(jax_crf.mean_field_crf_variants(
        jnp.asarray(logits), jnp.asarray(image), JaxCRFConfig(),
        bilateral_impl="pallas", xy_scale=jnp.asarray([0.4, 0.5]), **jax_kw))
    got = port_crf.mean_field_crf_variants(
        _t(logits), _t(image), CRFConfig(), xy_scale=torch.tensor([0.4, 0.5]),
        **kw).numpy()
    assert got.shape == want.shape == logits[:, 0].shape
    assert (got == want).mean() > bar, (got == want).mean()
    assert len(np.unique(got)) > 1


def test_nystrom_gram_matrix_is_cancellation_safe():
    """Fault F2 (tests/test_crf.py's test of the same name): adjacent
    anchors of a structured scene are near-duplicates, so K_AA built by the
    ||a||^2 + ||b||^2 - 2ab expansion loses positive definiteness and the
    Cholesky factor turns to NaN. Built from explicit differences (K5's f32
    output), Nystrom at s = 8 stays finite and agrees with the exact CRF
    (> 99.5%, the JAX test's bar)."""
    image, logits = _two_colour(np.random.RandomState(5), 64, 64, noise=5.0)
    cfg = CRFConfig(num_iters=10)
    exact = port_crf.mean_field_crf(_t(logits), _t(image), cfg,
                                    bilateral_subsample=1).numpy()
    ny = port_crf.mean_field_crf(_t(logits), _t(image), cfg,
                                 bilateral_subsample=8,
                                 bilateral_mode="nystrom").numpy()
    assert ny.shape == (64, 64) and ny.min() >= 0 and ny.max() < 3
    assert (ny == exact).mean() > 0.995, (ny == exact).mean()


def test_kernel_matmul_fn_matches_one_shot_calls():
    """The CRF packs K8's features once per image (``kernel_matmul_fn``)
    and calls it with many values; each call equals the one-shot entry, and
    values of the wrong length raise."""
    rng = np.random.RandomState(24)
    fi, fj = _t(_feats(rng, 150)), _t(_feats(rng, 70))
    fn = port_bp.kernel_matmul_fn(fi, fj)
    for c in (1, 58, 1):
        vals = _t(rng.randn(70, c).astype(np.float32))
        torch.testing.assert_close(
            fn(vals), port_bp.gaussian_kernel_matmul(fi, vals, fj),
            rtol=0, atol=0)
    with pytest.raises(ValueError):
        fn(torch.zeros(69, 3))


# Masks of the runner's 29 slots (background, then 28 classes): the live
# slots of each of its images' two variants.
_MASKS = {
    "classes_dead": [True] * 4 + [False] * 25,  # background and 3 classes
    "background_dead": [False] + [True] * 3 + [False] * 25,
    "all_live": [True] * 29,
    "one_class": [False, True] + [False] * 27,
}


@pytest.mark.parametrize("mask,want", [
    ("classes_dead", (0, 5, [0, 1, 2, 3] + [4] * 25)),
    ("background_dead", (0, 4, [0, 1, 2, 3] + [0] * 25)),
    ("all_live", None),
    ("one_class", (0, 2, [0, 1] + [0] * 27)),
    ("one_dead", None),  # no two slots known equal
    ("two_dead", (0, 28, list(range(28)) + [27])),
    ("gap", (0, 4, [0, 1, 2, 3, 1, 1, 1])),  # slot 2 dead inside the range
])
def test_distinct_slots(mask, want):
    """The range of slots a message runs on: every live slot and the first
    dead one; the map of every slot to its row there."""
    valid = {"one_dead": [True] * 28 + [False],
             "two_dead": [True] * 27 + [False] * 2,
             "gap": [True, False, False, True, False, False, False]} \
        .get(mask) or _MASKS[mask]
    got = port_crf.distinct_slots(np.asarray(valid), len(valid))
    if want is None:
        assert got is None
    else:
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])


def _masked_logits(rng, size, valid):
    """Two variants of 29 slots on ``_scene``'s texture, the dead slots
    at the runner's -1e30."""
    image, logits = _scene(rng, size, size)
    extra = rng.randn(2, 29, size, size).astype(np.float32) * 0.5
    extra[:, :4] += np.stack([logits, logits[::-1]])
    extra[:, ~np.asarray(valid)] = -1e30
    return _t(extra), _t(image)


def _run_recorded(monkeypatch, logits, image, **kw):
    """Labels and, per ``_normalised_apply`` call (the bilateral message
    first, then the spatial, each iteration), the state it read and the
    message it gave."""
    calls, real = [], port_crf._normalised_apply

    def spy(fn, q, norm):
        out = real(fn, q, norm)
        calls.append((q.clone(), out))
        return out

    monkeypatch.setattr(port_crf, "_normalised_apply", spy)
    labels = port_crf.mean_field_crf_variants(
        logits, image, CRFConfig(), xy_scale=torch.tensor([0.4, 0.5]), **kw)
    monkeypatch.setattr(port_crf, "_normalised_apply", real)
    return labels, calls


def _aten_ops(fn):
    """The aten operators ``fn`` runs, in order."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("aten::")]


@pytest.mark.parametrize("mask", list(_MASKS))
@pytest.mark.parametrize("branch", ["exact_s1", "unmaterialised_s2"])
def test_channel_valid_keeps_every_state(branch, mask, monkeypatch):
    """With ``channel_valid`` the exact CRF and the unmaterialised strided
    CRF (K8 on the distinct slots, the spatial product too) read the same
    state as without it, for a live background with dead classes, a dead
    background, one live class, and every slot live, and give the same
    labels. The plain K8's f32 products sum in an order that may depend
    on the column count, so the states agree to f32 rounding (1e-5 on
    probabilities; the seeded readings are 0); the card tests hold the
    kernel's columns bit-equal. In
    the exact CRF with every slot live the same operators run, with dead
    slots one gather more a message."""
    s = 1 if branch == "exact_s1" else 2
    if s == 2:
        monkeypatch.setattr(port_crf, "_MATERIALIZE_LIMIT", 0)
    logits, image = _masked_logits(np.random.RandomState(51), 16,
                                   _MASKS[mask])
    valid = np.asarray(_MASKS[mask])
    want, want_calls = _run_recorded(monkeypatch, logits, image,
                                     bilateral_subsample=s)
    got, got_calls = _run_recorded(monkeypatch, logits, image,
                                   bilateral_subsample=s, channel_valid=valid)
    assert torch.equal(got, want)
    assert len(got_calls) == len(want_calls) == 2 * CRFConfig().num_iters
    for (q_got, _), (q_want, _) in zip(got_calls, want_calls):
        assert q_got.shape == (58, 16 * 16)
        assert (q_got - q_want).abs().max().item() <= 1e-5

    def run(cv):
        return lambda: port_crf.mean_field_crf_variants(
            logits, image, CRFConfig(), bilateral_subsample=s,
            channel_valid=cv)

    if s == 1 and mask == "all_live":
        assert _aten_ops(run(valid)) == _aten_ops(run(None))
    elif s == 1 and mask == "classes_dead":
        deduped, plain = (_aten_ops(run(cv)).count("aten::index_select")
                          for cv in (valid, None))
        assert deduped == plain + 2 * CRFConfig().num_iters


@pytest.mark.parametrize("case", ["nystrom_s4", "ragged_n"])
def test_channel_valid_in_the_other_unfused_branches(case, monkeypatch):
    """The Nystrom CRF (two K8 products and the K_AA^-1 projection) and
    the materialised kernel under the unfused loop (N = 1600) run on the
    distinct slots too. Their f32 products sum in an order that depends
    on the row count, so the states agree to f32 rounding (1e-5 on
    probabilities; seeded readings under 1e-6) and the labels equal."""
    size, kw = {"nystrom_s4": (48, dict(bilateral_subsample=4,
                                        bilateral_mode="nystrom")),
                "ragged_n": (40, dict(bilateral_subsample=4))}[case]
    valid = np.asarray(_MASKS["classes_dead"])
    logits, image = _masked_logits(np.random.RandomState(52), size, valid)
    want, want_calls = _run_recorded(monkeypatch, logits, image, **kw)
    got, got_calls = _run_recorded(monkeypatch, logits, image,
                                   channel_valid=valid, **kw)
    assert torch.equal(got, want)
    assert len(got_calls) == len(want_calls) == 2 * CRFConfig().num_iters
    for (q_got, _), (q_want, _) in zip(got_calls, want_calls):
        assert (q_got - q_want).abs().max().item() <= 1e-5


def test_fused_branch_ignores_channel_valid():
    """The default branch (K5 once, K6 each iteration) runs the same
    operators and gives the same labels with and without the keyword."""
    valid = np.asarray(_MASKS["classes_dead"])
    logits, image = _masked_logits(np.random.RandomState(53), 32, valid)

    def run(cv):
        return port_crf.mean_field_crf_variants(
            logits, image, CRFConfig(), bilateral_subsample=4,
            channel_valid=cv)

    assert torch.equal(run(valid), run(None))
    assert _aten_ops(lambda: run(valid)) == _aten_ops(lambda: run(None))


def test_crf_rows_counters():
    """``crf.rows`` and ``crf.rows_run`` sum the state rows and the rows
    run over the unfused loop's messages (two an iteration) while the
    tracer is on: 58 and 2 x 5 with a live background and 3 live classes,
    beside the exact CRF's ``crf.k8_symmetric_launches`` (the degree and
    every message); nothing while it is off; from the fused branch only
    its own ``crf.spatial_launches``, one an iteration."""
    from pnp_ovss_tpu_torch.utils.tracing import TRACER

    valid = np.asarray(_MASKS["classes_dead"])
    logits, image = _masked_logits(np.random.RandomState(54), 32, valid)
    messages = 2 * CRFConfig().num_iters

    def run(s):
        port_crf.mean_field_crf_variants(
            logits, image, CRFConfig(), bilateral_subsample=s,
            channel_valid=valid)

    TRACER.drain()
    run(1)
    assert TRACER.drain()["counters"] == {}
    TRACER.enable()
    try:
        run(1)
        counted = TRACER.drain()["counters"]
        run(4)
        fused = TRACER.drain()["counters"]
    finally:
        TRACER.disable()
    assert counted == {"crf.rows": messages * 58,
                       "crf.rows_run": messages * 2 * 5,
                       "crf.k8_symmetric_launches": CRFConfig().num_iters + 1}
    assert fused == {"crf.spatial_launches": CRFConfig().num_iters}
