"""``crf_first_state`` and ``crf_spatial_operands``: the fused CRF loop's
first state and its per-iteration operands.

On the CPU the wrapper runs its plain version: the fold's band matrices,
the f32 separable product and the strided state times ``norm_bi``, as the
fused loop computed them before the card got a kernel for them; the
kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). These tests pin the
plain versions bit for bit to that glue, the wrappers' checks, the
counter and the benchmark's recording seam on the fused loop.
"""

import numpy as np
import pytest
import torch

from pnp_ovss_tpu_torch.config import CRFConfig
from pnp_ovss_tpu_torch.ops import crf
from pnp_ovss_tpu_torch.utils.tracing import TRACER


def _inputs(seed, v, c, h, w, s=4):
    """A bf16 state of v*c rows (softmax probabilities) padded with zero
    rows to a multiple of 16, norm_bi [1, N] in K5's range, sigma for a
    500 x 375 ground truth at this bucket (the runner's xy scale), and
    M_pad as K5 pads it."""
    rng = np.random.RandomState(seed)
    vc, n = v * c, h * w
    r = -(-vc // 16) * 16
    probs = torch.softmax(torch.from_numpy(
        rng.randn(v, c, n).astype(np.float32) * 2), dim=1)
    q = torch.zeros((r, n), dtype=torch.bfloat16)
    q[:vc] = probs.reshape(vc, n)
    norm_bi = torch.from_numpy(
        (rng.rand(1, n) * 0.25 + 0.05).astype(np.float32))
    sigma = torch.tensor([3.0 * h / 375, 3.0 * w / 500])
    m_pad = -(-(-(-h // s) * -(-w // s)) // 128) * 128
    return q, norm_bi, sigma, m_pad


def _glue(q, norm_bi, sigma, h, w, s, m_pad, pos_w):
    """The fused loop's operands as it made them in PyTorch, on the CPU."""
    r, n = q.shape
    kh, kw = crf.spatial_band_matrices(h, w, sigma)
    nh = torch.rsqrt(torch.clamp(kh.sum(1), min=1e-20))
    nw = torch.rsqrt(torch.clamp(kw.sum(1), min=1e-20))
    khp = nh[:, None] * kh * nh[None, :]
    kwp = nw[:, None] * kw * nw[None, :]
    msp = pos_w * crf._apply_separable(
        khp, kwp, q.reshape(r, h, w)).reshape(r, n)

    def take_j_pad(x):
        xs = x.unflatten(-1, (h, w))[..., ::s, ::s].flatten(-2)
        return torch.nn.functional.pad(xs, (0, m_pad - xs.shape[-1]))

    qsub = take_j_pad(q) * take_j_pad(norm_bi)
    return msp.to(torch.bfloat16), qsub.float().contiguous()


@pytest.mark.parametrize("v,c,h,w", [(2, 5, 32, 32), (1, 3, 16, 24),
                                     (2, 29, 192, 192)])
def test_cpu_branch_equals_the_pytorch_glue(v, c, h, w):
    """Bit for bit: msp (bf16) and qsub (f32 on the CPU, as the CPU's K6
    takes it), pad rows 0; bucket 192 with 58 rows is the main path's."""
    q, norm_bi, sigma, m_pad = _inputs(0, v, c, h, w)
    msp, qsub = crf.crf_spatial_operands(q, norm_bi, sigma, h=h, w=w, s=4,
                                         m_pad=m_pad, rows=v * c, pos_w=7.0)
    want_msp, want_qsub = _glue(q, norm_bi, sigma, h, w, 4, m_pad, 7.0)
    assert msp.dtype == torch.bfloat16 and qsub.dtype == torch.float32
    assert torch.equal(msp, want_msp)
    assert torch.equal(qsub, want_qsub)
    assert not msp[v * c:].any() and not qsub[v * c:].any()


def test_plain_version_rounds_qsub_once():
    """The plain version's bf16 qsub is the f32 product rounded once (the
    kernel's bar), and its f32 msp the product before the rounding."""
    q, norm_bi, sigma, m_pad = _inputs(1, 2, 5, 32, 32)
    kw = dict(h=32, w=32, s=4, m_pad=m_pad, pos_w=7.0)
    msp16, qsub16 = crf.spatial_operands_plain(q, norm_bi, sigma, **kw)
    msp32, qsub32 = crf.spatial_operands_plain(
        q, norm_bi, sigma, msp_dtype=torch.float32,
        qsub_dtype=torch.float32, **kw)
    assert torch.equal(qsub16, qsub32.to(torch.bfloat16))
    assert torch.equal(msp16, msp32.to(torch.bfloat16))


def _codes(seed, m_pad, n):
    """uint8 K^T codes with zero pad rows, as K5 leaves them."""
    rng = np.random.RandomState(seed)
    kt = torch.from_numpy(rng.randint(0, 256, (m_pad, n)).astype(np.uint8))
    kt[m_pad - 40:] = 0
    return kt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,c,h,w", [(2, 5, 32, 32), (2, 29, 192, 192)])
def test_first_state_cpu_branch_equals_the_pytorch_glue(v, c, h, w, dtype):
    """Bit for bit: softmax over each variant's slots, log of the clipped
    state, both bf16, pad rows 0 (the disabled slots at the runner's
    value); norm_bi and nb from K^T's column sums."""
    rng = np.random.RandomState(3)
    logits = torch.from_numpy(rng.randn(v, c, h, w).astype(np.float32) * 3)
    logits[:, c // 2 + 1:] = -1e30
    logits = logits.to(dtype)
    vc, r, n = v * c, -(-(v * c) // 16) * 16, h * w
    kt = _codes(4, 128 * -(-(-(-h // 4) * -(-w // 4)) // 128), n)
    (q, u_neg), norms = crf.crf_first_state(logits, kt, r, 10.0 / 255)
    q0 = torch.softmax(logits.float(), dim=1)
    want_q = torch.nn.functional.pad(q0.reshape(vc, n),
                                     (0, 0, 0, r - vc)).to(torch.bfloat16)
    want_u = torch.nn.functional.pad(
        -(-torch.log(torch.clamp(q0, 1e-5, 1.0)).reshape(vc, n)),
        (0, 0, 0, r - vc)).to(torch.bfloat16)
    deg_bi = kt.sum(dim=0, dtype=torch.float32)[None] * (1.0 / 255.0)
    norm_bi = torch.rsqrt(torch.clamp(deg_bi, min=1e-20))
    nb = (10.0 * (1.0 / 255.0) * norm_bi).contiguous()
    assert q.dtype == u_neg.dtype == torch.bfloat16
    assert torch.equal(q, want_q) and torch.equal(u_neg, want_u)
    assert norms.shape == (2, n) and norms.dtype == torch.float32
    assert torch.equal(norms[0:1], norm_bi) and torch.equal(norms[1:2], nb)


@pytest.mark.parametrize("case", ["f16", "strided", "rows", "kt_f32",
                                  "kt_short"])
def test_first_state_refuses_what_the_kernel_does_not_take(case):
    logits = torch.randn(2, 5, 8, 16)
    kt, r = _codes(5, 128, 128), 16
    if case == "f16":
        logits = logits.half()
    elif case == "strided":
        logits = logits.transpose(2, 3)
    elif case == "rows":
        r = 8
    elif case == "kt_f32":
        kt = kt.float()
    else:
        kt = kt[:, :100]
    with pytest.raises(ValueError):
        crf.crf_first_state(logits, kt, r, 10.0 / 255)


def _bad(case):
    q, norm_bi, sigma, m_pad = _inputs(2, 2, 5, 32, 32)
    kw = dict(h=32, w=32, s=4, m_pad=m_pad, rows=10, pos_w=7.0)
    if case == "q_f32":
        q = q.float()
    elif case == "q_shape":
        q = q.reshape(16, 32, 32)
    elif case == "q_strided":
        q = torch.cat([q, q], 1)[:, ::2]
    elif case == "norm_f64":
        norm_bi = norm_bi.double()
    elif case == "norm_short":
        norm_bi = norm_bi[:, 1:]
    elif case == "sigma_shape":
        sigma = torch.ones(3)
    elif case == "m_pad":
        kw["m_pad"] = 63
    elif case == "rows":
        kw["rows"] = 17
    elif case == "msp_dtype":
        kw["msp_dtype"] = torch.float16
    return q, norm_bi, sigma, kw


@pytest.mark.parametrize("case", ["q_f32", "q_shape", "q_strided",
                                  "norm_f64", "norm_short", "sigma_shape",
                                  "m_pad", "rows", "msp_dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Wrong dtypes, shapes and a non-contiguous state raise, on the CPU as
    on the card (the checks come before the branch)."""
    q, norm_bi, sigma, kw = _bad(case)
    with pytest.raises(ValueError):
        crf.crf_spatial_operands(q, norm_bi, sigma, **kw)


def _scene_logits(seed, size, c=5):
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(
        rng.randn(2, c, size, size).astype(np.float32)).to(torch.bfloat16)
    image = torch.from_numpy(
        rng.randint(0, 256, (size, size, 3)).astype(np.float32))
    return logits, image


def _fused_crf(logits, image):
    return crf.mean_field_crf_variants(
        logits, image, CRFConfig(), bilateral_subsample=4,
        xy_scale=torch.tensor([32 / 500, 32 / 375]))


def test_spatial_launches_counts_ten_an_image():
    """``crf.spatial_launches`` counts one a call of the wrapper: 10 an
    image in the fused loop, while the tracer is on; nothing while it is
    off."""
    scenes = [_scene_logits(seed, 32) for seed in (3, 4)]
    TRACER.drain()
    _fused_crf(*scenes[0])
    assert TRACER.drain()["counters"] == {}
    TRACER.enable()
    try:
        for scene in scenes:
            _fused_crf(*scene)
        counted = TRACER.drain()["counters"]
    finally:
        TRACER.disable()
    assert counted == {"crf.spatial_launches": 2 * CRFConfig().num_iters}


def test_benchmark_seam_records_every_fused_state(monkeypatch):
    """With the benchmark's spies installed (``port_bench/systems/
    segmentation_runner.py``), one fused CRF call records the logits and
    ``num_iters`` states of >= V*C rows, each a distinct tensor that the
    later iterations leave unchanged."""
    from port_bench.systems.segmentation_runner import System

    copies, real = [], crf.crf_fused_iteration

    def copying(*args, **kw):
        out = real(*args, **kw)
        copies.append(out.clone())
        return out

    monkeypatch.setattr(crf, "crf_fused_iteration", copying)
    system = System.__new__(System)
    system._recording = {}
    system._crf_spies()
    system._sampled_now = [0]
    try:
        logits, image = _scene_logits(5, 32)
        crf.mean_field_crf_variants(
            logits, image, CRFConfig(), bilateral_subsample=4,
            xy_scale=torch.tensor([32 / 500, 32 / 375]))
    finally:
        (crf.mean_field_crf_variants, crf.crf_fused_iteration,
         crf._normalised_apply) = system._crf_real
    rec = system._recording
    states = rec["crf"][0]
    assert torch.equal(rec["crf_logits"][0], logits)
    assert rec["crf_first"] == 1
    assert len(states) == CRFConfig().num_iters
    assert all(st.shape[0] >= 2 * 5 for st in states)
    assert len({st.data_ptr() for st in states}) == len(states)
    assert all(torch.equal(st, cp) for st, cp in zip(states, copies))
    # The last state gives the labels the call returned.
    labels = _fused_crf(logits, image)
    last = states[-1][:10].reshape(2, 5, -1).argmax(1).reshape(2, 32, 32)
    assert torch.equal(labels, last)
