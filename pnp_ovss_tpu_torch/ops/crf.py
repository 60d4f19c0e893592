"""Mean-field DenseCRF (counterpart of ``pnp_ovss_tpu/ops/crf.py``).

Reference semantics (reference script ``densecrf``, :1030-1074): unary
``-log(clip(softmax(logits), 1e-5, 1))``; a spatial Gaussian kernel
(POS_XY_STD, Potts weight POS_W) and a bilateral kernel over
(position/BI_XY_STD, rgb/BI_RGB_STD) (weight BI_W), both symmetrically
normalised; 10 iterations of ``Q <- softmax(-U + sum_m w_m K'_m Q)``.

Every branch of the JAX package's ``mean_field_crf_variants`` is ported:

- the default, strided s > 1 with the kernel K^T materialised once per
  image as uint8 by K5 and the loop's set-up made by one launch
  (``crf_first_state``, ``csrc/crf_spatial.cu``), then each iteration two
  launches over a bf16 state: ``crf_spatial_operands`` (same source)
  makes the spatial message, with the normaliser folded into the band
  matrices, and the strided operand, then the fused kernel K6
  (``crf.py:267-325``, ``:476-544``);
- the same materialised kernel under the unfused loop (``crf.py:384-390``,
  ``:546-563``) where K6 cannot run: more than 64 state rows, or N not a
  multiple of 128;
- the exact CRF (s = 1) and the unmaterialised strided CRF, whose message
  is one K8 product a call (``crf.py:429-433``);
- the Nystrom reconstruction through the strided anchors, two K8 products
  a call, the anchor Gram matrix built by K5 in f32 (``crf.py:391-428``).

The JAX package's gates alone choose the branch. Its knobs that no caller
of the port sets are not ported: ``exclude_self``, ``unary_clip`` (fixed
at 1e-5), ``materialize_kernel``, ``fused_iteration``, ``bilateral_impl``
(the tensor's device decides) and the f32 opt-outs (uint8 K^T and bf16
fused state only). No environment variable is read.
"""

from __future__ import annotations

import numpy as np
import torch

from pnp_ovss_tpu_torch import to_device
from pnp_ovss_tpu_torch.config import CRFConfig
from pnp_ovss_tpu_torch.ops import _build
from pnp_ovss_tpu_torch.ops.bilateral import (
    KT_QUANT_SCALE,
    crf_fused_iteration,
    gaussian_kernel_materialize,
    kernel_matmul_fn,
)
from pnp_ovss_tpu_torch.utils.tracing import TRACER

_MATERIALIZE_LIMIT = 7e8  # N*M entries (the JAX package's pallas limit)
_UNARY_CLIP = 1e-5  # the reference's clip of softmax(logits)


def _pair(x, device) -> torch.Tensor:
    """Scalar or 2-vector -> f32 tensor [2]."""
    return torch.as_tensor(x, dtype=torch.float32, device=device) \
        .reshape(-1).expand(2)


def spatial_band_matrices(h: int, w: int, sigma: torch.Tensor):
    """(kh [H, H], kw [W, W]) Gaussian band matrices of the separable
    spatial kernel; ``sigma`` is ``(sigma_y, sigma_x)``."""
    def band(n, s):
        idx = torch.arange(n, dtype=torch.float32, device=sigma.device)
        return torch.exp(-0.5 * ((idx[:, None] - idx[None, :]) / s) ** 2)

    return band(h, sigma[0]), band(w, sigma[1])


def bilateral_features(image_rgb: torch.Tensor, sxy, srgb: float
                       ) -> torch.Tensor:
    """[H, W, 3] (0-255 RGB) -> [H*W, 5] features (x/sx, y/sy, rgb/srgb).

    ``sxy`` is a scalar or the per-axis pair ``(sxy_x, sxy_y)``: y is
    divided by ``sxy[1]`` (fault F6 in ROADMAP.md)."""
    h, w, _ = image_rgb.shape
    sxy = _pair(sxy, image_rgb.device)
    ys = torch.arange(h, dtype=torch.float32, device=sxy.device)[:, None] \
        / sxy[1]
    xs = torch.arange(w, dtype=torch.float32, device=sxy.device)[None, :] \
        / sxy[0]
    feats = torch.stack(
        [xs.expand(h, w), ys.expand(h, w)], dim=-1)
    rgb = image_rgb.float() / srgb
    return torch.cat([feats, rgb], dim=-1).reshape(h * w, 5)


def _apply_separable(kh, kw, q):
    """kh @ Q @ kw^T per leading index (kh, kw symmetric)."""
    return torch.matmul(torch.matmul(kh, q.float()), kw.transpose(0, 1))


def _take_j_pad(x, h: int, w: int, s: int, m_pad: int) -> torch.Tensor:
    """[..., h*w] -> [..., M_pad]: every s-th pixel per axis, then zero
    pad columns."""
    xs = x.unflatten(-1, (h, w))[..., ::s, ::s].flatten(-2)
    return torch.nn.functional.pad(xs, (0, m_pad - xs.shape[-1]))


def spatial_operands_plain(q, norm_bi, sigma, *, h: int, w: int, s: int,
                           m_pad: int, pos_w: float,
                           msp_dtype=torch.bfloat16,
                           qsub_dtype=torch.bfloat16):
    """Plain version of ``crf_spatial_operands``: the band matrices of
    ``sigma`` with the spatial normaliser folded in (the exact rank-1
    fold, ``crf.py:505-522``: khp = n_h kh n_h; valid because the fused
    branch keeps the self term), the f32 separable
    product times ``pos_w`` in ``msp_dtype``, and the strided state times
    ``norm_bi`` at the anchors, zero pad columns, in ``qsub_dtype`` (f32
    keeps the product unrounded)."""
    r = q.shape[0]
    kh, kw = spatial_band_matrices(h, w, sigma)
    nh = torch.rsqrt(torch.clamp(kh.sum(1), min=1e-20))
    nw = torch.rsqrt(torch.clamp(kw.sum(1), min=1e-20))
    khp = nh[:, None] * kh * nh[None, :]
    kwp = nw[:, None] * kw * nw[None, :]
    msp = pos_w * _apply_separable(khp, kwp, q.reshape(r, h, w)) \
        .reshape(r, h * w)
    qsub = _take_j_pad(q, h, w, s, m_pad) * _take_j_pad(norm_bi, h, w, s,
                                                         m_pad)
    return msp.to(msp_dtype), qsub.to(qsub_dtype)


def crf_spatial_operands(q: torch.Tensor, norm_bi: torch.Tensor,
                         sigma: torch.Tensor, *, h: int, w: int, s: int,
                         m_pad: int, rows: int, pos_w: float,
                         msp_dtype=torch.bfloat16):
    """K6's two operands of one fused iteration from the state ``q`` [R,
    h*w] bf16 -> (msp [R, h*w] in ``msp_dtype``, bf16 or f32: ``pos_w``
    times the normalised separable spatial product of each row; qsub [R,
    M_pad]: ``q * norm_bi`` at every s-th pixel per axis, zero pad
    columns). ``norm_bi`` holds h*w f32 ([1, N] or [N]); ``sigma`` [2] f32
    is (sigma_y, sigma_x). Rows >= ``rows`` must be 0 in ``q`` (the fused
    loop's pad rows); they stay 0.

    On a CUDA tensor one launch of ``csrc/crf_spatial.cu`` (qsub bf16,
    bit-equal to the plain product rounded once); on a CPU tensor the
    plain version, qsub kept f32 as the CPU's K6 takes it. Counts
    ``crf.spatial_launches`` either way."""
    r, n = q.shape[0], h * w
    # name: (tensor, dtype, shape fits)
    want = {"q": (q, torch.bfloat16, tuple(q.shape) == (r, n)),
            "norm_bi": (norm_bi, torch.float32, norm_bi.numel() == n),
            "sigma": (sigma, torch.float32, tuple(sigma.shape) == (2,))}
    for name, (t, dtype, fits) in want.items():
        if t.dtype != dtype or not fits:
            raise ValueError(f"crf_spatial_operands: {name} must be {dtype} "
                             f"(h={h}, w={w}), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"crf_spatial_operands: {name} must be "
                             "contiguous")
    if msp_dtype not in (torch.bfloat16, torch.float32) or s < 1 \
            or m_pad < -(-h // s) * -(-w // s) or not 0 <= rows <= r \
            or r > 65535:
        raise ValueError(f"crf_spatial_operands: unsupported R={r} rows="
                         f"{rows} h={h} w={w} s={s} M_pad={m_pad} "
                         f"msp_dtype={msp_dtype}")
    TRACER.count("crf.spatial_launches")
    if q.device.type == "cpu":
        return spatial_operands_plain(q, norm_bi, sigma, h=h, w=w, s=s,
                                      m_pad=m_pad, pos_w=pos_w,
                                      msp_dtype=msp_dtype,
                                      qsub_dtype=torch.float32)
    msp = torch.empty((r, n), dtype=msp_dtype, device=q.device)
    qsub = torch.empty((r, m_pad), dtype=torch.bfloat16, device=q.device)
    _build.require_cuda("crf_spatial_operands", q=q, norm_bi=norm_bi,
                        sigma=sigma, msp=msp, qsub=qsub)
    lib = _build.library("crf_spatial")
    rc = lib.crf_spatial_operands(
        q.data_ptr(), norm_bi.data_ptr(), sigma.data_ptr(), msp.data_ptr(),
        qsub.data_ptr(), r, rows, h, w, s, m_pad, pos_w,
        int(msp_dtype == torch.float32), _build.stream_ptr(q))
    _build.check(lib, rc, "crf_spatial_operands")
    _build.LAUNCHES["crf_spatial_operands"] += 1
    return msp, qsub


def _materialised_degree(kt: torch.Tensor) -> torch.Tensor:
    """[1, N] bilateral degree of K5's uint8 K^T: the all-ones anchor row
    times K^T is the column sum of the stored codes (integers, exact in
    f32), then the 1/255 scale."""
    return kt.sum(dim=0, dtype=torch.float32)[None] * (1.0 / KT_QUANT_SCALE)


def first_state_plain(logits: torch.Tensor, kt: torch.Tensor, r_rows: int,
                      nb_scale: float):
    """Plain version of ``crf_first_state``."""
    v, c = logits.shape[:2]
    vc = v * c
    q0 = torch.softmax(logits.float(), dim=1).reshape(vc, -1)
    first = torch.zeros((2, r_rows, q0.shape[1]), dtype=torch.bfloat16,
                        device=logits.device)
    first[0, :vc] = q0
    first[1, :vc] = torch.log(torch.clamp(q0, _UNARY_CLIP, 1.0))
    norm_bi = torch.rsqrt(torch.clamp(_materialised_degree(kt), min=1e-20))
    return first, torch.cat([norm_bi, nb_scale * norm_bi])


def crf_first_state(logits: torch.Tensor, kt: torch.Tensor, r_rows: int,
                    nb_scale: float):
    """The fused loop's set-up -> (first [2, R, N] bf16, norms [2, N] f32).
    first[0] is the first state, softmax(logits) over C per variant (f32,
    as ``torch.softmax(logits.float(), 1)``), first[1] its minus-unary
    log(clip(state, 1e-5, 1)), each rounded once, rows >= V*C 0; norms[0]
    is norm_bi = rsqrt(max(deg, 1e-20)) with deg K^T's column sums / 255,
    norms[1] is nb = ``nb_scale`` * norm_bi. logits [V, C, ...] bf16 or
    f32, kt [M_pad, N] uint8 from K5. On a CUDA tensor one launch of
    ``csrc/crf_spatial.cu``; on a CPU tensor the plain version."""
    v, c = logits.shape[:2]
    n = logits[0, 0].numel()
    if logits.dtype not in (torch.bfloat16, torch.float32) \
            or not logits.is_contiguous() or not v * c <= r_rows \
            or kt.dtype != torch.uint8 or kt.ndim != 2 or kt.shape[1] != n \
            or not kt.is_contiguous():
        raise ValueError(f"crf_first_state: logits {logits.dtype} "
                         f"{tuple(logits.shape)}, kt {kt.dtype} "
                         f"{tuple(kt.shape)} (contiguous bf16 or f32 logits, "
                         f"uint8 [M_pad, N], V*C <= R = {r_rows})")
    if logits.device.type == "cpu":
        return first_state_plain(logits, kt, r_rows, nb_scale)
    first = torch.empty((2, r_rows, n), dtype=torch.bfloat16,
                        device=logits.device)
    norms = torch.empty((2, n), dtype=torch.float32, device=logits.device)
    _build.require_cuda("crf_first_state", logits=logits, kt=kt,
                        first=first, norms=norms)
    lib = _build.library("crf_spatial")
    rc = lib.crf_first_state(
        logits.data_ptr(), kt.data_ptr(), first.data_ptr(), norms.data_ptr(),
        v, c, r_rows, n, kt.shape[0], nb_scale,
        int(logits.dtype == torch.float32), _build.stream_ptr(logits))
    _build.check(lib, rc, "crf_first_state")
    _build.LAUNCHES["crf_first_state"] += 1
    return first, norms


def spatial_gaussian_apply(q: torch.Tensor, sigma) -> torch.Tensor:
    """K @ q for the separable 2D spatial Gaussian. q: [..., H, W];
    ``sigma`` is a scalar or ``(sigma_y, sigma_x)``."""
    h, w = q.shape[-2:]
    kh, kw = spatial_band_matrices(h, w, _pair(sigma, q.device))
    return _apply_separable(kh, kw, q)


def _normalised_apply(apply_fn, q_flat: torch.Tensor,
                      norm: torch.Tensor) -> torch.Tensor:
    """Symmetric normalisation: n * K(n * q)."""
    return norm * apply_fn(norm * q_flat)


def distinct_slots(channel_valid, c: int):
    """(lo, hi, back) for a [C] host mask whose ``False`` slots hold
    identical logits, or None where no two slots are known to be equal.

    Dead slots that start equal get equal messages, so their states stay
    equal, bit for bit, through every iteration; a message need only run
    on slots ``lo:hi`` of each variant, the smallest range that holds every
    live slot and the first dead one. ``back`` [C] (numpy int64) maps each
    slot to its row in that range: its own inside it, the first dead
    slot's outside it."""
    valid = np.asarray(channel_valid, dtype=bool)
    if valid.shape != (c,):
        raise ValueError(f"channel_valid has shape {valid.shape}, want "
                         f"({c},)")
    dead = np.flatnonzero(~valid)
    if dead.size < 2:
        return None
    keep = np.append(np.flatnonzero(valid), dead[0])
    lo, hi = int(keep.min()), int(keep.max()) + 1
    if hi - lo == c:
        return None
    slots = np.arange(c)
    back = np.where((slots >= lo) & (slots < hi), slots, dead[0]) - lo
    return lo, hi, back


def mean_field_crf(logits: torch.Tensor, image_rgb: torch.Tensor,
                   cfg: CRFConfig, **kw) -> torch.Tensor:
    """Single-variant mean-field inference: logits [C, H, W] -> labels
    [H, W] int64."""
    return mean_field_crf_variants(logits[None], image_rgb, cfg, **kw)[0]


def mean_field_crf_variants(
    logits: torch.Tensor,  # [V, C, H, W]: V unary variants, shared image
    image_rgb: torch.Tensor,  # [H, W, 3] 0-255
    cfg: CRFConfig,
    *,
    bilateral_subsample: int = 4,
    bilateral_mode: str = "strided",  # "strided" | "nystrom"
    nystrom_ridge: float = 1e-2,
    xy_scale=1.0,
    channel_valid=None,
) -> torch.Tensor:
    """Mean-field inference for V unary variants of one image -> labels
    [V, H, W] int64.

    ``bilateral_subsample`` s > 1 restricts the bilateral support to every
    s-th pixel per axis: "strided" sums over that subset, "nystrom"
    reconstructs K ~= K_NA (K_AA + ridge I)^-1 K_AN through it; s = 1 is
    the exact CRF. ``xy_scale`` (scalar or ``(sx, sy)``) multiplies the
    spatial stds so the bucket-resolution CRF keeps the reference's
    relative reach per axis (the runner passes ``(bucket/gt_w,
    bucket/gt_h)``). The strided kernel is materialised where N*M <= 7e8;
    K6 then runs each iteration where v*c <= 64 and N % 128 == 0, as the
    JAX package decides.

    ``channel_valid`` [C] bool, host data (numpy or a sequence): every
    ``False`` slot of a variant holds identical logits (the runner's
    disabled slots). The unfused loop then runs each message on the
    distinct slots only (``distinct_slots``) and copies a dead slot's
    message from the first dead slot's: the same arithmetic on fewer
    rows, while the state keeps all V * C rows. None keeps every slot
    distinct; the fused branch ignores it."""
    if bilateral_mode not in ("strided", "nystrom"):
        raise ValueError(f"bilateral_mode={bilateral_mode!r}: want "
                         "'strided' or 'nystrom'")
    v, c, h, w = logits.shape
    n = h * w
    s = bilateral_subsample
    hs, ws = -(-h // s), -(-w // s)
    dev = logits.device

    scale_xy = _pair(xy_scale, dev)  # (sx, sy)
    pos_xy_std = cfg.pos_xy_std * scale_xy.flip(0)  # (sigma_y, sigma_x)
    feats = bilateral_features(image_rgb, cfg.bi_xy_std * scale_xy,
                               cfg.bi_rgb_std)
    # The bilateral support: every s-th pixel per axis (all of them at s=1).
    feats_j = feats.reshape(h, w, 5)[::s, ::s].reshape(-1, 5)

    def take_j_cols(x):  # [..., N] -> [..., M]
        return x.unflatten(-1, (h, w))[..., ::s, ::s].flatten(-2)

    use_nystrom = bilateral_mode == "nystrom" and s > 1
    materialised = (bilateral_mode == "strided" and s > 1
                    and n * hs * ws <= _MATERIALIZE_LIMIT)
    fused = materialised and v * c <= 64 and n % 128 == 0

    if materialised:
        kt = gaussian_kernel_materialize(feats_j, feats,
                                         out_dtype=torch.uint8)
        m_pad = kt.shape[0]

        def take_j_pad(q_cn):  # [..., N] -> [..., M_pad], zero pad columns
            return _take_j_pad(q_cn, h, w, s, m_pad)

        if fused:
            return _fused_loop(logits, kt, pos_xy_std, cfg, h, w, s)
        deg_bi = _materialised_degree(kt)
        # Unfused loop on the materialised kernel: v^T [C', M] @ K^T with
        # bf16 operands on the card (f32 on the CPU, crf.py:279) and f32
        # sums, descaled by 1/255. The codes are integers, exact in bf16
        # and f32, so the f32 product of the bf16-rounded state equals the
        # JAX package's bf16 dot with an f32 result. K^T is cast once per
        # image here, where the JAX package casts it in every iteration.
        mm_dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
        kt_f = kt.float()

        def bilateral_apply(q_cn):  # [..., N] -> [C', N]
            qs = take_j_pad(q_cn).to(mm_dtype).float()
            return (torch.matmul(qs, kt_f)
                    * (1.0 / KT_QUANT_SCALE)).reshape(-1, n)
    elif use_nystrom:
        # The anchor Gram matrix K_AA, f32 from K5's explicit differences
        # (fault F2: the ||a||^2 + ||b||^2 - 2ab expansion cancels for
        # near-duplicate anchors and loses positive definiteness),
        # factorised once per image; cholesky_ex does not wait on the host.
        # K_AA is ill-conditioned, so the per-iteration projection stays in
        # f32 (the port leaves TF32 off).
        fa = feats_j
        m_a = fa.shape[0]
        eye = torch.eye(m_a, dtype=torch.float32, device=dev)
        k_aa = gaussian_kernel_materialize(fa, fa,
                                           out_dtype=torch.float32)[:m_a]
        chol, _ = torch.linalg.cholesky_ex(k_aa + nystrom_ridge * eye)
        k_aa_inv = torch.cholesky_solve(eye, chol)
        k_an, k_na = kernel_matmul_fn(fa, feats), kernel_matmul_fn(feats, fa)

        def bilateral_apply(q_cn):  # [..., N] -> [C', N], two K8 products
            return k_na(k_aa_inv @ k_an(q_cn.movedim(-1, 0))).t()
    else:
        k_nm = kernel_matmul_fn(feats, feats_j if s > 1 else None)

        def bilateral_apply(q_cn):  # [..., N] -> [C', N], one K8 product
            return k_nm(take_j_cols(q_cn).movedim(-1, 0)).t()

    if not materialised:
        deg_bi = bilateral_apply(torch.ones((1, n), device=dev))
    norm_bi = torch.rsqrt(torch.clamp(deg_bi, min=1e-20))  # [1, N]

    kh, kw = spatial_band_matrices(h, w, pos_xy_std)

    def spatial_apply(q_cn):  # [..., N] -> [C', N]
        return _apply_separable(kh, kw, q_cn.reshape(-1, h, w)) \
            .reshape(-1, n)

    deg_sp = spatial_apply(torch.ones((1, n), device=dev))
    norm_sp = torch.rsqrt(torch.clamp(deg_sp, min=1e-20))  # [1, N]

    slots = None if channel_valid is None else distinct_slots(channel_valid,
                                                               c)
    if slots is None:
        bi_msg, sp_msg, rows_run = bilateral_apply, spatial_apply, v * c
    else:
        lo, hi, back = slots
        back = to_device((np.arange(v)[:, None] * (hi - lo) + back)
                         .reshape(-1), dev)
        rows_run = v * (hi - lo)

        def distinct(apply_fn):
            # Slots lo:hi of each variant, a view of the [V*C, N] state;
            # the message of those V*(hi-lo) rows, then one gather to all.
            return lambda q_cn: apply_fn(
                q_cn.reshape(v, c, n)[:, lo:hi]).index_select(0, back)

        bi_msg, sp_msg = distinct(bilateral_apply), distinct(spatial_apply)
    # Summed over the loop's messages (two an iteration).
    TRACER.count("crf.rows", 2 * cfg.num_iters * v * c)
    TRACER.count("crf.rows_run", 2 * cfg.num_iters * rows_run)

    q0 = torch.softmax(logits.float(), dim=1)
    u_flat = -torch.log(torch.clamp(q0, _UNARY_CLIP, 1.0)).reshape(v * c, n)
    q = q0.reshape(v * c, n)
    for _ in range(cfg.num_iters):
        m_bi = _normalised_apply(bi_msg, q, norm_bi)
        m_sp = _normalised_apply(sp_msg, q, norm_sp)
        energy = -u_flat + cfg.bi_w * m_bi + cfg.pos_w * m_sp
        # The mean-field softmax runs per variant block of c rows.
        q = torch.softmax(energy.reshape(v, c, n), dim=1).reshape(v * c, n)
    return torch.argmax(q.reshape(v, c, n), dim=1).reshape(v, h, w)


def _fused_loop(logits, kt, pos_xy_std, cfg: CRFConfig, h: int, w: int,
                s: int) -> torch.Tensor:
    """The default branch's iterations over a bf16 state of R = v*c rows
    rounded up to 16 (pad rows exactly 0), made with the minus-unary and
    the bilateral normalisers by ``crf_first_state``; two launches an
    iteration: ``crf_spatial_operands`` makes K6's spatial message and
    strided operand from the state, then K6, which returns a new state
    tensor each iteration."""
    v, c = logits.shape[:2]
    vc = v * c
    # K6 multiplies raw uint8 codes, so the 1/255 rides in nb.
    (q, u_neg), norms = crf_first_state(
        logits.contiguous(), kt, -(-vc // 16) * 16,
        cfg.bi_w * (1.0 / KT_QUANT_SCALE))
    norm_bi, nb = norms[0:1], norms[1:2]  # [1, N] each
    m_pad = kt.shape[0]
    for _ in range(cfg.num_iters):
        msp, qsub = crf_spatial_operands(q, norm_bi, pos_xy_std, h=h, w=w,
                                         s=s, m_pad=m_pad, rows=vc,
                                         pos_w=cfg.pos_w)
        q = crf_fused_iteration(qsub, kt, u_neg, msp, nb, v=v, c=c)
    labels = torch.argmax(q[:vc].reshape(v, c, h * w), dim=1)
    return labels.reshape(v, h, w)
