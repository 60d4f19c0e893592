"""Mean-field DenseCRF (counterpart of ``pnp_ovss_tpu/ops/crf.py``).

Reference semantics (reference script ``densecrf``, :1030-1074): unary
``-log(clip(softmax(logits), 1e-5, 1))``; a spatial Gaussian kernel
(POS_XY_STD, Potts weight POS_W) and a bilateral kernel over
(position/BI_XY_STD, rgb/BI_RGB_STD) (weight BI_W), both symmetrically
normalised; 10 iterations of ``Q <- softmax(-U + sum_m w_m K'_m Q)``.

Every branch of the JAX package's ``mean_field_crf_variants`` is ported:

- the default, strided s > 1 with the kernel K^T materialised once per
  image as uint8 by K5, each iteration one fused kernel K6 over a bf16
  state, the spatial normaliser folded into the band matrices
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

from pnp_ovss_tpu_torch.config import CRFConfig
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

    q0 = torch.softmax(logits.float(), dim=1)
    u_flat = -torch.log(torch.clamp(q0, _UNARY_CLIP, 1.0)).reshape(v * c, n)

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
            qs = take_j_cols(q_cn)
            return torch.nn.functional.pad(qs, (0, m_pad - qs.shape[-1]))

        # The all-ones anchor row times K^T is the column sum of the stored
        # codes (integers, exact in f32), then the 1/255 scale.
        deg_bi = kt.sum(dim=0, dtype=torch.float32)[None] \
            * (1.0 / KT_QUANT_SCALE)
        if fused:
            return _fused_loop(q0, u_flat, kt, take_j_pad, deg_bi, pos_xy_std,
                               cfg, h, w)
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
        back = _upload((np.arange(v)[:, None] * (hi - lo) + back)
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

    q = q0.reshape(v * c, n)
    for _ in range(cfg.num_iters):
        m_bi = _normalised_apply(bi_msg, q, norm_bi)
        m_sp = _normalised_apply(sp_msg, q, norm_sp)
        energy = -u_flat + cfg.bi_w * m_bi + cfg.pos_w * m_sp
        # The mean-field softmax runs per variant block of c rows.
        q = torch.softmax(energy.reshape(v, c, n), dim=1).reshape(v * c, n)
    return torch.argmax(q.reshape(v, c, n), dim=1).reshape(v, h, w)


def _upload(index: np.ndarray, device) -> torch.Tensor:
    """Host int64 index -> ``device``, without waiting for the device: a
    pageable copy to the card synchronises the stream, a pinned one is
    queued on it."""
    t = torch.from_numpy(np.ascontiguousarray(index, dtype=np.int64))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _fused_loop(q0, u_flat, kt, take_j_pad, deg_bi, pos_xy_std,
                cfg: CRFConfig, h: int, w: int) -> torch.Tensor:
    """The default branch's iterations: one K6 launch each over a bf16
    state of R = v*c rows rounded up to 16 (pad rows exactly 0), with the
    spatial normaliser folded into the band matrices (the exact rank-1
    fold, ``crf.py:505-522``; valid because the fused branch keeps the
    self term)."""
    v, c = q0.shape[:2]
    n = h * w
    # bf16 products on the card; f32 on the CPU, as crf.py:279.
    mm_dtype = torch.float32 if q0.device.type == "cpu" else torch.bfloat16
    state_dtype = torch.bfloat16
    norm_bi = torch.rsqrt(torch.clamp(deg_bi, min=1e-20))  # [1, N]

    kh, kw = spatial_band_matrices(h, w, pos_xy_std)
    nh = torch.rsqrt(torch.clamp(kh.sum(1), min=1e-20))
    nw = torch.rsqrt(torch.clamp(kw.sum(1), min=1e-20))
    khp = nh[:, None] * kh * nh[None, :]
    kwp = nw[:, None] * kw * nw[None, :]

    r_rows = -(-(v * c) // 16) * 16
    pad_r = r_rows - v * c
    u_neg = torch.nn.functional.pad(-u_flat, (0, 0, 0, pad_r)) \
        .to(state_dtype)
    # The kernel multiplies raw uint8 codes, so the 1/255 rides in nb.
    nb = (cfg.bi_w * (1.0 / KT_QUANT_SCALE) * norm_bi).contiguous()
    norm_j = take_j_pad(norm_bi)  # [1, M_pad]

    q = torch.nn.functional.pad(q0.reshape(v * c, n), (0, 0, 0, pad_r)) \
        .to(state_dtype)
    for _ in range(cfg.num_iters):
        msp = cfg.pos_w * _apply_separable(
            khp, kwp, q.reshape(r_rows, h, w)).reshape(r_rows, n)
        qsub = take_j_pad(q) * norm_j  # bf16 * f32 -> f32
        q = crf_fused_iteration(
            qsub.to(mm_dtype).contiguous(), kt, u_neg,
            msp.to(state_dtype), nb, v=v, c=c)
    labels = torch.argmax(q[:v * c].reshape(v, c, n), dim=1)
    return labels.reshape(v, h, w)
