"""CRF bilateral kernels K8, K5 and K6 (counterparts of
``pnp_ovss_tpu/ops/bilateral_pallas.py``).

- ``gaussian_kernel_matmul`` (K8, ``csrc/crf_matmul.cu``) computes the
  bilateral message ``sum_j exp(-||f_i - f_j||^2 / 2) v_j`` without
  materialising the kernel: the exact, unmaterialised and Nystrom CRFs.
- ``gaussian_kernel_materialize`` (K5, ``csrc/crf_materialize.cu``) builds
  the transposed bilateral kernel K^T [M_pad, N] once per image.
- ``crf_fused_iteration`` (K6, ``csrc/crf_iteration.cu``) runs one
  mean-field iteration: bilateral product, energy and per-variant softmax.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs the plain PyTorch version beside it.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from pnp_ovss_tpu_torch.ops import _build

KT_QUANT_SCALE = 255.0  # uint8 kernel storage: k in [0, 1] -> round(k*255)
_OUT_KIND = {torch.uint8: 0, torch.float32: 1}
_ROW_ALIGN = 128  # K^T rows pad to this multiple with exact zeros
_MATMUL_ROWS = 128  # K8's row tile: two m64 tiles of one warpgroup
_MATMUL_BJ = 64  # K8's j stage
_MATMUL_FLD = 12  # floats a packed K8 feature row
_MATMUL_WIDTHS = (8, 16, 32, 48, 64, 96, 128)  # K8's channels a chunk
_MATMUL_MAX_SPLIT = 32  # j chunks at most
_MATMUL_RESIDENT = 3  # K8 blocks an SM holds at W <= 64
_LOG2_SCALE = (0.5 / math.log(2.0)) ** 0.5  # exp(-d2 / 2) = 2^-(s^2 d2)


def kernel_matmul_plain(features: torch.Tensor, values: torch.Tensor,
                        features_j=None) -> torch.Tensor:
    """Plain version of K8: explicit f32 differences, 256 i-rows at a time
    to bound the [rows, M, F] intermediate (the full f32 kernel is 5.4 GB
    at N = M = 36864); k and v rounded to bf16, f32 products. ``values`` is
    [M, C] or [M, G, A] (C = G * A channels)."""
    rows = 256
    fi = features.float()
    fj = fi if features_j is None else features_j.float()
    v = values.flatten(1).to(torch.bfloat16).float()
    out = torch.empty((fi.shape[0], v.shape[1]), dtype=torch.float32,
                      device=fi.device)
    for lo in range(0, fi.shape[0], rows):
        d = fi[lo:lo + rows, None, :] - fj[None, :, :]
        k = torch.exp(-0.5 * (d * d).sum(-1)).to(torch.bfloat16).float()
        out[lo:lo + rows] = k @ v
    return out


def pack_features(features: torch.Tensor) -> torch.Tensor:
    """K8's feature operand [rows, 12] f32: each row scaled so that
    k = 2^-||f_i - f_j||^2 in columns 0..F-1, zeros beyond (12 floats a
    row keep the kernel's shared-memory reads free of bank conflicts)."""
    return torch.nn.functional.pad(features.float() * _LOG2_SCALE,
                                   (0, _MATMUL_FLD - features.shape[1]))


def kernel_matmul_exponent(features: torch.Tensor, features_j=None
                           ) -> torch.Tensor:
    """log2 k [N, M] f32 as K8 computes it: explicit f32 differences of the
    packed features, squared and summed by one FMA a feature in order,
    negated (each FMA emulated by a float64 product and sum rounded to f32
    once). For the F1 test."""
    fi = pack_features(features)
    fj = fi if features_j is None else pack_features(features_j)
    d2 = torch.zeros((fi.shape[0], fj.shape[0]), dtype=torch.float32,
                     device=fi.device)
    for d in range(features.shape[1]):
        e = fi[:, d, None] - fj[None, :, d]
        d2 = (e.double() * e.double() + d2).float()
    return -d2


@functools.lru_cache(maxsize=None)
def matmul_plan(n: int, m: int, c: int, sms: int):
    """K8's launch shape for N rows, M columns and C channels on ``sms``
    SMs -> (width, chunks, split): C in ``chunks`` equal chunks of at
    most 128 channels, each ``width`` wide (wgmma's n), and j in ``split``
    chunks. A work unit is one 128-row tile of one channel chunk over one
    j chunk; ``split`` minimises the most units an SM runs, counted as at
    least ``_MATMUL_RESIDENT`` (fewer leave its issue slots idle), times
    the 64-column stages of a unit, plus, when split > 1, the cost of the
    partial sums in stages: 2 a unit and 3/4 for each partial the last
    unit adds (fitted to forced splits on the H100, PERF.md); the
    smallest on a tie."""
    chunks = -(-c // 128)
    width = next(w for w in _MATMUL_WIDTHS if w * chunks >= c)
    tiles = -(-n // _MATMUL_ROWS) * chunks
    stages = max(1, -(-m // _MATMUL_BJ))

    def cost(split):
        per_sm = max(-(-tiles * split // sms), _MATMUL_RESIDENT)
        partials = 2 + 0.75 * split if split > 1 else 0
        return per_sm * (-(-stages // split) + partials)

    split = min(range(1, min(stages, _MATMUL_MAX_SPLIT) + 1), key=cost)
    return width, chunks, split


class MatmulBufs(NamedTuple):
    """K8's buffers and launch shape for one channel count and M: v^T
    [C, M rounded up to 8] bf16, the workspace of f32 partials, one
    counter a row tile and channel chunk (0 between launches), wgmma's n
    and the j split."""
    vt: torch.Tensor
    ws: torch.Tensor
    counters: torch.Tensor
    width: int
    split: int


def matmul_bufs(n: int, m: int, c: int, device, width: int, split: int,
                rows: int = _MATMUL_ROWS) -> MatmulBufs:
    """K8's buffers for N rows, M columns and C channels at ``width`` and
    ``split``, in row tiles of ``rows`` (the kernel's)."""
    tiles = -(-n // rows) * -(-c // width)
    ws_floats = tiles * rows * width * split if split > 1 else 0
    return MatmulBufs(
        torch.empty((c, -(-m // 8) * 8), dtype=torch.bfloat16, device=device),
        torch.empty(ws_floats, dtype=torch.float32, device=device),
        torch.zeros(tiles, dtype=torch.int32, device=device), width, split)


def launch_matmul(fn, fi: torch.Tensor, fj: torch.Tensor, f: int,
                  values: torch.Tensor, stream: int, bufs=None):
    """One call of K8's C entry ``fn`` on packed features (``fi`` [N, 12],
    ``fj`` [M, 12]) and ``values`` [M, C] or [M, G, A] (C = G * A; any
    strides), copied into v^T in bf16 by one copy. ``bufs``: a
    ``MatmulBufs`` for this C and M whose counters are 0 (each launch
    leaves them so); without it, made at ``matmul_plan``'s shape.
    Returns (return code, out [N, C] f32, bufs)."""
    n, m = fi.shape[0], fj.shape[0]
    c = math.prod(values.shape[1:])
    if bufs is None:
        sms = torch.cuda.get_device_properties(fi.device).multi_processor_count
        width, _, split = matmul_plan(n, m, c, sms)
        bufs = matmul_bufs(n, m, c, fi.device, width, split)
    bufs.vt[:, :m].unflatten(0, values.shape[1:]).copy_(
        values.movedim(0, -1))
    out = torch.empty((n, c), dtype=torch.float32, device=fi.device)
    rc = fn(fi.data_ptr(), fj.data_ptr(), bufs.vt.data_ptr(), out.data_ptr(),
            bufs.ws.data_ptr(), bufs.counters.data_ptr(), n, m,
            bufs.vt.shape[1], f, c, bufs.width, bufs.split, bufs.ws.numel(),
            bufs.counters.numel(), stream)
    return rc, out, bufs


def kernel_matmul_fn(features: torch.Tensor, features_j=None):
    """values [M, C] -> ``gaussian_kernel_matmul(features, values,
    features_j)``, with the features checked and, on the card, packed
    once (the CRF makes one per image and calls it once per message).
    values may also be [M, G, A], G groups of A channels with any strides
    (the CRF's distinct state rows of each variant): the result is [N,
    G * A], the channels in that order, and the gather rides in the copy
    into v^T."""
    fj_src = features if features_j is None else features_j
    f, m = features.shape[1], fj_src.shape[0]
    if fj_src.shape[1] != f or not 1 <= f <= 8:
        raise ValueError(
            f"gaussian_kernel_matmul: features {tuple(features.shape)}, "
            f"features_j {tuple(fj_src.shape)} do not fit ([N, F<=8], "
            "[M, F])")
    if not (features.is_floating_point() and fj_src.is_floating_point()):
        raise TypeError("gaussian_kernel_matmul: features must be floating "
                        "point")
    if fj_src.device != features.device:
        raise ValueError("gaussian_kernel_matmul: inputs on different "
                         "devices")

    def check_values(values):
        if values.shape[0] != m or values.ndim not in (2, 3):
            raise ValueError(f"gaussian_kernel_matmul: values "
                             f"{tuple(values.shape)}, want [{m}, C] or "
                             f"[{m}, G, A]")
        if not values.is_floating_point():
            raise TypeError("gaussian_kernel_matmul: values must be floating "
                            "point")
        if values.device != features.device:
            raise ValueError("gaussian_kernel_matmul: inputs on different "
                             "devices")

    if features.device.type == "cpu":
        def plain(values):
            check_values(values)
            return kernel_matmul_plain(features, values, features_j)
        return plain

    n = features.shape[0]
    if n == 0 or m == 0:
        def empty(values):  # nothing to sum: no launch
            check_values(values)
            return torch.zeros((n, math.prod(values.shape[1:])),
                               dtype=torch.float32, device=features.device)
        return empty

    fj = pack_features(fj_src)
    fi = fj if features_j is None else pack_features(features)
    _build.require_cuda("gaussian_kernel_matmul", fi=fi, fj=fj)
    f_kernel = 5 if f <= 5 else 8
    # MatmulBufs by channel count, made at the first launch and kept on
    # the returned function as ``bufs`` (the launch shape that ran).
    # Rewriting v^T is safe: the copy and the launches that read it are
    # ordered on the current stream, and each launch leaves its counters 0.
    bufs = {}

    def launch(values):
        check_values(values)
        lib = _build.library("crf_matmul")
        c = math.prod(values.shape[1:])
        rc, out, bufs[c] = launch_matmul(
            lib.gaussian_kernel_matmul, fi, fj, f_kernel, values,
            _build.stream_ptr(fi), bufs.get(c))
        _build.check(lib, rc, "gaussian_kernel_matmul")
        _build.LAUNCHES["gaussian_kernel_matmul"] += 1
        return out

    launch.bufs = bufs
    return launch


def gaussian_kernel_matmul(
    features: torch.Tensor,  # [N, F], F <= 8
    values: torch.Tensor,  # [M, C]; any strides (e.g. a transposed view)
    features_j=None,  # [M, F] j-side support; None = ``features``
) -> torch.Tensor:
    """m_i = sum_j exp(-||f_i - f_j||^2 / 2) v_j, self included -> [N, C]
    float32 (the JAX entry's signature and layout). The exponent is f32;
    k and v are rounded to bf16 for the product, which accumulates in f32.
    """
    return kernel_matmul_fn(features, features_j)(values)


def _quantize(k: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    if out_dtype == torch.uint8:
        # torch.round is round-half-to-even, as jnp.round.
        return torch.round(k * KT_QUANT_SCALE).to(torch.uint8)
    return k.to(out_dtype)


def materialize_plain(fj: torch.Tensor, fi: torch.Tensor, m_pad: int,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K5: explicit differences in f32, 256 rows at a
    time to bound the [rows, N, 5] intermediate."""
    m, n = fj.shape[0], fi.shape[0]
    out = torch.zeros((m_pad, n), dtype=out_dtype, device=fi.device)
    for lo in range(0, m, 256):
        hi = min(lo + 256, m)
        d = fj[lo:hi, None, :] - fi[None, :, :]
        out[lo:hi] = _quantize(torch.exp(-0.5 * (d * d).sum(-1)), out_dtype)
    return out


def gaussian_kernel_materialize(
    features_j: torch.Tensor,  # [M, 5] anchor features (rows)
    features: torch.Tensor,  # [N, 5] pixel features (columns)
    *,
    out_dtype: torch.dtype = torch.uint8,
) -> torch.Tensor:
    """K^T[m, n] = exp(-||f_j[m] - f_i[n]||^2 / 2) -> [M_pad, N].

    M_pad rounds M up to a multiple of 128 and the pad rows are exactly 0
    (the JAX entry's ``keep_padded_rows=True`` layout), so the fused
    iteration reads all M_pad rows without a slice. uint8 storage holds
    round(k * 255); float32 keeps k itself."""
    fj = features_j.float().contiguous()
    fi = features.float().contiguous()
    m, f = fj.shape
    n = fi.shape[0]
    m_pad = -(-m // _ROW_ALIGN) * _ROW_ALIGN
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"out_dtype {out_dtype} not in {list(_OUT_KIND)}")
    if fi.device.type == "cpu":
        return materialize_plain(fj, fi, m_pad, out_dtype)
    out = torch.empty((m_pad, n), dtype=out_dtype, device=fi.device)
    _build.require_cuda("gaussian_kernel_materialize", fj=fj, fi=fi, out=out)
    if f != 5 or fi.shape[1] != 5:
        raise ValueError("gaussian_kernel_materialize: features must be "
                         f"[*, 5], got {tuple(fj.shape)}, {tuple(fi.shape)}")
    lib = _build.library("crf_materialize")
    rc = lib.gaussian_kernel_materialize(
        fj.data_ptr(), fi.data_ptr(), out.data_ptr(), m, m_pad, n, f,
        _OUT_KIND[out_dtype], _build.stream_ptr(fi))
    _build.check(lib, rc, "gaussian_kernel_materialize")
    _build.LAUNCHES["gaussian_kernel_materialize"] += 1
    return out


def crf_iteration_plain(qsub, kt, u_neg, msp, nb, *, v: int, c: int,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K6, same rounding steps: f32 product of the raw
    stored kernel codes, ``(nb*y + msp) + u``, f32 softmax per variant
    block, pad rows 0, one rounding to ``out_dtype``."""
    y = torch.matmul(qsub.float(), kt.float())
    e = nb[0:1].float() * y + msp.float() + u_neg.float()
    out = torch.zeros_like(e)
    for vi in range(v):
        blk = e[vi * c:(vi + 1) * c]
        p = torch.exp(blk - blk.amax(dim=0, keepdim=True))
        out[vi * c:(vi + 1) * c] = p / p.sum(dim=0, keepdim=True)
    return out.to(out_dtype)


def crf_fused_iteration(
    qsub: torch.Tensor,  # [R, M_pad] norm_j-scaled strided state, bf16
    #                      (f32 on the CPU)
    kt: torch.Tensor,  # [M_pad, N] uint8 K^T from gaussian_kernel_materialize
    u_neg: torch.Tensor,  # [R, N] bf16 minus-unary, pad rows 0
    msp: torch.Tensor,  # [R, N] bf16 spatial message (pos_w applied)
    nb: torch.Tensor,  # [k, N] f32 bi_w/255 * norm_bi; row 0 is read
    *,
    v: int,
    c: int,
) -> torch.Tensor:
    """One fused mean-field iteration -> next state [R, N] bf16 with rows
    >= v*c exactly 0. Caller guarantees: R a multiple of 16 (at most 64 on
    the card), v*c <= R, pad columns of qsub and pad rows of kt zero,
    N a multiple of 128."""
    if qsub.device.type == "cpu":
        return crf_iteration_plain(qsub, kt, u_neg, msp, nb, v=v, c=c,
                                   out_dtype=torch.bfloat16)
    r, m = qsub.shape
    n = kt.shape[1]
    out = torch.empty((r, n), dtype=torch.bfloat16, device=qsub.device)
    _build.require_cuda("crf_fused_iteration", qsub=qsub, kt=kt, u_neg=u_neg,
                        msp=msp, nb=nb, out=out)
    want = {"qsub": (qsub, torch.bfloat16, (r, m)),
            "kt": (kt, torch.uint8, (m, n)),
            "u_neg": (u_neg, torch.bfloat16, (r, n)),
            "msp": (msp, torch.bfloat16, (r, n)),
            "nb": (nb, torch.float32, (nb.shape[0], n))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"crf_fused_iteration: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if r % 16 or r > 64 or m % 32 or n % 128 or v not in (1, 2) or v * c > r:
        raise ValueError(f"crf_fused_iteration: unsupported R={r} M={m} "
                         f"N={n} v={v} c={c}")
    lib = _build.library("crf_iteration")
    rc = lib.crf_fused_iteration(
        qsub.data_ptr(), kt.data_ptr(), u_neg.data_ptr(), msp.data_ptr(),
        nb.data_ptr(), out.data_ptr(), r, m, n, v, c,
        _build.stream_ptr(qsub))
    _build.check(lib, rc, "crf_fused_iteration")
    _build.LAUNCHES["crf_fused_iteration"] += 1
    return out
