"""CRF bilateral kernels K8, K5 and K6 (counterparts of
``pnp_ovss_tpu/ops/bilateral_pallas.py``).

- ``gaussian_kernel_matmul`` (K8, ``csrc/crf_matmul.cu``) computes the
  bilateral message ``sum_j exp(-||f_i - f_j||^2 / 2) v_j`` without
  materialising the kernel: the exact, unmaterialised and Nystrom CRFs.
  Where the j side is the i side itself (no ``features_j``) and C <= 16,
  it runs the symmetric schedule (``symmetric_plan``): each exponent once
  for both k_ij and k_ji.
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
from pnp_ovss_tpu_torch.utils.tracing import TRACER

KT_QUANT_SCALE = 255.0  # uint8 kernel storage: k in [0, 1] -> round(k*255)
_OUT_KIND = {torch.uint8: 0, torch.float32: 1}
_ROW_ALIGN = 128  # K^T rows pad to this multiple with exact zeros
_MATMUL_ROWS = 128  # K8's row tile: two m64 tiles of one warpgroup
_MATMUL_BJ = 64  # K8's j stage
_MATMUL_FLD = 12  # floats a packed K8 feature row
_MATMUL_WIDTHS = (8, 16, 32, 48, 64, 96, 128)  # K8's channels a chunk
_MATMUL_MAX_SPLIT = 32  # j chunks at most
_MATMUL_RESIDENT = 3  # K8 blocks an SM holds at W <= 64
_SYM_WIDTHS = (8, 16)  # K8's widths on the symmetric schedule
_SYM_MAX_TILES = 8  # row tiles a symmetric block side at most
# The symmetric plan's costs in stages an SM (fitted to block sides 2-8
# on the H100 at N = 36864, PERF.md): a unit's fixed cost, a block's
# partials a channel, and the share of an SM's issue rate that 1, 2 or 3
# resident blocks reach.
_SYM_UNIT_COST = 1.35
_SYM_PARTIAL_COST = 0.25
_SYM_RATE = {1: 0.55, 2: 0.85, 3: 1.0}
_SM_SMEM = 233472  # shared memory an H100 SM gives its blocks, bytes
_BLOCK_SMEM_RESERVED = 1024  # the runtime's own a block, bytes
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


class SymmetricPlan(NamedTuple):
    """K8's launch shape on the symmetric schedule: wgmma's n, row tiles a
    block side, blocks along N, units (block pairs P <= Q, one launch
    block each; one reduction block a row tile follows them), the
    workspace's f32 partials (one a pixel, channel and block) and units an
    SM."""
    width: int
    unit_tiles: int
    blocks: int
    units: int
    ws_floats: int
    units_per_sm: float


def symmetric_width(c: int):
    """wgmma's n of the symmetric schedule for C channels, or None where
    it does not run (C > 16: a unit's J-side sums outgrow shared memory,
    and smaller units would spend more on partials than the exponents
    save)."""
    return next((w for w in _SYM_WIDTHS if w >= c), None)


def symmetric_smem_bytes(width: int, unit_tiles: int) -> int:
    """Shared memory of a symmetric K8 block (``csrc/crf_matmul.cu``'s
    sym_smem_bytes): a ring of 4 stages (3 at n = 16) of v^T and column
    features, the K^T tile, two v_rt^T buffers and the J-side sums of 2R
    stages, or the reduction's 64 KB if larger; barriers and 1 KB of
    alignment room."""
    stages = 4 if width <= 8 else 3
    main = (stages * (width * _MATMUL_BJ * 2 + _MATMUL_BJ * _MATMUL_FLD * 4)
            + 2 * 64 * _MATMUL_BJ * 2 + 4 * width * _MATMUL_BJ * 2
            + 2 * unit_tiles * _MATMUL_BJ * width * 4)
    return max(main, 4 * 8 * 16 * _MATMUL_ROWS) + (stages + 2) * 8 + 1024


@functools.lru_cache(maxsize=None)
def symmetric_plan(n: int, c: int, sms: int):
    """K8's symmetric launch shape for K v with both sides the same N
    pixels and C channels on ``sms`` SMs -> ``SymmetricPlan``, or None
    where C > 16. The pixels form blocks of R row tiles; R (1-8)
    minimises the stages an SM runs: whole waves of units, each SM holding
    as many blocks as fit its shared memory (at most 3; the J-side sums
    grow with R), a unit of 2R^2 stages, plus ``_SYM_UNIT_COST`` stages a
    unit and ``_SYM_PARTIAL_COST`` a block and channel of partials, over
    the issue rate the resident blocks reach; the largest R within 1% of
    the least, whose partials, N * blocks * width floats, are fewest."""
    width = symmetric_width(c)
    if width is None or n < 1:
        return None
    row_tiles = -(-n // _MATMUL_ROWS)

    def shape(r):
        blocks = -(-row_tiles // r)
        return blocks, blocks * (blocks + 1) // 2

    def cost(r):
        blocks, units = shape(r)
        resident = min(_MATMUL_RESIDENT, _SM_SMEM // (
            symmetric_smem_bytes(width, r) + _BLOCK_SMEM_RESERVED))
        waves = -(-units // (sms * resident))
        return (waves * resident * 2 * r * r + _SYM_UNIT_COST * units / sms
                + _SYM_PARTIAL_COST * blocks * width) / _SYM_RATE[resident]

    # The largest R within 1% of the least cost: fewer partials.
    least = min(cost(r) for r in range(1, _SYM_MAX_TILES + 1))
    r = next(r for r in range(_SYM_MAX_TILES, 0, -1)
             if cost(r) <= 1.01 * least)
    blocks, units = shape(r)
    return SymmetricPlan(width, r, blocks, units,
                         row_tiles * blocks * _MATMUL_ROWS * width,
                         units / sms)


def symmetric_schedule(n: int, unit_tiles: int):
    """The symmetric launch's work in the kernel's order: (P, Q, row tile,
    stage, both) for each 128-row tile x 64-column stage whose exponents
    it computes, unit (P, Q) by unit, P <= Q. ``both``: the tile also
    feeds the transposed product (out_stage += K^T v_rowtile); without it
    (the 128-pixel diagonal tiles) only out_rowtile += K v_stage."""
    row_tiles, stages = -(-n // _MATMUL_ROWS), -(-n // _MATMUL_BJ)
    blocks = -(-row_tiles // unit_tiles)
    for p in range(blocks):
        for q in range(p, blocks):
            st0 = 2 * q * unit_tiles
            st1 = min(st0 + 2 * unit_tiles, stages)
            for rt in range(p * unit_tiles,
                            min((p + 1) * unit_tiles, row_tiles)):
                for s in range(2 * rt if p == q else st0, st1):
                    yield p, q, rt, s, s >= 2 * rt + 2


class MatmulBufs(NamedTuple):
    """K8's buffers and launch shape for one channel count and M: v^T
    [C, M rounded up to 8] bf16, the workspace of f32 partials, one
    counter a row tile and channel chunk (two a block, on the symmetric
    schedule; 0 between launches), wgmma's n, the j split and, on the
    symmetric schedule, its row tiles a block side (0: the general
    schedule)."""
    vt: torch.Tensor
    ws: torch.Tensor
    counters: torch.Tensor
    width: int
    split: int
    unit_tiles: int = 0


def matmul_bufs(n: int, m: int, c: int, device, width: int, split: int,
                rows: int = _MATMUL_ROWS) -> MatmulBufs:
    """K8's buffers for N rows, M columns and C channels at ``width`` and
    ``split``, in row tiles of ``rows`` (the kernel's)."""
    tiles = -(-n // rows) * -(-c // width)
    ws_floats = tiles * rows * width * split if split > 1 else 0
    return MatmulBufs(_vt_buffer(m, c, device),
                      torch.empty(ws_floats, dtype=torch.float32,
                                  device=device),
                      torch.zeros(tiles, dtype=torch.int32, device=device),
                      width, split)


def symmetric_bufs(n: int, c: int, device, plan: SymmetricPlan,
                   ws=None) -> MatmulBufs:
    """K8's buffers on the symmetric schedule of ``plan``, for N pixels
    and C channels; ``ws``, a workspace to share, where it is large
    enough."""
    if ws is None or ws.numel() < plan.ws_floats:
        ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=device)
    return MatmulBufs(_vt_buffer(n, c, device), ws,
                      torch.zeros(2 * plan.blocks, dtype=torch.int32,
                                  device=device),
                      plan.width, 1, plan.unit_tiles)


def _vt_buffer(m: int, c: int, device) -> torch.Tensor:
    return torch.empty((c, -(-m // 8) * 8), dtype=torch.bfloat16,
                       device=device)


def _fill_vt(vt: torch.Tensor, values: torch.Tensor) -> None:
    """values [M, C] or [M, G, A] (any strides) into v^T [C, >= M] bf16,
    one copy."""
    vt[:, :values.shape[0]].unflatten(0, values.shape[1:]).copy_(
        values.movedim(0, -1))


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
    _fill_vt(bufs.vt, values)
    out = torch.empty((n, c), dtype=torch.float32, device=fi.device)
    rc = fn(fi.data_ptr(), fj.data_ptr(), bufs.vt.data_ptr(), out.data_ptr(),
            bufs.ws.data_ptr(), bufs.counters.data_ptr(), n, m,
            bufs.vt.shape[1], f, c, bufs.width, bufs.split, bufs.ws.numel(),
            bufs.counters.numel(), stream)
    return rc, out, bufs


def launch_matmul_symmetric(fn, fp: torch.Tensor, f: int,
                            values: torch.Tensor, stream: int,
                            bufs: MatmulBufs):
    """One call of K8's symmetric C entry ``fn`` on packed features ``fp``
    [N, 12] (both sides) and ``values`` [N, C] or [N, G, A], with
    ``bufs`` from ``symmetric_bufs`` whose counters are 0. Returns (return
    code, out [N, C] f32)."""
    n, c = fp.shape[0], math.prod(values.shape[1:])
    _fill_vt(bufs.vt, values)
    out = torch.empty((n, c), dtype=torch.float32, device=fp.device)
    rc = fn(fp.data_ptr(), bufs.vt.data_ptr(), out.data_ptr(),
            bufs.ws.data_ptr(), bufs.counters.data_ptr(), n,
            bufs.vt.shape[1], f, c, bufs.width, bufs.unit_tiles,
            bufs.ws.numel(), bufs.counters.numel(), stream)
    return rc, out


def kernel_matmul_fn(features: torch.Tensor, features_j=None):
    """values [M, C] -> ``gaussian_kernel_matmul(features, values,
    features_j)``, with the features checked and, on the card, packed
    once (the CRF makes one per image and calls it once per message).
    values may also be [M, G, A], G groups of A channels with any strides
    (the CRF's distinct state rows of each variant): the result is [N,
    G * A], the channels in that order, and the gather rides in the copy
    into v^T.

    Without ``features_j`` (the j side is the i side: the exact CRF) a
    call with C <= 16 runs the symmetric schedule and counts
    ``crf.k8_symmetric_launches``, on the CPU too (where the plain
    version runs); passing ``features_j=features`` keeps the general
    one."""
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
            if features_j is None and symmetric_width(
                    math.prod(values.shape[1:])):
                TRACER.count("crf.k8_symmetric_launches")
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
    sms = torch.cuda.get_device_properties(fi.device).multi_processor_count

    def launch(values):
        check_values(values)
        lib = _build.library("crf_matmul")
        c = math.prod(values.shape[1:])
        plan = symmetric_plan(n, c, sms) if features_j is None else None
        stream = _build.stream_ptr(fi)
        if plan is None:
            rc, out, bufs[c] = launch_matmul(
                lib.gaussian_kernel_matmul, fi, fj, f_kernel, values, stream,
                bufs.get(c))
        else:
            if c not in bufs:
                # The closure's symmetric launches share one workspace,
                # the largest they need: they run in turn on one stream.
                sym = {k: b for k, b in bufs.items() if b.unit_tiles}
                bufs[c] = symmetric_bufs(n, c, fi.device, plan, max(
                    (b.ws for b in sym.values()), key=torch.numel,
                    default=None))
                for k, b in sym.items():
                    bufs[k] = b._replace(ws=bufs[c].ws)
            rc, out = launch_matmul_symmetric(
                lib.gaussian_kernel_matmul_symmetric, fi, f_kernel, values,
                stream, bufs[c])
            TRACER.count("crf.k8_symmetric_launches")
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
