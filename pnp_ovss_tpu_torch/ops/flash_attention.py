"""Flash attention: kernels K2, K7 and K9 (one kernel on strided views,
``csrc/flash_kernel.cuh`` through ``csrc/flash_attention.cu``) and K4,
attention + output projection + residual (``csrc/flash_qkv_proj.cu``: the
same flash kernel, then the wgmma GEMM of ``csrc/wgmma_gemm.cuh``).

Counterpart of ``pnp_ovss_tpu/ops/flash_attention.py``'s ``flash_mha_flat_qkv``,
``flash_mha_flat``, ``flash_mha_flat_xlen``, ``flash_mha`` and
``flash_mha_qkv_proj``. In the flat entries q/k/v stay in the qkv
projection's own layout: ``[B, S, H*D]`` column views with heads as column
slices, so no head transposes happen around the kernel; ``flash_mha``
reads ``[B, H, S, D]`` through its strides. Forward only: the GradCAM tap
sits in the BERT cross-attention, so no gradient ever reaches the ViT.

On a CUDA tensor the wrappers launch the CUDA kernel (bf16 in and out) or
raise; on a CPU tensor they run the plain version, the same math in plain
PyTorch. The TPU's tile policies (``seq_blocks`` padding, the 16-row and
256-row q padding, batch and head groups) are not ported: the kernel masks
the ragged tail itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from pnp_ovss_tpu_torch.ops import _build

_NEG_INF = -1e30


def flat_supported(s: int, h: int, d: int) -> bool:
    """Shapes the ViT sends through the flat kernel K2 (the rest go to
    ``ops.attention.mha``), the JAX package's rule: heads in pairs, as its
    TPU kernel takes them, although the port's kernel takes any head
    count."""
    return d in (64, 128) and s >= 128 and h % 2 == 0


def xlen_supported(sq: int, skv: int, h: int, d: int) -> bool:
    """Shapes the sequence-parallel attention sends through K7: ``sq`` the
    local query chunk, ``skv`` the gathered key count. The JAX package's
    rule without its head-pair lane rule: the kernel takes any head count
    (``h`` is kept for the JAX signature)."""
    del h
    return d in (64, 128) and skv >= 128 and sq >= 16


def supported(q: torch.Tensor) -> bool:
    """Shapes ``ops.attention.mha(impl="flash")`` sends through K9."""
    *_, s, d = q.shape
    return d in (64, 128) and s >= 128


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int, true_len: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K2 and K7: q [B, Sq, H*D], k/v [B, Skv, H*D] (any
    strides) -> [B, Sq, H*D]. q is scaled before the product, as the
    kernel does; keys at index >= true_len are masked."""
    b, sq, hd = q.shape
    skv = k.shape[1]
    d = hd // num_heads

    def heads(x):
        return x.reshape(b, x.shape[1], num_heads, d).permute(0, 2, 1, 3) \
            .float()

    scores = (heads(q) * (1.0 / d**0.5)) @ heads(k).transpose(-1, -2)
    if true_len < skv:
        scores[..., true_len:] = _NEG_INF
    out = torch.softmax(scores, dim=-1) @ heads(v)
    return out.permute(0, 2, 1, 3).reshape(b, sq, hd).to(out_dtype)


def _check_views(name: str, **views: torch.Tensor) -> None:
    """What the kernel reads: bf16 tensors on one CUDA device, unit stride
    in the last dim, 16-byte aligned pointers and other strides."""
    devs = {t.device for t in views.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on different devices "
                         f"{ {k: str(t.device) for k, t in views.items()} }")
    dev = next(iter(devs))
    if dev.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {dev}")
    for k, t in views.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {k} must be bfloat16, got {t.dtype}")
        if (t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: {k} needs unit column stride and "
                             "16-byte aligned rows")


def _check_head_dim(name: str, hd: int, num_heads: int) -> int:
    d = hd // num_heads
    if d not in (64, 128) or hd != num_heads * d:
        raise ValueError(f"{name}: head dim {hd} / {num_heads} heads not in "
                         "(64, 128)")
    return d


def _flat_strides(*views: torch.Tensor):
    return [st for t in views for st in (t.stride(0), t.stride(1))]


def _bf16_out(out_dtype: torch.dtype) -> None:
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel writes bfloat16, not {out_dtype}")


def flash_mha_flat(q2: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor, *,
                   num_heads: int, out_dtype: Optional[torch.dtype] = None,
                   true_len: Optional[int] = None) -> torch.Tensor:
    """Attention on flat [B, S, H*D] q/k/v (three arrays or views) ->
    [B, S, H*D] (K2', the entry tensor parallelism takes on this rank's
    heads; counted as ``flash_mha_flat``). ``true_len`` masks keys at or
    beyond it when the caller carries padded rows; rows beyond it are
    garbage by contract."""
    return _flat(q2, k2, v2, num_heads=num_heads, out_dtype=out_dtype,
                 true_len=true_len, counter="flash_mha_flat")


def _flat(q2, k2, v2, *, num_heads, out_dtype, true_len, counter):
    out_dtype = out_dtype or q2.dtype
    b, s, hd = q2.shape
    tl = s if true_len is None else true_len
    if not 0 < tl <= s:
        raise ValueError(f"true_len {tl} outside (0, {s}]")
    if q2.device.type == "cpu":
        return attention_plain(q2, k2, v2, num_heads=num_heads, true_len=tl,
                               out_dtype=out_dtype)
    _bf16_out(out_dtype)
    out = torch.empty((b, s, hd), dtype=torch.bfloat16, device=q2.device)
    views = dict(q=q2, k=k2, v=v2, out=out)
    _check_views("flash_mha_flat", **views)
    for name, t in views.items():
        if t.shape != (b, s, hd):
            raise ValueError(f"flash_mha_flat: {name} shape "
                             f"{tuple(t.shape)} != {(b, s, hd)}")
    d = _check_head_dim("flash_mha_flat", hd, num_heads)
    lib = _build.library("flash_attention")
    rc = lib.flash_mha_flat_bf16(
        q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), out.data_ptr(),
        *_flat_strides(q2, k2, v2, out), b, s, tl, num_heads, d,
        1.0 / d**0.5, _build.stream_ptr(q2))
    _build.check(lib, rc, "flash_mha_flat")
    _build.LAUNCHES[counter] += 1
    return out


def flash_mha_flat_xlen(q2: torch.Tensor, k2: torch.Tensor,
                        v2: torch.Tensor, *, num_heads: int,
                        out_dtype: Optional[torch.dtype] = None,
                        true_kv_len: Optional[int] = None) -> torch.Tensor:
    """Cross-length flat attention (K7), the sequence-parallel entry: a
    local chunk of query rows q [B, Sq, H*D] over the K/V gathered from
    every rank, k/v [B, Skv, H*D] -> [B, Sq, H*D]. Keys at or beyond
    ``true_kv_len`` (padding that travels with the last chunk) are masked.
    The kernel visits the keys in K2's 64-key tiles and order, so each
    row is bit-equal to the same row of K2 over the whole sequence."""
    out_dtype = out_dtype or q2.dtype
    b, sq, hd = q2.shape
    skv = k2.shape[1]
    tl = skv if true_kv_len is None else true_kv_len
    if not 0 < tl <= skv:
        raise ValueError(f"true_kv_len {tl} outside (0, {skv}]")
    if k2.shape != (b, skv, hd) or v2.shape != (b, skv, hd):
        raise ValueError(f"flash_mha_flat_xlen: k {tuple(k2.shape)} / v "
                         f"{tuple(v2.shape)} do not match q "
                         f"{tuple(q2.shape)}")
    if q2.device.type == "cpu":
        return attention_plain(q2, k2, v2, num_heads=num_heads, true_len=tl,
                               out_dtype=out_dtype)
    _bf16_out(out_dtype)
    out = torch.empty((b, sq, hd), dtype=torch.bfloat16, device=q2.device)
    _check_views("flash_mha_flat_xlen", q=q2, k=k2, v=v2, out=out)
    d = _check_head_dim("flash_mha_flat_xlen", hd, num_heads)
    lib = _build.library("flash_attention")
    rc = lib.flash_mha_xlen_bf16(
        q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), out.data_ptr(),
        *_flat_strides(q2, k2, v2, out), b, sq, skv, tl, num_heads, d,
        1.0 / d**0.5, _build.stream_ptr(q2))
    _build.check(lib, rc, "flash_mha_flat_xlen")
    _build.LAUNCHES["flash_mha_flat_xlen"] += 1
    return out


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Flash self-attention (K9) on q/k/v [B, H, S, D] (any strides with a
    unit last one; no mask) -> [B, H, S, D] in ``out_dtype`` (q's dtype by
    default). On the CPU it runs ``ops.attention.mha_plain``. The CUDA
    kernel takes bf16 only and raises on f32, which the JAX kernel also
    takes: no caller of the port passes f32 on the card (the ViT computes
    in bf16)."""
    out_dtype = out_dtype or q.dtype
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_mha: q/k/v shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}; want one "
                         "[B, H, S, D]")
    if q.device.type == "cpu":
        # attention.py imports this module; the plain math lives there.
        from pnp_ovss_tpu_torch.ops.attention import mha_plain

        return mha_plain(q, k, v, out_dtype=out_dtype)
    _bf16_out(out_dtype)
    b, h, s, d = q.shape
    out = torch.empty((b, h, s, d), dtype=torch.bfloat16, device=q.device)
    _check_views("flash_mha", q=q, k=k, v=v, out=out)
    _check_head_dim("flash_mha", d, 1)
    lib = _build.library("flash_attention")
    rc = lib.flash_mha_bhsd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *[st for t in (q, k, v, out) for st in t.stride()[:3]],
        b, h, s, d, 1.0 / d**0.5, _build.stream_ptr(q))
    _build.check(lib, rc, "flash_mha")
    _build.LAUNCHES["flash_mha"] += 1
    return out


def flash_mha_flat_qkv(qkv3: torch.Tensor, *, num_heads: int,
                       out_dtype: Optional[torch.dtype] = None,
                       true_len: Optional[int] = None) -> torch.Tensor:
    """Attention straight on the qkv projection output ``[B, S, 3*H*D]``
    ([q | k | v] on the channel axis): the kernel reads q/k/v as strided
    column views of the one array, so no slice is copied."""
    hd = qkv3.shape[-1] // 3
    return _flat(qkv3[..., :hd], qkv3[..., hd:2 * hd], qkv3[..., 2 * hd:],
                 num_heads=num_heads, out_dtype=out_dtype, true_len=true_len,
                 counter="flash_mha_flat_qkv")


_KEY_BLOCK = 512  # the reference's widest k-block (``_FLAT_BLOCK_K``)


def proj_fold_enabled(true_len: int) -> bool:
    """Whether the fused ViT block folds attention, proj and the residual
    into K4. This is the reference's routing (its auto rule): on iff the
    true length needs more than one 512-key block of its k-schedule
    (``seq_blocks`` rounds the length up to 16 and splits it into blocks
    of at most 512), i.e. iff ``true_len > 512`` -- the 768 px leg (2305
    tokens), not 336 px (442)."""
    return true_len > _KEY_BLOCK


def qkv_proj_plain(qkv3: torch.Tensor, x: torch.Tensor, proj_w: torch.Tensor,
                   proj_b: torch.Tensor, *, num_heads: int,
                   true_len: int) -> torch.Tensor:
    """Plain version of K4: each head's output rounded to x's dtype, the
    full H*D proj contraction in f32 rounded once, then
    ``x + (acc + proj_b)`` in x's dtype."""
    dt = x.dtype
    hd = qkv3.shape[-1] // 3
    out = attention_plain(qkv3[..., :hd], qkv3[..., hd:2 * hd],
                          qkv3[..., 2 * hd:], num_heads=num_heads,
                          true_len=true_len, out_dtype=dt)
    acc = (out.float() @ proj_w.float().T).to(dt)
    y = (acc.float() + proj_b.to(dt).float()).to(dt)
    return (x.float() + y.float()).to(dt)


def flash_mha_qkv_proj(qkv3: torch.Tensor, x: torch.Tensor,
                       proj_w: torch.Tensor, proj_b: torch.Tensor, *,
                       num_heads: int,
                       true_len: Optional[int] = None) -> torch.Tensor:
    """x + attention(qkv) @ proj_w^T + proj_b in one call.

    ``qkv3`` [B, S, 3*H*D] ([q | k | v] on the channel axis), ``x``
    [B, S, Dm] the residual stream, ``proj_w`` [Dm, H*D] (``nn.Linear``
    layout), ``proj_b`` [Dm]. Keys at or beyond ``true_len`` are masked.
    Returns [B, S, Dm] in x's dtype. On the card the call runs two
    kernels: K2's flash kernel into bf16 head outputs [B, S, H*D],
    scratch this wrapper allocates, then the wgmma GEMM with the
    ``bf16(x + bf16(bf16(acc) + proj_b))`` epilogue: the value flow of
    ``qkv_proj_plain`` and of the sequence-parallel block's
    ``x + (F.linear(out, proj_w) + proj_b)``."""
    b, s, hd3 = qkv3.shape
    hd = hd3 // 3
    tl = s if true_len is None else true_len
    if not 0 < tl <= s:
        raise ValueError(f"true_len {tl} outside (0, {s}]")
    if qkv3.device.type == "cpu":
        return qkv_proj_plain(qkv3, x, proj_w, proj_b, num_heads=num_heads,
                              true_len=tl)
    dm = x.shape[-1]
    d = hd // num_heads
    tensors = dict(qkv3=qkv3, x=x, proj_w=proj_w, proj_b=proj_b)
    _build.require_cuda("flash_mha_qkv_proj", **tensors)
    _build.require_bf16("flash_mha_qkv_proj", **tensors)
    if (x.shape != (b, s, dm) or proj_w.shape != (dm, hd)
            or proj_b.shape != (dm,)):
        raise ValueError("flash_mha_qkv_proj: x / proj shapes do not match "
                         f"qkv {tuple(qkv3.shape)}")
    if (d not in (64, 128) or hd != num_heads * d or num_heads % 2
            or hd > 1024 or dm % 128):
        raise ValueError(f"flash_mha_qkv_proj: needs head dim 64 or 128, an"
                         f" even head count, H*D <= 1024 and Dm % 128 == 0; "
                         f"got H={num_heads}, D={d}, Dm={dm}")
    out = torch.empty_like(x)
    attn = torch.empty((b, s, hd), dtype=torch.bfloat16, device=x.device)
    lib = _build.library("flash_qkv_proj")
    rc = lib.flash_mha_qkv_proj_bf16(
        qkv3.data_ptr(), x.data_ptr(), proj_w.data_ptr(), proj_b.data_ptr(),
        attn.data_ptr(), out.data_ptr(), b, s, tl, num_heads, d, dm,
        1.0 / d**0.5, _build.stream_ptr(x))
    _build.check(lib, rc, "flash_mha_qkv_proj")
    _build.LAUNCHES["flash_mha_qkv_proj"] += 1
    return out
