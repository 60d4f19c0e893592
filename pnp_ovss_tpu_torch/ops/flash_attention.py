"""Flat-layout flash attention: kernel K2 (``csrc/flash_attention.cu``) and
K4, attention + output projection + residual (``csrc/flash_qkv_proj.cu``).

Counterpart of ``pnp_ovss_tpu/ops/flash_attention.py``'s ``flash_mha_flat_qkv``,
``flash_mha_flat`` and ``flash_mha_qkv_proj``. q/k/v stay in the qkv projection's own layout:
``[B, S, H*D]`` column views with heads as column slices, so no head
transposes happen around the kernel. Forward only: the GradCAM tap sits in
the BERT cross-attention, so no gradient ever reaches the ViT.

On a CUDA tensor the wrappers launch the CUDA kernel (bf16 in and out) or
raise; on a CPU tensor they run ``attention_plain``, the same math in plain
PyTorch. The TPU's tile policies (``seq_blocks`` padding, batch and head
groups) are not ported: the kernel masks the ragged tail itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from pnp_ovss_tpu_torch.ops import _build

_NEG_INF = -1e30


def flat_supported(s: int, d: int) -> bool:
    """Shapes the ViT sends through the flat kernel (the rest run the plain
    attention, as the JAX package sends them to XLA). The JAX package's
    head-count condition is a TPU lane rule and does not apply here."""
    return d in (64, 128) and s >= 128


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int, true_len: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the kernel: q/k/v [B, S, H*D] (any strides) ->
    [B, S, H*D]. q is scaled before the product, as the kernel does; keys
    at index >= true_len are masked."""
    b, s, hd = q.shape
    d = hd // num_heads

    def heads(x):
        return x.reshape(b, s, num_heads, d).permute(0, 2, 1, 3).float()

    scores = (heads(q) * (1.0 / d**0.5)) @ heads(k).transpose(-1, -2)
    if true_len < s:
        scores[..., true_len:] = _NEG_INF
    out = torch.softmax(scores, dim=-1) @ heads(v)
    return out.permute(0, 2, 1, 3).reshape(b, s, hd).to(out_dtype)


def _launch(q, k, v, *, num_heads: int, true_len: int) -> torch.Tensor:
    b, s, hd = q.shape
    d = hd // num_heads
    out = torch.empty((b, s, hd), dtype=torch.bfloat16, device=q.device)
    views = {"q": q, "k": k, "v": v, "out": out}
    if len({t.device for t in views.values()}) != 1:
        raise ValueError("flash_mha_flat: q/k/v on different devices")
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_flat: needs a CUDA tensor, got {q.device}")
    for name, t in views.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_mha_flat: {name} must be bfloat16, "
                            f"got {t.dtype}")
        if t.shape != (b, s, hd):
            raise ValueError(f"flash_mha_flat: {name} shape {tuple(t.shape)}"
                             f" != {(b, s, hd)}")
        if (t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8
                or t.data_ptr() % 16):
            raise ValueError(f"flash_mha_flat: {name} needs unit column "
                             "stride and 16-byte aligned rows")
    if d not in (64, 128) or hd != num_heads * d:
        raise ValueError(f"flash_mha_flat: head dim {d} not in (64, 128)")
    lib = _build.library("flash_attention")
    rc = lib.flash_mha_flat_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        b, s, true_len, num_heads, d, 1.0 / d**0.5, _build.stream_ptr(q))
    _build.check(lib, rc, "flash_mha_flat")
    _build.LAUNCHES["flash_mha_flat_qkv"] += 1
    return out


def flash_mha_flat(q2: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor, *,
                   num_heads: int, out_dtype: Optional[torch.dtype] = None,
                   true_len: Optional[int] = None) -> torch.Tensor:
    """Attention on flat [B, S, H*D] q/k/v (three arrays or views) ->
    [B, S, H*D]. ``true_len`` masks keys at or beyond it when the caller
    carries padded rows; rows beyond it are garbage by contract."""
    out_dtype = out_dtype or q2.dtype
    s = q2.shape[1]
    tl = s if true_len is None else true_len
    if not 0 < tl <= s:
        raise ValueError(f"true_len {tl} outside (0, {s}]")
    if q2.device.type == "cpu":
        return attention_plain(q2, k2, v2, num_heads=num_heads, true_len=tl,
                               out_dtype=out_dtype)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel writes bfloat16, not {out_dtype}")
    return _launch(q2, k2, v2, num_heads=num_heads, true_len=tl)


def flash_mha_flat_qkv(qkv3: torch.Tensor, *, num_heads: int,
                       out_dtype: Optional[torch.dtype] = None,
                       true_len: Optional[int] = None) -> torch.Tensor:
    """Attention straight on the qkv projection output ``[B, S, 3*H*D]``
    ([q | k | v] on the channel axis): the kernel reads q/k/v as strided
    column views of the one array, so no slice is copied."""
    hd = qkv3.shape[-1] // 3
    return flash_mha_flat(qkv3[..., :hd], qkv3[..., hd:2 * hd],
                          qkv3[..., 2 * hd:], num_heads=num_heads,
                          out_dtype=out_dtype, true_len=true_len)


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
    """x + attention(qkv) @ proj_w^T + proj_b in one kernel.

    ``qkv3`` [B, S, 3*H*D] ([q | k | v] on the channel axis), ``x``
    [B, S, Dm] the residual stream, ``proj_w`` [Dm, H*D] (``nn.Linear``
    layout), ``proj_b`` [Dm]. Keys at or beyond ``true_len`` are masked.
    Returns [B, S, Dm] in x's dtype: the attention output never reaches
    device memory on the card."""
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
    lib = _build.library("flash_qkv_proj")
    rc = lib.flash_mha_qkv_proj_bf16(
        qkv3.data_ptr(), x.data_ptr(), proj_w.data_ptr(), proj_b.data_ptr(),
        out.data_ptr(), b, s, tl, num_heads, d, dm, 1.0 / d**0.5,
        _build.stream_ptr(x))
    _build.check(lib, rc, "flash_mha_qkv_proj")
    _build.LAUNCHES["flash_mha_qkv_proj"] += 1
    return out
