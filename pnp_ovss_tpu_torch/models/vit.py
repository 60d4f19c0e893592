"""ViT image encoder, BLIP's ViT-L/16 (counterpart of
``pnp_ovss_tpu/models/vit.py``).

Pre-LN blocks ``x += attn(LN(x)); x += mlp(LN(x))`` with float32 LayerNorm
(eps 1e-6) and exact-erf GELU, a conv patch embed with a prepended CLS
token and learned position embeddings, and a final LayerNorm. Images are
NHWC. Two blocks with one parameter tree:

- ``ViTBlockFused``, the JAX package's default: LN1 + qkv in kernel K1,
  then attention through K2 with the proj + residual as a plain matmul
  (one 512-key block, e.g. 336 px) or attention + proj + residual in K4
  (longer sequences, e.g. 768 px), then LN2 + MLP + residual in K3;
- ``ViTBlock``, the JAX package's unfused block (``PNP_VIT_FUSED=0``
  there): LN1 -> qkv -> attention -> proj -> LN2 -> MLP, the products
  plain matmuls, attention through K2 where the JAX package takes its flat
  kernel (heads in pairs), else ``ops.attention.mha(impl="flash")`` (K9
  for an odd head count, plain attention for small shapes). It also serves
  configurations the fused kernels do not take.

Sequence parallelism (``forward(images, sp=group)``, the JAX package's
``sp_axis``): each rank keeps a contiguous chunk of the tokens, and every
attention gathers K/V from the group's ranks and runs K7 on the local
query rows.

The JAX package pads the whole encode to its k-block schedule (a TPU tile
rule); the port carries ``[B, S, D]`` as it is (under sequence
parallelism padded to a multiple of the group size), and the kernels mask
the ragged row tail and keys >= S themselves.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from pnp_ovss_tpu_torch.config import ViTConfig
from pnp_ovss_tpu_torch.models.layers import DTYPES, LayerNorm
from pnp_ovss_tpu_torch.ops import attention as attn_ops
from pnp_ovss_tpu_torch.ops import vit_block
from pnp_ovss_tpu_torch.ops.flash_attention import (
    flash_mha_flat_qkv,
    flash_mha_flat_xlen,
    flash_mha_qkv_proj,
    flat_supported,
    proj_fold_enabled,
    xlen_supported,
)
from pnp_ovss_tpu_torch.parallel.mesh import SequenceGroup

_NEG_INF = -1e30


def fused_path_supported(cfg: ViTConfig) -> bool:
    """True iff the fused kernels take this config: the JAX package's
    shape conditions (its flat-attention rule, heads in pairs, and
    ``vit_block.supported``), without its environment switch."""
    return (flat_supported(cfg.seq_len, cfg.num_heads, cfg.head_dim)
            and vit_block.supported(
                cfg.hidden_size, 3 * cfg.hidden_size,
                mlp_hidden=int(cfg.hidden_size * cfg.mlp_ratio)))


def make_patch_conv(cfg: ViTConfig) -> nn.Conv2d:
    """The patch-embedding conv (kernel = stride = patch size)."""
    return nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                     stride=cfg.patch_size, dtype=DTYPES[cfg.dtype])


def stem_from_patches(cfg: ViTConfig, patches: torch.Tensor,
                      cls_token: torch.Tensor,
                      pos_embed: torch.Tensor) -> torch.Tensor:
    """Patch-conv output [B, g, g, D] (NHWC) -> tokens [B, 1 + g*g, D]:
    reshape, prepend CLS, add position embeddings (vit.py:220-231)."""
    dtype = DTYPES[cfg.dtype]
    b = patches.shape[0]
    x = patches.reshape(b, cfg.num_patches, cfg.hidden_size)
    cls = cls_token.to(dtype).expand(b, 1, cfg.hidden_size)
    return torch.cat([cls, x], dim=1) + pos_embed.to(dtype)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*D] -> [B, H, S, D] (a view)."""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H*D]."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def sp_attention(cfg: ViTConfig, qkv: torch.Tensor,
                 sp: SequenceGroup) -> torch.Tensor:
    """Sequence-parallel attention of this rank's query rows: ``qkv`` [B,
    s, 3*H*D] of the local chunk; K/V gathered from every rank in token
    order, keys >= ``cfg.seq_len`` (the padding of the last chunk)
    masked. -> [B, s, H*D]."""
    c = cfg
    dtype = DTYPES[c.dtype]
    b, s, _ = qkv.shape
    hd = c.hidden_size
    kv = sp.all_gather_tokens(qkv[..., hd:])  # [B, Skv, 2*H*D]
    skv = kv.shape[1]
    if xlen_supported(s, skv, c.num_heads, c.head_dim):
        return flash_mha_flat_xlen(qkv[..., :hd], kv[..., :hd], kv[..., hd:],
                                   num_heads=c.num_heads, out_dtype=dtype,
                                   true_kv_len=c.seq_len)
    # Small shapes: plain attention with a key mask; masked keys weigh
    # exactly 0, as in the unsharded encode.
    bias = torch.where(torch.arange(skv, device=qkv.device) < c.seq_len,
                       0.0, _NEG_INF)
    out = attn_ops.mha(_heads(qkv[..., :hd], c.num_heads),
                       _heads(kv[..., :hd], c.num_heads),
                       _heads(kv[..., hd:], c.num_heads), bias,
                       out_dtype=dtype)
    return _merge_heads(out)


class ViTSelfAttention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        dtype = DTYPES[cfg.dtype]
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size,
                             dtype=dtype)
        self.proj = nn.Linear(cfg.hidden_size, cfg.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor,
                sp: Optional[SequenceGroup] = None) -> torch.Tensor:
        c = self.cfg
        dtype = DTYPES[c.dtype]
        s = x.shape[1]
        qkv = self.qkv(x)
        if sp is not None:
            out = sp_attention(c, qkv, sp)
        elif flat_supported(s, c.num_heads, c.head_dim):
            out = flash_mha_flat_qkv(qkv, num_heads=c.num_heads,
                                     out_dtype=dtype)
        else:
            q, k, v = (_heads(t, c.num_heads) for t in qkv.chunk(3, dim=-1))
            out = _merge_heads(attn_ops.mha(q, k, v, impl="flash",
                                            out_dtype=dtype))
        return self.proj(out)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        dtype = DTYPES[cfg.dtype]
        mlp = int(cfg.hidden_size * cfg.mlp_ratio)
        self.cfg = cfg
        self.norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        self.attn = ViTSelfAttention(cfg)
        self.norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        self.mlp_fc1 = nn.Linear(cfg.hidden_size, mlp, dtype=dtype)
        self.mlp_fc2 = nn.Linear(mlp, cfg.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor,
                sp: Optional[SequenceGroup] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), sp)
        h = F.gelu(self.mlp_fc1(self.norm2(x)))  # exact erf
        return x + self.mlp_fc2(h)


class ViTBlockFused(ViTBlock):
    """The fused block: the same modules and parameters as ``ViTBlock``
    (so ``from_jax_params`` and the seeded init see no difference), the
    kernels' value flow in the forward."""

    def forward(self, x: torch.Tensor,
                sp: Optional[SequenceGroup] = None) -> torch.Tensor:
        c = self.cfg
        b, s, d = x.shape
        eps = c.layer_norm_eps
        attn = self.attn
        qkv = vit_block.ln_matmul(
            x.reshape(b * s, d), self.norm1.weight, self.norm1.bias,
            attn.qkv.weight, attn.qkv.bias, eps=eps).reshape(b, s, 3 * d)
        if sp is None and proj_fold_enabled(s):
            x = flash_mha_qkv_proj(qkv, x, attn.proj.weight, attn.proj.bias,
                                   num_heads=c.num_heads)
        else:  # under sp the JAX block never folds proj either
            out = (flash_mha_flat_qkv(qkv, num_heads=c.num_heads)
                   if sp is None else sp_attention(c, qkv, sp))
            # proj + residual as plain products, rounded where the
            # reference rounds: dot, + bias, + x.
            x = x + (F.linear(out, attn.proj.weight) + attn.proj.bias)
        return vit_block.ln_mlp_residual(
            x.reshape(b * s, d), self.norm2.weight, self.norm2.bias,
            self.mlp_fc1.weight, self.mlp_fc1.bias, self.mlp_fc2.weight,
            self.mlp_fc2.bias, eps=eps).reshape(b, s, d)


class VisionTransformer(nn.Module):
    """NHWC images (CLIP-normalised) -> embeddings [B, 1 + g*g, D].

    ``fused`` (the default, as in the JAX package) takes ``ViTBlockFused``
    where ``fused_path_supported(cfg)``; ``fused=False`` is the JAX
    package's ``PNP_VIT_FUSED=0``."""

    def __init__(self, cfg: ViTConfig, fused: bool = True):
        super().__init__()
        self.cfg = cfg
        self.fused = fused and fused_path_supported(cfg)
        block = ViTBlockFused if self.fused else ViTBlock
        self.patch_embed = make_patch_conv(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.seq_len, cfg.hidden_size))
        self.blocks = nn.ModuleList(
            block(cfg) for _ in range(cfg.num_layers))
        self.norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                              DTYPES[cfg.dtype])

    def forward(self, images: torch.Tensor,
                sp: Optional[SequenceGroup] = None) -> torch.Tensor:
        """``sp``: encode sequence-parallel over this group. The images
        are the same on every rank; the tokens, padded with zero rows to a
        multiple of the group size, are cut into one contiguous chunk per
        rank, the blocks run on this rank's chunk with keys >= seq_len
        masked, and the chunks are gathered back, so that every rank
        returns the whole encode (vit.py:405-456)."""
        c = self.cfg
        nchw = images.to(DTYPES[c.dtype]).permute(0, 3, 1, 2)
        patches = self.patch_embed(nchw).permute(0, 2, 3, 1)
        x = stem_from_patches(c, patches, self.cls_token, self.pos_embed)
        if sp is not None:
            chunk = -(-c.seq_len // sp.size)
            x = F.pad(x, (0, 0, 0, chunk * sp.size - c.seq_len))
            x = x[:, sp.rank * chunk:(sp.rank + 1) * chunk].contiguous()
        for blk in self.blocks:
            x = blk(x, sp)
        if sp is not None:
            x = sp.all_gather_tokens(x)[:, :c.seq_len]
        return self.norm(x)


def interpolate_pos_embed(pos_embed: torch.Tensor,
                          target_num_patches: int) -> torch.Tensor:
    """Resample grid position embeddings [1, 1 + g*g, D] to a new patch
    count (vit.py:459-480 of the JAX package; reference base_model.py:86-127,
    vit.py:435-465): the CLS entry is kept and the [g, g] grid is resized
    bicubically in float32. ``F.interpolate``'s bicubic with
    ``antialias=True`` takes the a = -0.5 Keys filter, as
    ``jax.image.resize(method="bicubic")`` does (and antialiases when it
    shrinks, as JAX does), so the two agree to float32 rounding;
    ``antialias=False`` would take a = -0.75."""
    _, n, dim = pos_embed.shape
    orig_grid = int((n - 1) ** 0.5)
    new_grid = int(target_num_patches ** 0.5)
    if orig_grid == new_grid:
        return pos_embed
    grid = pos_embed[:, 1:].float().reshape(1, orig_grid, orig_grid, dim)
    grid = F.interpolate(grid.permute(0, 3, 1, 2), size=(new_grid, new_grid),
                         mode="bicubic", antialias=True, align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, new_grid * new_grid, dim)
    return torch.cat([pos_embed[:, :1], grid.to(pos_embed.dtype)], dim=1)
