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
  there): LN1 -> qkv -> K2 -> proj -> LN2 -> MLP, the products plain
  matmuls. It also serves configurations the fused kernels do not take.

The JAX package pads the whole encode to its k-block schedule (a TPU tile
rule); the port carries ``[B, S, D]`` as it is, and the kernels mask the
ragged row tail and keys >= S themselves.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from pnp_ovss_tpu_torch.config import ViTConfig
from pnp_ovss_tpu_torch.models.layers import DTYPES, LayerNorm
from pnp_ovss_tpu_torch.ops import attention as attn_ops
from pnp_ovss_tpu_torch.ops import vit_block
from pnp_ovss_tpu_torch.ops.flash_attention import (
    flash_mha_flat_qkv,
    flash_mha_qkv_proj,
    flat_supported,
    proj_fold_enabled,
)


def fused_path_supported(cfg: ViTConfig) -> bool:
    """True iff the fused kernels take this config: the JAX package's
    shape conditions (its flat-attention rule, with heads in pairs as K4
    takes them, and ``vit_block.supported``), without its environment
    switch."""
    return (flat_supported(cfg.seq_len, cfg.head_dim)
            and cfg.num_heads % 2 == 0
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


class ViTSelfAttention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        dtype = DTYPES[cfg.dtype]
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size,
                             dtype=dtype)
        self.proj = nn.Linear(cfg.hidden_size, cfg.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        dtype = DTYPES[c.dtype]
        b, s, _ = x.shape
        qkv = self.qkv(x)
        if flat_supported(s, c.head_dim):
            out = flash_mha_flat_qkv(qkv, num_heads=c.num_heads,
                                     out_dtype=dtype)
        else:
            q, k, v = qkv.reshape(b, s, 3, c.num_heads, c.head_dim) \
                .permute(2, 0, 3, 1, 4)
            out = attn_ops.mha(q, k, v, out_dtype=dtype)
            out = out.transpose(1, 2).reshape(b, s, c.hidden_size)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        h = F.gelu(self.mlp_fc1(self.norm2(x)))  # exact erf
        return x + self.mlp_fc2(h)


class ViTBlockFused(ViTBlock):
    """The fused block: the same modules and parameters as ``ViTBlock``
    (so ``from_jax_params`` and the seeded init see no difference), the
    kernels' value flow in the forward."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, s, d = x.shape
        eps = c.layer_norm_eps
        attn = self.attn
        qkv = vit_block.ln_matmul(
            x.reshape(b * s, d), self.norm1.weight, self.norm1.bias,
            attn.qkv.weight, attn.qkv.bias, eps=eps).reshape(b, s, 3 * d)
        if proj_fold_enabled(s):
            x = flash_mha_qkv_proj(qkv, x, attn.proj.weight, attn.proj.bias,
                                   num_heads=c.num_heads)
        else:
            out = flash_mha_flat_qkv(qkv, num_heads=c.num_heads)
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

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        nchw = images.to(DTYPES[c.dtype]).permute(0, 3, 1, 2)
        patches = self.patch_embed(nchw).permute(0, 2, 3, 1)
        x = stem_from_patches(c, patches, self.cls_token, self.pos_embed)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)
