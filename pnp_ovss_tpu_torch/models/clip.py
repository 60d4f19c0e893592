"""CLIP dual encoder, the search's independent reward model (counterpart
of ``pnp_ovss_tpu/models/clip.py``).

The reference scores its hyper-parameter search with LAVIS
``clip_feature_extractor ViT-L-14-336`` (reference script :1370-1372): an
OpenAI CLIP with a ViT-L/14 vision tower at 336 px and a 12-layer causal
text transformer, giving L2-normalised projected embeddings whose
products, divided by the temperature 0.01, softmax into class
probabilities (``cli/search.py::make_clip_scorer``).

The topology is OpenAI CLIP's:

- vision: a bias-free patch conv, a class token and learned position
  embeddings (added in the compute dtype), ``ln_pre``, pre-LN residual
  blocks with quick-GELU MLPs, ``ln_post`` on the class token cast to the
  compute dtype, then a projection; NHWC images;
- text: token + position embeddings, the same blocks under a causal mask,
  ``ln_final`` (its output stays float32, as in the JAX package), the
  features at the EOT token (the argmax of the ids) cast to the compute
  dtype, then a projection.

Attention in ``CLIPBlock``: non-causal blocks whose shape the flat kernel
takes (``flat_supported``: the vision tower's 577 tokens at 336 px, 16
heads of 64) run kernel K2 ``flash_mha_flat_qkv`` straight on the qkv
projection; other non-causal shapes go to ``ops.attention.mha(impl=
"flash")`` (K9 where it takes the shape, plain attention for small ones);
the causal text blocks run plain attention with the float32 ``-1e9``
upper-triangular bias added after scaling. The JAX package has no Pallas
kernel for the causal case, so plain PyTorch is its counterpart there, not
a fallback. Quick-GELU is its own function and never goes through K3's
erf GELU. Forward only.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pnp_ovss_tpu_torch import resolve_device
from pnp_ovss_tpu_torch.config import (
    CLIPConfig, CLIPTextConfig, CLIPVisionConfig,
)
from pnp_ovss_tpu_torch.models.layers import DTYPES, LayerNorm
from pnp_ovss_tpu_torch.ops import attention as attn_ops
from pnp_ovss_tpu_torch.ops.flash_attention import (
    flash_mha_flat_qkv, flat_supported,
)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's GELU approximation ``x * sigmoid(1.702 x)``, in x's
    dtype."""
    return x * torch.sigmoid(1.702 * x)


class CLIPBlock(nn.Module):
    """Pre-LN residual block with a quick-GELU MLP (both towers)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float,
                 eps: float, dtype: str, causal: bool = False):
        super().__init__()
        dt = DTYPES[dtype]
        self.num_heads = num_heads
        self.causal = causal
        self.ln_1 = LayerNorm(hidden_size, eps, dt)
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size, dtype=dt)
        self.proj = nn.Linear(hidden_size, hidden_size, dtype=dt)
        self.ln_2 = LayerNorm(hidden_size, eps, dt)
        mlp = int(hidden_size * mlp_ratio)
        self.c_fc = nn.Linear(hidden_size, mlp, dtype=dt)
        self.c_proj = nn.Linear(mlp, hidden_size, dtype=dt)

    def attention(self, qkv: torch.Tensor) -> torch.Tensor:
        """qkv [B, S, 3*H*D] -> [B, S, H*D] in qkv's dtype."""
        b, s, three_hd = qkv.shape
        h = self.num_heads
        d = three_hd // (3 * h)
        if not self.causal and flat_supported(s, h, d):
            return flash_mha_flat_qkv(qkv, num_heads=h, out_dtype=qkv.dtype)
        q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        bias = None
        if self.causal:
            bias = torch.triu(torch.full((s, s), -1e9, device=qkv.device),
                              diagonal=1)
        out = attn_ops.mha(q, k, v, bias, impl="flash", out_dtype=qkv.dtype)
        return out.transpose(1, 2).reshape(b, s, h * d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.proj(self.attention(self.qkv(self.ln_1(x))))
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


def _blocks(cfg, causal: bool) -> nn.ModuleList:
    return nn.ModuleList(
        CLIPBlock(cfg.hidden_size, cfg.num_heads, cfg.mlp_ratio,
                  cfg.layer_norm_eps, cfg.dtype, causal=causal)
        for _ in range(cfg.num_layers))


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        dt = DTYPES[cfg.dtype]
        w = cfg.hidden_size
        self.cfg = cfg
        self.patch_embed = nn.Conv2d(3, w, cfg.patch_size,
                                     stride=cfg.patch_size, bias=False,
                                     dtype=dt)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.num_patches + 1, w))
        self.ln_pre = LayerNorm(w, cfg.layer_norm_eps, dt)
        self.blocks = _blocks(cfg, causal=False)
        self.ln_post = LayerNorm(w, cfg.layer_norm_eps, dt)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] CLIP-normalised NHWC -> f32 [B, embed_dim], not
        normalised."""
        c = self.cfg
        dt = DTYPES[c.dtype]
        b = images.shape[0]
        x = self.patch_embed(images.to(dt).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # [B, g*g, W]
        cls = self.class_embedding.to(dt).expand(b, 1, c.hidden_size)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.pos_embed.to(dt))
        for blk in self.blocks:
            x = blk(x)
        return (self.ln_post(x[:, 0]) @ self.proj.to(dt)).float()


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        dt = DTYPES[cfg.dtype]
        w = cfg.hidden_size
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, w, dtype=dt)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.context_length, w))
        self.blocks = _blocks(cfg, causal=True)
        self.ln_final = LayerNorm(w, cfg.layer_norm_eps, torch.float32)
        self.text_projection = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """[B, T] BPE ids (SOT ... EOT, zero-padded) -> f32 [B, embed_dim],
        not normalised. The features are read at the EOT position, the
        argmax of the ids (EOT is the vocab's largest id, padding 0)."""
        dt = DTYPES[self.cfg.dtype]
        x = self.token_embedding(ids) + self.pos_embed.to(dt)[:ids.shape[1]]
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_final(x)
        feats = x[torch.arange(x.shape[0], device=x.device),
                  ids.argmax(dim=-1)]
        return (feats.to(dt) @ self.text_projection.to(dt)).float()


def _normalise(z: torch.Tensor) -> torch.Tensor:
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


class CLIPModel(nn.Module):
    """``encode_image`` / ``encode_text`` return L2-normalised f32
    embeddings (the LAVIS ``extract_features`` ``*_embeds_proj`` the
    reference reads, script :161-165)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = CLIPVisionTower(cfg.vision)
        self.text = CLIPTextTower(cfg.text)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return _normalise(self.visual(images))

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        return _normalise(self.text(ids))

    def forward(self, images, ids):
        return self.encode_image(images), self.encode_text(ids)


# The JAX package's initialisers' standard deviations for the tensors its
# modules create themselves (models/clip.py there); Linear and conv
# weights take N(0, 1/fan_in) and the token embedding N(0, 1/width), as
# Flax's lecun-normal and embedding defaults scale them.
_INIT_STD = {"visual.class_embedding": 0.02, "visual.pos_embed": 0.02,
             "visual.proj": 0.02, "text.pos_embed": 0.01,
             "text.text_projection": 0.01}


def init_clip(cfg: CLIPConfig, *, seed: int = 0, device="cuda") -> CLIPModel:
    """Random CLIP weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (smoke runs and tests without a checkpoint):
    biases 0, norms 1, the rest normal at the JAX package's scales."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = CLIPModel(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner = model.get_submodule(name.rpartition(".")[0])
            if isinstance(owner, LayerNorm):
                continue  # keeps ones / zeros
            if name.endswith(".bias"):
                p.zero_()
                continue
            if name in _INIT_STD:
                std = _INIT_STD[name]
            elif isinstance(owner, nn.Embedding):
                std = 1.0 / math.sqrt(p.shape[1])
            else:  # Linear and conv weights
                std = 1.0 / math.sqrt(p[0].numel())
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)
    return model.requires_grad_(False).eval()
