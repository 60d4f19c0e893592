"""BLIP-ITM (LAVIS ``blip_itm_large.yaml``) as plain float32 equations, read
straight from a LAVIS state dict: the ViT image encoder, the BERT fusion
encoder with cross-attention, the ITM head, and GradCAM of one
cross-attention layer and head.

ViT (LAVIS ``vit.py``): patch conv, CLS token, learned position
embeddings (resampled bicubically when the checkpoint's grid differs),
pre-LN blocks ``x += attn(LN(x)); x += mlp(LN(x))`` with exact-erf GELU,
LayerNorm eps 1e-6, a final LayerNorm.

BERT (LAVIS ``med.py``): word + position embeddings and LayerNorm,
post-LN layers (eps 1e-12) of text self-attention with the additive mask
bias ``(1 - mask) * -10000``, cross-attention over the image embeddings,
and a GELU feed-forward; the ITM head reads the first position.

GradCAM (``blip_image_text_matching.py:386-457``): the gradient of
``itm_logits[:, 1].sum()`` with respect to the chosen layer's
cross-attention probabilities; ``relu(probs * relu(grad) * text_mask)``
over the image patches, the [ENC] row dropped.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
from torch.nn import functional as F

from .precision import EXACT, Rounding

VIT = "visual_encoder."
BERT = "text_encoder."


def resample_pos_embed(pos: torch.Tensor, grid: int) -> torch.Tensor:
    """[1, 1 + g0*g0, D] -> [1, 1 + grid*grid, D]: the CLS entry kept, the
    grid resized bicubically (Keys a = -0.5, antialiased when it shrinks)."""
    n, dim = pos.shape[1], pos.shape[2]
    g0 = int(round((n - 1) ** 0.5))
    if g0 == grid:
        return pos
    g = pos[:, 1:].reshape(1, g0, g0, dim).permute(0, 3, 1, 2)
    g = F.interpolate(g, size=(grid, grid), mode="bicubic", antialias=True,
                      align_corners=False)
    g = g.permute(0, 2, 3, 1).reshape(1, grid * grid, dim)
    return torch.cat([pos[:, :1], g], dim=1)


class BlipItm:
    """The model of ``model_cfg`` (a configuration file's ``"model"``)
    with the weights of ``state_dict`` (LAVIS names), every product
    operand put through ``rounding``'s ``model`` format."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 model_cfg: Dict, *, device, rounding: Rounding = EXACT):
        self.vcfg, self.bcfg = model_cfg["vit"], model_cfg["bert"]
        self.rounding = rounding
        self.p = {k: torch.as_tensor(v).to(device=device,
                                           dtype=torch.float32)
                  for k, v in state_dict.items()
                  if k.startswith((VIT, BERT, "itm_head."))}
        grid = self.vcfg["image_size"] // self.vcfg["patch_size"]
        self.grid = grid
        self.p[VIT + "pos_embed"] = resample_pos_embed(
            self.p[VIT + "pos_embed"], grid)
        self._rounded: Dict[str, torch.Tensor] = {}

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        return self.rounding.round("model", x)

    def _w(self, name: str) -> torch.Tensor:
        w = self._rounded.get(name)
        if w is None:
            w = self._rounded[name] = self._r(self.p[name])
        return w

    def _linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self._r(x) @ self._w(name + ".weight").t() \
            + self.p[name + ".bias"]

    def _ln(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"],
                            self.p[name + ".bias"], eps)

    def _attend(self, q, k, v, bias=None, tap=None):
        """q [B, H, Tq, d], k, v [B, H, Tk, d] -> (context, probs)."""
        s = (self._r(q) @ self._r(k).transpose(-1, -2)) / math.sqrt(
            q.shape[-1])
        if bias is not None:
            s = s + bias
        probs = torch.softmax(s, dim=-1)
        if tap is not None:
            probs = probs + tap
        return self._r(probs) @ self._r(v), probs

    @staticmethod
    def _split(x: torch.Tensor, heads: int) -> torch.Tensor:
        b, t, d = x.shape
        return x.reshape(b, t, heads, d // heads).transpose(1, 2)

    @staticmethod
    def _merge(x: torch.Tensor) -> torch.Tensor:
        b, h, t, d = x.shape
        return x.transpose(1, 2).reshape(b, t, h * d)

    # -- ViT -------------------------------------------------------------
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] CLIP-normalised -> embeddings [B, S, D]."""
        c = self.vcfg
        heads, eps = c["num_heads"], c["layer_norm_eps"]
        x = F.conv2d(self._r(images.permute(0, 3, 1, 2)),
                     self._w(VIT + "patch_embed.proj.weight"),
                     self.p[VIT + "patch_embed.proj.bias"],
                     stride=c["patch_size"])
        x = x.flatten(2).transpose(1, 2)
        cls = self.p[VIT + "cls_token"].expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.p[VIT + "pos_embed"]
        for i in range(c["num_layers"]):
            blk = f"{VIT}blocks.{i}"
            qkv = self._linear(self._ln(x, blk + ".norm1", eps),
                               blk + ".attn.qkv")
            q, k, v = (self._split(t, heads) for t in qkv.chunk(3, dim=-1))
            ctx, _ = self._attend(q, k, v)
            x = x + self._linear(self._merge(ctx), blk + ".attn.proj")
            h = F.gelu(self._linear(self._ln(x, blk + ".norm2", eps),
                                    blk + ".mlp.fc1"))
            x = x + self._linear(h, blk + ".mlp.fc2")
        return self._ln(x, VIT + "norm", eps)

    # -- BERT, ITM and GradCAM -------------------------------------------
    def itm(self, embeds, ids, mask, *, tap_layer: int = -1, tap=None):
        """-> (ITM logits [B, 2], probs of ``tap_layer`` [B, H, T, S])."""
        c = self.bcfg
        heads, eps = c["num_heads"], c["layer_norm_eps"]
        pre = BERT + "embeddings."
        t = ids.shape[1]
        x = self.p[pre + "word_embeddings.weight"][ids] \
            + self.p[pre + "position_embeddings.weight"][:t]
        x = self._ln(x, pre + "LayerNorm", eps)
        bias = (1.0 - mask[:, None, None, :].float()) * -10000.0
        captured = None
        for i in range(c["num_layers"]):
            lay = f"{BERT}encoder.layer.{i}"
            sa = lay + ".attention"
            q, k, v = (self._split(self._linear(x, f"{sa}.self.{n}"), heads)
                       for n in ("query", "key", "value"))
            ctx, _ = self._attend(q, k, v, bias)
            x = self._ln(self._linear(self._merge(ctx), sa + ".output.dense")
                         + x, sa + ".output.LayerNorm", eps)
            ca = lay + ".crossattention"
            q = self._split(self._linear(x, ca + ".self.query"), heads)
            k, v = (self._split(self._linear(embeds, f"{ca}.self.{n}"), heads)
                    for n in ("key", "value"))
            ctx, probs = self._attend(q, k, v,
                                      tap=tap if i == tap_layer else None)
            if i == tap_layer:
                captured = probs
            x = self._ln(self._linear(self._merge(ctx), ca + ".output.dense")
                         + x, ca + ".output.LayerNorm", eps)
            h = F.gelu(self._linear(x, lay + ".intermediate.dense"))
            x = self._ln(self._linear(h, lay + ".output.dense") + x,
                         lay + ".output.LayerNorm", eps)
        logits = x[:, 0] @ self.p["itm_head.weight"].t() \
            + self.p["itm_head.bias"]
        return logits, captured

    def gradcam(self, embeds: torch.Tensor, ids: torch.Tensor,
                mask: torch.Tensor, *, layer: int, head: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """GradCAM of 1-indexed BERT ``layer`` and 0-indexed ``head`` ->
        (gradcam [B, T-1, g, g], ITM logits [B, 2]). ``self.last`` keeps
        the head's probabilities and gradient before the relus, and the
        text mask, each [B, T-1, g, g]."""
        b, t = ids.shape
        heads = self.bcfg["num_heads"]
        tap = torch.zeros((b, heads, t, embeds.shape[1]),
                          device=embeds.device, requires_grad=True)
        with torch.enable_grad():
            logits, probs = self.itm(embeds.detach(), ids, mask,
                                     tap_layer=layer - 1, tap=tap)
            (grad,) = torch.autograd.grad(logits[:, 1].sum(), tap)
        cam = probs.detach()[:, head, :, 1:]
        g = grad[:, head, :, 1:]
        m = mask[:, :, None].float().expand_as(g)
        gc = F.relu(cam * F.relu(g) * m)[:, 1:]
        shape = (b, t - 1, self.grid, self.grid)
        self.last = {k: v[:, 1:].reshape(shape)
                     for k, v in (("cam", cam), ("grad", g), ("mask", m))}
        return gc.reshape(shape), logits.detach()
