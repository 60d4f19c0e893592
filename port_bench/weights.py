"""Random BLIP-ITM weights under LAVIS's state-dict names, drawn from a
seed on the device in one call.

Matrices are N(0, 1/fan_in), so activations keep a real scale through
the depth; LayerNorm weights 1 + N(0, 0.1^2); biases, embeddings, the CLS
token and the position grid N(0, 0.02^2). The ViT's position grid is the
checkpoint's (``checkpoint_image_size``, 384 px for BLIP-ITM-Large), so
the system resamples it as it does a real checkpoint. The same seed on the
same kind of device gives the same tensors, so the reference draws them
again after the system's run instead of holding a second copy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# (name, shape, kind): kind "w" N(0, 1/fan_in), "ln" 1 + N(0, 0.01),
# anything else N(0, 0.02^2).
Entry = Tuple[str, Tuple[int, ...], str]


def layout(model_cfg: Dict) -> List[Entry]:
    """Every tensor of the state dict, in drawing order."""
    v, c = model_cfg["vit"], model_cfg["bert"]
    d, p = v["hidden_size"], v["patch_size"]
    g = v["checkpoint_image_size"] // p
    mlp = int(d * v["mlp_ratio"])
    out: List[Entry] = []

    def lin(name, n_in, n_out):
        out.append((name + ".weight", (n_out, n_in), "w"))
        out.append((name + ".bias", (n_out,), "b"))

    def ln(name, n):
        out.append((name + ".weight", (n,), "ln"))
        out.append((name + ".bias", (n,), "b"))

    ve = "visual_encoder."
    out.append((ve + "patch_embed.proj.weight", (d, 3, p, p), "w"))
    out.append((ve + "patch_embed.proj.bias", (d,), "b"))
    out.append((ve + "cls_token", (1, 1, d), "b"))
    out.append((ve + "pos_embed", (1, g * g + 1, d), "b"))
    for i in range(v["num_layers"]):
        b = f"{ve}blocks.{i}"
        ln(b + ".norm1", d)
        lin(b + ".attn.qkv", d, 3 * d)
        lin(b + ".attn.proj", d, d)
        ln(b + ".norm2", d)
        lin(b + ".mlp.fc1", d, mlp)
        lin(b + ".mlp.fc2", mlp, d)
    ln(ve + "norm", d)
    h = c["hidden_size"]
    te = "text_encoder."
    out.append((te + "embeddings.word_embeddings.weight",
                (c["vocab_size"], h), "b"))
    out.append((te + "embeddings.position_embeddings.weight",
                (c["max_position_embeddings"], h), "b"))
    ln(te + "embeddings.LayerNorm", h)
    for i in range(c["num_layers"]):
        b = f"{te}encoder.layer.{i}"
        for part, kv_in in (("attention", h),
                            ("crossattention", c["encoder_width"])):
            lin(f"{b}.{part}.self.query", h, h)
            lin(f"{b}.{part}.self.key", kv_in, h)
            lin(f"{b}.{part}.self.value", kv_in, h)
            lin(f"{b}.{part}.output.dense", h, h)
            ln(f"{b}.{part}.output.LayerNorm", h)
        lin(b + ".intermediate.dense", h, c["intermediate_size"])
        lin(b + ".output.dense", c["intermediate_size"], h)
        ln(b + ".output.LayerNorm", h)
    lin("itm_head", h, 2)
    lin("vision_proj", d, model_cfg["embed_dim"])
    lin("text_proj", h, model_cfg["embed_dim"])
    return out


def lavis_state_dict(model_cfg: Dict, seed: int, device
                     ) -> Dict[str, torch.Tensor]:
    """The state dict of ``seed``: float32 views of one buffer drawn by
    one ``torch.Generator`` on ``device``."""
    entries = layout(model_cfg)
    sizes = [torch.Size(s).numel() for _, s, _ in entries]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    sd, lo = {}, 0
    for (name, shape, kind), n in zip(entries, sizes):
        t = flat[lo:lo + n].view(shape)
        lo += n
        if kind == "w":
            t.mul_(torch.Size(shape[1:]).numel() ** -0.5)
        elif kind == "ln":
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.02)
        sd[name] = t
    return sd
