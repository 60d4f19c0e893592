"""Weights -> the port's ``BlipITM`` and ``CLIPModel``: LAVIS BLIP-ITM
and OpenAI CLIP torch checkpoints, and the JAX package's parameter trees.

``from_lavis_state_dict`` / ``load_torch_checkpoint`` load a LAVIS BLIP-ITM
state dict (e.g. model_large_retrieval_flickr.pth, blip_itm_large.yaml:10)
straight into the port's modules, the counterpart of the JAX package's
``convert_state_dict`` / ``load_torch_checkpoint``:

- LAVIS names map onto the port's by renaming; the layouts already are
  PyTorch's (OIHW patch conv, [out, in] Linear weights, the fused qkv
  Linear of the ViT), so no tensor is transposed;
- ``text_encoder.bert.*`` (some LAVIS exports) is read as
  ``text_encoder.*``;
- the ITC projections ``vision_proj`` / ``text_proj`` are kept (the
  search's ITC scorer reads them);
- the keys the port never reads are dropped, as the JAX converter drops
  or ignores them: the momentum towers and projections (``*_m``), the ITC
  queues and their pointer, ``temp``, BERT's serialised ``position_ids``
  buffer and its ``token_type_embeddings`` (the ITM path passes no token
  types; med.py:67-70,111-115);
- the ViT position embeddings are resampled when the checkpoint's grid
  differs from the config's (``models.vit.interpolate_pos_embed``);
- any other key, a missing one, or a shape that does not fit raises and
  names the key: nothing is skipped quietly.

``from_jax_params`` maps the Flax tree of ``pnp_ovss_tpu`` (as nested dicts
of numpy arrays) onto the port's modules, so both packages compute with the
same weights:

- the ViT blocks' scanned stacks ``visual_encoder/blocks/block/*`` (leading
  layer axis) become ``visual_encoder.blocks.{i}``;
- the BERT layer groups (``layers_pre/layer/*`` stacked over the layers
  before the captured one, then ``layer_{i}``; models/bert.py:208-225; a
  tree drawn for several captured layers has ``layer_{i}`` for every
  layer) become ``text_encoder.layers.{i}``; the ITM and ITC heads keep
  their names;
- Dense kernels [in, out] are transposed to Linear weights [out, in], the
  HWIO patch conv becomes OIHW, LayerNorm ``scale`` becomes ``weight``.

The CLIP reward model of the search (``models/clip.py``) loads the same
two ways, the counterparts of the JAX package's ``convert_clip_state_dict``
/ ``load_clip_checkpoint``:

- ``from_openai_clip_state_dict`` / ``load_clip_checkpoint``: the OpenAI
  layout (``ViT-L-14-336px.pt``: the ``visual.*`` tower with its fused
  ``attn.in_proj_*``, ``transformer.resblocks.*``, ``token_embedding``,
  ``positional_embedding``, ``ln_final``, ``text_projection``) by
  renaming, no tensor transposed; the vision position embeddings are
  resampled when their grid differs from the config's; ``logit_scale``
  and the archive's size entries are dropped; any other key, a missing
  one or a misfit shape raises and names the key. OpenAI ships the file
  as a TorchScript archive, which ``torch.jit.load`` reads where
  ``torch.load`` refuses it;
- ``from_jax_clip_params``: the Flax tree of ``init_clip_params``, its
  scanned ``blocks/block/*`` stacks split per layer.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from pnp_ovss_tpu_torch import resolve_device
from pnp_ovss_tpu_torch.config import CLIPConfig, ModelConfig
from pnp_ovss_tpu_torch.models.blip_itm import BlipITM
from pnp_ovss_tpu_torch.models.clip import CLIPModel
from pnp_ovss_tpu_torch.models.vit import interpolate_pos_embed

# LAVIS keys the port never reads (prefixes, substrings, exact names).
_DROP_PREFIXES = ("visual_encoder_m.", "text_encoder_m.", "vision_proj_m.",
                  "text_proj_m.")
_DROP_NAMES = ("temp", "text_encoder.embeddings.position_ids",
               "text_encoder.embeddings.token_type_embeddings.weight")

# LAVIS name -> the port's, applied in order after the ``.bert`` prefix is
# normalised; names no rule matches are already the port's.
_LAYER = r"^text_encoder\.encoder\.layer\.(\d+)\."
_RENAMES = [(re.compile(a), b) for a, b in (
    (r"^visual_encoder\.patch_embed\.proj\.", "visual_encoder.patch_embed."),
    (r"^(visual_encoder\.blocks\.\d+)\.mlp\.fc(\d)\.", r"\1.mlp_fc\2."),
    (r"^text_encoder\.embeddings\.word_embeddings\.",
     "text_encoder.word_embeddings."),
    (r"^text_encoder\.embeddings\.position_embeddings\.weight$",
     "text_encoder.position_embeddings"),
    (r"^text_encoder\.embeddings\.LayerNorm\.", "text_encoder.embed_norm."),
    (_LAYER + r"(attention|crossattention)\.self\.",
     r"text_encoder.layers.\1.\2."),
    (_LAYER + r"(attention|crossattention)\.output\.dense\.",
     r"text_encoder.layers.\1.\2.output_dense."),
    (_LAYER + r"(attention|crossattention)\.output\.LayerNorm\.",
     r"text_encoder.layers.\1.\2.output_norm."),
    (_LAYER + r"intermediate\.dense\.", r"text_encoder.layers.\1.intermediate."),
    (_LAYER + r"output\.dense\.", r"text_encoder.layers.\1.output_dense."),
    (_LAYER + r"output\.LayerNorm\.", r"text_encoder.layers.\1.output_norm."),
)]


def _unbert(key: str) -> str:
    return re.sub(r"^text_encoder\.bert\.", "text_encoder.", key)


def _dropped(key: str) -> bool:
    key = _unbert(key)
    return (key.startswith(_DROP_PREFIXES) or key in _DROP_NAMES
            or "queue" in key)


def lavis_port_name(key: str) -> str:
    """A LAVIS BLIP-ITM state-dict key as the port's parameter name."""
    key = _unbert(key)
    for pattern, repl in _RENAMES:
        key, n = pattern.subn(repl, key)
        if n:
            break
    return key


def empty_model(cfg: ModelConfig, capture_layers: Tuple[int, ...],
                device, vit_fused: bool) -> BlipITM:
    """A ``BlipITM`` built on ``device`` with default-initialised
    parameters, for a state dict to fill."""
    with torch.device(resolve_device(device)):
        return BlipITM(cfg, capture_layers, vit_fused=vit_fused)


def from_lavis_state_dict(sd: Mapping[str, object], cfg: ModelConfig, *,
                          capture_layers: Tuple[int, ...], device="cuda",
                          vit_fused: bool = True) -> BlipITM:
    """A LAVIS BLIP-ITM state dict (tensors or numpy arrays) -> the port's
    ``BlipITM`` on ``device``, every tensor cast to its parameter's dtype.
    Raises ``KeyError`` for a key the port cannot place or a parameter no
    key fills, ``ValueError`` for a shape that does not fit; each names
    the key."""
    model = empty_model(cfg, capture_layers, device, vit_fused)
    want = model.state_dict()
    port: Dict[str, torch.Tensor] = {}
    for key, val in sd.items():
        if _dropped(key):
            continue
        name = lavis_port_name(key)
        if name not in want:
            raise KeyError(f"checkpoint key {key!r} has no place in the "
                           f"port's BlipITM (read as {name!r})")
        if name in port:
            raise KeyError(f"checkpoint key {key!r} fills {name!r} a "
                           "second time")
        t = torch.as_tensor(val)
        if name == "visual_encoder.pos_embed":
            t = interpolate_pos_embed(t, cfg.vit.num_patches)
        if t.shape != want[name].shape:
            raise ValueError(f"checkpoint key {key!r}: shape "
                             f"{tuple(t.shape)} does not fit {name!r} "
                             f"{tuple(want[name].shape)}")
        port[name] = t
    missing = sorted(set(want) - set(port))
    if missing:
        raise KeyError(f"checkpoint fills no value for {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}")
    model.load_state_dict(port, strict=True)
    return model.requires_grad_(False).eval()


def load_torch_checkpoint(path: str, cfg: ModelConfig,
                          capture_layers: Tuple[int, ...], *, device="cuda",
                          vit_fused: bool = True) -> BlipITM:
    """Load a LAVIS/BLIP ``.pth`` checkpoint (a state dict, or one under
    ``"model"``) on the CPU and place it in the port's ``BlipITM`` on
    ``device``."""
    resolve_device(device)  # no card: raise before reading the file
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    return from_lavis_state_dict(sd, cfg, capture_layers=capture_layers,
                                 device=device, vit_fused=vit_fused)


def _index(tree, i: int):
    """Select layer ``i`` from every array of a stacked subtree."""
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """Flax leaf names -> torch parameter names, arrays re-laid out."""
    for key, val in tree.items():
        if isinstance(val, Mapping):
            _flatten(val, f"{prefix}{key}.", out)
            continue
        arr = np.asarray(val, np.float32)
        if key == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            key = "weight"
        elif key in ("scale", "embedding"):
            key = "weight"
        out[prefix + key] = arr


def from_jax_params(tree, cfg: ModelConfig, *,
                    capture_layers: Tuple[int, ...], device="cuda",
                    vit_fused: bool = True) -> BlipITM:
    """``tree``: the JAX package's params (``{"params": {...}}`` or the
    inner dict) with numpy (or array-like) leaves. The fused and unfused
    ViT blocks share one parameter tree, as in the JAX package;
    ``vit_fused`` picks the block (``BlipITM``)."""
    p = tree["params"] if "params" in tree else tree
    ve = dict(p["visual_encoder"])
    stacked = ve.pop("blocks")["block"]
    te = dict(p["text_encoder"])
    layers = {}
    if "layers_pre" in te:
        pre = te.pop("layers_pre")["layer"]
        n_pre = np.asarray(pre["output_norm"]["scale"]).shape[0]
        layers.update({i: _index(pre, i) for i in range(n_pre)})
    for key in list(te):
        m = re.fullmatch(r"layer_(\d+)", key)
        if m:
            layers[int(m.group(1))] = te.pop(key)

    flat: Dict[str, np.ndarray] = {}
    _flatten(ve, "visual_encoder.", flat)
    for i in range(cfg.vit.num_layers):
        _flatten(_index(stacked, i), f"visual_encoder.blocks.{i}.", flat)
    _flatten(te, "text_encoder.", flat)
    for i, layer in layers.items():
        _flatten(layer, f"text_encoder.layers.{i}.", flat)
    for head in ("itm_head", "vision_proj", "text_proj"):
        _flatten({head: p[head]}, "", flat)

    model = BlipITM(cfg, capture_layers, vit_fused=vit_fused)
    model.load_state_dict({k: torch.tensor(v) for k, v in flat.items()},
                          strict=True)
    return model.to(resolve_device(device)).requires_grad_(False).eval()


# OpenAI CLIP keys the port never reads: the learned temperature (the
# reference divides by a fixed 0.01) and the sizes the TorchScript archive
# carries beside the weights.
_CLIP_DROP = ("logit_scale", "input_resolution", "context_length",
              "vocab_size")
_CLIP_RENAMES = [(re.compile(a), b) for a, b in (
    (r"^visual\.conv1\.", "visual.patch_embed."),
    (r"^visual\.positional_embedding$", "visual.pos_embed"),
    (r"^visual\.transformer\.resblocks\.", "visual.blocks."),
    (r"^transformer\.resblocks\.", "text.blocks."),
    (r"^token_embedding\.", "text.token_embedding."),
    (r"^positional_embedding$", "text.pos_embed"),
    (r"^(ln_final\.|text_projection$)", r"text.\1"),
)]
_CLIP_BLOCK_RENAMES = [(re.compile(a), b) for a, b in (
    (r"\.attn\.in_proj_(weight|bias)$", r".qkv.\1"),
    (r"\.attn\.out_proj\.", ".proj."),
    (r"\.mlp\.(c_fc|c_proj)\.", r".\1."),
)]


def clip_port_name(key: str) -> str:
    """An OpenAI CLIP state-dict key as the port's parameter name."""
    for pattern, repl in _CLIP_RENAMES:
        key, n = pattern.subn(repl, key)
        if n:
            break
    for pattern, repl in _CLIP_BLOCK_RENAMES:
        key = pattern.sub(repl, key)
    return key


def _clip_model(cfg: CLIPConfig, device) -> CLIPModel:
    with torch.device(resolve_device(device)):
        return CLIPModel(cfg)


def from_openai_clip_state_dict(sd: Mapping[str, object], cfg: CLIPConfig,
                                *, device="cuda") -> CLIPModel:
    """An OpenAI CLIP state dict (tensors or numpy arrays, any float
    dtype) -> the port's ``CLIPModel`` on ``device``, every tensor cast to
    its parameter's dtype. Raises ``KeyError`` for a key the port cannot
    place or a parameter no key fills, ``ValueError`` for a shape that
    does not fit; each names the key."""
    model = _clip_model(cfg, device)
    want = model.state_dict()
    port: Dict[str, torch.Tensor] = {}
    for key, val in sd.items():
        if key in _CLIP_DROP:
            continue
        name = clip_port_name(key)
        if name not in want:
            raise KeyError(f"CLIP checkpoint key {key!r} has no place in the "
                           f"port's CLIPModel (read as {name!r})")
        t = torch.as_tensor(val)
        if name == "visual.pos_embed":
            t = interpolate_pos_embed(t.float()[None],
                                      cfg.vision.num_patches)[0]
        if t.shape != want[name].shape:
            raise ValueError(f"CLIP checkpoint key {key!r}: shape "
                             f"{tuple(t.shape)} does not fit {name!r} "
                             f"{tuple(want[name].shape)}")
        port[name] = t
    missing = sorted(set(want) - set(port))
    if missing:
        raise KeyError(f"CLIP checkpoint fills no value for {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}")
    model.load_state_dict(port, strict=True)
    return model.requires_grad_(False).eval()


def load_clip_checkpoint(path: str, cfg: CLIPConfig, *,
                         device="cuda") -> CLIPModel:
    """Load an OpenAI CLIP ``.pt`` (a TorchScript archive, as OpenAI ships
    ``ViT-L-14-336px.pt``, or a plain state dict, or one under
    ``"state_dict"`` / ``"model"``) on the CPU into the port's
    ``CLIPModel`` on ``device``. Recent PyTorch hands a TorchScript
    archive from ``torch.load`` to ``torch.jit.load`` itself; older
    versions raise ``RuntimeError``, and then ``torch.jit.load`` reads
    it."""
    resolve_device(device)  # no card: raise before reading the file
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except RuntimeError:
        obj = torch.jit.load(path, map_location="cpu")
    if hasattr(obj, "state_dict"):
        sd = obj.state_dict()
    else:
        sd = obj.get("state_dict", obj.get("model", obj))
    return from_openai_clip_state_dict(sd, cfg, device=device)


def from_jax_clip_params(tree, cfg: CLIPConfig, *,
                         device="cuda") -> CLIPModel:
    """``tree``: the JAX package's CLIP params (``{"params": {"visual":
    ..., "text": ...}}`` or the inner dict) with numpy (or array-like)
    leaves -> the port's ``CLIPModel`` on ``device``."""
    p = tree["params"] if "params" in tree else tree
    flat: Dict[str, np.ndarray] = {}
    for tower, n in (("visual", cfg.vision.num_layers),
                     ("text", cfg.text.num_layers)):
        sub = dict(p[tower])
        stacked = sub.pop("blocks")["block"]
        _flatten(sub, f"{tower}.", flat)
        for i in range(n):
            _flatten(_index(stacked, i), f"{tower}.blocks.{i}.", flat)
    model = _clip_model(cfg, device)
    model.load_state_dict({k: torch.tensor(v) for k, v in flat.items()},
                          strict=True)
    return model.requires_grad_(False).eval()
