"""JAX-package parameter tree -> the port's ``BlipITM``.

``from_jax_params`` maps the Flax tree of ``pnp_ovss_tpu`` (as nested dicts
of numpy arrays) onto the port's modules, so both packages compute with the
same weights:

- the ViT blocks' scanned stacks ``visual_encoder/blocks/block/*`` (leading
  layer axis) become ``visual_encoder.blocks.{i}``;
- the BERT layer groups (``layers_pre/layer/*`` stacked over the layers
  before the captured one, then ``layer_{i}``; models/bert.py:208-225)
  become ``text_encoder.layers.{i}``;
- Dense kernels [in, out] are transposed to Linear weights [out, in], the
  HWIO patch conv becomes OIHW, LayerNorm ``scale`` becomes ``weight``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from pnp_ovss_tpu_torch import resolve_device
from pnp_ovss_tpu_torch.config import ModelConfig
from pnp_ovss_tpu_torch.models.blip_itm import BlipITM


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


def from_jax_params(tree, cfg: ModelConfig, *, capture_layer: int,
                    device="cuda", vit_fused: bool = True) -> BlipITM:
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
    _flatten({"itm_head": p["itm_head"]}, "", flat)

    model = BlipITM(cfg, capture_layer, vit_fused=vit_fused)
    model.load_state_dict({k: torch.tensor(v) for k, v in flat.items()},
                          strict=True)
    return model.to(resolve_device(device)).requires_grad_(False).eval()
