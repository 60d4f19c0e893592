"""Converted-parameter cache (the port's counterpart of
``pnp_ovss_tpu/models/cache.py``, which caches with orbax).

The reference re-loads the torch checkpoint every run
(base_model.py:86-127). Here the converted ``BlipITM`` state dict is saved
with ``torch.save`` under ``~/.cache/pnp_ovss_tpu_torch/params/`` (or
``cache_dir``), keyed as the JAX package keys its cache: checkpoint path,
size and mtime, the model config (``embed_dim`` included, so conversions
from before the ITC projections were kept are not read) and the captured
layers. Later runs load it straight into the model, with no renaming or
resampling.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Tuple

import torch

from pnp_ovss_tpu_torch.config import ModelConfig
from pnp_ovss_tpu_torch.models import convert
from pnp_ovss_tpu_torch.models.blip_itm import BlipITM
from pnp_ovss_tpu_torch.utils.logging import log


def _cache_key(ckpt_path: str, cfg: ModelConfig,
               capture_layers: Tuple[int, ...]) -> str:
    stat = os.stat(ckpt_path)
    payload = json.dumps({
        "path": os.path.abspath(ckpt_path),
        "size": stat.st_size,
        "mtime": int(stat.st_mtime),
        "cfg": repr(cfg),
        "capture": list(capture_layers),
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def cache_path(ckpt_path: str, cfg: ModelConfig,
               capture_layers: Tuple[int, ...], *,
               cache_dir: Optional[str] = None) -> str:
    """Where ``load_params_cached`` keeps this checkpoint's conversion."""
    cache_dir = cache_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "pnp_ovss_tpu_torch")
    key = _cache_key(ckpt_path, cfg, capture_layers)
    return os.path.join(cache_dir, "params", key + ".pt")


def load_params_cached(ckpt_path: str, cfg: ModelConfig,
                       capture_layers: Tuple[int, ...] = (7,), *,
                       cache_dir: Optional[str] = None, device="cuda",
                       vit_fused: bool = True) -> BlipITM:
    """The port's ``BlipITM`` from a LAVIS checkpoint on ``device``:
    converted (``convert.load_torch_checkpoint``) and cached on the first
    call, read from the cache on later ones."""
    store = cache_path(ckpt_path, cfg, capture_layers, cache_dir=cache_dir)
    if os.path.exists(store):
        log(f"params: cached conversion {store}")
        model = convert.empty_model(cfg, capture_layers, device, vit_fused)
        model.load_state_dict(
            torch.load(store, map_location="cpu", weights_only=True),
            strict=True)
        return model.requires_grad_(False).eval()
    model = convert.load_torch_checkpoint(
        ckpt_path, cfg, capture_layers, device=device, vit_fused=vit_fused)
    os.makedirs(os.path.dirname(store), exist_ok=True)
    tmp = f"{store}.{os.getpid()}.tmp"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, tmp)
    os.replace(tmp, store)
    log(f"params: converted {ckpt_path}, cached at {store}")
    return model
