"""Token-contrast ablation over all layers and heads (the port's
counterpart of ``pnp_ovss_tpu/cli/token_contrast.py``):

    python -m pnp_ovss_tpu_torch.cli.token_contrast --data_type voc \\
        --home_dir DATA --save_path OUT [--checkpoint x.pth]

Reference: ``--cal_token_sim_forall_layerhead`` (script :110-153,
:1414-1436): per (layer, head), the mean cosine similarity between the
per-class token maps, averaged over images into
``Token_Contrast/sum_token_contrast.json``. Low contrast (maps that point
at different regions per class) goes with heads that localise well. The
all-layer GradCAM is captured in one forward and backward per image
(``cli/search.py``'s ensemble), on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch


def token_contrast_all_heads(pooled_maps: np.ndarray) -> np.ndarray:
    """pooled_maps [L, H, K, g, g] per-class maps -> TCSum [L, H]."""
    from pnp_ovss_tpu_torch.search.reward import token_contrast

    l, h, k, g, _ = pooled_maps.shape
    tc, _ = token_contrast(
        torch.as_tensor(pooled_maps).reshape(l * h, k, g, g))
    return tc.cpu().numpy().reshape(l, h)


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(
        "pnp-ovss-tpu-torch token contrast", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_type", required=True)
    p.add_argument("--home_dir", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--limit", type=int, default=100)
    p.add_argument("--img_size", type=int, default=336)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--vocab", default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model (machinery smoke runs and tests)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from pnp_ovss_tpu_torch import resolve_device
    from pnp_ovss_tpu_torch.cli.search import (
        ensemble_gradcam_fn, load_model, pooled_ensemble,
    )
    from pnp_ovss_tpu_torch.config import ModelConfig, ViTConfig
    from pnp_ovss_tpu_torch.data import transforms
    from pnp_ovss_tpu_torch.data.categories import get_dataset_meta
    from pnp_ovss_tpu_torch.data.datasets import make_dataset
    from pnp_ovss_tpu_torch.text.captions import (
        build_caption_batch, fitted_text_len,
    )
    from pnp_ovss_tpu_torch.text.wordpiece import WordPieceTokenizer
    from pnp_ovss_tpu_torch.utils.logging import log

    device = resolve_device(args.device)
    cfg = (ModelConfig.tiny() if args.tiny
           else ModelConfig(vit=ViTConfig(image_size=args.img_size)))
    meta = get_dataset_meta(args.data_type)
    model = load_model(args, cfg, tuple(range(cfg.bert.num_layers)), device)
    tok = (WordPieceTokenizer.from_vocab_file(args.vocab) if args.vocab
           else WordPieceTokenizer.toy(["a", "picture", "of"] + meta.nms))
    gc_fn = ensemble_gradcam_fn(model)

    ds = make_dataset(args.data_type, args.home_dir)
    records = list(ds.records())[: args.limit]
    sums = np.zeros((cfg.bert.num_layers, cfg.bert.num_heads))
    count = 0
    for rec in records:
        raw = transforms.load_rgb(rec.image_path)
        gt = rec.load_gt()
        names = [meta.nms[int(i) - 1] for i in np.unique(gt)
                 if 0 < i < len(meta.nms) + 1]
        if len(names) < 2:
            continue
        cap = build_caption_batch(
            [names], tok,
            max_text_len=fitted_text_len([names], tok,
                                         max_text_len=cfg.max_text_len),
            max_classes=28)
        img = transforms.preprocess_image(raw, cfg.vit.image_size)
        sums += token_contrast_all_heads(
            pooled_ensemble(gc_fn, cap, img, device))
        count += 1

    out_dir = os.path.join(args.save_path, "Token_Contrast")
    os.makedirs(out_dir, exist_ok=True)
    result: Dict[str, float] = {}
    for l in range(sums.shape[0]):
        for h in range(sums.shape[1]):
            result[f"TCSum_layer{l + 1}_head{h}"] = float(
                sums[l, h] / max(count, 1))
    with open(os.path.join(out_dir, "sum_token_contrast.json"), "w") as f:
        json.dump(result, f, indent=2)
    log(f"token contrast over {count} images -> {out_dir}")
    return result


if __name__ == "__main__":
    main()
