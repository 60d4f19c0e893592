"""Hyper-parameter search CLI: find the best (layer, head, min_att) (the
port's counterpart of ``pnp_ovss_tpu/cli/search.py``):

    python -m pnp_ovss_tpu_torch.cli.search --data_type voc \\
        --home_dir DATA --save_path OUT --scorer itc [--checkpoint x.pth]

Reference: script :1333-1412, a 34-iteration random-annealing search over
{layer 1..12, head 0..11, min_att 0.05..0.45} maximising the positive-vs-
negative masked-image reward (scaled by token contrast for
``--search Wsupervised``). As in the JAX package, the GradCAM of every
layer and head is captured in ONE forward and backward per image (the
BERT captures all layers of ``--layer``), pooled per class and kept on the
host; each configuration the search visits then scores its masked images.

``--scorer itc`` scores with the BLIP ITC head of the same model (no other
checkpoint; the model scores its own maps). ``--scorer clip``, the
reference's independent CLIP ViT-L-14-336, is not ported yet (ROADMAP
A7b) and raises ``SystemExit``. The model runs on the card unless
``--device cpu``; the ViT encodes run the port's kernels (K1, K2 or K4,
K3 with the fused block).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import numpy as np
import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def ensemble_gradcam_fn(model):
    """All-captured-layer GradCAM of ``model`` (a ``BlipITM`` capturing a
    tuple of layers): fn(images, ids, mask) -> (gradcam [L, B, H, T-1, g,
    g], ITM logits)."""
    from pnp_ovss_tpu_torch.attribution.gradcam import gradcam_from_tap

    grid = model.cfg.vit.grid

    def fn(images, ids, mask):
        return gradcam_from_tap(model, images, ids, mask, grid=grid)

    return fn


def make_itc_scorer(model, *, device):
    """An image-text scorer from the BLIP ITC head (reference :156-175):
    (images [N, H, W, 3] CLIP-normalised, texts, tokenizer, max_text_len)
    -> probs [N, len(texts)], the softmax over texts of the ITC
    similarities at temperature 0.01."""

    def scorer(images: np.ndarray, texts: List[str], tokenizer,
               max_text_len: int) -> np.ndarray:
        ids, masks = [], []
        for t in texts:
            i, m, _ = tokenizer.encode(t, max_length=max_text_len)
            ids.append(i)
            masks.append(m)
        sims = model.itc(
            torch.as_tensor(np.asarray(images, np.float32), device=device),
            torch.as_tensor(np.stack(ids), device=device).long(),
            torch.as_tensor(np.stack(masks), device=device))
        sims = sims.cpu().numpy() / 0.01  # temperature (reference :170)
        e = np.exp(sims - sims.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    return scorer


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "pnp-ovss-tpu-torch search", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_type", required=True)
    p.add_argument("--home_dir", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--layer", default="1-12", help="layer range a-b")
    p.add_argument("--search", default="Wsupervised",
                   choices=["Wsupervised", "Unsupervised"])
    p.add_argument("--n_iter", type=int, default=34)
    p.add_argument("--limit", type=int, default=100,
                   help="images used for the reward")
    p.add_argument("--img_size", type=int, default=336)
    p.add_argument("--checkpoint", default=None,
                   help="LAVIS/BLIP torch checkpoint (.pth)")
    p.add_argument("--vocab", default=None)
    p.add_argument("--scorer", default="clip", choices=["clip", "itc"],
                   help="clip: the reference's independent CLIP ViT-L-14-"
                        "336, not ported yet (ROADMAP A7b); itc: the BLIP "
                        "ITC head of the same model")
    p.add_argument("--clip_checkpoint", default=None,
                   help="CLIP checkpoint for --scorer clip (ROADMAP A7b)")
    p.add_argument("--clip_bpe", default=None,
                   help="CLIP BPE vocab for --scorer clip (ROADMAP A7b)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model (machinery smoke runs and tests)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def load_model(args, cfg, capture, device):
    """The search's ``BlipITM``, capturing every layer of ``capture``:
    from ``--checkpoint``, else random weights from seed 0."""
    from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm
    from pnp_ovss_tpu_torch.utils.logging import log

    if args.checkpoint:
        from pnp_ovss_tpu_torch.models.convert import load_torch_checkpoint

        return load_torch_checkpoint(args.checkpoint, cfg, capture,
                                     device=device)
    log("WARNING: random weights (machinery smoke run)")
    return init_blip_itm(cfg, capture_layers=capture, seed=0, device=device)


def pooled_ensemble(gc_fn, cap, img, device) -> np.ndarray:
    """One image's ensemble GradCAM pooled per class -> [L, H, K, g, g]
    host numpy (K the image's classes)."""
    from pnp_ovss_tpu_torch.ops.segment_pool import pool_token_maps

    gc, _ = gc_fn(torch.as_tensor(img[None], device=device),
                  torch.as_tensor(cap.input_ids, device=device).long(),
                  torch.as_tensor(cap.attention_mask, device=device))
    l, _, h, t, g, _ = gc.shape  # [L, 1, H, T-1, g, g]
    k = int(cap.num_classes[0])
    pool = torch.as_tensor(cap.pool_matrix, device=device)
    pooled = pool_token_maps(pool.expand(l * h, -1, -1),
                             gc[:, 0].reshape(l * h, t, g, g))
    return pooled[:, :k].reshape(l, h, k, g, g).cpu().numpy()


def main(argv=None):
    """Run the search. Returns its summary: ``best`` (layer, head,
    min_att), its ``score``, the visited ``history`` [(point, score)],
    the seconds each image's ensemble GradCAM took (``ensemble_s``) and
    each new configuration's evaluation over every image
    (``evaluation_s``)."""
    args = get_args_parser().parse_args(argv)
    if args.scorer == "clip":
        raise SystemExit("--scorer clip (the independent CLIP reward model "
                         "and its BPE tokenizer) is not ported yet (ROADMAP "
                         "A7b); use --scorer itc")

    from pnp_ovss_tpu_torch import resolve_device
    from pnp_ovss_tpu_torch.config import ModelConfig, ViTConfig
    from pnp_ovss_tpu_torch.data import transforms
    from pnp_ovss_tpu_torch.data.categories import get_dataset_meta
    from pnp_ovss_tpu_torch.data.datasets import make_dataset
    from pnp_ovss_tpu_torch.search.optimizer import run_search
    from pnp_ovss_tpu_torch.search.reward import RewardEvaluator
    from pnp_ovss_tpu_torch.text.captions import (
        build_caption_batch, fitted_text_len,
    )
    from pnp_ovss_tpu_torch.text.wordpiece import WordPieceTokenizer
    from pnp_ovss_tpu_torch.utils.logging import log

    device = resolve_device(args.device)
    cfg = (ModelConfig.tiny() if args.tiny
           else ModelConfig(vit=ViTConfig(image_size=args.img_size)))
    meta = get_dataset_meta(args.data_type)
    lo, hi = (int(x) for x in args.layer.split("-"))
    model = load_model(args, cfg, tuple(range(lo - 1, hi)), device)
    if args.vocab:
        tok = WordPieceTokenizer.from_vocab_file(args.vocab)
    else:
        tok = WordPieceTokenizer.toy(["a", "picture", "of"] + meta.nms)
    gc_fn = ensemble_gradcam_fn(model)

    # Wsupervised scores the ground-truth classes (Dataset.py:231);
    # Unsupervised prefers GPT-proposed classes when the cache exists.
    gpt_provider = None
    if args.search == "Unsupervised":
        gpt_path = os.path.join(
            args.home_dir, "GPT4o_classification",
            f"{args.data_type}_classification_noboundary.json")
        if os.path.exists(gpt_path):
            from pnp_ovss_tpu_torch.text.labels import GPTLabelProvider

            gpt_provider = GPTLabelProvider(gpt_path, meta.nms)

    ds = make_dataset(args.data_type, args.home_dir)
    records = list(ds.records())[: args.limit]
    cache: Dict[str, tuple] = {}
    ensemble_s = []
    for rec in records:
        raw = transforms.load_rgb(rec.image_path)
        if gpt_provider is not None:
            _, names = gpt_provider.lookup(rec.gpt_key)
        else:
            gt = rec.load_gt()
            names = [meta.nms[int(i) - 1] for i in np.unique(gt)
                     if 0 < i < len(meta.nms) + 1]
        if not names:
            continue
        cap = build_caption_batch(
            [names], tok,
            # The fitted 64-bucket text length (same maps, a fraction of
            # the fusion encoder's cost; see cli/segment.py).
            max_text_len=fitted_text_len([names], tok,
                                         max_text_len=cfg.max_text_len),
            max_classes=28)
        # The masked crops are scored at the model's own resolution.
        img = transforms.preprocess_image(raw, cfg.vit.image_size)
        _sync(device)
        t0 = time.perf_counter()
        pooled = pooled_ensemble(gc_fn, cap, img, device)
        ensemble_s.append(time.perf_counter() - t0)
        cache[rec.img_id] = (pooled, cap.class_names[0], img)

    itc_scorer = make_itc_scorer(model, device=device)

    def scorer(images, texts):
        return itc_scorer(images, texts, tok, cfg.max_text_len)

    provided = [0]  # configs scored afresh (not read from a memo file)

    def gradcam_provider(layer, head):
        provided[0] += 1
        for img_id, (pooled, names, img) in cache.items():
            maps = pooled[layer - lo, head]
            if args.search == "Unsupervised":
                # Reference Unsupervised_pn_mask_for_clipsim
                # (Dataset.py:103-163): only the top-salience class's mask
                # is scored, no ground-truth labels used.
                top = int(np.argmax(maps.sum(axis=(1, 2))))
                yield img_id, (maps[top: top + 1], [names[top]], img)
            else:
                yield img_id, (maps, names, img)

    evaluator = RewardEvaluator(
        gradcam_provider, scorer,
        cache_dir=os.path.join(args.save_path,
                               f"Search_{args.search}_{args.data_type}"),
        scale_by_token_contrast=(args.search == "Wsupervised"),
        # Per-image TCSum / TCStd JSONs in the reference's layout
        # (Dataset.py:166-210), next to the reward JSONs.
        token_contrast_dir=os.path.join(args.save_path, "Token_Contrast"),
        device=device)
    evaluation_s = []

    def timed(config):
        before = provided[0]
        t0 = time.perf_counter()
        score = evaluator(config)
        _sync(device)
        if provided[0] != before:
            evaluation_s.append(time.perf_counter() - t0)
        return score

    best, score, history = run_search(
        timed, layers=range(lo, hi + 1), heads=range(cfg.bert.num_heads),
        n_iter=args.n_iter)
    log(f"best config: {best} score {score}")
    return {"best": best, "score": score, "history": history,
            "ensemble_s": ensemble_s, "evaluation_s": evaluation_s}


if __name__ == "__main__":
    main()
