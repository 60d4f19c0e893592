"""Main segmentation entry point on the card (the port's counterpart of
``pnp_ovss_tpu/cli/segment.py``, the reference's public CLI):

    python -m pnp_ovss_tpu_torch.cli.segment --data_type voc \\
        --home_dir DATA --save_path OUT [--checkpoint model.pth] \\
        [--vocab vocab.txt]

One entry point for every dataset adapter (VOC, Pascal Context, ADE20K, COCO
object and stuff), with the JAX CLI's flags where the port has the feature.
Per-image outputs keep the reference's layout, so Calculate_mIoU-style
offline aggregation (``python -m pnp_ovss_tpu_torch.evalx.aggregate``) and
image-granular resume both work, and the files are interchangeable with
the JAX CLI's:
  {save_path}/hist_withfiltered_caption/img_{id}_max_blocknum_{L}_atthead_{H}.npy
  {save_path}/all_drop_hist_with_filtered_caption/img_{id}_....npy

The batch loop is double buffered: batch N+1 is submitted to the card
before batch N's labels are read, all device work runs on the main thread,
and the host finalize (resize, remap, histogram, files) of batch N runs on
one worker thread on host numpy only. ``--postprocess_backend host`` (the
parity path) adds the grid-resolution maps to what the main thread copies
down, and the worker runs the reference's per-image postprocess at GT
resolution on them (``SegmentationRunner.finalize_image_parity``: numpy and
the native lattice CRF, spread over the host's cores; no device work).
``--device cuda`` (the default)
raises without a card; nothing falls back to the CPU. Flags of features the
port does not have yet raise ``SystemExit`` and name their ROADMAP item.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import glob
import os
import time

import numpy as np


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "pnp-ovss-tpu-torch segmentation", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    # Reference flag surface (scripts :57-106).
    p.add_argument("--img_size", type=int, default=336)
    p.add_argument("--batch_size", type=int, default=35)
    p.add_argument("--max_att_block_num", type=int, default=8)
    p.add_argument("--prune_att_head", type=int, default=9)
    p.add_argument("--drop_iter", type=int, default=4)
    p.add_argument("--del_patch_num", default="sort_thresh005",
                   help="kept for flag parity; 10 patches/round")
    p.add_argument("--sort_threshold", type=float, default=0.05)
    p.add_argument("--threshold", type=float, default=0.15)
    p.add_argument("--postprocess", default="blur+crf",
                   choices=["", "blur", "crf", "blur+crf"])
    p.add_argument("--data_type", required=True,
                   choices=["voc", "psc", "ade20k", "coco_object",
                            "coco_stuff"])
    p.add_argument("--save_path", required=True)
    p.add_argument("--home_dir", required=True)
    p.add_argument("--world_size", type=int, default=1,
                   help="data-parallel processes: this one segments every "
                        "world_size-th image from --rank on")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--distributed", action="store_true",
                   help="not ported (ROADMAP A8)")
    p.add_argument("--mesh", action="store_true",
                   help="not ported (ROADMAP A8)")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="> 1 not ported (ROADMAP A8)")
    p.add_argument("--sequence_parallel", type=int, default=1,
                   help="> 1 not ported (ROADMAP A8)")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="> 1 not ported (ROADMAP A8)")
    p.add_argument("--pp_microbatches", type=int, default=None,
                   help="not ported (ROADMAP A8)")
    p.add_argument("--max_txt_len", type=int, default=128,
                   help="static caption bucket (reference pads to 500)")
    p.add_argument("--checkpoint", default=None,
                   help="LAVIS/BLIP torch checkpoint (.pth) to load; the "
                        "conversion is cached under "
                        "~/.cache/pnp_ovss_tpu_torch")
    p.add_argument("--vocab", default=None,
                   help="bert-base-uncased vocab.txt path")
    p.add_argument("--bucket_size", type=int, default=192,
                   help="device postprocess resolution")
    p.add_argument("--crf_mode", default=None,
                   choices=["strided", "nystrom"],
                   help="device-CRF bilateral approximation (default: "
                        "config strided s=4)")
    p.add_argument("--crf_subsample", type=int, default=None,
                   help="bilateral anchor-grid stride (1 = exact)")
    p.add_argument("--crf_xy_bucket_pixels", action="store_true",
                   help="interpret the CRF spatial stds in raw bucket "
                        "pixels instead of rescaling them per image to "
                        "match the reference's GT-resolution reach")
    p.add_argument("--max_classes", type=int, default=28)
    p.add_argument("--attn_impl", default="pallas",
                   choices=["pallas", "xla"],
                   help="pallas (default): the fused ViT block (kernels "
                        "K1, K2 or K4, K3); xla: the unfused block (the JAX "
                        "package's PNP_VIT_FUSED=0; K2, or K9 for an odd "
                        "head count). Both run hand-written kernels on the "
                        "card")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu "
                        "(the kernels' plain versions, for tests)")
    p.add_argument("--limit", type=int, default=None,
                   help="process only the first N images (debug)")
    p.add_argument("--no_resume", action="store_true",
                   help="recompute even if per-image hist files exist")
    p.add_argument("--postprocess_backend", default="device",
                   choices=["device", "host"],
                   help="device: batched blur + CRF at bucket resolution "
                        "on the card. host: the reference's per-image "
                        "postprocess at exact GT resolution (one bilinear "
                        "resize of the grid maps, blur, the native lattice "
                        "DenseCRF) on the host; slower, parity semantics")
    p.add_argument("--eval_at_bucket", action="store_true",
                   help="compute confusion hists on the device at the "
                        "bucket resolution (nearest-resized GT) instead of "
                        "at exact GT resolution on the host")
    p.add_argument("--record_classification", action="store_true",
                   help="save per-image classification pred/true vectors "
                        "(reference Record_classification_prediction, "
                        "script :958-986)")
    p.add_argument("--viz_ids", default=None,
                   help="comma-separated image ids: dump attention overlays"
                        " and pred-vs-GT renders under {save_path}/viz/ "
                        "(reference script :330-341, :790-807)")
    # Demo mode (reference coco script --in_the_wild :351-384): segment
    # arbitrary images in a directory with a user-given class list; no GT,
    # no metrics — rendered maps are written under {save_path}/viz/.
    p.add_argument("--in_the_wild", action="store_true")
    p.add_argument("--wild_dir", default=None,
                   help="directory of images for --in_the_wild")
    p.add_argument("--wild_classes", default=None,
                   help="comma-separated class names for --in_the_wild "
                        "(reference hard-codes its demo lists :379-384)")
    return p


def reject_unported(args) -> None:
    """Raise ``SystemExit`` for a flag whose feature the port lacks."""
    unported = [flag for flag, on in (
        ("--distributed", args.distributed), ("--mesh", args.mesh),
        ("--tensor_parallel", args.tensor_parallel > 1),
        ("--sequence_parallel", args.sequence_parallel > 1),
        ("--pipeline_parallel", args.pipeline_parallel > 1),
        ("--pp_microbatches", args.pp_microbatches is not None)) if on]
    if unported:
        raise SystemExit(f"{', '.join(unported)}: data, tensor, sequence and "
                         "pipeline parallelism are not ported to the CLI "
                         "yet (ROADMAP A8)")


def run_in_the_wild(args, cfg, runner, tok, meta):
    """Segment a directory of arbitrary images with a fixed class list."""
    from pnp_ovss_tpu_torch.data import transforms
    from pnp_ovss_tpu_torch.text.captions import (
        build_caption_batch, fitted_text_len,
    )
    from pnp_ovss_tpu_torch.utils import viz
    from pnp_ovss_tpu_torch.utils.logging import log

    classes = (args.wild_classes.split(",") if args.wild_classes
               else meta.nms[:2])
    paths = sorted(
        p for p in glob.glob(os.path.join(args.wild_dir, "*"))
        if p.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    if args.limit:
        paths = paths[: args.limit]
    log(f"in-the-wild: {len(paths)} images, classes={classes}")

    bs = cfg.batch_size
    text_len = fitted_text_len([classes], tok,
                               max_text_len=cfg.model.max_text_len)
    for start in range(0, len(paths), bs):
        chunk = paths[start : start + bs]
        raws = [transforms.load_rgb(p) for p in chunk]
        imgs = [transforms.resize_for_model(r, cfg.img_size) for r in raws]
        rgbs = [
            transforms.resize_rgb(r, (runner.bucket, runner.bucket))
            for r in raws
        ]
        pad = bs - len(chunk)
        cap = build_caption_batch(
            [classes] * (len(chunk) + pad), tok, max_text_len=text_len,
            max_classes=cfg.max_classes,
        )
        sizes = [r.shape[:2] for r in raws]
        res = runner.run_batch(
            np.stack(imgs + [imgs[-1]] * pad),
            cap,
            np.stack(rgbs + [rgbs[-1]] * pad).astype(np.float32),
            gt_sizes=sizes + [sizes[-1]] * pad,
        )
        for i, p in enumerate(chunk):
            name = os.path.splitext(os.path.basename(p))[0]
            pred = runner.finalize_image(
                res.labels_agg[i],
                np.arange(1, len(classes) + 1),
                raws[i].shape[:2],
            )
            viz.save_image01(
                os.path.join(args.save_path, "viz", f"wild_{name}.jpeg"),
                viz.render_segmentation(
                    pred, raws[i].astype(np.float32) / 255.0
                ),
            )
    log(f"in-the-wild outputs under {args.save_path}/viz/")


def build_config(args) -> "PipelineConfig":
    from pnp_ovss_tpu_torch.config import (
        AttributionConfig, DropConfig, ModelConfig, PipelineConfig,
        PostprocessConfig, ViTConfig,
    )

    model = ModelConfig(
        vit=ViTConfig(image_size=args.img_size),
        max_text_len=args.max_txt_len,
    )
    post_kw = {}
    if args.crf_mode is not None:
        post_kw["bilateral_mode"] = args.crf_mode
    if args.crf_subsample is not None:
        post_kw["bilateral_subsample"] = args.crf_subsample
    if args.crf_xy_bucket_pixels:
        post_kw["crf_xy_gt_scale"] = False
    post_kw["backend"] = args.postprocess_backend
    return PipelineConfig(
        model=model,
        attribution=AttributionConfig(
            layer=args.max_att_block_num, head=args.prune_att_head
        ),
        drop=DropConfig(num_rounds=args.drop_iter),
        postprocess=PostprocessConfig(mode=args.postprocess, **post_kw),
        data_type=args.data_type,
        batch_size=args.batch_size,
        threshold=args.threshold,
        max_classes=args.max_classes,
    )


def main(argv=None):
    """Run the CLI. Returns None for ``--in_the_wild``, else a summary of
    the run: ``images`` segmented, and per batch its image count
    (``batch_images``), the seconds from the loop's start until its files
    were written (``batch_done_s``) and the seconds its host finalize took
    on the worker thread (``finalize_s``)."""
    args = get_args_parser().parse_args(argv)
    reject_unported(args)

    import torch

    from pnp_ovss_tpu_torch import resolve_device
    from pnp_ovss_tpu_torch.config import NUM_CLASSES
    from pnp_ovss_tpu_torch.data.categories import get_dataset_meta
    from pnp_ovss_tpu_torch.data.datasets import make_dataset, shard_records
    from pnp_ovss_tpu_torch.data.loader import PrefetchLoader
    from pnp_ovss_tpu_torch.evalx.metrics import fast_hist, scores_from_hist
    from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner
    from pnp_ovss_tpu_torch.text.captions import (
        build_caption_batch, fitted_text_len,
    )
    from pnp_ovss_tpu_torch.text.labels import GPTLabelProvider
    from pnp_ovss_tpu_torch.text.wordpiece import WordPieceTokenizer
    from pnp_ovss_tpu_torch.utils.logging import MetricLogger, log

    device = resolve_device(args.device)
    cfg = build_config(args)
    meta = get_dataset_meta(args.data_type)

    # --- tokenizer & labels -------------------------------------------
    if args.vocab:
        tok = WordPieceTokenizer.from_vocab_file(args.vocab)
    else:
        log("WARNING: no --vocab given; using a toy vocab (random-weight "
            "smoke runs only)")
        tok = WordPieceTokenizer.toy(["a", "picture", "of"] + meta.nms)

    gpt_file = f"{args.data_type}_classification_noboundary.json"
    labels = GPTLabelProvider(
        os.path.join(args.home_dir, "GPT4o_classification", gpt_file),
        meta.nms, prob_cutoff=cfg.gpt_prob_cutoff,
    )

    # --- model --------------------------------------------------------
    layer0 = cfg.attribution.layer - 1
    vit_fused = args.attn_impl == "pallas"
    if args.checkpoint:
        from pnp_ovss_tpu_torch.models.cache import load_params_cached

        model = load_params_cached(args.checkpoint, cfg.model, (layer0,),
                                   device=device, vit_fused=vit_fused)
    else:
        log("WARNING: no --checkpoint given; RANDOM weights "
            "(throughput/smoke runs only)")
        model = init_blip_itm(cfg.model, capture_layers=(layer0,), seed=0,
                              device=device, vit_fused=vit_fused)
    runner = SegmentationRunner(cfg, model, device=device,
                                bucket_size=args.bucket_size)

    if args.in_the_wild:
        if not args.wild_dir:
            raise SystemExit("--in_the_wild requires --wild_dir")
        return run_in_the_wild(args, cfg, runner, tok, meta)

    # --- data ---------------------------------------------------------
    ds = make_dataset(args.data_type, args.home_dir)
    records = list(ds.records())
    if args.limit:
        records = records[: args.limit]
    records = shard_records(records, args.rank, args.world_size)
    log(f"{len(records)} images on rank {args.rank}/{args.world_size}")

    # Bucket-resolution hists have different metric semantics than exact-
    # GT-res hists; tag the directories so an offline aggregator can never
    # silently mix the two.
    bucket_tag = f"_bucket{args.bucket_size}" if args.eval_at_bucket else ""
    hist_dir_r0 = os.path.join(
        args.save_path, "hist_withfiltered_caption" + bucket_tag
    )
    hist_dir_agg = os.path.join(
        args.save_path, "all_drop_hist_with_filtered_caption" + bucket_tag
    )
    os.makedirs(hist_dir_r0, exist_ok=True)
    os.makedirs(hist_dir_agg, exist_ok=True)

    def hist_path(d, img_id):
        return os.path.join(
            d,
            f"img_{img_id}_max_blocknum_{cfg.attribution.layer}"
            f"_atthead_{cfg.attribution.head}.npy",
        )

    if not args.no_resume:
        before = len(records)
        records = [
            r for r in records
            if not (os.path.exists(hist_path(hist_dir_r0, r.img_id))
                    and os.path.exists(hist_path(hist_dir_agg, r.img_id)))
        ]
        if len(records) != before:
            log(f"resume: skipping {before - len(records)} done images")

    n_class = NUM_CLASSES[args.data_type]
    totals = {"r0": np.zeros((n_class, n_class)),
              "agg": np.zeros((n_class, n_class))}
    # --eval_at_bucket: the run-total confusion matrices live on the device
    # and are accumulated there; predicted masks never leave the card, only
    # the per-image [C, C] hists come down for the resume files, and one
    # total per rank is written at the end.
    dev_totals = {}

    logger = MetricLogger()
    bs = cfg.batch_size
    parity = cfg.postprocess.backend == "host"
    viz_set = set(args.viz_ids.split(",")) if args.viz_ids else set()
    loader = PrefetchLoader(
        records, batch_size=bs, img_size=cfg.img_size, bucket=runner.bucket,
        keep_raw=parity or bool(viz_set), gt_at_bucket=args.eval_at_bucket,
    )
    hist_fn = runner.make_hist_fn(n_class) if args.eval_at_bucket else None

    def maybe_dump_viz(batch, res, class_idx_lists):
        """Debug artifacts for --viz_ids images (reference :330-341,
        :790-807): per-class attention overlays + pred/GT renders."""
        from pnp_ovss_tpu_torch.data.transforms import resize_rgb
        from pnp_ovss_tpu_torch.utils import viz

        for i, rec in enumerate(batch.records):
            if rec.img_id not in viz_set:
                continue
            idxs = class_idx_lists[i]
            cat_ids = meta.category_ids[idxs]
            names = [meta.nms[j] for j in idxs]
            gt = batch.gts[i]
            h, w = gt.shape[:2]
            image01 = (
                resize_rgb(
                    batch.raw_images[i].astype(np.float32), (h, w)
                ) / 255.0
            )
            pred = runner.finalize_image(res.labels_agg[i], cat_ids, (h, w))
            maps = res.maps_agg[i][: len(names)]
            viz.dump_debug_artifacts(
                args.save_path, rec.img_id, image01, maps, names, pred,
                gt_labels=gt.astype(np.int32),
            )

    def bucket_hists(batch, res, class_idx_lists):
        """Per-image hists on the device and the run totals accumulated
        there. Runs on the main thread, as all device work does. Returns
        {variant: [B, C, C] int32 numpy} of the batch's real rows for the
        worker thread to write; padded rows weigh 0 in the totals."""
        nb = len(batch.records)
        tables = np.zeros((bs, cfg.max_classes + 2), np.int32)
        for i in range(nb):
            cat_ids = meta.category_ids[class_idx_lists[i]]
            tables[i, 1 : len(cat_ids) + 1] = cat_ids
        gtb = np.concatenate(
            [batch.gt_bucket] + [batch.gt_bucket[-1:]] * (bs - nb)
        ).astype(np.int32)
        w = torch.zeros(bs, dtype=torch.int32, device=device)
        w[:nb] = 1
        tables_d = torch.as_tensor(tables, device=device)
        gtb_d = torch.as_tensor(gtb, device=device)
        out = {}
        for variant in ("r0", "agg"):
            labels_b = torch.as_tensor(
                res.labels_r0 if variant == "r0" else res.labels_agg,
                device=device)  # uploaded only under --viz_ids
            hists = hist_fn(labels_b, tables_d, gtb_d)
            total = dev_totals.setdefault(variant, torch.zeros(
                (n_class, n_class), dtype=torch.int32, device=device))
            total += (hists * w[:, None, None]).sum(dim=0).to(torch.int32)
            out[variant] = hists[:nb].cpu().numpy()
        return out

    batch_done_s, finalize_s = [], []
    t_loop = time.perf_counter()

    def parity_preds(batch, res, class_idx_lists, class_valid):
        """{(i, variant): GT-resolution category labels} of the parity
        path. The images' lattice CRFs are independent and release the
        GIL, so they spread over a thread pool; none touches the card."""
        def one(job):
            i, variant = job
            return runner.finalize_image_parity(
                res.grid_r0[i] if variant == "r0" else res.grid_agg[i],
                bool(res.bg_enable[i]), class_valid[i],
                meta.category_ids[class_idx_lists[i]], batch.raw_images[i],
                batch.gts[i].shape[:2], rescale=(variant == "r0"))

        jobs = [(i, v) for i in range(len(batch.records))
                for v in ("r0", "agg")]
        return dict(zip(jobs, parity_pool.map(one, jobs)))

    def finalize_batch(batch, res, class_idx_lists, class_valid,
                       hists_np=None):
        """Host resize/remap/hist/file-IO for one batch (worker thread).
        ``res`` holds host numpy only (``bucket_hists`` did the device
        work on the main thread)."""
        t0 = time.perf_counter()
        if viz_set:
            maybe_dump_viz(batch, res, class_idx_lists)
        if args.eval_at_bucket:
            for variant, hist_dir in (
                ("r0", hist_dir_r0), ("agg", hist_dir_agg),
            ):
                for i, rec in enumerate(batch.records):
                    np.save(hist_path(hist_dir, rec.img_id),
                            hists_np[variant][i])
            finalize_s.append(time.perf_counter() - t0)
            batch_done_s.append(time.perf_counter() - t_loop)
            return
        preds = (parity_preds(batch, res, class_idx_lists, class_valid)
                 if parity else {})
        for i, rec in enumerate(batch.records):
            cat_ids = meta.category_ids[class_idx_lists[i]]
            gt = batch.gts[i]
            if args.record_classification:
                # Binary pred/true vectors over the label set
                # (reference :958-986).
                pred_vec = np.zeros(len(meta.nms), np.int64)
                pred_vec[class_idx_lists[i]] = 1
                gt_ids = [
                    int(v) for v in np.unique(gt)
                    if 0 < v <= len(meta.nms)
                ]
                true_vec = np.zeros(len(meta.nms), np.int64)
                true_vec[[g - 1 for g in gt_ids]] = 1
                for sub, vec in (("classification_pred", pred_vec),
                                 ("classification_true", true_vec)):
                    d = os.path.join(args.save_path, sub)
                    os.makedirs(d, exist_ok=True)
                    np.save(os.path.join(
                        d, f"img_{rec.img_id}.npy"), vec)
            for variant, hist_dir in (("r0", hist_dir_r0),
                                      ("agg", hist_dir_agg)):
                if parity:
                    # Grid maps resized once to GT inside
                    # finalize_image_parity (reference :358-360).
                    pred = preds[i, variant]
                else:
                    labels_b = (res.labels_r0 if variant == "r0"
                                else res.labels_agg)
                    pred = runner.finalize_image(
                        labels_b[i], cat_ids, gt.shape[:2]
                    )
                h = fast_hist(gt.flatten(), pred.flatten(), n_class)
                np.save(hist_path(hist_dir, rec.img_id), h)
                totals[variant] += h
        finalize_s.append(time.perf_counter() - t0)
        batch_done_s.append(time.perf_counter() - t_loop)

    # Double-buffered loop: batch N+1 is submitted (queued on the card)
    # before batch N's labels are read, so the device queue never drains;
    # the host finalize overlaps in a worker thread. (The reference's loop
    # is synchronous per batch, script :213-257.)
    # (batch, PendingBatch, class_idx_lists, class_valid, t_sub)
    in_flight = None
    fin_future = None
    # The parity pool's threads start only when the parity path uses them.
    with cf.ThreadPoolExecutor(1) as finalize_pool, \
            cf.ThreadPoolExecutor(os.cpu_count() or 1) as parity_pool:

        def collect(entry):
            nonlocal fin_future
            b0, pb0, cls0, valid0, t_sub = entry
            t0 = time.perf_counter()
            res0 = pb0.result(
                materialize_labels=not args.eval_at_bucket or bool(viz_set)
            )
            hists_np = None
            if args.eval_at_bucket:
                hists_np = bucket_hists(b0, res0, cls0)
                if not viz_set:  # the worker gets host arrays only
                    res0 = dataclasses.replace(res0, labels_r0=None,
                                               labels_agg=None)
            t_dev = time.perf_counter() - t0
            if fin_future is not None:
                fin_future.result()  # surface worker exceptions, keep order
            fin_future = finalize_pool.submit(
                finalize_batch, b0, res0, cls0, valid0, hists_np
            )
            logger.update(
                device_s=t_dev,
                imgs_per_s=len(b0.records) / max(
                    time.perf_counter() - t_sub, 1e-9
                ),
            )

        # One fitted text length for the whole run (largest caption over
        # all records, rounded to a 64 bucket): the reference pads every
        # caption to 500 tokens; masked positions are inert, so the
        # results are the same at a fraction of the fusion-encoder cost.
        text_len = fitted_text_len(
            [labels.lookup(r.gpt_key)[1] for r in records], tok,
            max_text_len=cfg.model.max_text_len,
        )
        log(f"fitted text length: {text_len} "
            f"(cap {cfg.model.max_text_len})")

        for batch in logger.log_every(loader, 10, header="segment",
                                      total=len(loader)):
            t0 = time.perf_counter()
            class_idx_lists, class_name_lists = [], []
            for rec in batch.records:
                idxs, names = labels.lookup(rec.gpt_key)
                class_idx_lists.append(idxs)
                class_name_lists.append(names)
            # Pad the trailing batch to the static batch size by repeating
            # its last image; padded rows write no file and add no hist.
            pad = bs - len(batch.records)
            cap = build_caption_batch(
                class_name_lists + [class_name_lists[-1]] * pad, tok,
                max_text_len=text_len,
                max_classes=cfg.max_classes,
            )
            images_np = np.concatenate(
                [batch.images] + [batch.images[-1:]] * pad
            )
            rgbs_np = np.concatenate(
                [batch.rgb_bucket] + [batch.rgb_bucket[-1:]] * pad
            )
            # Per-image GT sizes drive the CRF's GT-relative spatial
            # rescaling (ops/crf.py xy_scale); padded rows reuse the last
            # real image's size.
            gt_sizes = [g.shape[:2] for g in batch.gts]
            gt_sizes += [gt_sizes[-1]] * pad
            t_sub = time.perf_counter()
            pending_batch = runner.submit_batch(
                images_np, cap, rgbs_np,
                return_maps=bool(viz_set),
                return_grid_maps=parity,
                gt_sizes=gt_sizes,
            )
            logger.update(host_s=t_sub - t0)

            if in_flight is not None:
                collect(in_flight)
            in_flight = (batch, pending_batch, class_idx_lists,
                         cap.class_valid, t_sub)
        if in_flight is not None:
            collect(in_flight)
        if fin_future is not None:
            fin_future.result()

    if args.eval_at_bucket:
        # One run total per rank, straight off the device, written next to
        # the per-image resume files.
        for variant, total in dev_totals.items():
            totals[variant] = total.cpu().numpy()
            np.save(
                os.path.join(
                    args.save_path,
                    f"total_hist_{variant}{bucket_tag}_rank{args.rank}.npy",
                ),
                totals[variant],
            )

    for name, variant in (("1-drop", "r0"), ("N-drop agg", "agg")):
        total = totals[variant]
        if total.sum() == 0:
            continue
        table = scores_from_hist(total, meta.metric_class_names())
        log(f"== {name} ({args.data_type}, rank {args.rank}) ==")
        for k, v in table.items():
            if k != "Class IoU":
                log(f"  {k}: {v:.4f}")
    return {"images": len(records), "batch_images": [
        len(b) for b in (records[i:i + bs]
                         for i in range(0, len(records), bs))],
        "batch_done_s": batch_done_s, "finalize_s": finalize_s}


if __name__ == "__main__":
    main()
