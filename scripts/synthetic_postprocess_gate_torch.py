"""Synthetic end-to-end postprocess mIoU gate of the PyTorch/CUDA port (the
port's copy of ``scripts/synthetic_postprocess_gate.py``; it imports
neither JAX nor ``pnp_ovss_tpu``).

Every accuracy-relevant approximation of the device postprocess lives
downstream of the model: the bucket resolution with a nearest upsample to
GT, the strided / Nystrom bilateral support, the bf16 blur and CRF state,
and the background channel made at the bucket. This gate measures them end
to end with no model. It builds the JAX gate's photo-like synthetic scenes
from the same seeds (piecewise-region GT, textured RGB, noisy
grid-resolution saliency maps shaped like thresholded GradCAMs) and pushes
the same maps through

  anchor : the host parity path (``SegmentationRunner.
           finalize_image_parity``): ONE bilinear resize of the grid maps
           to GT resolution, f32 blur, the native permutohedral DenseCRF
           at GT resolution: the reference's semantics;
  grid   : the port's device postprocess (``SegmentationRunner._post`` on
           the card at the bucket, then the nearest upsample) over the JAX
           gate's configurations plus the exact CRF (s = 1) at bucket 192,

and reports each configuration's mIoU delta against the anchor, per seed
and as the mean over seeds. The budget is one-sided, as in the JAX gate: a
configuration fails only if its mean delta is below -0.3 mIoU points.
``nystrom_s8_b224`` stays in the list for the record: it fails on the TPU
too (``SYNTH_GATE.json``'s ``failures_mean``).

    python3 scripts/synthetic_postprocess_gate_torch.py --scenes 48 \\
        --seeds 0,1,2,3,4 --out SYNTH_GATE_H100.json

The anchors' lattice CRFs run on a thread pool over the host's cores; the
device configurations run on the card (``--device cuda``, the default) or,
for tests, on the CPU through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

DEVICE_GRID = [
    # (tag, bilateral_mode, subsample, bucket)
    ("strided_s4_b224", "strided", 4, 224),
    ("strided_s2_b224", "strided", 2, 224),
    ("strided_s3_b224", "strided", 3, 224),
    ("strided_s6_b224", "strided", 6, 224),
    ("strided_s4_b192", "strided", 4, 192),  # the CLI's default bucket
    ("strided_s4_b288", "strided", 4, 288),
    ("strided_s4_b336", "strided", 4, 336),
    ("nystrom_s8_b224", "nystrom", 8, 224),  # fails on the TPU too
    ("exact_s1_b192", "strided", 1, 192),  # the exact CRF (K8)
]

SIZES = [(375, 500), (500, 375), (333, 500), (480, 360)]


def make_scene(rng: np.random.RandomState, h: int, w: int, k: int, grid: int):
    """One photo-like scene: GT labels, textured RGB, grid saliency maps
    (the JAX gate's, draw for draw).

    GT: argmax of k+1 smooth random fields (channel 0 = background).
    RGB: per-region base colour + texture noise + illumination gradient.
    Saliency: per-class GT indicator average-pooled to the model grid,
    degraded the way real thresholded GradCAMs are: multiplicative
    amplitude jitter, additive noise, and leakage onto wrong classes.
    """
    lowres = 8
    fields = rng.randn(k + 1, lowres, lowres).astype(np.float32)
    fields = _upsample_bilinear(fields, h, w)
    fields[0] -= 0.35  # background loses ties unless clearly dominant
    gt = np.argmax(fields, axis=0).astype(np.int32)

    colors = rng.randint(30, 226, (k + 1, 3)).astype(np.float32)
    rgb = colors[gt]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb += (xx[..., None] / w - 0.5) * rng.uniform(-40, 40)
    rgb += (yy[..., None] / h - 0.5) * rng.uniform(-40, 40)
    rgb += rng.randn(h, w, 3).astype(np.float32) * 12.0
    rgb = np.clip(rgb, 0, 255)

    maps = np.zeros((k, grid, grid), np.float32)
    ys = np.linspace(0, h, grid + 1).astype(int)
    xs = np.linspace(0, w, grid + 1).astype(int)
    for c in range(1, k + 1):
        ind = (gt == c).astype(np.float32)
        pooled = np.add.reduceat(
            np.add.reduceat(ind, ys[:-1], axis=0), xs[:-1], axis=1
        )
        area = np.maximum(
            np.outer(np.diff(ys), np.diff(xs)).astype(np.float32), 1.0
        )
        m = pooled / area
        m *= rng.uniform(0.6, 1.0)                      # amplitude jitter
        m += np.abs(rng.randn(grid, grid)) * 0.08       # saliency noise
        m += rng.uniform(0.0, 0.06) * (np.max(maps, axis=0)
                                       if c > 1 else 0.0)  # class leakage
        maps[c - 1] = m
    return gt, rgb, maps


def _upsample_bilinear(x: np.ndarray, h: int, w: int) -> np.ndarray:
    from pnp_ovss_tpu_torch.ops.host_post import resize_bilinear_np

    return resize_bilinear_np(x, h, w)


def make_scenes(seed: int, n: int, max_k: int, grid: int) -> list:
    """[((gt, rgb, maps), (h, w), k)] of one seed, in the JAX gate's
    order of draws."""
    rng = np.random.RandomState(seed)
    scenes = []
    for i in range(n):
        h, w = SIZES[i % len(SIZES)]
        k = int(rng.randint(2, max_k + 1))
        scenes.append((make_scene(rng, h, w, k, grid), (h, w), k))
    return scenes


def threshold_grid(maps_k: np.ndarray, k: int, cfg) -> np.ndarray:
    """The pipeline's threshold at grid resolution, padded to
    ``max_classes`` channels: what the anchor resizes grid -> GT in one
    step and the device path upsamples to the bucket."""
    import torch

    from pnp_ovss_tpu_torch.pipeline import masks as masks_mod

    grid = cfg.model.vit.grid
    padded = np.zeros((1, cfg.max_classes, grid, grid), np.float32)
    padded[0, :k] = maps_k
    t = masks_mod.threshold_maps(torch.from_numpy(padded), cfg.threshold)
    return t[0].numpy()


def anchor_labels(runner, scenes, tgrids, workers: int) -> list:
    """The host parity path's GT-resolution labels of every scene, the
    lattice CRFs spread over ``workers`` threads."""
    kmax = runner.cfg.max_classes

    def one(args):
        tg, ((gt, rgb, maps), (h, w), k) = args
        return runner.finalize_image_parity(
            tg, True, np.arange(kmax) < k, list(range(1, k + 1)), rgb,
            (h, w), rescale=False)

    with cf.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(one, zip(tgrids, scenes)))


def device_labels(runner, scenes, tgrids) -> list:
    """The device postprocess's GT-resolution labels of every scene: the
    grid maps upsampled to the bucket, ``_post`` on the runner's device,
    the aggregate variant's labels nearest-resized to GT."""
    import torch

    from pnp_ovss_tpu_torch.data.transforms import resize_rgb
    from pnp_ovss_tpu_torch.pipeline import masks as masks_mod

    cfg, dev, bucket = runner.cfg, runner.device, runner.bucket
    out = []
    for tg, ((gt, rgb, maps), (h, w), k) in zip(tgrids, scenes):
        mb = masks_mod.upsample_maps(torch.from_numpy(tg)[None].to(dev),
                                     bucket, bucket, rescale=False)
        rgb_b = resize_rgb(rgb, (bucket, bucket))
        if cfg.postprocess.crf_xy_gt_scale:
            scale = [[bucket / w, bucket / h]]
        else:
            scale = [[1.0, 1.0]]
        labels = runner._post(
            mb, mb, torch.tensor([True], device=dev),
            torch.as_tensor(np.arange(cfg.max_classes) < k,
                            device=dev)[None],
            torch.tensor(rgb_b, device=dev)[None],
            torch.tensor(scale, dtype=torch.float32, device=dev))
        out.append(runner.finalize_image(labels[0, 1].cpu().numpy(),
                                         list(range(1, k + 1)), (h, w)))
    return out


def miou(preds, scenes, n_class: int) -> float:
    from pnp_ovss_tpu_torch.evalx.metrics import fast_hist, scores_from_hist

    hist = np.zeros((n_class, n_class), np.int64)
    for pred, ((gt, _, _), _, _) in zip(preds, scenes):
        hist += fast_hist(gt.flatten(), pred.flatten(), n_class)
    names = [str(i) for i in range(n_class)]
    return float(scores_from_hist(hist, names)["Mean IoU"])


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def run_gate(*, scenes: int = 48, seeds=(0, 1, 2, 3, 4), max_k: int = 6,
             budget: float = 0.3, configs=None, device="cuda",
             workers=None, log=print) -> dict:
    """Run the gate; returns the JSON payload (per seed mIoU, per config
    deltas in points, their mean and range, failures)."""
    from pnp_ovss_tpu_torch import resolve_device
    from pnp_ovss_tpu_torch.config import PipelineConfig
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

    dev = resolve_device(device)
    workers = workers or os.cpu_count() or 1
    base_cfg = PipelineConfig()  # reference constants (threshold, CRF)
    n_class = max_k + 1
    grid = [c for c in DEVICE_GRID if configs is None or c[0] in configs]
    anchor_runner = SegmentationRunner(base_cfg, None, device="cpu")
    runners = {}
    for tag, mode, sub, bucket in grid:
        cfg = dataclasses.replace(base_cfg, postprocess=dataclasses.replace(
            base_cfg.postprocess, bilateral_mode=mode,
            bilateral_subsample=sub))
        runners[tag] = SegmentationRunner(cfg, None, device=dev,
                                          bucket_size=bucket)
    log(f"[synth-gate] {scenes} scenes x seeds {list(seeds)}, device {dev}"
        f", {workers} anchor threads")
    by_seed, seconds = {}, {"anchor": 0.0}
    for seed in seeds:
        sc = make_scenes(seed, scenes, max_k, base_cfg.model.vit.grid)
        tgrids = [threshold_grid(maps, k, base_cfg)
                  for (_, _, maps), _, k in sc]
        t0 = time.perf_counter()
        anchor = miou(anchor_labels(anchor_runner, sc, tgrids, workers), sc,
                      n_class)
        seconds["anchor"] += time.perf_counter() - t0
        by_seed[seed] = {"anchor_host": anchor}
        log(f"[synth-gate] seed {seed} anchor (host, GT-res lattice CRF) "
            f"mIoU={anchor:.4f} [{time.perf_counter() - t0:.1f}s]")
        for tag, *_ in grid:
            t0 = time.perf_counter()
            m = miou(device_labels(runners[tag], sc, tgrids), sc, n_class)
            seconds[tag] = seconds.get(tag, 0.0) + time.perf_counter() - t0
            by_seed[seed][tag] = m
            log(f"[synth-gate] seed {seed} {tag}: mIoU={m:.4f} delta="
                f"{(m - anchor) * 100:+.3f} pts "
                f"[{time.perf_counter() - t0:.1f}s]")
    stats, failures, marginal = {}, [], []
    for tag, *_ in grid:
        deltas = [(by_seed[s][tag] - by_seed[s]["anchor_host"]) * 100
                  for s in seeds]
        mean = float(np.mean(deltas))
        lo, hi = float(np.min(deltas)), float(np.max(deltas))
        ok, worst_ok = mean >= -budget, lo >= -budget
        stats[tag] = {"deltas_pts": [round(d, 3) for d in deltas],
                      "mean_pts": round(mean, 3),
                      "range_pts": [round(lo, 3), round(hi, 3)],
                      "pass_mean": ok, "pass_worst_seed": worst_ok}
        if not ok:
            failures.append(tag)
        elif not worst_ok:
            marginal.append(tag)
        log(f"[synth-gate] {tag}: mean {mean:+.3f} pts, range "
            f"[{lo:+.3f}, {hi:+.3f}] over {len(seeds)} seeds "
            f"{'PASS' if ok else 'FAIL'}")
    return {
        "scenes": scenes, "seeds": list(seeds), "device": str(dev),
        "budget_pts": budget, "miou_by_seed": by_seed, "stats": stats,
        "failures_mean": failures, "marginal_worst_seed": marginal,
        "seconds": {k: round(v, 3) for k, v in seconds.items()},
        "anchor_threads": workers,
        "note": "synthetic scenes; measures only the device postprocess "
                "(bucket, bilateral support, bf16, background at the "
                "bucket) against the single-resample GT-resolution host "
                "anchor (the native permutohedral lattice CRF), not model "
                "accuracy. One-sided: a config fails if its mean delta "
                "over seeds is below -budget.",
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scenes", type=int, default=48)
    p.add_argument("--max_k", type=int, default=6)
    p.add_argument("--seeds", default="0,1,2,3,4",
                   help="comma-separated scene-distribution seeds; the "
                        "verdict is the mean over seeds")
    p.add_argument("--budget", type=float, default=0.3)
    p.add_argument("--configs", default=None,
                   help="comma-separated subset of config tags to run")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    t0 = time.perf_counter()
    payload = run_gate(
        scenes=args.scenes, seeds=[int(s) for s in args.seeds.split(",")],
        max_k=args.max_k, budget=args.budget,
        configs=set(args.configs.split(",")) if args.configs else None,
        device=args.device)
    payload["wall_s"] = round(time.perf_counter() - t0, 3)
    if payload["device"].startswith("cuda"):
        import torch

        payload["card"] = card_line()
        payload["card_name"] = torch.cuda.get_device_name(0)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"[synth-gate] wrote {args.out}")
    print(f"[synth-gate] mean-delta verdict over {len(payload['seeds'])} "
          f"seeds: failures={payload['failures_mean']} "
          f"marginal={payload['marginal_worst_seed']} "
          f"({payload['wall_s']:.1f} s)")
    return payload


if __name__ == "__main__":
    main()
