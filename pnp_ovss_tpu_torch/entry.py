"""Entry points of the port (the twin of the repository's
``__graft_entry__.py``): the flagship GradCAM step, and a dry run of the
pipeline over a (data, model) mesh of spawned ranks.

    python -m pnp_ovss_tpu_torch.entry            # the step on the card
    python -m pnp_ovss_tpu_torch.entry dryrun 4   # 4 ranks
    python -m pnp_ovss_tpu_torch.entry dryrun 4 cpu

Both run on the card unless the caller asks for the CPU, and raise when
the card is asked for and there is none.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from pnp_ovss_tpu_torch import resolve_device

LAYER, HEAD = 8, 9  # the reference's --max_att_block_num, --prune_att_head
NMS = ["dog", "cat", "grass", "sky"]
HIST_CLASSES = 5


def entry(device="cuda", *, cfg=None):
    """(fn, args): the GradCAM step of BLIP-ITM-Large (``cfg``, by default
    ``ModelConfig()``: ViT-L/16 at 336 px and the BERT-base fusion
    encoder) with random weights from seed 0, at batch 2 on ``device``:
    one forward and tap backward that gives the layer-8, head-9
    cross-attention GradCAM, the unit of work the salience-drop loop
    repeats. ``fn(*args)`` -> (GradCAM [B, T-1, grid, grid] f32, ITM
    logits [B, 2])."""
    from pnp_ovss_tpu_torch.attribution.gradcam import make_gradcam_fn
    from pnp_ovss_tpu_torch.config import ModelConfig
    from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm

    dev = resolve_device(device)
    cfg = cfg or ModelConfig()
    model = init_blip_itm(cfg, capture_layers=(LAYER - 1,), seed=0,
                          device=dev)
    fn = make_gradcam_fn(model, layer=LAYER, head=HEAD)
    b, t = 2, cfg.max_text_len
    rng = np.random.RandomState(0)
    size = cfg.vit.image_size
    images = torch.as_tensor(rng.rand(b, size, size, 3), dtype=torch.float32,
                             device=dev).to(torch.bfloat16)
    ids = np.zeros((b, t), np.int64)
    mask = np.zeros((b, t), np.int64)
    n = min(12, t)
    ids[:, :n] = rng.randint(3, cfg.bert.vocab_size - 2, (b, n))
    ids[:, 0] = cfg.bert.enc_token_id
    ids[:, n - 1] = 102 % cfg.bert.vocab_size  # [SEP]
    mask[:, :n] = 1
    return fn, (images, torch.as_tensor(ids, device=dev),
                torch.as_tensor(mask, device=dev))


def _tiny_cfg():
    """``PipelineConfig.tiny()`` at __graft_entry__.py's dry-run settings:
    BERT layer 1, head 1, a 2-iteration CRF."""
    from pnp_ovss_tpu_torch.config import (
        CRFConfig, PipelineConfig, PostprocessConfig,
    )

    cfg = PipelineConfig.tiny()
    return dataclasses.replace(
        cfg, attribution=dataclasses.replace(cfg.attribution, layer=1,
                                             head=1),
        postprocess=PostprocessConfig(mode="blur+crf",
                                      crf=CRFConfig(num_iters=2)))


def _fused_cfg(cfg):
    """The smallest configuration on the fused kernels' path (hidden 128,
    2 heads of 64, 192 px: 145 tokens; bf16), __graft_entry__.py's, with
    BERT in bf16 too (the port's linears take their own dtype, where the
    JAX package promotes)."""
    from pnp_ovss_tpu_torch.config import ViTConfig
    from pnp_ovss_tpu_torch.models.vit import fused_path_supported

    vit = ViTConfig(image_size=192, patch_size=16, hidden_size=128,
                    num_layers=2, num_heads=2, dtype="bfloat16")
    if not fused_path_supported(vit):
        raise AssertionError("the dry run's fused config left the fused "
                             "kernels' path")
    model = dataclasses.replace(
        cfg.model, vit=vit,
        bert=dataclasses.replace(cfg.model.bert,
                                 encoder_width=vit.hidden_size,
                                 dtype="bfloat16"))
    return dataclasses.replace(cfg, model=model)


def _rows(x, mesh):
    """This data index's rows of a global batch (as the JAX mesh shards
    the batch over ``data``)."""
    n = len(x) // mesh.data
    return x[mesh.data_rank * n:(mesh.data_rank + 1) * n]


def _dryrun_rank(rank: int, n: int, devices, init_method: str) -> None:
    from torch import distributed as dist

    from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm
    from pnp_ovss_tpu_torch.parallel.mesh import make_mesh_2d
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner
    from pnp_ovss_tpu_torch.text.captions import build_caption_batch
    from pnp_ovss_tpu_torch.text.wordpiece import WordPieceTokenizer

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh_2d(2, devices, rank=rank, init_method=init_method)
    try:
        dev = torch.device(devices[rank])
        cfg = _tiny_cfg()
        tok = WordPieceTokenizer.toy(["a", "picture", "of"] + NMS)
        rng = np.random.RandomState(0)
        b = 2 * n
        cap = build_caption_batch(
            _rows([[NMS[i % 4]] for i in range(b)], mesh), tok,
            max_text_len=cfg.model.max_text_len, max_classes=cfg.max_classes)
        images = rng.rand(b, cfg.img_size, cfg.img_size, 3).astype(np.float32)
        rgb = rng.randint(0, 255, (b, 32, 32, 3)).astype(np.float32)
        # Data parallelism with Megatron tensor parallelism over the model
        # axis: each data index segments its rows of the batch.
        model = init_blip_itm(cfg.model, capture_layers=(0,), seed=0,
                              device=dev)
        runner = SegmentationRunner(cfg, model, device=dev, bucket_size=32,
                                    mesh=mesh)
        bl = b // mesh.data
        res = runner.run_batch(_rows(images, mesh), cap, _rows(rgb, mesh),
                               gt_sizes=[(40, 52)] * bl)
        if res.labels_r0.shape != (bl, 32, 32) or \
                res.labels_agg.shape != (bl, 32, 32):
            raise AssertionError(f"labels {res.labels_agg.shape}")

        # Sequence- and pipeline-parallel legs on the fused kernels' path,
        # the whole pipeline through the per-image confusion matrices.
        fcfg = _fused_cfg(cfg)
        fb = 8
        fcap = build_caption_batch(
            _rows([[NMS[i % 4]] for i in range(fb)], mesh), tok,
            max_text_len=fcfg.model.max_text_len,
            max_classes=fcfg.max_classes)
        fimages = rng.rand(fb, fcfg.img_size, fcfg.img_size, 3).astype(
            np.float32)
        frgb = rng.randint(0, 255, (fb, 32, 32, 3)).astype(np.float32)
        tables = np.tile(np.arange(fcfg.max_classes + 1) % HIST_CLASSES,
                         (fb, 1)).astype(np.int32)
        gt = rng.randint(0, HIST_CLASSES, (fb, 32, 32)).astype(np.int32)
        fbl = fb // mesh.data
        for kind in ("sp", "pp"):
            fmodel = init_blip_itm(fcfg.model, capture_layers=(0,), seed=2,
                                   device=dev)
            r = SegmentationRunner(fcfg, fmodel, device=dev, bucket_size=32,
                                   encode_parallel=kind, mesh=mesh)
            pending = r.submit_batch(_rows(fimages, mesh), fcap,
                                     _rows(frgb, mesh),
                                     gt_sizes=[(40, 52)] * fbl)
            labels = pending.result(materialize_labels=False).labels_agg
            hists = r.make_hist_fn(HIST_CLASSES)(
                labels, torch.as_tensor(_rows(tables, mesh), device=dev),
                torch.as_tensor(_rows(gt, mesh), device=dev))
            if tuple(hists.shape) != (fbl, HIST_CLASSES, HIST_CLASSES):
                raise AssertionError(f"{kind}: hists {tuple(hists.shape)}")
            total = hists.sum().reshape(1).to(torch.int64)
            dist.all_reduce(total, group=mesh.data_axis.group)
            if int(total.item()) != fb * 32 * 32:
                raise AssertionError(f"{kind}: hist sum {int(total.item())}"
                                     f", want {fb * 32 * 32}")
        if rank == 0:
            print(f"dryrun_multichip OK: {n} ranks ({mesh.backend}, "
                  f"data={mesh.data} x model={mesh.model}), batch {b}, "
                  f"labels {res.labels_agg.shape} per data rank; the whole "
                  f"pipeline (attribution -> post -> hist) also under "
                  f"dp={mesh.data} x sp=2 and dp={mesh.data} x pp=2 on the "
                  "fused kernels' path", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device="cuda", *,
                     timeout_s: float = 900.0) -> None:
    """The pipeline over ``n`` spawned ranks, data = n/2 x model = 2
    (__graft_entry__.py's ``dryrun_multichip``): the tiny configuration
    under Megatron tensor parallelism, then sequence- and
    pipeline-parallel legs on the fused configuration, each data index on
    its rows of the batch; the confusion matrices of the fused legs sum,
    over the data group, to every pixel of the batch. ``device``: "cuda"
    gives rank r card r (NCCL) when there are ``n`` cards, else every
    rank card 0 (gloo); "cpu" runs gloo on the CPU. Raises when a rank
    fails or the ranks outlast ``timeout_s``."""
    from pnp_ovss_tpu_torch.parallel.mesh import free_port, spawn

    if n < 2 or n % 2:
        raise ValueError(f"dryrun_multichip needs an even rank count >= 2, "
                         f"got {n}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        devices = ([f"cuda:{r}" for r in range(n)] if cards >= n
                   else [f"cuda:{dev.index or 0}"] * n)
    else:
        devices = ["cpu"] * n
    spawn(_dryrun_rank, n,
          (n, devices, f"tcp://localhost:{free_port()}"),
          timeout_s=timeout_s)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "dryrun":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 4,
                         sys.argv[3] if len(sys.argv) > 3 else "cuda")
    else:
        fn, args = entry()
        gc, logits = fn(*args)
        print(f"entry() OK: gradcam {tuple(gc.shape)}, logits "
              f"{tuple(logits.shape)}")
