"""Why the full-width labels of a tensor-parallel run cannot be held to
the JAX package's 0.1% bar on random weights (the study behind
chip_smoke.py's TP yardstick).

  python scripts/tp_label_study_torch.py   # one H100; about two minutes

At the reference default (336 px, batch 35, the strided s=4 CRF), with
weights drawn from seed 0 and chip_smoke.py's synthetic inputs, it runs
the fused pipeline, the unfused one (the same weights through the
unfused ViT block: another order of the same sums) and, on two spawned
ranks sharing the card through gloo, the fused one under tensor
parallelism (tp = 2). It prints:

1. each run's label agreement with the fused run (round 0 and the
   aggregate), the quantiles of the fused run's final CRF top-2 margins,
   and the agreement restricted to the pixels whose margin exceeds
   0, 0.1, ..., 0.8: whether confident pixels flip too;
2. for changes of the seeded weights (the ITM head scaled by 2^17 as
   chip_smoke.py's run G does, the BERT cross-attention queries scaled by
   4 or 16, at every layer or the attribution layer only), the unfused
   run's agreement with the fused run, the least relative L1 gap between
   two class maps of an image (mean over images) and the share of
   background labels.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

MARGINS = (0.0, 0.1, 0.2, 0.4, 0.6, 0.8)


def scale(path: str, factor: float, layers=None):
    """A weight change: ``weight *= factor`` of the BERT linear at
    ``path`` (or of the ITM head) in every layer, or in ``layers``."""
    def change(model):
        if path == "itm_head":
            model.itm_head.weight.mul_(factor)
            return
        for i, layer in enumerate(model.text_encoder.layers):
            if layers is None or i in layers:
                mod, name = path.split(".")
                getattr(getattr(layer, mod), name).weight.mul_(factor)
    return change


CHANGES = {
    "seeded": None,
    "ITM head x 2^17": scale("itm_head", 2.0 ** 17),
    "cross-attention query x 4": scale("crossattention.query", 4.0),
    "cross-attention query x 16": scale("crossattention.query", 16.0),
    "cross-attention query x 16, layer 8": scale("crossattention.query",
                                                 16.0, (7,)),
}


class CRFState:
    """Stands in for ``torch`` inside ``ops/crf.py`` and keeps the CRF's
    final state, the argument of its last ``argmax`` ([V, C, N])."""

    def __init__(self):
        self.states = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def argmax(self, x, dim=None, **kw):
        if x.dim() == 3 and dim == 1:
            self.states.append(x.detach().float().cpu())
        return torch.argmax(x, dim=dim, **kw)


def run(change=None, fused: bool = True, mesh=None) -> dict:
    """One batch of the reference default; labels, round-0 maps and the
    CRF's final states [B, V, C, N]."""
    from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm
    from pnp_ovss_tpu_torch.ops import crf as crf_mod
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

    cfg = cs.full_config(336)
    model = init_blip_itm(cfg.model,
                          capture_layers=(cfg.attribution.layer - 1,),
                          seed=0, device="cuda", vit_fused=fused)
    if change is not None:
        with torch.no_grad():
            change(model)
    runner = SegmentationRunner(cfg, model, device="cuda",
                                bucket_size=cs.BUCKET, mesh=mesh)
    images, cap, rgb, gt = cs.synthetic_batch(cfg, cfg.batch_size, cs.BUCKET)
    crf_mod.torch = state = CRFState()
    try:
        res = runner.run_batch(images, cap, rgb, return_maps=True,
                               gt_sizes=gt)
    finally:
        crf_mod.torch = torch
    return dict(labels=(res.labels_r0, res.labels_agg), maps_r0=res.maps_r0,
                q=torch.stack(state.states))


def tp_rank(rank: int, init_method: str, out_dir: str) -> None:
    from pnp_ovss_tpu_torch.parallel.mesh import make_mesh_2d

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh_2d(2, ["cuda:0"] * 2, rank=rank,
                        init_method=init_method)
    try:
        out = run(mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        torch.save(dict(labels=out["labels"]),
                   os.path.join(out_dir, "tp_rank0.pt"))


def class_gap(maps: np.ndarray) -> float:
    """Mean over images of the least relative L1 gap between two of the
    image's three class maps."""
    gaps = []
    for m in maps:
        gaps.append(min(
            np.abs(m[i] - m[j]).mean()
            / max(0.5 * (np.abs(m[i]).mean() + np.abs(m[j]).mean()), 1e-30)
            for i in range(3) for j in range(i + 1, 3)))
    return float(np.mean(gaps))


def main() -> int:
    import tempfile

    from pnp_ovss_tpu_torch.parallel.mesh import free_port, spawn

    if not torch.cuda.is_available():
        print("tp_label_study: needs a card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    ref = run()
    unfused = run(fused=False)
    with tempfile.TemporaryDirectory() as tmp:
        spawn(tp_rank, 2, (f"tcp://localhost:{free_port()}", tmp),
              timeout_s=600)
        tp = torch.load(os.path.join(tmp, "tp_rank0.pt"), weights_only=False)
    q = ref["q"]
    top = q.topk(2, dim=2).values
    margin = (top[:, :, 0] - top[:, :, 1]).numpy()  # [B, V, N]
    b = q.shape[0]
    print("1. labels against the fused run (seeded weights)", flush=True)
    for v, variant in enumerate(("round 0", "aggregate")):
        m = margin[:, v].reshape(b, cs.BUCKET, cs.BUCKET)
        print(f"  {variant}: final CRF top-2 margin quantiles 10/50/90% "
              f"{np.quantile(m, [0.1, 0.5, 0.9]).round(4).tolist()}",
              flush=True)
        for name, other in (("unfused", unfused), ("TP", tp)):
            same = other["labels"][v] == ref["labels"][v]
            cells = [f"> {t}: {same[m > t].mean():.4f} of "
                     f"{(m > t).mean():.4f}" for t in MARGINS]
            print(f"    {name}: agree {same.mean():.4f}; by margin "
                  + ", ".join(cells), flush=True)
    print("2. weight changes: unfused vs fused", flush=True)
    for name, change in CHANGES.items():
        a = ref if change is None else run(change)
        u = unfused if change is None else run(change, fused=False)
        agree = [float((u["labels"][v] == a["labels"][v]).mean())
                 for v in range(2)]
        print(f"  {name}: labels agree r0 {agree[0]:.5f} agg {agree[1]:.5f};"
              f" class-map gap {class_gap(a['maps_r0']):.4f}; background "
              f"{(a['labels'][0] == 0).mean():.4f}", flush=True)
    print(f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
