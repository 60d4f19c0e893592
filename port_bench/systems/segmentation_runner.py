"""The system under test for the segmentation configurations: the port's
``SegmentationRunner`` with BLIP-ITM weights loaded through the LAVIS
path, driven as the CLI drives it (``submit_batch``, then
``PendingBatch.result()``).

For the batches the comparison samples, the adapter keeps what the timed
path itself produced: each drop round's image embeddings (a forward
hook on the ViT), state and GradCAM (a wrapper around the runner's round
step), the bucket-resolution class maps
(``return_maps``, taken off the pending batch before ``result()`` so that
only the labels are copied), and each CRF iteration's state of the
sampled images (wrappers around the CRF module's fused iteration and its
unfused loop's normalised message). The wrappers only keep references:
nothing is computed for the comparison inside the window.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pnp_ovss_tpu_torch.config import (
    AttributionConfig, BertConfig, CRFConfig, DropConfig, ModelConfig,
    PipelineConfig, PostprocessConfig, ViTConfig,
)
from pnp_ovss_tpu_torch.models.convert import from_lavis_state_dict
from pnp_ovss_tpu_torch.ops import _build
from pnp_ovss_tpu_torch.ops import crf as crf_mod
from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner
from pnp_ovss_tpu_torch.text.captions import (
    build_caption_batch, fitted_text_len,
)
from pnp_ovss_tpu_torch.text.wordpiece import WordPieceTokenizer

from port_bench import traffic as traffic_mod
from port_bench import weights

_VIT_KEYS = ("image_size", "patch_size", "hidden_size", "num_layers",
             "num_heads", "mlp_ratio", "layer_norm_eps")
_BERT_KEYS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "intermediate_size", "max_position_embeddings",
              "encoder_width", "layer_norm_eps")


def port_config(model: Dict, pipe: Dict, dtype: str, enc_id: int
                ) -> PipelineConfig:
    """The port's ``PipelineConfig`` of a configuration file."""
    vit = ViTConfig(**{k: model["vit"][k] for k in _VIT_KEYS}, dtype=dtype)
    bert = BertConfig(**{k: model["bert"][k] for k in _BERT_KEYS},
                      enc_token_id=enc_id, dtype=dtype)
    post = pipe["postprocess"]
    return PipelineConfig(
        model=ModelConfig(vit=vit, bert=bert,
                          max_text_len=model["max_text_len"],
                          embed_dim=model["embed_dim"]),
        attribution=AttributionConfig(**pipe["attribution"]),
        drop=DropConfig(**pipe["drop"]),
        postprocess=PostprocessConfig(
            mode=post["mode"], blur_scale=post["blur_scale"],
            crf=CRFConfig(**post["crf"]),
            bilateral_subsample=post["bilateral_subsample"],
            bilateral_mode=post["bilateral_mode"],
            crf_xy_gt_scale=post["crf_xy_gt_scale"]),
        data_type=pipe["data_type"], batch_size=pipe["batch_size"],
        threshold=pipe["threshold"], max_classes=pipe["max_classes"])


@dataclasses.dataclass
class Handle:
    index: int
    pending: object
    t_submit: float
    record: Optional[Dict[str, List[torch.Tensor]]] = None


class System:
    def __init__(self, cfg: Dict, pipe: Dict, pool: traffic_mod.Pool,
                 vocab: Dict[str, int], *, seed: int, device,
                 sample: Dict[int, List[int]]):
        self.cfg, self.pipe, self.pool = cfg, pipe, pool
        self.sample = sample
        self.pcfg = port_config(cfg["model"], pipe, cfg["dtype"],
                                vocab["[ENC]"])
        sd = weights.lavis_state_dict(cfg["model"], seed, device)
        model = from_lavis_state_dict(
            sd, self.pcfg.model,
            capture_layers=(pipe["attribution"]["layer"] - 1,),
            device=device)
        del sd
        self.runner = SegmentationRunner(self.pcfg, model, device=device,
                                         bucket_size=pipe["bucket"])
        tok = WordPieceTokenizer(vocab)
        self.text_len = fitted_text_len(
            pool.class_lists, tok, max_text_len=cfg["model"]["max_text_len"])
        n_batches = len(pool.class_lists) // pool.batch
        self.batches = []
        for j in range(n_batches):
            sl = pool.batch_slice(j)
            cap = build_caption_batch(pool.class_lists[sl], tok,
                                      max_text_len=self.text_len,
                                      max_classes=pipe["max_classes"])
            self.batches.append((pool.images[sl], cap, pool.rgb[sl],
                                 pool.gt_sizes[sl]))
        self._recording: Optional[Dict[str, List[torch.Tensor]]] = None
        real = self.runner._round_step

        def round_step(dropped, images, ids, mask):
            out, gc = real(dropped, images, ids, mask)
            rec = self._recording
            if rec is not None:
                rec["dropped_in"].append(dropped)
                rec["dropped_out"].append(out)
                rec["gradcam"].append(gc)
            return out, gc

        self.runner._round_step = round_step

        def encode_spy(_module, _inputs, out):
            if self._recording is not None:
                self._recording.setdefault("encode", []).append(out)

        self._hook = self.runner.model.visual_encoder.register_forward_hook(
            encode_spy)
        self.kept: Dict[int, Dict[str, object]] = {}
        self._crf_spies()

    def _crf_spies(self) -> None:
        """Keep, for the sampled images, the CRF's input (the blurred maps
        with the disabled channels, as ``mean_field_crf_variants`` gets
        them; the runner runs one CRF an image, in order) and its state of
        each iteration: the fused iteration's output (the materialised
        strided CRF: the states after iterations 1..n), or the state that
        the unfused loop's bilateral message reads (the exact CRF: the
        states before iterations 1..n)."""
        variants = crf_mod.mean_field_crf_variants
        fused, apply = crf_mod.crf_fused_iteration, crf_mod._normalised_apply
        self._crf_real = (variants, fused, apply)

        def store(key: str, value, first: Optional[int] = None):
            rec, img = self._recording, self._crf_image
            if rec is None or img not in self._sampled_now:
                return
            if key == "crf_logits":
                rec.setdefault(key, {})[img] = value
            else:
                rec.setdefault(key, {}).setdefault(img, []).append(value)
                rec["crf_first"] = first

        def variants_spy(logits, *args, **kw):
            self._crf_image += 1
            self._crf_calls = 0
            store("crf_logits", logits)
            return variants(logits, *args, **kw)

        def fused_spy(*args, **kw):
            out = fused(*args, **kw)
            store("crf", out, 1)
            return out

        def apply_spy(fn, q_flat, norm):
            if self._crf_calls % 2 == 0:  # the bilateral message first
                store("crf", q_flat, 0)
            self._crf_calls += 1
            return apply(fn, q_flat, norm)

        crf_mod.mean_field_crf_variants = variants_spy
        crf_mod.crf_fused_iteration = fused_spy
        crf_mod._normalised_apply = apply_spy
        self._crf_image, self._crf_calls = -1, 0
        self._sampled_now: List[int] = []

    # -- the timed path -------------------------------------------------
    def submit(self, index: int) -> Handle:
        t = time.perf_counter()
        images, cap, rgb, gt = self.batches[index % len(self.batches)]
        keep = index in self.sample
        self._recording = {"dropped_in": [], "dropped_out": [],
                           "gradcam": []} if keep else None
        self._sampled_now = self.sample.get(index, [])
        self._crf_image = -1
        pending = self.runner.submit_batch(images, cap, rgb, gt_sizes=gt,
                                           return_maps=keep)
        rec, self._recording = self._recording, None
        if keep:
            rec["maps_r0"] = pending.maps_r0_dev
            rec["maps_agg"] = pending.maps_agg_dev
            pending.maps_r0_dev = pending.maps_agg_dev = None
        return Handle(index, pending, t, rec)

    def collect(self, h: Handle) -> None:
        res = h.pending.result()
        if h.record is not None:
            h.record["labels"] = np.stack([res.labels_r0, res.labels_agg], 1)
            self.kept[h.index] = h.record

    # -- after the window -------------------------------------------------
    def records(self) -> List[Dict[str, object]]:
        """Per sampled image: what the timed path produced for it (host
        tensors), with its place in the pool."""
        out = []
        for b, images in sorted(self.sample.items()):
            rec = self.kept.get(b)
            if rec is None:
                raise RuntimeError(f"sampled window batch {b} never "
                                   "completed")
            base = self.pool.batch_slice(b).start
            for i in images:
                out.append({
                    "pool_index": base + i,
                    "encode": torch.stack([e[i] for e in rec["encode"]])
                    .float().cpu(),
                    "gradcam": torch.stack([g[i] for g in rec["gradcam"]])
                    .float().cpu(),
                    "dropped_in": torch.stack(
                        [d[i] for d in rec["dropped_in"]]).float().cpu(),
                    "dropped_out": torch.stack(
                        [d[i] for d in rec["dropped_out"]]).float().cpu(),
                    "maps_r0": rec["maps_r0"][i].float().cpu(),
                    "maps_agg": rec["maps_agg"][i].float().cpu(),
                    "labels": torch.as_tensor(rec["labels"][i]),
                    "crf_states": torch.stack(
                        [q.float() for q in rec.get("crf", {}).get(i, [])])
                    .cpu() if rec.get("crf", {}).get(i) else
                    torch.zeros((0,)),
                    "crf_first": torch.tensor(rec.get("crf_first", -1)),
                    "crf_logits": rec["crf_logits"][i].float().cpu(),
                })
        return out

    def close(self) -> None:
        (crf_mod.mean_field_crf_variants, crf_mod.crf_fused_iteration,
         crf_mod._normalised_apply) = self._crf_real
        self._hook.remove()
        self.kept.clear()
        self.runner = None
        self.batches = None

    # -- the path's launch counts -------------------------------------------
    def expected_launches(self) -> Dict[str, int]:
        """Launches a batch of every counted kernel on this cell's path:
        the configuration's ViT kernels once per layer and drop round; the
        materialised strided CRF K5 once and K6 once per iteration an
        image; the exact or unmaterialised CRF K8 once per message (the
        degree, then each iteration)."""
        pipe, vit = self.pipe, self.cfg["model"]["vit"]
        want = dict.fromkeys(_build.LAUNCHES, 0)
        for name in self.cfg["vit_kernels"]:
            want[name] += vit["num_layers"] * pipe["drop"]["num_rounds"]
        post, b = pipe["postprocess"], pipe["batch_size"]
        s, iters = post["bilateral_subsample"], post["crf"]["num_iters"]
        n, m = pipe["bucket"] ** 2, (-(-pipe["bucket"] // s)) ** 2
        if s > 1 and post["bilateral_mode"] == "strided" and n * m <= 7e8:
            want["gaussian_kernel_materialize"] = b
            want["crf_fused_iteration"] = b * iters
        else:
            want["gaussian_kernel_matmul"] = b * (iters + 1)
        return want

    @staticmethod
    def reset_launches() -> None:
        _build.reset_launch_counts()

    @staticmethod
    def launches() -> Dict[str, int]:
        return dict(_build.LAUNCHES)
