"""End-to-end segmentation runner (counterpart of
``pnp_ovss_tpu/pipeline/runner.py``, with its sequence-parallel encode at
data = 1 and its host parity path; without data, tensor or pipeline
parallelism).

ATTRIBUTION (per batch): salience-drop rounds (pipeline/drop.py: ViT
encode, BERT GradCAM) -> token->class pooling ->
threshold -> bilinear upsample to the bucket resolution, for the round-0
map (rescaled 0-1) and the aggregated map.

POSTPROCESS (per batch): background channel -> blur + per-channel min-max
-> per image, one CRF over both variants (by default kernels K5 and K6; the
exact, unmaterialised and Nystrom CRFs through K8) -> labels.
Disabled channels (padded class slots, and background where the context
rule says so) are driven to -1e30 after the blur.

Work is queued on the device without host synchronisation until
``PendingBatch.result()`` copies the labels back, so holding one pending
batch while submitting the next double-buffers the pipeline. With
``result(materialize_labels=False)`` the labels stay on the device, and
``make_hist_fn`` counts per-image confusion matrices there.

HOST PARITY PATH (``finalize_image_parity``, per image, numpy and the
native lattice CRF, no device work): the grid-resolution thresholded maps
that ``submit_batch(return_grid_maps=True)`` returns, resized ONCE to GT
resolution, then background, blur and the DenseCRF at GT resolution, as
the reference does them. The device postprocess still runs for such a
batch, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pnp_ovss_tpu_torch import resolve_device
from pnp_ovss_tpu_torch.attribution.gradcam import gradcam_from_embeds
from pnp_ovss_tpu_torch.config import PipelineConfig
from pnp_ovss_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from pnp_ovss_tpu_torch.evalx.metrics import batch_hist_t
from pnp_ovss_tpu_torch.models.blip_itm import BlipITM
from pnp_ovss_tpu_torch.ops import crf as crf_mod
from pnp_ovss_tpu_torch.ops.blur import blur_and_minmax
from pnp_ovss_tpu_torch.ops.segment_pool import pool_token_maps
from pnp_ovss_tpu_torch.parallel.mesh import SequenceGroup
from pnp_ovss_tpu_torch.parallel.sequence import encode_images_sp
from pnp_ovss_tpu_torch.pipeline import drop as drop_mod
from pnp_ovss_tpu_torch.pipeline import masks as masks_mod

_DISABLED = -1e30


@dataclasses.dataclass
class BatchResult:
    # [B, Hb, Wb] uint8 channel indices, host numpy; device tensors after
    # ``result(materialize_labels=False)``.
    labels_r0: np.ndarray  # 1-drop
    labels_agg: np.ndarray  # N-drop aggregate
    num_classes: np.ndarray  # [B]
    bg_enable: np.ndarray  # [B] bool
    maps_r0: Optional[np.ndarray] = None  # [B, K, Hb, Wb] with return_maps
    maps_agg: Optional[np.ndarray] = None
    grid_r0: Optional[np.ndarray] = None  # [B, K, g, g] (return_grid_maps)
    grid_agg: Optional[np.ndarray] = None


@dataclasses.dataclass
class PendingBatch:
    """A submitted batch whose device work may still be running."""

    labels_dev: torch.Tensor  # [B, 2, Hb, Wb] uint8 (round-0, aggregate)
    num_classes: np.ndarray
    bg_enable: np.ndarray
    maps_r0_dev: Optional[torch.Tensor] = None
    maps_agg_dev: Optional[torch.Tensor] = None
    grid_r0_dev: Optional[torch.Tensor] = None
    grid_agg_dev: Optional[torch.Tensor] = None

    def result(self, *, materialize_labels: bool = True) -> BatchResult:
        """Copy the results to the host (waits for the device).
        ``materialize_labels=False`` keeps the labels on the device (the
        CLI's ``--eval_at_bucket``, whose histograms are counted there)."""
        labels = (self.labels_dev.cpu().numpy() if materialize_labels
                  else self.labels_dev)

        def opt(x):
            return None if x is None else x.cpu().numpy()

        return BatchResult(
            labels_r0=labels[:, 0], labels_agg=labels[:, 1],
            num_classes=self.num_classes, bg_enable=self.bg_enable,
            maps_r0=opt(self.maps_r0_dev), maps_agg=opt(self.maps_agg_dev),
            grid_r0=opt(self.grid_r0_dev), grid_agg=opt(self.grid_agg_dev))


class SegmentationRunner:
    def __init__(self, cfg: PipelineConfig, model: Optional[BlipITM], *,
                 device="cuda", bucket_size: int = 192,
                 encode_parallel: Optional[str] = None,
                 sp_group: Optional[SequenceGroup] = None):
        """``model``: a ``BlipITM`` whose ``capture_layers`` are
        ``(cfg.attribution.layer - 1,)`` (``init_blip_itm`` or
        ``from_jax_params``); it is moved to ``device``. None makes a
        postprocess-only runner (``_post``, ``finalize_image``,
        ``finalize_image_parity``; the synthetic postprocess gate), whose
        ``submit_batch`` cannot run. Raises when ``device`` is CUDA and
        there is no card.

        ``encode_parallel``: None encodes on this process alone; "sp"
        splits the ViT encode's tokens over ``sp_group``
        (``parallel.mesh.make_mesh_2d``, data = 1): every rank of the
        group runs a runner on the same model and batch, the encode
        gathers K/V across the ranks, and every rank runs BERT, GradCAM,
        the drop loop and the CRF on the whole batch and returns the same
        results. "pp" (pipeline parallelism) is not ported yet."""
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is not None and \
                model.text_encoder.capture_layers != \
                (cfg.attribution.layer - 1,):
            raise ValueError(
                f"model captures BERT layers "
                f"{model.text_encoder.capture_layers}, config asks for "
                f"({cfg.attribution.layer - 1},)")
        if encode_parallel not in (None, "sp", "pp"):
            raise ValueError(f"encode_parallel must be None, 'sp' or 'pp'; "
                             f"got {encode_parallel!r}")
        if encode_parallel == "pp":
            raise NotImplementedError(
                "encode_parallel='pp' (pipeline parallelism) is not ported")
        if (encode_parallel == "sp") != (sp_group is not None):
            raise ValueError("encode_parallel='sp' needs an sp_group "
                             "(parallel.mesh.make_mesh_2d), and an sp_group "
                             "needs encode_parallel='sp'")
        self.bucket = bucket_size
        self._mean = torch.as_tensor(CLIP_MEAN, device=self.device)
        self._std = torch.as_tensor(CLIP_STD, device=self.device)
        self.model = None if model is None else model.to(self.device)
        if model is None:
            return
        if sp_group is None:
            embed = self.model.encode_image
        else:
            def embed(images):
                return encode_images_sp(self.model.visual_encoder, images,
                                        sp_group)
        self._round_step = drop_mod.make_split_round_step(
            embed, self._bert_gradcam,
            cfg=cfg.drop, grid=cfg.model.vit.grid,
            patch_size=cfg.model.vit.patch_size)

    def _to_dev(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _normalize(self, images_u8: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] uint8 -> CLIP-normalised bf16, on the device."""
        x = images_u8.float() / 255.0
        return ((x - self._mean) / self._std).to(torch.bfloat16)

    def _bert_gradcam(self, embeds, ids, mask):
        cfg = self.cfg
        gc, logits = gradcam_from_embeds(self.model, embeds, ids, mask,
                                         grid=cfg.model.vit.grid)
        return gc[0, :, cfg.attribution.head], logits

    def _finish_maps(self, gc0, agg, pool_matrix):
        """Pool + threshold + bucket-upsample both GradCAM variants ->
        ((maps_r0, maps_agg) [B, K, Hb, Wb], (grid_r0, grid_agg) [B, K, g,
        g]). The grid maps (thresholded, before the upsample) are what the
        parity path resizes to GT in one step."""
        out, grids = [], []
        for gc, rescale in ((gc0, True), (agg, False)):
            pooled = pool_token_maps(pool_matrix, gc)
            masked = masks_mod.threshold_maps(pooled, self.cfg.threshold)
            grids.append(masked)
            out.append(masks_mod.upsample_maps(
                masked, self.bucket, self.bucket, rescale=rescale))
        return tuple(out), tuple(grids)

    def _post(self, maps_r0, maps_agg, bg_enable, class_valid, images_rgb,
              xy_scale):
        """maps_* [B, K, Hb, Wb]; bg_enable [B]; class_valid [B, K];
        images_rgb [B, Hb, Wb, 3] uint8; xy_scale [B, 2] -> labels
        [B, 2, Hb, Wb] uint8 (variant 0 = round 0, 1 = aggregate)."""
        cfg = self.cfg
        maps = torch.stack([maps_r0, maps_agg], dim=1)  # [B, 2, K, Hb, Wb]
        hb, wb = maps.shape[-2:]
        maps = torch.where(class_valid[:, None, :, None, None], maps,
                           torch.zeros_like(maps))
        wbg = masks_mod.add_background(maps)  # [B, 2, K+1, Hb, Wb]
        mode = cfg.postprocess.mode
        if "blur" in mode:
            sigma = cfg.postprocess.blur_scale * max(hb, wb)
            wbg = blur_and_minmax(wbg.to(torch.bfloat16), sigma)
        chan_valid = torch.cat([bg_enable[:, None], class_valid], dim=1)
        wbg = torch.where(chan_valid[:, None, :, None, None], wbg,
                          torch.full_like(wbg, _DISABLED))
        if "crf" not in mode:
            return masks_mod.argmax_labels(wbg).to(torch.uint8)
        pp = cfg.postprocess
        labels = [
            crf_mod.mean_field_crf_variants(
                wbg[i], images_rgb[i].float(), pp.crf,
                bilateral_subsample=pp.bilateral_subsample,
                bilateral_mode=pp.bilateral_mode,
                nystrom_ridge=pp.nystrom_ridge, xy_scale=xy_scale[i])
            for i in range(wbg.shape[0])
        ]
        # Channel indices fit in uint8 (max_classes + 1 <= 256).
        return torch.stack(labels).to(torch.uint8)

    def run_batch(self, images, caption_batch, images_rgb_bucket, *,
                  return_maps: bool = False, gt_sizes=None) -> BatchResult:
        """Submit one batch and wait for its results."""
        return self.submit_batch(
            images, caption_batch, images_rgb_bucket,
            return_maps=return_maps, gt_sizes=gt_sizes).result()

    @torch.no_grad()
    def submit_batch(
        self,
        images: np.ndarray,  # [B, S, S, 3] uint8, or normalised float
        caption_batch,  # text.captions.CaptionBatch
        images_rgb_bucket: np.ndarray,  # [B, Hb, Wb, 3] 0-255
        *,
        return_maps: bool = False,
        return_grid_maps: bool = False,
        gt_sizes: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> PendingBatch:
        """Queue one batch on the device. ``return_maps``: keep the
        bucket-resolution maps (viz); ``return_grid_maps``: keep the
        grid-resolution thresholded maps (the parity path).

        gt_sizes: per-image (H, W) of the ground truth; with
        ``crf_xy_gt_scale`` the CRF's spatial stds scale per axis by
        (bucket/gt_w, bucket/gt_h). None keeps bucket-pixel constants."""
        cfg = self.cfg
        n = caption_batch.num_classes
        bg_enable = np.asarray([
            masks_mod.context_includes_background(
                cfg.data_type, int(c),
                max_for_background=cfg.context_background_max_classes)
            for c in n])
        images_np = np.asarray(images)
        if images_np.dtype == np.uint8:
            img = self._normalize(self._to_dev(images_np))
        else:  # pre-normalised float images: bf16, as the model computes
            img = self._to_dev(images_np.astype(np.float32)) \
                .to(torch.bfloat16)
        ids = self._to_dev(caption_batch.input_ids).long()
        mask = self._to_dev(caption_batch.attention_mask)
        gc0, agg = drop_mod.run_drop_rounds(
            self._round_step, img, ids, mask,
            cfg=cfg.drop, num_patches=cfg.model.vit.num_patches)
        (maps_r0, maps_agg), (grid_r0, grid_agg) = self._finish_maps(
            gc0, agg, self._to_dev(caption_batch.pool_matrix))

        b = images_np.shape[0]
        if gt_sizes is not None and cfg.postprocess.crf_xy_gt_scale:
            # (sx, sy) per image: the square bucket resize is anisotropic.
            scale = np.asarray([(self.bucket / w, self.bucket / h)
                                for h, w in gt_sizes], np.float32)
        else:
            scale = np.ones((b, 2), np.float32)
        labels = self._post(
            maps_r0, maps_agg, self._to_dev(bg_enable),
            self._to_dev(caption_batch.class_valid),
            self._to_dev(np.asarray(images_rgb_bucket, np.uint8)),
            self._to_dev(scale))
        return PendingBatch(
            labels_dev=labels, num_classes=np.asarray(n),
            bg_enable=bg_enable,
            maps_r0_dev=maps_r0 if return_maps else None,
            maps_agg_dev=maps_agg if return_maps else None,
            grid_r0_dev=grid_r0 if return_grid_maps else None,
            grid_agg_dev=grid_agg if return_grid_maps else None)

    def make_hist_fn(self, n_class: int):
        """Per-image confusion matrices at bucket resolution, on the
        labels' device: (labels [B, Hb, Wb] channel indices, tables
        [B, >= C + 1] channel -> category id, gt [B, Hb, Wb]) -> [B,
        n_class, n_class] int32 (``evalx.metrics.batch_hist_t``; out-of-range
        GT is not counted)."""

        def hist_fn(labels: torch.Tensor, tables: torch.Tensor,
                    gt: torch.Tensor) -> torch.Tensor:
            b = labels.shape[0]
            pred = torch.gather(tables.long(), 1,
                                labels.reshape(b, -1).long())
            return batch_hist_t(gt, pred, n_class)

        return hist_fn

    def finalize_image(self, labels_bucket: np.ndarray,
                       category_ids: Sequence[int],
                       gt_shape: Tuple[int, int]) -> np.ndarray:
        """Nearest-resize bucket labels to GT resolution (PIL, as the JAX
        package) and remap channels to category ids."""
        from PIL import Image

        h, w = gt_shape
        up = np.asarray(
            Image.fromarray(labels_bucket.astype(np.int32), mode="I")
            .resize((w, h), Image.NEAREST))
        return masks_mod.remap_channels_to_categories(
            up, np.asarray(category_ids, np.int32), include_background=True,
            max_channels=self.cfg.max_classes)

    def finalize_image_parity(
        self,
        maps_grid: np.ndarray,  # [K, g, g] thresholded grid-res class maps
        bg_enable: bool,
        class_valid: np.ndarray,  # [K]
        category_ids: Sequence[int],
        image_rgb_full: np.ndarray,  # [H, W, 3] original image
        gt_shape: Tuple[int, int],
        *,
        rescale: bool = False,  # True for the 1-drop (r0) variant
    ) -> np.ndarray:
        """The parity path, the reference's per-image CPU postprocess: ONE
        bilinear resize of the grid maps to GT resolution (script
        :358-360), Scale_0_1 on the 1-drop variant only (:362 vs :441),
        the background channel (:370), blur + min-max and the native
        permutohedral CRF at GT resolution (:1002-1074), then the remap to
        category ids. Numpy and the lattice only: no device work, so the
        CLI runs it on its finalize worker."""
        from pnp_ovss_tpu_torch.ops import crf_host, host_post

        h, w = gt_shape
        k = int(np.sum(class_valid))
        maps = host_post.resize_bilinear_np(
            np.asarray(maps_grid[:k], np.float32), h, w)
        if rescale:
            maps = host_post.rescale_0_1_np(maps)
        if bg_enable:
            background = (maps.max(axis=0) == 0).astype(np.float32)
            wbg = np.concatenate([background[None], maps], axis=0)
        else:
            wbg = maps
        mode = self.cfg.postprocess.mode
        if "blur" in mode:
            sigma = self.cfg.postprocess.blur_scale * max(h, w)
            wbg = host_post.blur_and_minmax_np(wbg, sigma)
        if "crf" in mode:
            img = np.asarray(image_rgb_full, np.float32)
            if img.shape[:2] != (h, w):
                from pnp_ovss_tpu_torch.data.transforms import resize_rgb

                img = resize_rgb(img, (h, w)).astype(np.float32)
            labels = crf_host.densecrf_labels(wbg, img,
                                              self.cfg.postprocess.crf)
        else:
            labels = np.argmax(wbg, axis=0).astype(np.int32)
        return masks_mod.remap_channels_to_categories(
            labels, np.asarray(category_ids, np.int32),
            include_background=bool(bg_enable),
            max_channels=self.cfg.max_classes)
