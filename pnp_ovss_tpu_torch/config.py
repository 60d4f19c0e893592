"""Configuration tree (the port's copy of ``pnp_ovss_tpu/config.py``).

Only the dataclasses the port's paths read are kept. ``ViTConfig``,
``BertConfig`` and the three CLIP classes keep every field of the JAX
package's, so one converts to the other field for field; the other
classes keep only the fields the path reads. Defaults are the
reference's (Run_seg.sh):

- drop count 10/round        (reference script ``save_len = 10`` at :643)
- CRF constants              (reference script :1036-1041)
- GPT probability cutoff 70  (reference script :764-767)
- blur scale 0.05            (reference script :1149)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT image-encoder hyperparameters (reference vit.py:467-533)."""

    image_size: int = 336
    patch_size: int = 16
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    dtype: str = "bfloat16"  # compute dtype; LayerNorm runs in float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        """Patch tokens + the image CLS token."""
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT fusion-encoder hyperparameters (BLIP med config); every layer
    carries a cross-attention block over the ViT embeddings."""

    vocab_size: int = 30524  # BERT-base 30522 + BLIP's [DEC]/[ENC] tokens
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    encoder_width: int = 1024  # ViT-L hidden size (cross-attn K/V input dim)
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    enc_token_id: int = 30523  # BLIP [ENC] (text/wordpiece.BLIP_ENC_ID)
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """BLIP-ITM assembly (reference blip_image_text_matching.py:19-314)."""

    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    max_text_len: int = 128
    embed_dim: int = 256  # ITC projection dim (blip_itm_large.yaml:23)

    @classmethod
    def tiny(cls) -> "ModelConfig":
        """Small config for unit tests (CPU-runnable, same topology)."""
        return cls(
            vit=ViTConfig(
                image_size=48,
                patch_size=16,
                hidden_size=32,
                num_layers=2,
                num_heads=2,
                dtype="float32",
            ),
            bert=BertConfig(
                vocab_size=256,
                hidden_size=32,
                num_layers=2,
                num_heads=2,
                intermediate_size=64,
                max_position_embeddings=64,
                encoder_width=32,
                enc_token_id=2,
                dtype="float32",
            ),
            max_text_len=16,
            embed_dim=16,
        )


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """OpenAI CLIP vision tower (ViT-L/14-336: the search's independent
    reward model, reference script :1370-1372)."""

    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    embed_dim: int = 768  # projection dim shared with the text tower
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """OpenAI CLIP text tower (causal transformer, BPE vocab 49408)."""

    vocab_size: int = 49408
    context_length: int = 77
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    embed_dim: int = 768
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """CLIP dual encoder (ViT-L-14-336 by default)."""

    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=CLIPVisionConfig)
    text: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)

    @classmethod
    def tiny(cls) -> "CLIPConfig":
        return cls(
            vision=CLIPVisionConfig(
                image_size=28, patch_size=14, hidden_size=32, num_layers=2,
                num_heads=2, embed_dim=16, dtype="float32"),
            text=CLIPTextConfig(
                # Headroom over the toy BPE vocab (512 byte tokens + merges;
                # an id past the table raises in the embedding).
                vocab_size=1024, context_length=16, hidden_size=32,
                num_layers=2, num_heads=2, embed_dim=16, dtype="float32"),
        )


@dataclasses.dataclass(frozen=True)
class DropConfig:
    """Iterative salience drop (reference script :564-722)."""

    num_rounds: int = 4  # --drop_iter
    patches_per_round: int = 10  # save_len=10 (reference script :643)
    # Reference aggregation double-counts round 0 (reference script :716-721).
    double_count_round0: bool = True


@dataclasses.dataclass(frozen=True)
class AttributionConfig:
    """GradCAM source selection (reference :572-574, :619-620)."""

    layer: int = 8  # --max_att_block_num, 1-indexed BERT layer
    head: int = 9  # --prune_att_head, 0-indexed attention head


@dataclasses.dataclass(frozen=True)
class CRFConfig:
    """DenseCRF mean-field constants (reference script :1036-1041)."""

    num_iters: int = 10
    pos_w: float = 7.0
    pos_xy_std: float = 3.0
    bi_w: float = 10.0
    bi_xy_std: float = 50.0
    bi_rgb_std: float = 5.0


@dataclasses.dataclass(frozen=True)
class PostprocessConfig:
    """Blur + CRF selection (reference --postprocess, script :1002-1028).

    ``bilateral_subsample`` is the stride of the bilateral anchor grid
    (1 = the exact CRF). ``bilateral_mode`` "strided" sums the bilateral
    message over the anchors; "nystrom" reconstructs the full kernel
    through them as K_NA (K_AA + ``nystrom_ridge`` I)^-1 K_AN. Every mode
    of the JAX package's device CRF runs (``ops/crf.py``).
    """

    mode: str = "blur+crf"  # "", "blur", "crf", "blur+crf"
    blur_scale: float = 0.05  # sigma = scale * max(H, W) (script :1149)
    crf: CRFConfig = dataclasses.field(default_factory=CRFConfig)
    # "device": blur + CRF batched on the card at the bucket resolution.
    # "host": the parity path, per image in numpy and the native lattice
    # CRF at exact GT resolution (``SegmentationRunner.finalize_image_parity``).
    backend: str = "device"
    bilateral_subsample: int = 4
    bilateral_mode: str = "strided"
    nystrom_ridge: float = 1e-2
    # Scale the CRF's spatial stds per image by (bucket/gt_w, bucket/gt_h)
    # so the bucket-resolution CRF keeps the reference's relative reach.
    crf_xy_gt_scale: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end segmentation pipeline configuration."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    attribution: AttributionConfig = dataclasses.field(
        default_factory=AttributionConfig
    )
    drop: DropConfig = dataclasses.field(default_factory=DropConfig)
    postprocess: PostprocessConfig = dataclasses.field(
        default_factory=PostprocessConfig
    )

    data_type: str = "voc"  # voc | psc | ade20k | coco_object | coco_stuff
    batch_size: int = 35
    threshold: float = 0.15  # mask binarization (--threshold)
    gpt_prob_cutoff: int = 70  # keep GPT classes with prob > this (:764-767)
    max_classes: int = 28  # static padding for ragged per-image class counts
    # Context datasets skip the synthesized background channel when >= this
    # many classes were proposed (reference script :372-379).
    context_background_max_classes: int = 3

    @property
    def img_size(self) -> int:
        return self.model.vit.image_size

    @classmethod
    def reference_default(cls) -> "PipelineConfig":
        """The Run_seg.sh configuration (336px, layer 8 head 9, 4 drops)."""
        return cls()

    @classmethod
    def tiny(cls) -> "PipelineConfig":
        return cls(
            model=ModelConfig.tiny(),
            drop=DropConfig(num_rounds=2, patches_per_round=2),
            batch_size=2,
            max_classes=4,
        )


# Dataset category-count table (background channel included where the
# reference includes it; see Calculate_mIoU.py:23-201).
NUM_CLASSES = {
    "voc": 21,
    "psc": 60,
    "ade20k": 151,
    "coco_object": 91,
    "coco_stuff": 183,
}
