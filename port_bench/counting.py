"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM, the
model FLOPs of a segmentation batch, and the least time of the flash
attention and Gaussian-kernel (K8) launches.

A roofline counts the work that a launch's inputs need, whatever
implements it: each input byte read once and each output byte written
once at the memory rate; every product at the bf16 dense tensor-core
rate; element-wise float32 work at the CUDA cores' rate, counting one
operation for an exponent. No rate of the special-function units is
used: NVIDIA publishes none, and another way of taking the exponent would
beat it. Units that run side by side overlap, so the least time is the
largest of the three.
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense tensor-core bf16
F32_FLOPS = 67e12  # CUDA-core float32


def least_s(nbytes: float, products: float, elementwise: float) -> float:
    """The least time of a launch in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, products / BF16_FLOPS,
               elementwise / F32_FLOPS)


# -- model FLOPs ------------------------------------------------------------
def vit_flops(vit: Dict) -> float:
    """One image through the ViT: the patch conv and every block's
    products (qkv, the two attention products, proj, the MLP)."""
    p, d, g = vit["patch_size"], vit["hidden_size"], \
        vit["image_size"] // vit["patch_size"]
    s = g * g + 1
    mlp = d * vit["mlp_ratio"]
    block = 2 * s * d * (3 * d + d + 2 * mlp) + 4 * s * s * d
    return 2 * g * g * (3 * p * p) * d + vit["num_layers"] * block


def bert_flops(bert: Dict, image_tokens: int, text_len: int,
               tap_layer: int) -> float:
    """One image through the BERT fusion encoder and GradCAM's backward.

    Forward, every layer: the self-attention's four projections and two
    products, the cross-attention's query and output projections, the
    key and value projections of the image tokens, its two products, and
    the feed-forward. Backward, gradients to activations only (the
    weights and the image embeddings take none), from the ITM logit down
    to the 0-indexed ``tap_layer``'s cross-attention probabilities: each
    layer above it in full (each projection and feed-forward product once
    more, the self-attention's two products twice, the cross-attention's
    two products, to its query and its probabilities), then the tap
    layer's feed-forward and output projection and the product back to
    its probabilities."""
    t, h, s = text_len, bert["hidden_size"], image_tokens
    e, f = bert["encoder_width"], bert["intermediate_size"]
    self_attn = 2 * t * h * 4 * h + 4 * t * t * h
    cross = 2 * t * h * 2 * h + 2 * s * e * 2 * h + 4 * t * s * h
    ffn = 2 * t * h * 2 * f
    forward = bert["num_layers"] * (self_attn + cross + ffn)
    above = bert["num_layers"] - tap_layer - 1
    per_layer_back = (2 * t * h * 4 * h + 8 * t * t * h
                      + 2 * t * h * 2 * h + 4 * t * s * h + ffn)
    tap = ffn + 2 * t * h * h + 2 * t * s * h
    return forward + above * per_layer_back + tap


def model_flops_per_image(model: Dict, pipe: Dict, text_len: int) -> float:
    """Every drop round's ViT encode, BERT forward and tap backward."""
    vit = model["vit"]
    s = (vit["image_size"] // vit["patch_size"]) ** 2 + 1
    per_round = vit_flops(vit) + bert_flops(
        model["bert"], s, text_len, pipe["attribution"]["layer"] - 1)
    return pipe["drop"]["num_rounds"] * per_round


# -- kernel bounds ----------------------------------------------------------
def flash_least_s(batch: int, heads: int, seq: int, head_dim: int) -> float:
    """Non-causal attention of ``batch`` x ``heads`` heads over ``seq``
    tokens: a bf16 qkv [B, S, 3HD] read and a bf16 [B, S, HD] written; QK^T
    and PV on the tensor cores; one exponent a score."""
    nbytes = 2 * batch * seq * 4 * heads * head_dim
    scores = batch * heads * seq * seq
    return least_s(nbytes, 4.0 * scores * head_dim, scores)


def gaussian_matmul_least_s(n: int, m: int, channels: int,
                            features: int = 5) -> float:
    """m_i = sum_j exp(-||f_i - f_j||^2 / 2) v_j over N x M pairs: f32
    features of both sides and bf16 values [M, C] read, f32 [N, C]
    written; the distance's cross term and the product with the values on
    the tensor cores; one exponent a pair."""
    nbytes = (n + m) * features * 4 + m * channels * 2 + n * channels * 4
    pairs = n * m
    return least_s(nbytes, 2.0 * pairs * (features + channels), pairs)


def crf_image_least_s(n: int, m: int, iters: int, live_channels: int
                      ) -> float:
    """One image's exact CRF through K8: the degree at one channel, then
    each iteration's message at the channels that carry a value (both
    variants' enabled channels; a disabled channel's value is 0)."""
    return gaussian_matmul_least_s(n, m, 1) \
        + iters * gaussian_matmul_least_s(n, m, live_channels)
