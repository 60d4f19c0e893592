"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's images (ViT encode, BERT forward, GradCAM's backward, every drop
round; ``counting.model_flops_per_image``) over the window's seconds."""

from port_bench import counting


def read(ctx):
    w = ctx["window"]
    if not ctx.get("text_len") or w["seconds"] <= 0:
        return None
    flops = counting.model_flops_per_image(
        ctx["config"]["model"], ctx["pipeline"], ctx["text_len"])
    return 100.0 * flops * w["images"] / w["seconds"] / counting.BF16_FLOPS
