"""The flash attention kernel's share of its roofline: the least time of
a launch at the cell's shape (``counting.flash_least_s``: the ViT's
batch, heads, tokens and head size) over its mean device time a launch
in the trace."""

from port_bench import counting, devtrace

PATTERN = r"(^|::|\s)flash_kernel\b"


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    ks = devtrace.matching(tr["kernels"], PATTERN)
    if not ks:
        return None
    vit = ctx["config"]["model"]["vit"]
    seq = (vit["image_size"] // vit["patch_size"]) ** 2 + 1
    least = counting.flash_least_s(
        ctx["pipeline"]["batch_size"], vit["num_heads"], seq,
        vit["hidden_size"] // vit["num_heads"])
    spent = sum(e - s for _, s, e in ks) * 1e-6
    return 100.0 * least * len(ks) / spent
