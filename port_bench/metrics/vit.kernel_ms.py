"""Device ms a batch of the ViT's own kernels (K1, K2 or K4, K3: the
wgmma GEMM with its epilogues, its LayerNorm pass, the flash kernel), by
name in the trace. The cuBLAS proj at 336 px is left out: its name is
not the ViT's alone."""

from port_bench import devtrace

PATTERN = r"(^|::|\s)(flash_kernel|gemm_kernel|layer_norm_kernel)\b"


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    ks = devtrace.matching(tr["kernels"], PATTERN)
    if not ks:
        return None
    return sum(e - s for _, s, e in ks) * 1e-3 / tr["batches"]
