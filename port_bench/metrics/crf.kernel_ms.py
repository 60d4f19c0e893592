"""Device ms a batch of the CRF's kernels by name: K5 + K6 (the
materialised strided CRF) or K8 (the exact CRF)."""

from port_bench import devtrace

PATTERN = r"(^|::|\s)(materialize_kernel|crf_iter_kernel|matmul_kernel)\b"


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    ks = devtrace.matching(tr["kernels"], PATTERN)
    if not ks:
        return None
    return sum(e - s for _, s, e in ks) * 1e-3 / tr["batches"]
