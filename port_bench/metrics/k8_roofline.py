"""K8's share of its roofline: the least time of the exact CRF's launches
over their device time in the trace. An image's least time
(``counting.crf_image_least_s``) counts the channels its inputs enable:
both variants' background (where the data type keeps one) and classes;
the runner pads the rest to the configuration's slots with values of 0.
Every batch holds the same counts of classes (``traffic.py``), so the
traced batches' mean image stands for each traced image."""

from port_bench import counting, devtrace
from port_bench.reference.segment import background_enabled

PATTERN = r"(^|::|\s)matmul_kernel\b"


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    ks = devtrace.matching(tr["kernels"], PATTERN)
    if not ks:
        return None
    pipe = ctx["pipeline"]
    post = pipe["postprocess"]
    iters = post["crf"]["num_iters"]
    n = pipe["bucket"] ** 2
    m = (-(-pipe["bucket"] // post["bilateral_subsample"])) ** 2
    counts = tr["class_counts"]
    per_image = sum(
        counting.crf_image_least_s(
            n, m, iters,
            2 * (k + background_enabled(pipe["data_type"], k)))
        for k in counts) / len(counts)
    images = len(ks) / (iters + 1)
    spent = sum(e - s for _, s, e in ks) * 1e-6
    return 100.0 * per_image * images / spent
