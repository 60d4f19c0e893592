"""The share of the window in which no kernel runs: one less the device's
busy time a batch (the union of kernel intervals over the traced stretch
of whole batches, by batch) over the wall time a batch of the window's
untraced batches (host clock). Tracing slows the host's dispatch, so the
traced stretch's own wall time would read the profiler's cost."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["kernels"] or tr["untraced_batch_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["batches"]
                    / tr["untraced_batch_s"])
