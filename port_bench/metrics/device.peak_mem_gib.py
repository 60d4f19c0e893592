"""The allocator's peak over the window, after a reset that follows the
warm-up (``torch.cuda.max_memory_allocated``), in GiB."""


def read(ctx):
    peak = ctx["memory"]["window_peak_bytes"]
    return peak / 2.0 ** 30 if peak else None
