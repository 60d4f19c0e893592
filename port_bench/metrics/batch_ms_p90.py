"""The 90th percentile of the batches completed in the window, from the
start of each batch's submit to its labels on the host (host clock;
``statistics.quantiles``, exclusive method)."""

import statistics


def read(ctx):
    lat = ctx["window"]["batch_s"]
    if len(lat) < 10:
        return None
    return 1e3 * statistics.quantiles(lat, n=10)[-1]
