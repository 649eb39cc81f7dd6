"""95th percentile of every call's latency in the window, from its issue to
its synchronised result (``statistics.quantiles``, exclusive method)."""

import statistics


def read(run):
    if run.kind != "reconstruct" or len(run.latencies) < 20:
        return None
    return 1e3 * statistics.quantiles(run.latencies, n=100)[94]
