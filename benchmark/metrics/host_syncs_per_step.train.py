"""Host syncs per step the program counts (``count("host_sync")``: the metric
flush, grids, checkpoints)."""

from harness import program_spans


def read(run):
    return program_spans.per_op(run, "train_loop",
                                lambda p, t0, t1: p.counts("host_sync", t0, t1))
