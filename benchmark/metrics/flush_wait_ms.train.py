"""Host ms per step in the metric flush's copy to the host, which waits for
the step's work on the card (the program's ``metrics.copy`` span)."""

from harness import program_spans


def read(run):
    return program_spans.per_op(run, "train_loop",
                                lambda p, t0, t1: p.host_ms("metrics.copy", t0, t1))
