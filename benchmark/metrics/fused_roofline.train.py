"""The five hand-written kernels' bound time at their call sites in the
training window over their device time in the trace."""

from harness import yardstick


def read(run):
    if run.kind != "train_loop" or run.trace is None:
        return None
    return yardstick.fused_roofline(run.launches, run.trace.kernels)
