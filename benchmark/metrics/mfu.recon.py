"""A reconstruct call's share of the card's published peak in the
configuration's precision: the reference forward's counted operations times
the calls of the traced window, over its wall time."""

from harness import yardstick


def read(run):
    if run.kind != "reconstruct" or run.flops_per_op is None:
        return None
    return 100.0 * run.flops_per_op * run.ops / run.window_s / yardstick.peak_flops(run.dtype)
