"""The gradient penalty's weight gradients per step through the convolutions'
own double backward (``count("conv.penalty_wgrad")`` in ``ops.conv.InputGrad``):
one per critic convolution on a step with the penalty. A program without the
counter reads nothing."""

from harness import program_spans


def read(run):
    return program_spans.per_op(run, "train_loop",
                                lambda p, t0, t1: p.counts("conv.penalty_wgrad", t0, t1) or None)
