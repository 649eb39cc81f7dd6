"""Device ms per step in the critic's backward, which holds the penalty's
double backward (``step.d_backward``)."""

from harness import program_spans


def read(run):
    return program_spans.per_op(run, "train_loop", program_spans.device_ms("step.d_backward"))
