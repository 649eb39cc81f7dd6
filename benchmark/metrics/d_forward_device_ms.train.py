"""Device ms per step in the critic's forwards on the real batch and the
fakes and the penalty's forward and input gradient (``step.d_forward``)."""

from harness import program_spans


def read(run):
    return program_spans.per_op(run, "train_loop", program_spans.device_ms("step.d_forward"))
