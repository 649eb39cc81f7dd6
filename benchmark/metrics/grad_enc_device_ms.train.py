"""Device ms per step of Algorithm 1's step in the encoder's gradient pass, through
the critic's x~ feature branch (``step.grad_enc``, inside ``step.d_backward``)."""

from harness import program_spans


def read(run):
    return program_spans.per_op(run, "train_loop", program_spans.device_ms("step.grad_enc"))
