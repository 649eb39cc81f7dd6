"""Device ms per step of Algorithm 1's step in the prior sample's draw and its
training decode, x_p = Dec(z_p) (``step.prior_decode``, inside
``step.g_forward``)."""

from harness import program_spans


def read(run):
    return program_spans.per_op(run, "train_loop", program_spans.device_ms("step.prior_decode"))
