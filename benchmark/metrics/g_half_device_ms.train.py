"""Device ms per step in the generator half: the updated critic on the fakes,
the generator's losses and their gradients (``step.g_half``)."""

from harness import program_spans


def read(run):
    return program_spans.per_op(run, "train_loop", program_spans.device_ms("step.g_half"))
