"""Device ms per step in the updates: the gradient and metric exchange, both
optimizers with the clamp, and the EMA (``step.reduce``, ``step.d_update``,
``step.g_update``, ``step.ema``)."""

from harness import program_spans


def read(run):
    return program_spans.per_op(run, "train_loop", program_spans.device_ms(
        "step.reduce", "step.d_update", "step.g_update", "step.ema"))
