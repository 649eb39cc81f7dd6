"""Device ms per step in the step's generator forward (the program's
``step.g_forward`` span: its CUDA events, traced runs)."""

from harness import program_spans


def read(run):
    return program_spans.per_op(run, "train_loop", program_spans.device_ms("step.g_forward"))
