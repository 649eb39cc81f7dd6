"""Device ms per call in ``inference.reconstruct's forward and MSE (the
program's ``serve.reconstruct`` span)."""

from harness import program_spans


def read(run):
    return program_spans.per_op(run, "reconstruct", program_spans.device_ms("serve.reconstruct"))
