"""Host time per call inside ``inference.reconstruct``, before the wait."""


def read(run):
    if run.kind != "reconstruct" or not run.ops:
        return None
    return 1e3 * run.spans.total("reconstruct", run.extra["t0"], run.extra["t1"]) / run.ops
