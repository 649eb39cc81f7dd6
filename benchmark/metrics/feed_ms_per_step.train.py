"""Host time per step inside the loader's ``next()``."""


def read(run):
    if run.kind != "train_loop" or not run.ops:
        return None
    return 1e3 * run.spans.total("feed", run.extra["t0"], run.extra["t1"]) / run.ops
