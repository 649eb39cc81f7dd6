"""Host time per step inside the step call (it never waits for the card)."""


def read(run):
    if run.kind != "train_loop" or not run.ops:
        return None
    return 1e3 * run.spans.total("step", run.extra["t0"], run.extra["t1"]) / run.ops
