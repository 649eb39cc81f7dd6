"""Host time per step of the training loop outside the feed and the step
call: the metric flush and its wait for the card, the schedule."""


def read(run):
    if run.kind != "train_loop" or not run.ops:
        return None
    t0, t1 = run.extra["t0"], run.extra["t1"]
    inside = run.spans.total("feed", t0, t1) + run.spans.total("step", t0, t1)
    return 1e3 * (run.window_s - inside) / run.ops
