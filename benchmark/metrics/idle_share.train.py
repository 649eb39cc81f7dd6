"""One minus the union of the card's busy intervals over the traced training
window."""


def read(run):
    if run.kind != "train_loop" or run.trace is None:
        return None
    return 100.0 * run.trace.idle_share
