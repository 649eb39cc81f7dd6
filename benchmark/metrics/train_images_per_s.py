"""Images of every step completed in the window over the window's wall time,
which ends when the card has finished the last step."""


def read(run):
    if run.kind != "train_loop":
        return None
    return run.ops * run.batch / run.window_s
