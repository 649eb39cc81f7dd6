"""Images reconstructed in the window over the window's wall time."""


def read(run):
    if run.kind != "reconstruct":
        return None
    return run.ops * run.batch / run.window_s
