"""Set-up: from the process's start to the window's (imports, the kernels'
build or load, the state and the inputs made, the warm-up)."""


def read(run):
    return run.setup_s
