"""Set-up: from the process's start to the window's (imports, inputs,
weights, index, kernel builds or loads, warm-up)."""


def read(run):
    return run.setup_s
