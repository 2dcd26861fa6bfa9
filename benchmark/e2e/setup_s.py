"""``setup_s``: seconds from the process's start to the window's start:
imports, the card's start, the rooms written, the kernels built or loaded
and the warm room."""


def value(run):
    return run["setup_s"]
