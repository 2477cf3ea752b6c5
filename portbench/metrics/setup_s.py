"""setup_s: seconds from the process's start until the window opens: the
imports, the card, the kernels' build or load, the blob pool and the
cell's warm-up calls (graph captures, tables)."""


def read(run):
    return run.setup_s
