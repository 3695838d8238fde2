"""Seconds from the process's start to the end of set-up: imports, the
engine, the inputs made on the card, the warm-up job (and, in a checkout's
first run, the kernels' build)."""


def read(run):
    return run.setup_s
