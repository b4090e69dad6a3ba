"""Seconds from the process's start to the window's: imports, the kernel
library (built on a checkout's first run), frames, weights, the program and
the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
