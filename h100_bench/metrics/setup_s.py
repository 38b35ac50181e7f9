"""Seconds from the process's start to the first timed job (host clock):
imports, CUDA start, the inputs and table from the seed, the program's
library from the checkout's cache (its build, in a checkout's first run),
the warm-up job."""


def read(w):
    return w.setup_s
