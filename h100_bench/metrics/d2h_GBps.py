"""Device-to-host copy bytes over their time in the traced window (GB/s)."""

from h100_bench.common import trace


def read(w):
    if w.trace is None:
        return None
    nbytes, seconds = trace.d2h(w.trace)
    if seconds <= 0:
        return None
    return nbytes / seconds / 1e9
