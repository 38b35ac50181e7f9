"""The share (%) of the traced window in which nothing ran on the device:
no kernel, copy or memset."""

from h100_bench.common import trace


def read(w):
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(w.trace) / w.trace.window_s)
