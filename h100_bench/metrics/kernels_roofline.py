"""The kernels' share (%) of their memory roofline: the least time the work
needs, input bytes read once and the output stream's bytes written once
at the card's memory rate, over the summed time of every kernel in the
window (copies and memsets aside). The work is counted from what the
jobs asked and produced, not from the rounds or wires of the kernels."""

from h100_bench.common import peaks, trace


def read(w):
    if w.trace is None:
        return None
    seconds = trace.kernel_seconds(w.trace)
    if seconds <= 0:
        return None
    work = sum(j.in_bytes + j.out_bytes for j in w.jobs)
    return 100.0 * work / peaks.HBM_BYTES_PER_S / seconds
