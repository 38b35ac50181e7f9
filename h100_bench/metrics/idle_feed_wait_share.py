"""The share (%) of the traced window in which the device is idle (no
kernel, copy or memset) while the stage after the feed waits on it (a
``feed.get`` span is open), the spans put on the trace's clock by each
job's offset (``common/spans.py``). Prints the offsets' spread over the
window's jobs to standard error."""

import sys

from h100_bench.common import spans, trace


def read(w):
    record = spans.window_spans(w)
    off = spans.offsets(w, record) if record is not None else None
    if off is None:
        return None
    t = w.trace
    lo, hi = t.window
    waits = trace.merged(spans.on_trace(record, off, "feed.get"), lo, hi)
    if not waits:
        return None
    busy = trace.merged(t.device_intervals(), lo, hi)
    idle_waiting = sum(b - a for a, b in waits) - spans.overlap_us(waits, busy)
    print(f"idle_feed_wait_share: {len(off)} jobs, the span clock's offset to the trace's "
          f"spreads {max(off.values()) - min(off.values()):.3f} us", file=sys.stderr)
    return 100.0 * idle_waiting / (hi - lo)
