"""The program's span record, as the metric readers see it.

``blt_tpu_torch.utils.logging`` keeps the spans of every job that runs
while a profiler records on the thread that enters it (the ``--trace 1``
run): name, job, batch, parent, thread, and start and end on
``time.perf_counter_ns()``, the clock the window and its jobs are read on.
Each job is also a ``record_function`` range, ``blt_tpu_torch.job``, in the
trace: the window's job spans and job ranges, paired in order, give each
job the offset from the record's clock to the trace's.

The readers import nothing of the program (``run.py`` alone loads it): the
record is read from the program's module as the run loaded it. A run that
did not load it (the control), a program without the record (a parent
commit) or a run without the profiler gives no spans, and the readers
return None.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

RECORD_MODULE = "blt_tpu_torch.utils.logging"
JOB_RANGE = "blt_tpu_torch.job"


def window_spans(w) -> Optional[list]:
    """The record's spans inside the window, or None if there are none."""
    snapshot = getattr(sys.modules.get(RECORD_MODULE), "snapshot", None)
    if snapshot is None:
        return None
    lo, hi = w.start * 1e9, w.jobs[-1].end * 1e9
    out = [s for s in snapshot() if lo <= s.start_ns and s.end_ns <= hi]
    return out or None


def share(w, name: str) -> Optional[float]:
    """The summed seconds of the window's ``name`` spans over the window's
    seconds (%), or None if the window holds none."""
    spans = [s for s in window_spans(w) or () if s.name == name]
    if not spans:
        return None
    return 100.0 * sum(s.end_ns - s.start_ns for s in spans) / 1e9 / w.seconds


def offsets(w, spans: list) -> Optional[Dict[int, float]]:
    """Each job's offset (microseconds) from the record's clock to the
    trace's: its range's start less its span's. None without a trace, or
    when the window's job spans and ranges do not pair one to one."""
    if w.trace is None:
        return None
    lo, hi = w.trace.window
    ranges = sorted(ts for name, ts, _, _ in w.trace.host if name == JOB_RANGE and lo <= ts <= hi)
    jobs = sorted((s for s in spans if s.name == "job"), key=lambda s: s.start_ns)
    if not jobs or len(ranges) != len(jobs):
        return None
    return {s.job: ts - s.start_ns / 1e3 for ts, s in zip(ranges, jobs)}


def on_trace(spans: list, off: Dict[int, float], name: str) -> List[Tuple[float, float]]:
    """The ``name`` spans as intervals on the trace's clock (microseconds)."""
    return [(s.start_ns / 1e3 + off[s.job], s.end_ns / 1e3 + off[s.job])
            for s in spans if s.name == name and s.job in off]


def overlap_us(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Microseconds that two sorted lists of disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
