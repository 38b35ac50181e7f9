"""``torch.profiler`` integration (port of ``blt_tpu/utils/profiling.py``).

Setting ``BLT_PROFILE=<dir>`` wraps each tokenizer job, its set-up
included, in ``torch.profiler.profile`` and writes one Chrome trace
(``blt_trace_<pid>_<ns>.json``) into ``<dir>``: host activity always,
the device's kernels and copies too when the run may use a CUDA device,
and the job's span record (``utils/logging``) on the trace's clock, each
span under the thread that ran it, so the feed, d2h, drain and writer
threads show beside the device. Open it in Perfetto or
``chrome://tracing``. Unset, it costs nothing.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, List

from blt_tpu_torch.utils import logging as spans
from blt_tpu_torch.utils.logging import get_logger

log = get_logger("profiling")

ENV_VAR = "BLT_PROFILE"

# the spans a trace holds already, as record_function ranges
_RANGED = ("job", "job.setup", "job.finish")


@contextlib.contextmanager
def maybe_profile(device=None) -> Iterator[None]:
    """Trace the block under ``torch.profiler`` when ``BLT_PROFILE`` is set;
    ``device`` is the run's ``torch.device`` (None: the host only)."""
    outdir = os.environ.get(ENV_VAR)
    if not outdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"blt_trace_{os.getpid()}_{time.time_ns()}.json")
    since = time.perf_counter_ns()
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    merge_spans(trace, [s for s in spans.snapshot() if s.start_ns >= since])
    with open(path, "w") as f:
        json.dump(trace, f)
    log.info("Wrote the torch.profiler trace %s", path)


def merge_spans(trace: dict, record: List[spans.Span]) -> int:
    """Add the spans of ``record`` to a Chrome trace's events, on the
    trace's clock, each under its own thread: a job's offset is its
    ``blt_tpu_torch.job`` range's start less its ``job`` span's. Returns
    the number of spans added (0 when the jobs and ranges do not pair)."""
    events = trace["traceEvents"]
    ranges = sorted(float(e["ts"]) for e in events  # the host's ranges, not the device's copies
                    if e.get("cat") == "user_annotation" and e.get("name") == spans.RANGE_PREFIX + "job")
    jobs = sorted((s for s in record if s.name == "job"), key=lambda s: s.start_ns)
    if len(ranges) != len(jobs):
        log.warning("%d job ranges in the trace and %d job spans: spans not merged",
                    len(ranges), len(jobs))
        return 0
    offset = {s.job: ts - s.start_ns / 1e3 for ts, s in zip(ranges, jobs)}
    pid = os.getpid()
    added = 0
    for s in record:
        if s.name in _RANGED or s.job not in offset:
            continue
        events.append({"ph": "X", "cat": "blt_span", "name": s.name, "pid": pid, "tid": s.thread,
                       "ts": s.start_ns / 1e3 + offset[s.job], "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"job": s.job, "batch": s.batch, "id": s.id, "parent": s.parent}})
        added += 1
    named = {e.get("tid") for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    names = spans.thread_names()
    for tid in sorted({s.thread for s in record} - named):
        if tid in names:
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": names[tid]}})
    return added


def _trace_device(engine):
    """The device a run on ``engine`` (an engine, its name, or None when not
    known yet) may use: None for the host engine or without a CUDA device."""
    if engine is not None and not isinstance(engine, str):
        return getattr(engine, "device", None)
    if engine == "numpy":
        return None
    import torch

    return torch.device("cuda") if torch.cuda.is_available() else None


@contextlib.contextmanager
def job(logger, engine=None) -> Iterator[None]:
    """One tokenizer job at an entry (``cli.main``,
    ``ByteTokenizer.tokenize_file``, ``run_tokenizer``): its spans
    (``utils/logging.job``) under ``maybe_profile``. An entry inside a job
    joins it, so a run makes one trace."""
    if spans.in_job():
        yield
        return
    device = _trace_device(engine) if os.environ.get(ENV_VAR) else None
    with maybe_profile(device), spans.job(logger):
        yield
