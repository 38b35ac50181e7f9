"""Structured logging and timing spans (copy of ``blt_tpu/utils/logging.py``;
the port logs under ``blt_tpu_torch``).

TPU-native stand-in for the reference's ``tracing`` subsystem
(reference: src/main.rs:83-85 installs a fmt subscriber driven by the
``RUST_LOG`` env filter; spans instrument every pipeline stage,
e.g. blt_core/src/pipeline.rs:148,348 ``info_span!("process_chunk_task")``).

Here the env var is ``BLT_LOG`` (same level names: error/warn/info/debug/trace);
``RUST_LOG`` is also honored for drop-in compatibility. ``trace`` maps to a
custom level below DEBUG. Spans are context managers that log entry/exit with
wall-clock duration at debug level, giving the per-chunk timing the reference
gets from tracing spans.

The span record. While a profiler records on the thread that enters a job
(``job``, which ``cli.main``, ``ByteTokenizer.tokenize_file`` and
``run_tokenizer`` open through ``utils/profiling.job``), every span of that
job, on every thread that works for it, is also kept in a bounded ring
(``snapshot``): name, job id, batch, parent span, thread, and start and end
on ``time.perf_counter_ns()``. The entry thread checks the profiler once a
job; its worker threads take the job from the thread that starts them
(``current`` and ``adopt``). A profiler sees ``record_function`` ranges on
that entry thread only, so the job's own three spans (``job``,
``job.setup``, ``job.finish``) are also ranges named
``blt_tpu_torch.<span>``: each job's ``job`` range and span give one offset
from the record's clock to the trace's. Without a profiler a span costs one
read of the thread's job, and makes no ``record_function`` call.

The multipass loop's spans carry one name on both of its routes (the plain
twin, ``ops/bpe_torch.py``, and the kernel loop, ``ops/multipass_cuda.py``):
``MP_CHUNK``, one chunk's passes until none merges, and inside it
``MP_READ``, the one host read a pass of whether another runs.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": TRACE,
    "off": logging.CRITICAL + 10,
}

_configured = False


def _env_level() -> int:
    raw = os.environ.get("BLT_LOG") or os.environ.get("RUST_LOG") or "error"
    # RUST_LOG supports per-target filters like "blt=debug"; take the last
    # recognizable level token.
    level = logging.ERROR
    for part in raw.replace("=", ",").split(","):
        part = part.strip().lower()
        if part in _LEVELS:
            level = _LEVELS[part]
    return level


def configure() -> None:
    """Install the root handler once, honoring BLT_LOG/RUST_LOG."""
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    root = logging.getLogger("blt_tpu_torch")
    root.addHandler(handler)
    root.setLevel(_env_level())
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    configure()
    return logging.getLogger(
        name if name.startswith("blt_tpu_torch") else f"blt_tpu_torch.{name}"
    )


class Span(NamedTuple):
    """One closed span of the record."""

    id: int
    name: str
    job: int
    batch: Optional[int]  # the item of a stage, or the chunk a write holds
    parent: Optional[int]  # the id of the span open around it on its thread
    thread: int  # ``threading.get_native_id()``, as a profiler's trace names threads
    start_ns: int  # ``time.perf_counter_ns()``
    end_ns: int


# the ring's entries: a 1 GiB job at 16 MiB batches keeps about a thousand
RECORD_SPANS = 1 << 17
# the job's record_function ranges are this prefix and the span's name
RANGE_PREFIX = "blt_tpu_torch."
# the multipass loop's spans, on either route
MP_CHUNK = "mp.chunk"
MP_READ = "mp.read"

_RECORD: "collections.deque[Span]" = collections.deque(maxlen=RECORD_SPANS)
_RECORD_LOCK = threading.Lock()
_THREAD_NAMES: Dict[int, str] = {}
_SPAN_IDS = itertools.count(1)  # next() on a count holds the interpreter lock
_JOB_IDS = itertools.count(1)


class _Thread(threading.local):
    job: Optional[int] = None  # the id of the recording job this thread works for
    phases: Optional[list] = None  # on an entry thread in a job: its open phases

    def __init__(self) -> None:
        self.open: list = []  # (id, batch) of this thread's open spans, innermost last
        self.tid = threading.get_native_id()


_tls = _Thread()


def current() -> Optional[int]:
    """The job this thread records for (None: it records nothing); a
    thread hands it to the workers it starts, which ``adopt`` it."""
    return _tls.job


def adopt(job: Optional[int]) -> None:
    """Record this thread's spans for ``job`` (another thread's ``current``)."""
    _tls.job = job
    if job is not None:
        _THREAD_NAMES[_tls.tid] = threading.current_thread().name


def begin(batch: Optional[int] = None) -> Optional[int]:
    """Open a span on this thread when it records: its id, else None.
    ``batch`` defaults to that of the span open around it."""
    t = _tls
    if t.job is None:
        return None
    if batch is None and t.open:
        batch = t.open[-1][1]
    sid = next(_SPAN_IDS)
    t.open.append((sid, batch))
    return sid


def end(sid: Optional[int], name: str, start_ns: int, end_ns: int) -> None:
    """Close the span ``begin`` opened last on this thread (``sid`` None:
    nothing was opened) into the record."""
    if sid is not None:
        t = _tls
        _, batch = t.open.pop()
        _keep(t, sid, name, batch, start_ns, end_ns)


def record(name: str, start_ns: int, end_ns: int, batch: Optional[int] = None) -> None:
    """A span from readings already taken, inside the span open on this
    thread, when the thread records."""
    t = _tls
    if t.job is not None:
        _keep(t, next(_SPAN_IDS), name, batch, start_ns, end_ns)


def _keep(t: _Thread, sid: int, name: str, batch: Optional[int], start_ns: int,
          end_ns: int) -> None:
    if batch is None and t.open:
        batch = t.open[-1][1]
    s = Span(sid, name, t.job, batch, t.open[-1][0] if t.open else None, t.tid, start_ns, end_ns)
    with _RECORD_LOCK:
        _RECORD.append(s)


def snapshot(reset: bool = False) -> List[Span]:
    """The record's spans, oldest first (and optionally clear it)."""
    with _RECORD_LOCK:
        out = list(_RECORD)
        if reset:
            _RECORD.clear()
    return out


def thread_names() -> Dict[int, str]:
    """The names of the threads that recorded, by native id."""
    return dict(_THREAD_NAMES)


@contextlib.contextmanager
def span(logger: logging.Logger, name: str, batch: Optional[int] = None,
         **fields: Any) -> Iterator[None]:
    """A timing span logged at debug level (tracing-span analog), and kept
    in the record while its thread's job records."""
    t0 = time.perf_counter_ns()
    if batch is not None:
        fields = {"batch": batch, **fields}
    if fields:
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        logger.debug("enter %s %s", name, kv)
    else:
        logger.debug("enter %s", name)
    sid = begin(batch)
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        logger.debug("exit %s duration_ms=%.3f", name, (t1 - t0) / 1e6)
        end(sid, name, t0, t1)


def in_job() -> bool:
    """Whether this thread is inside an entry's ``job``."""
    return _tls.phases is not None


@contextlib.contextmanager
def job(logger: logging.Logger) -> Iterator[None]:
    """One job at an entry: the ``job`` span, under a fresh job id when a
    profiler records on this thread, and its child ``job.setup``, which
    ``setup_done`` closes; ``finishing`` opens ``job.finish``, which runs to
    the end. Entries open it through ``utils/profiling.job``, which lets an
    entry inside a job join it."""
    t = _tls
    import torch

    adopt(next(_JOB_IDS) if torch.autograd._profiler_enabled() else None)
    t.phases = []
    try:
        _open_phase(logger, "job")
        _open_phase(logger, "job.setup")
        yield
    finally:
        while t.phases:
            _close_phase(logger)
        t.phases = None
        t.job = None


def setup_done(logger: logging.Logger) -> None:
    """Close this thread's ``job.setup``, if it is open: at the first
    ``next()`` on the engine's results."""
    p = _tls.phases
    if p and p[-1][0] == "job.setup":
        _close_phase(logger)


def finishing(logger: logging.Logger) -> None:
    """Open ``job.finish`` in this thread's job: after its last result."""
    p = _tls.phases
    if p and p[-1][0] == "job":
        _open_phase(logger, "job.finish")


def _open_phase(logger: logging.Logger, name: str) -> None:
    logger.debug("enter %s", name)
    sid = begin()
    t0 = time.perf_counter_ns()  # next to the range's start: the clocks' offset
    rf = None
    if sid is not None:
        from torch.autograd.profiler import record_function

        rf = record_function(RANGE_PREFIX + name)
        rf.__enter__()
    _tls.phases.append((name, sid, t0, rf))


def _close_phase(logger: logging.Logger) -> None:
    name, sid, t0, rf = _tls.phases.pop()
    if rf is not None:
        rf.__exit__(None, None, None)
    t1 = time.perf_counter_ns()
    logger.debug("exit %s duration_ms=%.3f", name, (t1 - t0) / 1e6)
    end(sid, name, t0, t1)
