"""Pipeline stages and host-to-device upload for the torch engine (port of
``blt_tpu/pipeline/feeder.py``).

``prefetch_iter`` (a generator on a worker thread behind a bounded queue),
its per-stage accounting ``stage_stats`` and the multithreaded ``pack_into``
are copies of the JAX package's, with the spans of ``utils/logging`` and a
byte count a stage added. What changes is the upload
(``upload_owned`` there): each encoder packs into one pinned
host staging buffer, the copy is asynchronous on a side stream, and
``upload`` returns only after a CUDA event recorded after the copy has
completed. So the staging buffer can be refilled at once: without that
wait the next batch would overwrite it while the previous one is still in
flight.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from typing import Iterable, Iterator, TypeVar

import numpy as np
import torch

from blt_tpu_torch.utils.logging import adopt, begin, current, end, get_logger, record, span

T = TypeVar("T")

log = get_logger("feeder")

_SENTINEL = object()

# Per-stage occupancy accounting (chip_smoke.py prints it per leg to
# attribute stalls): for each named stage, cumulative seconds the worker spent
# producing items (src_time, the call that finds the source exhausted
# included), blocked handing off (put_wait), and the consumer spent waiting
# on it (get_wait), with the items and their bytes it handed on. Cheap (a
# few perf_counter calls per *batch*), so always on. Kept in nanoseconds:
# the same readings time the stage's spans (``<stage>.item``, ``.put``,
# ``.get``), whose sums these are.
_STATS_LOCK = threading.Lock()
_STAGE_STATS: dict = {}
_TIMES = ("src_time", "put_wait", "get_wait")


def _account(name: str, items: int = 0, nbytes: int = 0, src_time: int = 0,
             put_wait: int = 0, get_wait: int = 0) -> None:
    # re-resolve the dict each time: stage_stats(reset=True) swaps the
    # registry under live pipelines
    with _STATS_LOCK:
        s = _STAGE_STATS.setdefault(
            name, {"items": 0, "bytes": 0, "src_time": 0, "put_wait": 0, "get_wait": 0})
        s["items"] += items
        s["bytes"] += nbytes
        s["src_time"] += src_time
        s["put_wait"] += put_wait
        s["get_wait"] += get_wait


def stage_stats(reset: bool = False) -> dict:
    """Snapshot (and optionally reset) cumulative per-stage timings, in
    seconds, and the items and bytes each stage handed on."""
    with _STATS_LOCK:
        snap = {k: {f: v / 1e9 if f in _TIMES else v for f, v in st.items()}
                for k, st in _STAGE_STATS.items()}
        if reset:
            _STAGE_STATS.clear()
    return snap


def _nbytes(item) -> int:
    """The bytes of a stage's item: its arrays' and tensors' (a tuple's summed)."""
    if isinstance(item, tuple):
        return sum(_nbytes(x) for x in item)
    if isinstance(item, (bytes, bytearray)):
        return len(item)
    return int(getattr(item, "nbytes", 0))


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_iter(it: Iterable[T], depth: int = 2, name: str = "feeder") -> Iterator[T]:
    """Run ``it`` on a worker thread, yielding up to ``depth`` items ahead.

    Exceptions raised by the source re-raise at the consumer exactly once,
    at the position they occurred (never silently truncating the stream).
    If the consumer abandons the iterator early (generator close), the
    worker is unblocked and exits. The worker records for the consumer's
    job, item ``k`` as the spans' batch.
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    abandoned = threading.Event()
    job = current()
    item_span, put_span, get_span = f"{name}.item", f"{name}.put", f"{name}.get"

    def worker() -> None:
        adopt(job)
        try:
            src = iter(it)
            for k in itertools.count():
                sid = begin(k)
                t0 = time.perf_counter_ns()
                try:
                    item = next(src)
                except StopIteration:
                    item = _SENTINEL
                finally:
                    t1 = time.perf_counter_ns()
                    end(sid, item_span, t0, t1)
                if item is _SENTINEL:
                    _account(name, src_time=t1 - t0)
                    break
                while not abandoned.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                t2 = time.perf_counter_ns()
                record(put_span, t1, t2, k)
                _account(name, 1, _nbytes(item), t1 - t0, t2 - t1)
                if abandoned.is_set():
                    return
        except BaseException as e:  # propagate to consumer
            item = _Failure(e)
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue
            return
        while not abandoned.is_set():
            try:
                q.put(_SENTINEL, timeout=0.1)
                return
            except queue.Full:
                continue

    t = threading.Thread(target=worker, name=f"blt-{name}", daemon=True)
    t.start()
    try:
        for k in itertools.count():
            t0 = time.perf_counter_ns()
            item = q.get()
            t1 = time.perf_counter_ns()
            record(get_span, t0, t1, k)
            _account(name, get_wait=t1 - t0)
            if item is _SENTINEL:
                return
            if isinstance(item, _Failure):
                raise item.exc
            yield item
    finally:
        abandoned.set()


def pack_into(dst, src, threads: int = 0) -> None:
    """Copy ``src`` bytes into the head of ``dst`` (reused padded buffer).

    Uses the native multithreaded copy when built (the host-bandwidth
    analog of the reference's mmap zero-copy feed, io_handler.rs:54-56);
    tail bytes beyond len(src) are left stale — every kernel masks by
    explicit length, so no memset is needed.
    """
    from blt_tpu_torch import native

    n = src.shape[0]
    if n == 0:
        return
    with span(log, "feed.pack"):
        if native.available() and n >= (1 << 22):
            native.copy_into(src, dst, threads if threads > 0 else (os.cpu_count() or 1))
        else:
            dst[:n] = src


def pinned_buffer(nbytes: int, device: torch.device) -> torch.Tensor:
    """A uint8 host staging buffer, pinned when ``device`` is a CUDA device
    (pinned memory is what makes the copy asynchronous)."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=device.type == "cuda")


def upload(buf, device: torch.device, copy_stream=None) -> torch.Tensor:
    """Host buffer -> device tensor that owns its memory.

    ``buf`` is a uint8 host tensor (pinned for an asynchronous copy) or a
    numpy array. Returns once the copy has completed, so the caller may
    reuse ``buf`` at once; the wait covers the copy only, never compute
    queued before it. On a CUDA device the copy runs on ``copy_stream``
    (default: the current stream) and the current stream waits for it.
    """
    host = torch.from_numpy(buf) if isinstance(buf, np.ndarray) else buf
    with span(log, "feed.h2d"):
        if device.type != "cuda":
            return host.to(device, copy=True)
        compute = torch.cuda.current_stream(device)
        copy = copy_stream if copy_stream is not None else compute
        with torch.cuda.stream(copy):
            dev = torch.empty(host.shape, dtype=host.dtype, device=device)
            dev.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        if copy != compute:
            compute.wait_event(done)
            # the allocator must not hand the memory out again while work on
            # the compute stream still reads it
            dev.record_stream(compute)
        done.synchronize()
        return dev
