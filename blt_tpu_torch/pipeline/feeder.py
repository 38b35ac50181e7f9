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

A batch of a file mapping (``np.memmap`` and its slices: an input given by
path) skips the staging copy on a CUDA device: ``MappedWindows`` page-locks
the window of the mapping that holds it and the copy engine reads it there.
Every other input (stdin, in-memory bytes, the sharded engine's rows, a CPU
device, a window CUDA refuses to register) is packed into staging as before.
"""

from __future__ import annotations

import itertools
import mmap
import os
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterable, Iterator, NamedTuple, Optional, TypeVar

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


def count(name: str, items: int = 0, nbytes: int = 0) -> None:
    """Add ``items`` and their ``nbytes`` to the counter ``name`` that
    ``stage_stats`` reports beside the stages."""
    _account(name, items, nbytes)


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


def _close(src, name: str) -> None:
    """Close a stage's source generator on the worker's own thread, so one
    left mid-stream (the consumer abandoned it) releases what it holds, such
    as the feed's registered windows, now and not when it is collected."""
    close = getattr(src, "close", None)
    if close is None:
        return
    try:
        close()
    except Exception:  # no consumer is left to raise to
        log.exception("closing the %s stage's source failed", name)


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
        src = None
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
        finally:
            _close(src, name)
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
    explicit length, so no memset is needed. Counted under ``feed.staged``
    in ``stage_stats`` (items: batches, bytes: their input bytes).
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
    _account("feed.staged", 1, n)


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
    if device.type != "cuda":
        with span(log, "feed.h2d"):
            return host.to(device, copy=True)
    return _copy_in(host.shape, host.dtype, device, copy_stream,
                    lambda dev: dev.copy_(host, non_blocking=True))


def _copy_in(shape, dtype, device: torch.device, copy_stream, copy) -> torch.Tensor:
    """A new device tensor that ``copy(dev)`` fills from the host; returns
    once that copy has completed, as ``upload`` does."""
    with span(log, "feed.h2d"):
        if device.type != "cuda":
            dev = torch.empty(shape, dtype=dtype, device=device)
            copy(dev)
            return dev
        compute = torch.cuda.current_stream(device)
        stream = copy_stream if copy_stream is not None else compute
        with torch.cuda.stream(stream):
            dev = torch.empty(shape, dtype=dtype, device=device)
            done = torch.cuda.Event()
            try:
                copy(dev)
            finally:
                # whatever was enqueued has finished before the host memory
                # it reads is reused or unregistered
                done.record(stream)
                done.synchronize()
        if stream != compute:
            compute.wait_event(done)
            # the allocator must not hand the memory out again while work on
            # the compute stream still reads it
            dev.record_stream(compute)
        return dev


# --- the direct upload of a mapped input -------------------------------------

# A window of a mapping spans this many bytes from the page that holds the
# batch that opens it (or the batch, if longer), clipped to the mapping: a
# job's first batch waits on one window's registration, not the whole file's.
WINDOW_BYTES = 64 << 20
PAGE_BYTES = mmap.PAGESIZE


def _align_page(n: int) -> int:
    return -(-n // PAGE_BYTES) * PAGE_BYTES


def _mapping(data: np.ndarray) -> Optional[mmap.mmap]:
    """The mapping at the root of ``data``'s views (``np.memmap`` and its
    slices: a file read by path), or None for any other memory."""
    base = data
    while isinstance(base, np.ndarray):
        base = base.base
    return base if isinstance(base, mmap.mmap) else None


class CudaHostCalls:
    """The three CUDA calls of the direct upload (``csrc/host_map.cu`` in
    the port's CUDA library): the one seam the CPU tests stand in for."""

    def __init__(self) -> None:
        from blt_tpu_torch.ops import _cuda_build

        self._lib = _cuda_build.load()
        self._check = _cuda_build.check

    def register(self, ptr: int, nbytes: int) -> bool:
        """Page-lock ``[ptr, ptr + nbytes)`` for the card, read-only; False
        when CUDA refuses."""
        err = self._lib.blt_host_register(ptr, nbytes)
        if err:
            log.debug("cudaHostRegister of %d bytes failed: CUDA error %d", nbytes, err)
        return err == 0

    def unregister(self, ptr: int) -> None:
        self._check(self._lib.blt_host_unregister(ptr), "cudaHostUnregister")

    def copy(self, dst: torch.Tensor, src: int, nbytes: int) -> None:
        """Enqueue the copy of ``nbytes`` at host address ``src`` into the
        head of ``dst`` on the current stream."""
        stream = torch.cuda.current_stream(dst.device).cuda_stream
        self._check(self._lib.blt_h2d(dst.data_ptr(), src, nbytes, stream), "cudaMemcpyAsync")


def host_calls(device: torch.device) -> Optional[CudaHostCalls]:
    """The calls of the direct upload to ``device``: None (every batch
    takes the staging copy) unless it is a CUDA device."""
    return CudaHostCalls() if device.type == "cuda" else None


class _Window(NamedTuple):
    lo: int  # page-aligned host address
    hi: int
    whole: np.ndarray  # the mapping's bytes, held open while registered
    ok: Optional[Future]  # the registration made ahead (True: registered)

    def covers(self, ptr: int, n: int) -> bool:
        return self.lo <= ptr and ptr + n <= self.hi


class MappedWindows:
    """The windows of a job's mapped input registered with the card.

    A batch that lies in a file mapping goes to the device by one
    asynchronous copy from the mapping itself (``upload``): the window of
    the mapping that holds it is page-locked, read-only, and each batch's
    copy completes before ``upload`` returns. A window opened for a batch
    starts at the page of its first byte; the next one, which starts where
    it ends, is registered ahead on a thread of its own, and a window is
    unregistered there once the feed has moved past it. So at most two
    windows are registered at once, and the feed waits on a registration
    only where the thread ahead has not finished it. ``close`` (a feed's
    ``with``) unregisters what is left, whether the job finished, raised,
    or was abandoned.

    ``stage_stats`` counts ``feed.direct`` (items: batches, bytes: input
    bytes) and ``feed.register_failed`` (items: windows CUDA refused;
    their batches take the staging copy and count as ``feed.staged``).
    """

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.calls = host_calls(self.device)
        self._window: Optional[_Window] = None  # serving batches now
        self._ahead: Optional[_Window] = None  # the next one, registered ahead
        self._refused: Optional[_Window] = None
        self._behind: list = []  # unregistrations on the thread ahead
        self._thread: Optional[ThreadPoolExecutor] = None

    def __enter__(self) -> "MappedWindows":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        try:
            self._release()
        finally:
            if self._thread is not None:
                self._thread.shutdown()
                self._thread = None

    def upload(self, data: np.ndarray, size: int, copy_stream=None) -> Optional[torch.Tensor]:
        """``data`` in the head of a new uint8 device tensor of ``size``
        bytes (the tail stale), copied from its mapping; None when it must
        take the staging copy (no mapping, no CUDA device, a refused
        window). Returns once the copy has completed."""
        if self.calls is None or data.shape[0] == 0:
            return None
        mapping = _mapping(data)
        if mapping is None:
            return None
        ptr, n = data.ctypes.data, data.shape[0]
        # the host work that makes the batch readable by the copy engine:
        # a range check, and for a batch that opens a window its
        # registration (what is left of it, when made ahead)
        with span(log, "feed.pack"):
            covered = self._cover(mapping, ptr, n)
        if not covered:
            return None
        _account("feed.direct", 1, n)
        return _copy_in((size,), torch.uint8, self.device, copy_stream,
                        lambda dev: self.calls.copy(dev, ptr, n))

    def _cover(self, mapping: mmap.mmap, ptr: int, n: int) -> bool:
        """Whether a registered window holds ``[ptr, ptr + n)``: the one
        serving batches, the one registered ahead, or else a window
        registered here from the page of ``ptr``."""
        if self._window is not None and self._window.covers(ptr, n):
            return True
        if self._refused is not None and self._refused.covers(ptr, n):
            return False
        if self._ahead is not None and self._ahead.covers(ptr, n):
            # every copy from the window before has completed (``upload``
            # waits): it is unregistered behind, on the thread ahead
            if self._window is not None:
                self._behind.append(self._thread.submit(self.calls.unregister, self._window.lo))
            w, self._window, self._ahead = self._ahead, None, None
        else:
            # a batch outside both: settle them, then open its own window
            self._release()
            whole = np.frombuffer(mapping, np.uint8)
            base = whole.ctypes.data
            lo = base + (ptr - base) // PAGE_BYTES * PAGE_BYTES
            hi = min(base + _align_page(whole.shape[0]),
                     lo + _align_page(max(WINDOW_BYTES, ptr + n - lo)))
            w = _Window(lo, hi, whole, None)
        with span(log, "feed.register"):
            ok = self.calls.register(w.lo, w.hi - w.lo) if w.ok is None else w.ok.result()
        if not ok:
            self._refused = w
            _account("feed.register_failed", 1)
            return False
        self._window = w
        end = w.whole.ctypes.data + _align_page(w.whole.shape[0])
        if w.hi < end:
            if self._thread is None:
                self._thread = ThreadPoolExecutor(1, thread_name_prefix="blt-register")
            hi = min(end, w.hi + WINDOW_BYTES)
            self._ahead = _Window(w.hi, hi, w.whole,
                                  self._thread.submit(self.calls.register, w.hi, hi - w.hi))
        return True

    def _release(self) -> None:
        """Unregister every window, once the thread ahead has finished."""
        behind, self._behind = self._behind, []
        ahead, self._ahead = self._ahead, None
        window, self._window = self._window, None
        for done in behind:
            done.result()
        if ahead is not None and ahead.ok.result():
            self.calls.unregister(ahead.lo)
        if window is not None:
            self.calls.unregister(window.lo)
