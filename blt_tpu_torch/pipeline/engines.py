"""The torch engine (port of ``blt_tpu/pipeline/engines.py::JaxEngine``)
and the engine choice.

``TorchEngine(device)`` streams batches through the kernel encoders of
``blt_tpu_torch/ops/bpe_cuda.py`` on an explicit ``torch.device``. The
encoders dispatch by the tensor alone (kernel on CUDA, plain version on the
CPU), so the CPU tests drive the same stream code that runs on the card.

Pipelining is the JAX engine's: feed (pack into a pinned buffer, upload,
launch), device-to-host copy, and host drain each run on their own thread
(``prefetch_iter``). The BPE carry and the previous raw slot stay on the
device between batches: the kernels read and write them by pointer, so no
batch waits on the host for them.
"""

from __future__ import annotations

import collections
import itertools
import os
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from blt_tpu.merges import MergeTable
from blt_tpu.pipeline.engines import AUTO_DEVICE_THRESHOLD, NumpyEngine
from blt_tpu.utils.chunking import align_up
from blt_tpu.utils.logging import get_logger
from blt_tpu_torch.ops import bpe_torch
from blt_tpu_torch.ops.bpe_cuda import (
    CudaBasicEncoder,
    CudaFlatEncoder,
    unpack_slots_host,
)
from blt_tpu_torch.pipeline.feeder import pinned_buffer, prefetch_iter
from blt_tpu_torch.utils.device import cuda_device, require_cuda

log = get_logger("torch_engine")

_MULTIPASS_TODO = (
    "general (non-flat) merge tables need the multipass engine, which the "
    "torch port does not have yet (ROADMAP.md: K3 with the multipass engine "
    "path); use --engine numpy"
)


def _batches(chunks: Iterable[np.ndarray], capacity: int) -> Iterator[np.ndarray]:
    """The chunks cut into non-empty batches of at most ``capacity`` bytes.
    A pipe may read a chunk longer than the hint; no output depends on
    where the stream is cut, because the BPE state crosses every cut."""
    for chunk in chunks:
        for i in range(0, chunk.shape[0], capacity):
            yield chunk[i : i + capacity]


class TorchEngine:
    """Device engine: pipelined batches through the CUDA kernels."""

    name = "torch"

    def __init__(self, device, depth: int = 2, threads: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            require_cuda()  # raises without a CUDA device
        self.depth = depth
        self.threads = threads if threads > 0 else (os.cpu_count() or 1)

    def basic_stream(
        self, chunks: Iterable[np.ndarray], chunk_hint: int
    ) -> Iterator[np.ndarray]:
        encoder = CudaBasicEncoder(max(chunk_hint, 1), self.device)
        # upload returns after its copy completed, so one buffer serves all
        staging = pinned_buffer(encoder.padded_bytes, self.device)

        def feed():
            for batch in _batches(chunks, encoder.capacity):
                dev, n = encoder.upload(batch, staging, self.threads)
                yield encoder.encode_device(dev, n)

        def drain(items):
            for out, n in items:
                # u16 image; little-endian b << 8 is the BE wire
                yield out.reshape(-1)[:n].cpu().numpy()

        yield from prefetch_iter(
            drain(prefetch_iter(feed(), self.depth, "feed")), self.depth, "drain"
        )

    def passthrough_stream(
        self, chunks: Iterable[np.ndarray], chunk_hint: int
    ) -> Iterator[memoryview]:
        # identity map: never round-trips through the device
        for chunk in chunks:
            yield memoryview(np.ascontiguousarray(chunk)).cast("B")

    def bpe_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator:
        if not table.flat:
            raise NotImplementedError(_MULTIPASS_TODO)
        if CudaFlatEncoder.supports(table):
            encoder = CudaFlatEncoder(
                table, self.device, capacity_bytes=max(chunk_hint, 1)
            )
            yield from self._bpe_kernel_stream(chunks, encoder)
        else:
            yield from self._bpe_twin_stream(chunks, table, chunk_hint)

    def _bpe_kernel_stream(
        self, chunks: Iterable[np.ndarray], encoder: CudaFlatEncoder
    ) -> Iterator:
        """Flat BPE through K2 and the packed wire (``_bpe_pallas_stream``
        in its default packed mode)."""
        from blt_tpu import native

        use_native = native.available()
        threads = self.threads
        cap = encoder.capacity
        staging = pinned_buffer(encoder.padded_bytes, self.device)

        def feed():
            carry = 0  # device tensors after the first batch
            prev_slot = 0
            prev_batch: Optional[np.ndarray] = None

            def dispatch(data: np.ndarray, next_byte: int):
                nonlocal carry, prev_slot
                dev, n = encoder.upload(data, staging, threads)
                wire, carry, prev_slot = encoder.encode_packed_device(
                    dev, n, carry, next_byte, prev_slot
                )
                return wire, n

            for batch in _batches(chunks, cap):
                if prev_batch is not None:
                    yield dispatch(prev_batch, int(batch[0]))
                prev_batch = batch
            if prev_batch is not None:
                yield dispatch(prev_batch, -1)

        def d2h(items):
            for wire, n in items:
                w = wire.cpu().numpy()
                yield w[:cap], w[cap:], n

        def drain(items):
            for packed, flags, n in items:
                if use_native:
                    yield native.unpack_slots(packed, flags, n, threads)
                else:
                    yield unpack_slots_host(packed, flags, n)

        yield from prefetch_iter(
            drain(
                prefetch_iter(
                    d2h(prefetch_iter(feed(), self.depth, "feed")),
                    self.depth,
                    "d2h",
                )
            ),
            self.depth,
            "drain",
        )

    def _bpe_twin_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[np.ndarray]:
        """Flat tables the kernel rejects (values < 256): plain torch ops
        (``bpe_torch.flat_encode``) on the engine's device, as the JAX
        engine's ``_bpe_xla_stream``."""
        dense = torch.from_numpy(table.dense).to(self.device)
        n_static = align_up(max(chunk_hint, 1))
        carry = torch.zeros((), dtype=torch.bool, device=self.device)
        pending: collections.deque = collections.deque()

        def dispatch(chunk: np.ndarray, next_byte: int):
            nonlocal carry
            buf = np.zeros(n_static, np.uint8)
            buf[: chunk.shape[0]] = chunk
            dev = torch.from_numpy(buf).to(self.device)
            _, count, carry, be = bpe_torch.flat_encode(
                dev, chunk.shape[0], dense, carry, next_byte
            )
            pending.append((count, be))

        def drain() -> np.ndarray:
            count, be = pending.popleft()
            return be[: int(count)].cpu().numpy()

        prev: Optional[np.ndarray] = None
        for batch in _batches(chunks, n_static):
            if prev is not None:
                dispatch(prev, int(batch[0]))
                if len(pending) > self.depth:
                    yield drain()
            prev = batch
        if prev is not None:
            dispatch(prev, -1)
        while pending:
            yield drain()


def _probe_device_engine(threads: int = 0) -> Optional[TorchEngine]:
    """The torch engine on the first CUDA device, or None without one."""
    device = cuda_device()
    return TorchEngine(device, threads=threads) if device is not None else None


class AutoStreamEngine:
    """AUTO engine for unknown-size inputs (stdin): peek, then commit.

    Port of the JAX package's ``AutoStreamEngine``: the stream is buffered
    until EOF or ``min(AUTO_DEVICE_THRESHOLD, mem_budget)`` bytes, then
    replayed through the torch engine when a CUDA device exists and the
    threshold was reached, else through the NumPy engine. No engine sees a
    byte before the choice, so the output is the same either way.
    """

    name = "auto"

    def __init__(self, threads: int = 0, mem_budget: Optional[int] = None):
        self.threads = threads
        self.selected = None  # set on first stream
        self.peek_threshold = AUTO_DEVICE_THRESHOLD
        if mem_budget is not None and mem_budget > 0:
            self.peek_threshold = min(AUTO_DEVICE_THRESHOLD, mem_budget)

    def _select(self, chunks: Iterable[np.ndarray]):
        buffered = []
        total = 0
        it = iter(chunks)
        for chunk in it:
            buffered.append(chunk)
            total += chunk.shape[0]
            if total >= self.peek_threshold:
                break
        engine = None
        if total >= self.peek_threshold:
            engine = _probe_device_engine(self.threads)
        if engine is None:
            engine = NumpyEngine(self.threads)
        self.selected = engine
        log.info("AUTO stream committed to %s engine (%d bytes peeked)",
                 engine.name, total)
        return engine, itertools.chain(buffered, it)

    def basic_stream(self, chunks, chunk_hint: int) -> Iterator:
        engine, replay = self._select(chunks)
        yield from engine.basic_stream(replay, chunk_hint)

    def passthrough_stream(self, chunks, chunk_hint: int) -> Iterator:
        engine = NumpyEngine(self.threads)
        self.selected = engine
        yield from engine.passthrough_stream(chunks, chunk_hint)

    def bpe_stream(self, chunks, table: MergeTable, chunk_hint: int) -> Iterator:
        engine, replay = self._select(chunks)
        yield from engine.bpe_stream(replay, table, chunk_hint)


ENGINES = ("auto", "torch", "numpy")


def select_engine(
    engine_pref: str,
    input_size: Optional[int],
    threads: int = 0,
    mem_budget: Optional[int] = None,
):
    """``torch``: the torch engine on the first CUDA device (raises without
    one). ``numpy``: the host engine. ``auto``: the torch engine for inputs
    of at least ``AUTO_DEVICE_THRESHOLD`` bytes when a CUDA device exists,
    else the host engine; unknown-size streams peek first."""
    if engine_pref not in ENGINES:
        raise ValueError(f"unknown engine {engine_pref!r}, expected one of {ENGINES}")
    if engine_pref == "numpy":
        return NumpyEngine(threads)
    if engine_pref == "torch":
        return TorchEngine(require_cuda(), threads=threads)
    if input_size is None:
        return AutoStreamEngine(threads, mem_budget=mem_budget)
    if input_size < AUTO_DEVICE_THRESHOLD:
        return NumpyEngine(threads)
    engine = _probe_device_engine(threads)
    return engine if engine is not None else NumpyEngine(threads)
