"""The engines of the torch port (port of ``blt_tpu/pipeline/engines.py``)
and the engine choice.

``TorchEngine(device)`` streams batches through the kernel encoders of
``blt_tpu_torch/ops/bpe_cuda.py`` (basic, flat BPE) and
``blt_tpu_torch/ops/multipass_cuda.py`` (general tables) on an explicit
``torch.device``. The encoders dispatch by the tensor alone (kernel on
CUDA, plain version on the CPU), so the CPU tests drive the same stream
code that runs on the card. ``NumpyEngine`` is a copy of the JAX package's
host engine: the way a caller asks for the CPU.

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

from blt_tpu_torch import native
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import bpe_numpy, bpe_torch
from blt_tpu_torch.ops.bpe_cuda import (
    CudaBasicEncoder,
    CudaFlatEncoder,
    unpack_slots_host,
)
from blt_tpu_torch.ops.multipass_cuda import (
    CudaTokenEncoder,
    expand_gap_wire_host,
    mp_compact_mode,
)
from blt_tpu_torch.pipeline.feeder import pinned_buffer, prefetch_iter
from blt_tpu_torch.utils.chunking import align_up
from blt_tpu_torch.utils.device import cuda_device, require_cuda
from blt_tpu_torch.utils.logging import get_logger

log = get_logger("engine")

# AUTO's size rule (the JAX package's): inputs below this run on the host
AUTO_DEVICE_THRESHOLD = 32 * 1024 * 1024


def _batches(chunks: Iterable[np.ndarray], capacity: int) -> Iterator[np.ndarray]:
    """The chunks cut into non-empty batches of at most ``capacity`` bytes,
    for the flat and basic streams only: their output does not depend on
    where the stream is cut, because the BPE state crosses every cut. A
    general table's output does, so its chunks are never cut."""
    for chunk in chunks:
        for i in range(0, chunk.shape[0], capacity):
            yield chunk[i : i + capacity]


def _whole_chunks(chunks: Iterable[np.ndarray], capacity: int) -> Iterator[np.ndarray]:
    """The non-empty chunks of a general-table stream; one longer than the
    encoder's capacity raises (the output depends on where chunks end)."""
    for chunk in chunks:
        if chunk.shape[0] > capacity:
            raise ValueError(
                f"chunk of {chunk.shape[0]} bytes exceeds the multipass capacity "
                f"{capacity}: a general table's chunks are never cut"
            )
        if chunk.shape[0]:
            yield chunk


class NumpyEngine:
    """Vectorized host engine (copy of the JAX package's ``NumpyEngine``).

    Uses the native C++ library (multithreaded widen / flat-BPE scan) when
    built, falling back to pure NumPy; ``threads`` carries the CLI
    --threads / num_cpus policy (utils.rs:79-97).
    """

    name = "numpy"

    def __init__(self, threads: int = 0):
        self.threads = threads if threads > 0 else (os.cpu_count() or 1)
        self._native = native if native.available() else None

    def basic_stream(
        self, chunks: Iterable[np.ndarray], chunk_hint: int
    ) -> Iterator[bytes]:
        for chunk in chunks:
            if self._native is not None:
                yield self._native.widen_be(chunk, self.threads)
            else:
                yield chunk.astype(">u2")  # fresh array; writer takes the buffer

    def passthrough_stream(
        self, chunks: Iterable[np.ndarray], chunk_hint: int
    ) -> Iterator[bytes]:
        for chunk in chunks:
            yield memoryview(np.ascontiguousarray(chunk)).cast("B")

    def bpe_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[bytes]:
        if table.flat:
            yield from self._bpe_flat_stream(chunks, table)
        else:
            # General tables: independent per-chunk multipass, which is the
            # reference's own chunked behavior (BPE output then depends on
            # chunk size exactly as the reference's does, SURVEY.md 2.1.6).
            for chunk in chunks:
                toks = bpe_numpy.bpe_encode_multipass(chunk, table)
                yield toks.astype(">u2")

    def _bpe_flat_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable
    ) -> Iterator[bytes]:
        carry = False
        prev: Optional[np.ndarray] = None

        def encode(data: np.ndarray, carry_in: bool, next_byte: int):
            if self._native is not None:
                return self._native.flat_bpe(
                    data, table.dense, carry_in, next_byte, self.threads
                )
            toks, c = bpe_numpy.bpe_encode_flat_carry(
                data, table, carry_in, next_byte
            )
            return toks.astype(">u2"), c

        for chunk in chunks:
            if chunk.shape[0] == 0:
                continue
            if prev is not None:
                wire, carry = encode(prev, carry, int(chunk[0]))
                yield wire
            prev = chunk
        if prev is not None:
            wire, _ = encode(prev, carry, -1)
            yield wire


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
            yield from self._bpe_multipass_stream(chunks, table, chunk_hint)
        elif CudaFlatEncoder.supports(table):
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

    def _bpe_multipass_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator:
        """General (non-flat) tables, per-chunk semantics (port of the JAX
        engine's ``_bpe_multipass_stream``). The kernel route when cuckoo32
        places the table; the plain-torch twin (``bpe_torch.multipass_encode``)
        for tables it cannot place and under ``BLT_MULTIPASS=xla`` (the JAX
        package's name for its plain route). The table chooses, never a
        failure."""
        if os.environ.get("BLT_MULTIPASS", "pallas") != "xla" and (
            CudaTokenEncoder.supports(table)
        ):
            yield from self._bpe_multipass_kernel_stream(chunks, table, chunk_hint)
        else:
            yield from self._bpe_multipass_twin_stream(chunks, table, chunk_hint)

    def _bpe_multipass_kernel_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[np.ndarray]:
        """The device-resident loop per chunk (``_bpe_multipass_pallas_stream``):
        upload, K3 rounds with a compaction every third round, and the gap
        wire (the u16-BE image plus an alive-flag plane) down; the host drops
        the tombstones. ``BLT_MP_COMPACT=sort`` runs the K4 loop and ships the
        compacted prefix. Feed, D2H and drain each run on a ``prefetch_iter``
        stage, ``depth`` chunks in flight. The encoder is sized from the
        chunk size, and a chunk is never cut."""
        enc = CudaTokenEncoder(
            table, self.device, capacity_tokens=align_up(max(chunk_hint, 1))
        )
        staging = pinned_buffer(enc.padded_bytes, self.device)
        sort_mode = mp_compact_mode() == "sort"
        threads = self.threads

        def feed():
            for chunk in _whole_chunks(chunks, enc.capacity):
                dev, n = enc.upload(chunk, staging, threads)
                dev = dev.reshape(-1)[:n]
                if sort_mode:
                    toks, m = enc.encode_resident_dispatch(dev)
                    yield bpe_torch.tokens_to_be_bytes_device(toks), m, None
                else:
                    yield enc.encode_resident_wire_dispatch(dev)

        def d2h(items):
            for out, m, capacity in items:
                yield out.cpu().numpy(), int(m), capacity

        def drain(items):
            for host, m, capacity in items:
                if capacity is None:
                    # uint16 LE image == u16-BE stream; copy the valid part
                    yield host[:m].copy()
                    continue
                toks = expand_gap_wire_host(host, capacity)
                if toks.shape[0] != m:
                    raise RuntimeError(f"{toks.shape[0]} alive tokens, count says {m}")
                yield toks

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

    def _bpe_multipass_twin_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[np.ndarray]:
        """Plain torch ops on the engine's device (the JAX engine's
        ``_bpe_multipass_xla_stream``)."""
        keys, vals = bpe_torch.sparse_table_device(table, self.device)
        n_static = align_up(max(chunk_hint, 1))
        pending: collections.deque = collections.deque()

        def drain() -> np.ndarray:
            count, be = pending.popleft()
            return be[: int(count)].cpu().numpy()

        for chunk in _whole_chunks(chunks, n_static):
            buf = np.zeros(n_static, np.uint8)
            buf[: chunk.shape[0]] = chunk
            dev = torch.from_numpy(buf).to(self.device)
            toks, count = bpe_torch.multipass_encode(dev, chunk.shape[0], keys, vals)
            pending.append((count, bpe_torch.tokens_to_be_bytes_device(toks)))
            if len(pending) > self.depth:
                yield drain()
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
    engine = None
    if input_size >= AUTO_DEVICE_THRESHOLD:
        engine = _probe_device_engine(threads)
    if engine is None:
        engine = NumpyEngine(threads)
    log.info("AUTO picked the %s engine for %d bytes", engine.name, input_size)
    return engine
