"""The engines of the torch port (port of ``blt_tpu/pipeline/engines.py``)
and the engine choice.

``TorchEngine(device)`` streams batches through the kernel encoders of
``blt_tpu_torch/ops/bpe_cuda.py`` (basic, flat BPE) and
``blt_tpu_torch/ops/multipass_cuda.py`` (general tables) on an explicit
``torch.device``. The encoders dispatch by the tensor alone (kernel on
CUDA, plain version on the CPU), so the CPU tests drive the same stream
code that runs on the card. ``ShardedTorchEngine(devices)`` lays each
batch out as rows over several devices (port of ``ShardedJaxEngine``, on
``blt_tpu_torch/parallel/`` and ``ops/sharded_cuda.py``). ``NumpyEngine``
is a copy of the JAX package's host engine: the way a caller asks for the
CPU. ``PayloadAutoEngine`` picks one of them per in-memory payload, as the
server's ``--engine auto`` does.

Pipelining is the JAX engine's: feed (pack into a pinned buffer, upload,
launch), device-to-host copy, and host drain each run on their own thread,
chained by ``TorchEngine._stages``; ``_with_next_byte`` gives each batch of
a stream the first byte of the next, which BPE's stitching reads. A
general table's stream has no drain: its wire is its output. A batch of a
file mapping skips the pack on a CUDA
device: it is copied from the mapping (``feeder.MappedWindows``). The BPE
carry and the previous raw slot stay on the device between batches: the
kernels read and write them by pointer, so no batch waits on the host for
them.
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Iterable, Iterator, Optional, Tuple

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
from blt_tpu_torch.ops.sharded_cuda import (
    CudaShardedFlatEncoder,
    CudaShardedTokenEncoder,
    copy_streams,
)
from blt_tpu_torch.parallel.mesh import make_mesh, replicated
from blt_tpu_torch.parallel.sharded import sharded_basic_encode, sharded_flat_encode
from blt_tpu_torch.pipeline.feeder import (
    MappedWindows,
    pack_into,
    pinned_buffer,
    prefetch_iter,
    upload,
)
from blt_tpu_torch.utils.chunking import align_up
from blt_tpu_torch.utils.device import cuda_device, require_cuda
from blt_tpu_torch.utils.logging import get_logger, span

log = get_logger("engine")

# AUTO's size rule (the JAX package's): inputs below this run on the host
AUTO_DEVICE_THRESHOLD = 32 * 1024 * 1024

# In-memory device payloads (server) take a power-of-two capacity of at
# least this many bytes (the JAX package's floor, one Pallas block). The
# kernels take any length, so the bucket changes no output; it keeps the
# sizes of the blocks that torch's device and pinned-host caching
# allocators hand out to a small set, which a warm-up can fill ahead.
DEVICE_HINT_FLOOR = 1 << 16
DEVICE_ENGINES = ("torch", "shard")


def device_capacity_hint(size: int, engine) -> int:
    """Capacity hint for a single in-memory payload of ``size`` bytes.

    Device engines (``DEVICE_ENGINES``) get the power-of-two bucket >=
    size, never less than ``DEVICE_HINT_FLOOR``; host engines keep the
    exact size. Never below ``size``: a general table's request is one
    chunk, and a chunk is never cut."""
    if size <= 0 or getattr(engine, "name", "") not in DEVICE_ENGINES:
        return size
    return max(DEVICE_HINT_FLOOR, 1 << (size - 1).bit_length())


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


def _with_next_byte(batches: Iterable[np.ndarray]) -> Iterator[Tuple[np.ndarray, int]]:
    """Each non-empty batch with the first byte of the one after it, -1
    after the last: a batch is dispatched once the next one is known."""
    prev: Optional[np.ndarray] = None
    for batch in batches:
        if batch.shape[0] == 0:
            continue
        if prev is not None:
            yield prev, int(batch[0])
        prev = batch
    if prev is not None:
        yield prev, -1


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
        for data, next_byte in _with_next_byte(chunks):
            if self._native is not None:
                wire, carry = self._native.flat_bpe(
                    data, table.dense, carry, next_byte, self.threads
                )
            else:
                toks, carry = bpe_numpy.bpe_encode_flat_carry(
                    data, table, carry, next_byte
                )
                wire = toks.astype(">u2")
            yield wire


class TorchEngine:
    """Device engine: pipelined batches through the CUDA kernels."""

    name = "torch"

    def __init__(self, device, depth: int = 2, threads: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            require_cuda()  # raises without a CUDA device
        self.mesh = (self.device,)  # the rows a general table's chunks cycle over
        self.depth = depth
        self.threads = threads if threads > 0 else (os.cpu_count() or 1)

    def _stages(self, feed: Iterator, *steps) -> Iterator:
        """The stage chain: ``feed`` on a thread named ``feed``, then each
        ``(name, step)`` on a thread of its own, ``step`` taking the items of
        the stage before it; ``depth`` items in flight between each two."""
        items = prefetch_iter(feed, self.depth, "feed")
        for name, step in steps:
            items = prefetch_iter(step(items), self.depth, name)
        return items

    def basic_stream(
        self, chunks: Iterable[np.ndarray], chunk_hint: int
    ) -> Iterator[np.ndarray]:
        encoder = CudaBasicEncoder(max(chunk_hint, 1), self.device)
        # upload returns after its copy completed, so one buffer serves all
        staging = pinned_buffer(encoder.padded_bytes, self.device)

        def feed():
            with MappedWindows(self.device) as windows:
                for batch in _batches(chunks, encoder.capacity):
                    dev, n = encoder.upload(batch, staging, self.threads, windows)
                    with span(log, "feed.launch"):
                        out = encoder.encode_device(dev, n)
                    yield out

        def drain(items):
            for out, n in items:
                # u16 image; little-endian b << 8 is the BE wire
                yield out.reshape(-1)[:n].cpu().numpy()

        yield from self._stages(feed(), ("drain", drain))

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
            with MappedWindows(self.device) as windows:
                for batch, next_byte in _with_next_byte(_batches(chunks, cap)):
                    dev, n = encoder.upload(batch, staging, threads, windows)
                    with span(log, "feed.launch"):
                        wire, carry, prev_slot = encoder.encode_packed_device(
                            dev, n, carry, next_byte, prev_slot
                        )
                    yield wire, n

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

        yield from self._stages(feed(), ("d2h", d2h), ("drain", drain))

    def _bpe_twin_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[np.ndarray]:
        """Flat tables the kernel rejects (values < 256): plain torch ops
        (``bpe_torch.flat_encode``) on the engine's device, as the JAX
        engine's ``_bpe_xla_stream``, on the stages feed and d2h: the
        u16-BE image of the batch's tokens is its output."""
        dense = torch.from_numpy(table.dense).to(self.device)
        n_static = align_up(max(chunk_hint, 1))

        def feed():
            carry = torch.zeros((), dtype=torch.bool, device=self.device)
            for batch, next_byte in _with_next_byte(_batches(chunks, n_static)):
                buf = np.zeros(n_static, np.uint8)
                buf[: batch.shape[0]] = batch
                dev = torch.from_numpy(buf).to(self.device)
                _, count, carry, be = bpe_torch.flat_encode(
                    dev, batch.shape[0], dense, carry, next_byte
                )
                yield count, be

        def d2h(items):
            for count, be in items:
                yield be[: int(count)].cpu().numpy()

        yield from self._stages(feed(), ("d2h", d2h))

    def _bpe_multipass_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[np.ndarray]:
        """General (non-flat) tables, per-chunk semantics (port of the JAX
        engine's ``_bpe_multipass_stream``): a device-resident loop a chunk,
        on the route ``multipass_cuda.token_encoder`` chooses from the table
        (the kernel loop when cuckoo32 places it, else the plain twin). The
        feed stage uploads a whole chunk and runs its loop; the D2H stage
        downloads the u16-BE image of the loop's compacted prefix, its
        ``2 * count`` bytes, which is the chunk's output. ``depth`` chunks
        in flight. The encoder is sized from the chunk size, and a chunk is
        never cut. Chunk i runs on row ``i % B`` of the engine's mesh (one
        row for this engine)."""
        enc = CudaShardedTokenEncoder(
            table, self.mesh, capacity_tokens=align_up(max(chunk_hint, 1))
        )
        staging = pinned_buffer(enc.rows[0].padded_bytes, self.device)
        threads = self.threads

        def feed():
            with MappedWindows(self.device) as windows:
                for i, chunk in enumerate(_whole_chunks(chunks, enc.capacity)):
                    r = i % enc.n_rows
                    dev, n = enc.rows[r].upload(chunk, staging, threads, windows)
                    yield enc.dispatch(r, dev.reshape(-1)[:n])

        def d2h(items):
            for wire, m in items:
                yield enc.download(wire, m)

        yield from self._stages(feed(), ("d2h", d2h))


class ShardedTorchEngine(TorchEngine):
    """Multi-device engine: row-sharded batches over a mesh (port of
    ``ShardedJaxEngine``).

    Each feed batch is laid out as ``B`` rows of one contiguous fill, row r
    on ``mesh[r]`` (``parallel/mesh.py``), the merges table replicated.
    Basic runs K1 a row; flat BPE runs the halo-sharded K2
    (``CudaShardedFlatEncoder``), exact across rows and batches, and sends
    a batch whose halo does not converge through the carry composition of
    ``parallel.sharded``; general tables keep the per-chunk semantics, chunk
    i on row ``i % B`` (``TorchEngine``'s route: each row dispatches by its
    tensor, so a CUDA row runs the K3 or K4 loop and a CPU row its plain
    version). ``devices``: the rows' devices, one may repeat (default:
    every CUDA device; raises without one).

    ``counts["carry_batches"]`` tallies the flat batches that took the carry
    composition; the kernels' own counters count their launches.
    """

    name = "shard"

    def __init__(self, devices=None, depth: int = 2, threads: int = 0):
        mesh = make_mesh(devices)
        super().__init__(mesh[0], depth=depth, threads=threads)
        self.mesh = mesh
        self.n_rows = len(mesh)
        self._copy_streams = copy_streams(mesh)
        self.counts = {"carry_batches": 0}

    def _row_bytes(self, chunk_hint: int) -> int:
        return align_up(-(-max(chunk_hint, 1) // self.n_rows))

    def _layout(self, chunk: np.ndarray, row_bytes: int, staging: torch.Tensor):
        """Fill a (B, row_bytes) batch front to back, upload each non-empty
        row to its device. Returns (B row tensors, lengths int32[B]).

        The fill is one contiguous (native multithreaded) copy into the
        pinned ``staging``; bytes past each row's length are stale, and an
        empty row is uninitialised memory on its device: every consumer
        masks by the lengths."""
        b = self.n_rows
        n = chunk.shape[0]
        if n > b * row_bytes:
            raise ValueError(f"batch of {n} bytes exceeds {b} rows of {row_bytes}")
        pack_into(staging.numpy(), chunk, self.threads)
        full = n // row_bytes
        lengths = np.zeros(b, np.int32)
        lengths[:full] = row_bytes
        if full < b:
            lengths[full] = n - full * row_bytes
        view = staging[: b * row_bytes].reshape(b, row_bytes)
        rows = [
            upload(view[r], dev, self._copy_streams.get(dev)) if lengths[r]
            else torch.empty(row_bytes, dtype=torch.uint8, device=dev)
            for r, dev in enumerate(self.mesh)
        ]
        return rows, lengths

    def basic_stream(
        self, chunks: Iterable[np.ndarray], chunk_hint: int
    ) -> Iterator[np.ndarray]:
        row_bytes = self._row_bytes(chunk_hint)
        staging = pinned_buffer(self.n_rows * row_bytes, self.device)

        def feed():
            for batch in _batches(chunks, self.n_rows * row_bytes):
                rows, lengths = self._layout(batch, row_bytes, staging)
                live = [r for r in range(self.n_rows) if lengths[r]]
                # the valid tokens are one contiguous prefix of the rows
                yield sharded_basic_encode([rows[r] for r in live]), lengths[live]

        def drain(items):
            for outs, lengths in items:
                for out, n in zip(outs, lengths):
                    yield out[:n].cpu().numpy()  # u16 image; b << 8 LE is the BE wire

        yield from self._stages(feed(), ("drain", drain))

    def bpe_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator:
        if not table.flat:
            yield from self._bpe_multipass_stream(chunks, table, chunk_hint)
        elif CudaShardedFlatEncoder.supports(table):
            slab = align_up(-(-max(chunk_hint, 1) // self.n_rows) + CudaShardedFlatEncoder.HALO)
            enc = CudaShardedFlatEncoder(table, self.mesh, capacity_bytes=slab,
                                         streams=self._copy_streams)
            yield from self._bpe_flat_halo_stream(chunks, table, enc, chunk_hint)
        else:
            yield from self._bpe_flat_carry_stream(chunks, table, chunk_hint)

    def _carry_dispatch(self, data, row_bytes, staging, dense_d, carry, next_byte):
        """One batch through the carry composition. Returns (tokens,
        counts, carry_out) of ``sharded_flat_encode``."""
        rows, lengths = self._layout(data, row_bytes, staging)
        return sharded_flat_encode(rows, lengths, dense_d, carry, next_byte)

    @staticmethod
    def _carry_host(tokens, counts) -> np.ndarray:
        """A carry-composition batch's tokens on the host, as u16-BE."""
        counts_h = counts.cpu().numpy()
        parts = [t[:c].cpu().numpy() for t, c in zip(tokens, counts_h) if c]
        return np.concatenate(parts).astype(">u2") if parts else np.empty(0, ">u2")

    def _bpe_flat_halo_stream(
        self,
        chunks: Iterable[np.ndarray],
        table: MergeTable,
        enc: CudaShardedFlatEncoder,
        chunk_hint: int,
    ) -> Iterator:
        """Flat BPE over the mesh at K2's rate a slab.

        Halo convergence (``CudaShardedFlatEncoder``): slabs run K2 fused
        with its pack from carry 0, and each slab's payload expands on the
        host on its own, so the fast path holds no state across batches. A
        batch with a degenerate (all-match) halo goes through the exact
        carry composition with the true boundary carry, read from the
        previous batch's last slab only then.

        The packed wire splits a merge that straddles a boundary (its hi
        byte at the start's slab, its lo byte at the consuming slab), which
        composes across slabs and batches. The carry composition emits whole
        tokens, so the transitions need a bridge: after a carry batch whose
        carry consumed this batch's first byte, the first packed position is
        skipped (its token was already emitted whole); a carry batch after a
        packed batch with a pending merge prepends that merge's lo byte.
        """
        H = enc.HALO
        d_rows = enc.n_rows
        payload = enc.payload
        dense = table.dense
        use_native = native.available()
        threads = self.threads
        carry_row_bytes = self._row_bytes(chunk_hint)
        staging = pinned_buffer(d_rows * enc.padded_bytes, self.device)
        slabs = staging.numpy().reshape(d_rows, enc.padded_bytes)
        carry_staging = None  # only a degenerate batch needs these
        dense_d = None

        def feed():
            nonlocal carry_staging, dense_d
            tail = np.empty(0, np.uint8)
            # the boundary carry, for the carry path only: ("const", bool) |
            # ("dev", carry-composition 0-d tensor) | ("slab", last slab's
            # (1, 1) carry)
            carry_state = ("const", False)
            prev_kind = None  # "p" | "x": emission convention of the last batch

            def boundary_carry():
                kind, value = carry_state
                return bool(value) if kind == "slab" else value

            def dispatch(data: np.ndarray, next_byte: int):
                nonlocal tail, carry_state, prev_kind, carry_staging, dense_d
                n = data.shape[0]
                lengths = np.zeros(d_rows, np.int32)
                next_bytes = np.full(d_rows, -1, np.int32)
                metas = []
                offset = 0
                converged = True
                for r in range(d_rows):
                    pl = min(payload, n - offset)
                    if pl <= 0:
                        metas.append((0, 0))
                        continue
                    halo = tail[-H:] if r == 0 else data[max(0, offset - H) : offset]
                    if not enc.halo_converges(
                        dense, np.concatenate([halo, data[offset : offset + 1]])
                    ):
                        converged = False
                        break
                    hl = halo.shape[0]
                    slabs[r, :hl] = halo
                    pack_into(slabs[r, hl:], data[offset : offset + pl], threads)
                    lengths[r] = hl + pl
                    next_bytes[r] = int(data[offset + pl]) if offset + pl < n else next_byte
                    metas.append((hl, pl))
                    offset += pl
                if converged:
                    # bridge rule 1: the carry batch before consumed this
                    # batch's first byte and emitted the whole merged token
                    skip_first = prev_kind == "x" and bool(boundary_carry())
                    wires, carries = enc.encode_batch(staging.reshape(d_rows, -1),
                                                      lengths, next_bytes)
                    r_last = max(r for r, (_, pl) in enumerate(metas) if pl)
                    carry_state = ("slab", carries[r_last])
                    prev_kind = "p"
                    tail = data[-H:].copy() if n >= H else np.concatenate([tail, data])[-H:]
                    return "p", wires, metas, skip_first
                # degenerate halo: the exact carry composition
                if dense_d is None:
                    dense_d = replicated(self.mesh, dense)
                    carry_staging = pinned_buffer(d_rows * carry_row_bytes, self.device)
                carry = boundary_carry()
                # bridge rule 2: a pending merge of a packed batch emitted only
                # its hi byte; its consumed byte (this batch's first) emits
                # nothing here, so prepend the merge's lo byte
                prefix = b""
                if prev_kind == "p" and bool(carry):
                    prefix = bytes([int(dense[int(tail[-1]) * 256 + int(data[0])]) & 0xFF])
                tokens, counts, carry_out = self._carry_dispatch(
                    data, carry_row_bytes, carry_staging, dense_d, carry, next_byte
                )
                carry_state = ("dev", carry_out)
                prev_kind = "x"
                tail = np.concatenate([tail, data])[-H:]
                self.counts["carry_batches"] += 1
                return "x", tokens, counts, prefix

            for batch, next_byte in _with_next_byte(_batches(chunks, d_rows * payload)):
                yield dispatch(batch, next_byte)

        cap = enc.capacity

        def d2h(items):
            for item in items:
                if item[0] == "p":
                    _, wires, metas, skip_first = item
                    yield "p", [None if w is None else w.cpu().numpy() for w in wires], \
                        metas, skip_first
                else:
                    _, tokens, counts, prefix = item
                    yield "x", self._carry_host(tokens, counts), prefix

        def drain(items):
            for item in items:
                if item[0] == "x":
                    _, out, prefix = item
                    if prefix:
                        yield prefix
                    yield out
                    continue
                _, wires, metas, skip_first = item
                for r, (hl, pl) in enumerate(metas):
                    start, cnt = hl, pl
                    if r == 0 and skip_first:
                        start, cnt = hl + 1, pl - 1
                    if cnt <= 0:
                        continue
                    packed, flags = wires[r][:cap], wires[r][cap:]
                    if use_native:
                        yield native.unpack_slots(packed, flags, cnt, threads, start)
                    else:
                        yield unpack_slots_host(packed, flags, cnt, start)

        yield from self._stages(feed(), ("d2h", d2h), ("drain", drain))

    def _bpe_flat_carry_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[np.ndarray]:
        """Flat tables K2 rejects (values < 256): every batch through the
        carry composition, the carry kept on the device between batches (the
        JAX engine's ``_bpe_flat_xla_stream``)."""
        row_bytes = self._row_bytes(chunk_hint)
        staging = pinned_buffer(self.n_rows * row_bytes, self.device)
        dense_d = replicated(self.mesh, table.dense)

        def feed():
            carry = False  # a device tensor after the first batch
            for batch, next_byte in _with_next_byte(_batches(chunks, self.n_rows * row_bytes)):
                tokens, counts, carry = self._carry_dispatch(
                    batch, row_bytes, staging, dense_d, carry, next_byte
                )
                yield tokens, counts

        def drain(items):
            for tokens, counts in items:
                yield self._carry_host(tokens, counts)

        yield from self._stages(feed(), ("drain", drain))


def _probe_device_engine(threads: int = 0) -> Optional[TorchEngine]:
    """The device engine for this process, or None without a CUDA device:
    every card of a multi-card host (``ShardedTorchEngine``), else the
    torch engine on the one card."""
    device = cuda_device()
    if device is None:
        return None
    if torch.cuda.device_count() > 1:
        return ShardedTorchEngine(threads=threads)
    return TorchEngine(device, threads=threads)


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


class PayloadAutoEngine:
    """Per-payload engine choice for known-size in-memory requests (port of
    the JAX package's ``PayloadAutoEngine``).

    The serving twin of the CLI's AUTO policy: each request's size is known
    up front (Content-Length), so the choice is a threshold. Payloads below
    it run on the host engine; larger ones on the device engine
    (``_probe_device_engine``) when a CUDA device exists, else on the host
    engine too. The device engine is probed once, under a lock, on the first
    large payload and shared by every request after it; callers resolve the
    engine with ``select(size)`` before streaming.
    """

    name = "auto"

    def __init__(self, threads: int = 0, device_threshold: Optional[int] = None):
        self.threads = threads
        self.threshold = (
            device_threshold
            if device_threshold and device_threshold > 0
            else AUTO_DEVICE_THRESHOLD
        )
        self._host = NumpyEngine(threads)
        self._device = None
        self._probed = False
        # two concurrent large requests must neither probe twice nor race
        # check-then-act into serving a large payload on the host
        self._probe_lock = threading.Lock()

    def select(self, size: int):
        if size >= self.threshold:
            if not self._probed:
                with self._probe_lock:
                    if not self._probed:
                        self._device = _probe_device_engine(self.threads)
                        self._probed = True
                        if self._device is not None:
                            log.info("payload AUTO: %s engine for payloads >= %d bytes",
                                     self._device.name, self.threshold)
            if self._device is not None:
                return self._device
        return self._host


ENGINES = ("auto", "torch", "numpy", "shard")


def select_engine(
    engine_pref: str,
    input_size: Optional[int],
    threads: int = 0,
    mem_budget: Optional[int] = None,
):
    """``torch``: the torch engine on the first CUDA device (raises without
    one). ``shard``: the sharded engine over every CUDA device (raises
    without one). ``numpy``: the host engine. ``auto``: the device engine
    (``_probe_device_engine``) for inputs of at least
    ``AUTO_DEVICE_THRESHOLD`` bytes when a CUDA device exists, else the host
    engine; unknown-size streams peek first."""
    if engine_pref not in ENGINES:
        raise ValueError(f"unknown engine {engine_pref!r}, expected one of {ENGINES}")
    if engine_pref == "numpy":
        return NumpyEngine(threads)
    if engine_pref == "torch":
        return TorchEngine(require_cuda(), threads=threads)
    if engine_pref == "shard":
        return ShardedTorchEngine(threads=threads)
    if input_size is None:
        return AutoStreamEngine(threads, mem_budget=mem_budget)
    engine = None
    if input_size >= AUTO_DEVICE_THRESHOLD:
        engine = _probe_device_engine(threads)
    if engine is None:
        engine = NumpyEngine(threads)
    log.info("AUTO picked the %s engine for %d bytes", engine.name, input_size)
    return engine
