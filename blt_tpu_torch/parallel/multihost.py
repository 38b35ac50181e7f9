"""Multi-process tokenization runner (port of
``blt_tpu/parallel/multihost.py``).

Each process encodes its own byte range of the input with its local engine
and writes at its exact offset in the shared output; the result equals a
single-process run byte for byte. Communication is replaced by boundary
analysis:

- **flat BPE**: a boundary at j where the pair (b[j-1], b[j]) is not a
  rule is transparent: no merge can consume byte j, so the carry into the
  range is 0 and the parity scan restarts as the whole stream's would.
  ``safe_split_bounds`` moves each nominal boundary forward to the nearest
  such position (a vectorised scan of the memory map).
- **general BPE** keeps the reference's per-chunk semantics, so boundaries
  snap to the global chunk grid (multiples of the chunk size from byte 0).
- **basic / passthrough** split anywhere: output offsets are affine in the
  input offset (2x, 1x), so each process writes at its offset directly.

BPE and decode processes spool their output (memory first, disk past half
the memory cap, ``_Spool``), all-gather the per-process byte counts (the
one collective, ``torch.distributed.all_gather`` over gloo), then write the
spool at ``header + sum(counts[:rank])``. A barrier ends the run.

Launch the same CLI in every process with the environment contract:

    BLT_COORDINATOR_ADDRESS=host0:29500 BLT_NUM_PROCESSES=2 \\
    BLT_PROCESS_ID=$RANK python -m blt_tpu_torch.cli -i in.bin -o out.bin
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional

import numpy as np

from blt_tpu_torch.config import CoreConfig, Mode
from blt_tpu_torch.merges import NO_RULE
from blt_tpu_torch.utils.chunking import get_effective_chunk_size
from blt_tpu_torch.utils.logging import get_logger

log = get_logger("multihost")

# bytes scanned per window while searching for a safe split
_SCAN_WINDOW = 4 * 1024 * 1024


def env_distributed() -> bool:
    """True when the multi-process environment contract is set."""
    return os.environ.get("BLT_COORDINATOR_ADDRESS") is not None


def initialize_from_env() -> None:
    from blt_tpu_torch.parallel import distributed as dist

    missing = [v for v in ("BLT_NUM_PROCESSES", "BLT_PROCESS_ID") if v not in os.environ]
    if missing:
        raise ValueError(
            "incomplete multi-process environment: BLT_COORDINATOR_ADDRESS "
            f"is set but {', '.join(missing)} is missing (the contract needs "
            "all three)"
        )
    dist.initialize(
        coordinator_address=os.environ["BLT_COORDINATOR_ADDRESS"],
        num_processes=int(os.environ["BLT_NUM_PROCESSES"]),
        process_id=int(os.environ["BLT_PROCESS_ID"]),
    )


def even_bounds(total: int, n: int) -> List[int]:
    """n+1 monotone bounds of near-equal contiguous ranges."""
    per = -(-total // n) if total else 0
    return [min(i * per, total) for i in range(n)] + [total]


def chunk_aligned_bounds(total: int, chunk: int, n: int) -> List[int]:
    """Bounds snapped down to the global chunk grid (general BPE: every
    ``chunk``-byte chunk from byte 0 lands wholly in one process)."""
    raw = even_bounds(total, n)
    snapped = [0]
    for b in raw[1:-1]:
        snapped.append(max(snapped[-1], (b // chunk) * chunk))
    snapped.append(total)
    return snapped


def safe_split_bounds(mm: np.ndarray, dense: np.ndarray, n: int) -> List[int]:
    """Flat-BPE bounds, each moved to a merge-transparent position.

    A split at j is safe iff the pair (mm[j-1], mm[j]) is not a rule: no
    merge can straddle it, under either parity. A pure function of (mm,
    dense, n), so every process computes the same bounds with no
    communication. A window with no safe position widens the scan; an
    all-matches file ends with fewer effective processes (correct first).
    """
    total = mm.shape[0]
    nominal = even_bounds(total, n)
    bounds = [0]
    for b in nominal[1:-1]:
        j = max(b, bounds[-1])
        found: Optional[int] = None
        while j < total:
            hi = min(j + _SCAN_WINDOW, total)
            if j >= 1 and hi > j:
                window = mm[j - 1 : hi]
                pairs = window[:-1].astype(np.int32) * 256 + window[1:]
                ok = np.nonzero(dense[pairs] == NO_RULE)[0]
                if ok.size:
                    found = j + int(ok[0])
                    break
            elif j == 0:
                found = 0
                break
            j = hi
        bounds.append(total if found is None else found)
    bounds.append(total)
    return bounds


# The multi-process chunk when the CLI gives none: the auto planner's upper
# clamp. The single-process planner derives the chunk from local RAM, which
# on unlike hosts would give each process its own chunk grid, and general
# BPE's bounds and output depend on that grid: every process must pin the
# same value with no communication.
DIST_DEFAULT_CHUNK = 16 * 1024 * 1024


def dist_chunk_size(config: CoreConfig) -> int:
    """Host-RAM-independent effective chunk size for multi-process runs."""
    if config.cli_chunk_size is not None:
        return get_effective_chunk_size(
            config.cli_chunk_size, config.num_threads, config.mem_cap_percent
        )
    return DIST_DEFAULT_CHUNK


def plan_bounds(config: CoreConfig, total: int, mm, nproc: int) -> List[int]:
    if config.mode == Mode.BPE:
        table = config.table()
        if table.flat:
            return safe_split_bounds(mm, table.dense, nproc)
        return chunk_aligned_bounds(total, dist_chunk_size(config), nproc)
    return even_bounds(total, nproc)


def _allgather_counts(local_count: int) -> np.ndarray:
    """Per-process output byte counts in rank order (the one collective)."""
    import torch
    import torch.distributed as tdist

    mine = torch.tensor([local_count], dtype=torch.int64)
    out = [torch.zeros(1, dtype=torch.int64) for _ in range(tdist.get_world_size())]
    tdist.all_gather(out, mine)
    return torch.cat(out).numpy()


def _barrier() -> None:
    import torch.distributed as tdist

    tdist.barrier()


class _Spool:
    """Output spool for offset-unknown assembly: memory first, disk beyond.

    BPE and decode processes cannot know their output offset until the
    per-process counts are all-gathered, so results accumulate until then.
    Up to ``budget`` bytes they are held as buffer references (the engines
    yield fresh buffers per item) and each output byte crosses the
    filesystem once, at pwrite time; past the budget everything spills to a
    temp file next to the output and only the spilled bytes are written
    twice. The budget is half the memory-capped RAM; the engine pipeline
    keeps the other half.
    """

    def __init__(self, out_dir: str, budget: int):
        self.budget = budget
        self.out_dir = out_dir
        self.parts: list = []
        self.bytes = 0
        self.path: Optional[str] = None
        self._file = None

    def write(self, data) -> int:
        nb = getattr(data, "nbytes", None) or len(data)
        if self._file is None and self.bytes + nb > self.budget:
            self._spill()
        if self._file is not None:
            self._file.write(data)
        else:
            self.parts.append(data)
        self.bytes += nb
        return nb

    def _spill(self) -> None:
        f = tempfile.NamedTemporaryFile(dir=self.out_dir, prefix=".blt_spool_", delete=False)
        self.path = f.name
        self._file = f
        log.info("spool exceeding %d-byte memory budget; spilling to %s",
                 self.budget, self.path)
        for part in self.parts:
            f.write(part)
        self.parts.clear()

    def drain_to(self, fd: int, off: int) -> int:
        """pwrite all spooled bytes at ``off``; returns bytes written."""
        written = 0
        if self._file is not None:
            self._file.flush()
            with open(self.path, "rb") as sp:
                while True:
                    buf = sp.read(1 << 22)
                    if not buf:
                        break
                    written += _pwrite_all(fd, buf, off + written)
        for part in self.parts:
            written += _pwrite_all(fd, part, off + written)
        return written

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
        if self.path is not None:
            try:
                os.unlink(self.path)
            except OSError:
                pass
        self.parts.clear()


def _spool_budget(config: CoreConfig) -> int:
    """Memory the spool may hold before spilling: half the memcap'd RAM."""
    from blt_tpu_torch.utils.sysinfo import total_memory_bytes

    ram = total_memory_bytes()
    return max(64 << 20, int(ram * config.mem_cap_percent / 100) // 2)


def _pwrite_all(fd: int, buf, off: int) -> int:
    """pwrite the whole buffer at off (a short write would shift every
    following byte of this process's region); returns bytes written."""
    view = memoryview(buf)
    if view.format != "B" or view.ndim != 1:
        view = view.cast("B")
    written = 0
    while written < len(view):
        n = os.pwrite(fd, view[written:], off + written)
        if n == 0:
            raise OSError(f"pwrite wrote 0 of {len(view) - written} bytes")
        written += n
    return written


def _open_spool(config: CoreConfig) -> _Spool:
    return _Spool(os.path.dirname(os.path.abspath(config.output)) or ".",
                  _spool_budget(config))


def _place(spool: _Spool, fd: int, local_count: int, base: int, pid: int, nproc: int) -> int:
    """Write the spool at ``base`` plus the lower ranks' counts; returns
    the total output size."""
    counts = _allgather_counts(local_count) if nproc > 1 else np.array([local_count], np.int64)
    spool.drain_to(fd, base + int(counts[:pid].sum()))
    return base + int(counts.sum())


def _run_decode_distributed(config: CoreConfig, mm, total: int, pid: int, nproc: int) -> None:
    """Multi-process decode: a token-aligned even split, spooled assembly.

    Decode expands each id on its own (ops/decode.py), so any even offset
    after the verified header is a transparent boundary. Every process
    verifies the header (cheap, and the error is the same on every rank),
    decodes its token range and places its bytes at the all-gathered
    offset as the encode path does.
    """
    from blt_tpu_torch.ops.decode import (
        build_expansion_table,
        decode_wire,
        header_mismatch_error,
        missing_header_error,
        odd_trailing_error,
    )

    base = 0
    if config.content_type is not None:
        if total < 2:
            raise missing_header_error()
        tok = (int(mm[0]) << 8) | int(mm[1])
        if tok != config.content_type.token_value:
            raise header_mismatch_error(config.content_type, tok)
        base = 2
    if (total - base) % 2:
        raise odd_trailing_error()
    n_tokens = (total - base) // 2
    tok_bounds = even_bounds(n_tokens, nproc)
    lo = base + 2 * tok_bounds[pid]
    hi = base + 2 * tok_bounds[pid + 1]
    log.info("process %d/%d: tokens [%d, %d) of %d", pid, nproc,
             tok_bounds[pid], tok_bounds[pid + 1], n_tokens)

    table = build_expansion_table(config.bpe_data)
    feed = max(dist_chunk_size(config) & ~1, 2)

    fd = os.open(config.output, os.O_WRONLY | os.O_CREAT, 0o644)
    spool = _open_spool(config)
    try:
        local_count = 0
        for start in range(lo, hi, feed):
            out = decode_wire(mm[start : min(start + feed, hi)], table, config.num_threads)
            local_count += spool.write(out)
        total_out = _place(spool, fd, local_count, 0, pid, nproc)
        if pid == 0:
            os.ftruncate(fd, total_out)
    finally:
        # a failure mid-spool must not leak the temp file (the shared
        # output is left to the other ranks)
        spool.close()
        os.close(fd)

    if nproc > 1:
        _barrier()
    log.info("process %d/%d: wrote %d bytes", pid, nproc, local_count)


def run_tokenizer_distributed(config: CoreConfig, engine=None) -> None:
    """Execute one multi-process run (file -> shared file).

    Every process runs this function and encodes its own byte range with
    ``engine`` (an engine name or object; None reads ``config.engine``),
    writing at its exact offset in the shared output.
    """
    from blt_tpu_torch.parallel import distributed as dist
    from blt_tpu_torch.pipeline.engines import TorchEngine, select_engine
    from blt_tpu_torch.pipeline.runner import _device_batch_bytes, _plan_feed_size

    if config.input is None or str(config.input) == "-":
        raise ValueError("multi-process runs require a file input (stdin is per-process)")
    if config.output is None or str(config.output) == "-":
        raise ValueError("multi-process runs require a file output")

    pid = dist.process_index()
    nproc = dist.process_count()
    total = os.path.getsize(config.input)
    mm = np.memmap(config.input, dtype=np.uint8, mode="r") if total else np.empty(0, np.uint8)

    mode = config.mode
    if mode == Mode.DECODE:
        _run_decode_distributed(config, mm, total, pid, nproc)
        return

    bounds = plan_bounds(config, total, mm, nproc)
    lo, hi = bounds[pid], bounds[pid + 1]
    log.info("process %d/%d: bytes [%d, %d) of %d", pid, nproc, lo, hi, total)

    header = b""
    if config.content_type is not None:
        header = config.content_type.token_value.to_bytes(2, "big")

    # the host-RAM-independent chunk the bounds were planned with: general
    # BPE output depends on the chunk grid itself
    effective_chunk_size = dist_chunk_size(config)
    if engine is None or isinstance(engine, str):
        engine = select_engine(engine or config.engine.value, hi - lo, config.num_threads)
    invariant = mode in (Mode.BASIC, Mode.PASSTHROUGH) or (
        mode == Mode.BPE and config.table().flat
    )
    feed_size = effective_chunk_size
    if invariant and isinstance(engine, TorchEngine):
        feed_size = _plan_feed_size(effective_chunk_size, _device_batch_bytes())

    def chunks():
        for start in range(lo, hi, feed_size):
            yield mm[start : min(start + feed_size, hi)]

    if mode == Mode.PASSTHROUGH:
        results = engine.passthrough_stream(chunks(), feed_size)
    elif mode == Mode.BASIC:
        results = engine.basic_stream(chunks(), feed_size)
    else:
        results = engine.bpe_stream(chunks(), config.table(), feed_size)

    fd = os.open(config.output, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        if mode in (Mode.BASIC, Mode.PASSTHROUGH):
            # size-deterministic: write directly at the known offset
            factor = 2 if mode == Mode.BASIC else 1
            off = len(header) + factor * lo
            for data in results:
                off += _pwrite_all(fd, data, off)
            local_count = off - (len(header) + factor * lo)
            if local_count != factor * (hi - lo):
                raise RuntimeError(f"wrote {local_count} bytes for input [{lo}, {hi})")
            total_out = len(header) + factor * total
        else:
            spool = _open_spool(config)
            try:
                local_count = 0
                for data in results:
                    local_count += spool.write(data)
                total_out = _place(spool, fd, local_count, len(header), pid, nproc)
            finally:
                # an encode failure mid-spool must not leak the temp file
                spool.close()
        if pid == 0:
            if header:
                os.pwrite(fd, header, 0)
            os.ftruncate(fd, total_out)
    finally:
        os.close(fd)

    if nproc > 1:
        _barrier()
    log.info("process %d/%d: wrote %d bytes", pid, nproc, local_count)
