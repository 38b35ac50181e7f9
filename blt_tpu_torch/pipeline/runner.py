"""The tokenizer run loop for the torch port (port of
``blt_tpu/pipeline/runner.py::run_tokenizer``).

I/O setup, chunk planning, decode and the ordered writer are copies of the
JAX package's helpers. What differs: the engine is the port's
(``config.engine``, an engine name, or an engine object the caller passes).
``BLT_WARMUP=1`` (or ``full``) runs ``warmup.warm_for_run`` before the
first batch, and ``BLT_PROFILE=<dir>`` traces the compute and drain under
``torch.profiler`` (``utils/profiling.py``), at the JAX runner's places.
With the multi-process contract set (``BLT_COORDINATOR_ADDRESS`` and the
two others), the run goes to ``parallel/multihost.py``.

Chunk-feed sizing (as the JAX runner):
- passthrough / basic / flat-BPE outputs are chunk-size invariant, so the
  device engine is fed large batches (``_device_batch_bytes``) whatever the
  CLI chunk size, which then only caps host memory;
- general (non-flat) BPE keeps the reference's per-chunk semantics, so its
  chunks are exactly the effective chunk size.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Iterator, Optional

import numpy as np

from blt_tpu_torch.config import CoreConfig, Mode
from blt_tpu_torch.io.sources import OutputWriter, kernel_copy, setup_io
from blt_tpu_torch.pipeline.engines import (
    AutoStreamEngine,
    ShardedTorchEngine,
    TorchEngine,
    select_engine,
)
from blt_tpu_torch.utils.chunking import get_effective_chunk_size, mem_budget_bytes
from blt_tpu_torch.utils.logging import get_logger, span
from blt_tpu_torch.utils.profiling import maybe_profile

log = get_logger("runner")

DEVICE_BATCH_BYTES = 16 * 1024 * 1024


def _device_batch_bytes() -> int:
    """Device feed batch size; env-tunable (tests use small batches)."""
    return int(os.environ.get("BLT_DEVICE_BATCH_BYTES", DEVICE_BATCH_BYTES))


def _plan_feed_size(chunk: int, dev: int) -> int:
    """Device feed size for size-invariant modes: full ``dev``-sized
    batches; an explicit larger ``--chunksize`` raises it."""
    return max(dev, chunk)


def run_tokenizer(config: CoreConfig, engine=None) -> None:
    """Execute one tokenization run.

    ``engine`` is an engine name (``"torch"``, ``"shard"``, ``"numpy"`` or
    ``"auto"``) or an engine object; None reads ``config.engine`` (``torch``
    unless the caller chose otherwise). A multi-process run passes it on
    to ``multihost.run_tokenizer_distributed``.
    """
    log.info("Starting tokenizer")
    from blt_tpu_torch.parallel import multihost

    if multihost.env_distributed():
        # every process runs its byte range into the shared output
        from blt_tpu_torch.parallel import distributed as dist

        multihost.initialize_from_env()
        if dist.process_count() > 1:
            multihost.run_tokenizer_distributed(config, engine)
            return
    mode = config.mode
    effective_chunk_size = get_effective_chunk_size(
        config.cli_chunk_size, config.num_threads, config.mem_cap_percent
    )
    log.info("Chunk size determined: %d", effective_chunk_size)

    src, writer = setup_io(config.input, config.output)
    try:
        if mode == Mode.DECODE:
            from blt_tpu_torch.ops.decode import build_expansion_table

            table = build_expansion_table(config.bpe_data)
            results = _decode_stream(
                src.chunks(effective_chunk_size), table, config.content_type,
                threads=config.num_threads,
            )
            with maybe_profile():
                _drain_to_writer(results, writer)
            log.info("Detokenizer run completed successfully")
            return

        if config.content_type is not None:
            writer.write(config.content_type.token_value.to_bytes(2, "big"))

        if mode == Mode.PASSTHROUGH and kernel_copy(src, writer):
            log.info("Passthrough completed via kernel zero-copy")
            return

        if engine is None or isinstance(engine, str):
            engine = select_engine(
                engine or config.engine.value,
                src.size,
                config.num_threads,
                mem_budget=mem_budget_bytes(config.mem_cap_percent),
            )
        log.info("Using %s strategy on %s engine", mode.value, engine.name)

        feed_size = effective_chunk_size
        invariant_output = mode in (Mode.BASIC, Mode.PASSTHROUGH) or (
            mode == Mode.BPE and config.table().flat
        )
        if isinstance(engine, (TorchEngine, AutoStreamEngine)) and invariant_output:
            feed_size = _plan_feed_size(effective_chunk_size, _device_batch_bytes())

        warm_env = os.environ.get("BLT_WARMUP", "0")
        # the sharded engine first: it is a TorchEngine, and warm_for_run
        # warms one device's encoders, which it does not run
        if warm_env in ("1", "full") and isinstance(engine, ShardedTorchEngine):
            log.info("BLT_WARMUP: skipped (the sharded engine's row layout is not "
                     "covered by the one-device warm-up)")
        elif warm_env in ("1", "full") and isinstance(engine, TorchEngine):
            from blt_tpu_torch.warmup import warm_for_run

            warm_for_run(
                mode,
                config.table() if mode == Mode.BPE else None,
                feed_size,
                engine.device,
                _device_batch_bytes(),
                config.num_threads,
                full=warm_env == "full",
            )

        chunks = src.chunks(feed_size)
        if mode == Mode.PASSTHROUGH:
            results = engine.passthrough_stream(chunks, feed_size)
        elif mode == Mode.BASIC:
            results = engine.basic_stream(chunks, feed_size)
        else:
            results = engine.bpe_stream(chunks, config.table(), feed_size)
        # BLT_PROFILE=<dir> traces the whole compute and drain (the engines'
        # streams are lazy generators, so every launch runs inside it)
        with maybe_profile(getattr(engine, "device", None)):
            _drain_to_writer(results, writer)
    except BaseException:
        # a failed run removes its partial output file (as the JAX runner)
        try:
            writer.close()
        except OSError:
            pass
        if writer.path is not None and str(writer.path) != "-":
            try:
                os.unlink(writer.path)
                log.info("Removed partial output %s after failure", writer.path)
            except OSError:
                pass
        raise
    finally:
        writer.close()
    log.info("Tokenizer run completed successfully")


def _decode_stream(
    chunks, table, content_type, threads: int = 0
) -> Iterator[np.ndarray]:
    """Stream u16-BE wire chunks through the detokenizer.

    Chunk boundaries may split a token (stream short reads are odd-length
    at will, io/sources.py), so a sub-token byte carries to the next chunk.
    With a content type configured, the leading header token is verified
    and stripped — the exact inverse of the encoder's prepend.
    """
    from blt_tpu_torch.ops.decode import (
        decode_wire,
        header_mismatch_error,
        missing_header_error,
        odd_trailing_error,
    )

    carry = np.empty(0, dtype=np.uint8)
    header_pending = content_type is not None
    for chunk in chunks:
        if chunk.shape[0] == 0:
            continue
        data = np.concatenate([carry, chunk]) if carry.size else chunk
        if header_pending:
            if data.shape[0] < 2:
                carry = data.copy()
                continue
            tok = (int(data[0]) << 8) | int(data[1])
            if tok != content_type.token_value:
                raise header_mismatch_error(content_type, tok)
            data = data[2:]
            header_pending = False
        n = data.shape[0] & ~1
        if n:
            yield decode_wire(data[:n], table, threads)
        carry = data[n:].copy()
    if header_pending:
        # the encoder emits the header even for empty input, so a stream
        # ending first (even mid-header: a lone byte) is this error, not
        # the generic odd-trailing-byte one
        raise missing_header_error()
    if carry.size:
        raise odd_trailing_error()


def _drain_to_writer(results: Iterator, writer: OutputWriter) -> None:
    """Write ordered results, overlapping disk writes with compute.

    The per-chunk debug spans are the analog of the reference's
    ``process_chunk_task`` tracing spans (pipeline.rs:148,348).
    """
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        prev: Optional[concurrent.futures.Future] = None
        for chunk_id, data in enumerate(results):
            nbytes = getattr(data, "nbytes", None) or len(data)
            with span(log, "drain_chunk", chunk_id=chunk_id, bytes=nbytes):
                if prev is not None:
                    prev.result()
                prev = pool.submit(writer.write, data)
        if prev is not None:
            prev.result()
