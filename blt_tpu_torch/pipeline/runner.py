"""The tokenizer run loop for the torch port (port of
``blt_tpu/pipeline/runner.py::run_tokenizer``).

I/O setup, chunk planning, decode and the ordered writer are the JAX
package's own helpers, imported. What differs: the engine is the port's
(``engines.select_engine`` or an engine object the caller passes), and
there is no multi-host branch, warm-up or profiling yet (ROADMAP.md).
"""

from __future__ import annotations

import os

from blt_tpu.config import CoreConfig, Mode
from blt_tpu.io.sources import kernel_copy
from blt_tpu.pipeline.runner import (
    _decode_stream,
    _device_batch_bytes,
    _drain_to_writer,
    _plan_feed_size,
    get_effective_chunk_size,
    setup_io,
)
from blt_tpu.utils.chunking import mem_budget_bytes
from blt_tpu.utils.logging import get_logger
from blt_tpu_torch.pipeline.engines import (
    AutoStreamEngine,
    TorchEngine,
    select_engine,
)

log = get_logger("torch_runner")


def run_tokenizer(config: CoreConfig, engine=None) -> None:
    """Execute one tokenization run.

    ``engine`` is ``"auto"`` (the default), ``"torch"`` or ``"numpy"``, or
    an engine object. ``config.engine`` is not read: the JAX package's
    ``Engine`` enum has no torch member.
    """
    log.info("Starting tokenizer")
    mode = config.mode
    effective_chunk_size = get_effective_chunk_size(
        config.cli_chunk_size, config.num_threads, config.mem_cap_percent
    )
    log.info("Chunk size determined: %d", effective_chunk_size)

    src, writer = setup_io(config.input, config.output)
    try:
        if mode == Mode.DECODE:
            from blt_tpu.ops.decode import build_expansion_table

            table = build_expansion_table(config.bpe_data)
            results = _decode_stream(
                src.chunks(effective_chunk_size), table, config.content_type,
                threads=config.num_threads,
            )
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
                engine or "auto",
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
            feed_size = _plan_feed_size(
                src.size, effective_chunk_size, _device_batch_bytes()
            )

        chunks = src.chunks(feed_size)
        if mode == Mode.PASSTHROUGH:
            results = engine.passthrough_stream(chunks, feed_size)
        elif mode == Mode.BASIC:
            results = engine.basic_stream(chunks, feed_size)
        else:
            results = engine.bpe_stream(chunks, config.table(), feed_size)
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
