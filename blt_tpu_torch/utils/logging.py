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
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Iterator

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


@contextlib.contextmanager
def span(logger: logging.Logger, name: str, **fields: Any) -> Iterator[None]:
    """A timing span logged at debug level (tracing-span analog)."""
    t0 = time.perf_counter()
    if fields:
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        logger.debug("enter %s %s", name, kv)
    else:
        logger.debug("enter %s", name)
    try:
        yield
    finally:
        dt = (time.perf_counter() - t0) * 1e3
        logger.debug("exit %s duration_ms=%.3f", name, dt)
