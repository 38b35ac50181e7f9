"""Warm-up before the first batch or request (port of ``blt_tpu/warmup.py``;
``BLT_WARMUP=1`` or ``full`` for a run, the server's ``--warmup SIZE``).

The port compiles nothing per shape: its kernels take any length. What
the first batch of a fresh process pays instead is:

- the kernel library's build (first use in a fresh checkout) and its
  ``ctypes`` load (``ops/_cuda_build.py``);
- CUDA's lazy load of each kernel's module on its first launch;
- a general table's cuckoo32 placement (memoized on the table);
- the first pinned host block and the first device blocks of each size
  (torch's caching allocators keep them once freed).

``warm_shapes`` pays these ahead: for each capacity it streams one small
payload through the torch engine on the run's device in the run's mode,
which launches each kernel that mode dispatches (K1; K2 fused with its
pack for a flat table; for a general one the K3 loop, or the K4 loop under
``BLT_MP_COMPACT=sort``, or for a table cuckoo32 cannot place the plain
twin, with the torch ops of their compactions and wire) at that
capacity's buffers.
A failure raises: a kernel that cannot build or launch fails the run where
it is found (the JAX package's ``warm_for_run`` logs and carries on).

Not ported: ``ladder_buckets`` (built on ``bucket_feed``, which bounds
Mosaic compiles; the port has nothing to bucket), and the persistent
compile cache the JAX module seeds (the kernel library's build directory,
keyed on a hash of the sources, does that job).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from blt_tpu_torch.config import Mode
from blt_tpu_torch.utils.logging import get_logger

log = get_logger("warmup")


def pow2_buckets(max_bytes: int) -> list:
    """The server's capacity buckets up to ``max_bytes``: powers of two
    from ``DEVICE_HINT_FLOOR``, the floor always among them."""
    from blt_tpu_torch.pipeline.engines import DEVICE_HINT_FLOOR

    out = []
    size = DEVICE_HINT_FLOOR
    while size <= max(max_bytes, DEVICE_HINT_FLOOR):
        out.append(size)
        size <<= 1
    return out


def warm_shapes(mode, table, capacities: Iterable[int], device, threads: int = 0) -> int:
    """Stream one 64-byte payload through ``TorchEngine(device)`` at each
    capacity in ``mode`` (with ``table`` for BPE) and wait for the device.
    Returns how many capacities were warmed: 0 off CUDA, and for
    passthrough, which never reaches the device."""
    from blt_tpu_torch.pipeline.engines import TorchEngine

    device = torch.device(device)
    if device.type != "cuda" or mode not in (Mode.BASIC, Mode.BPE):
        return 0
    engine = TorchEngine(device, threads=threads)
    probe = np.zeros(64, np.uint8)
    warmed = 0
    for cap in sorted({int(c) for c in capacities if c > 0}):
        if mode == Mode.BASIC:
            stream = engine.basic_stream(iter([probe]), cap)
        else:
            stream = engine.bpe_stream(iter([probe]), table, cap)
        for _ in stream:
            pass
        torch.cuda.synchronize(device)
        warmed += 1
        log.info("warmup: %s kernels at a %d-byte capacity", mode.value, cap)
    return warmed


def warm_for_run(
    mode, table, feed_size: int, device, max_bucket: int, threads: int = 0,
    full: bool = False,
) -> int:
    """``BLT_WARMUP`` entry: warm the run's feed capacity (every batch of
    the run, its short tail too, uses the encoder of that capacity) and,
    with ``full`` (``BLT_WARMUP=full``), the server's power-of-two buckets
    up to ``max_bucket`` as well. Raises on failure."""
    shapes = [feed_size]
    if full:
        shapes += pow2_buckets(max_bucket)
    return warm_shapes(mode, table, shapes, device, threads)
