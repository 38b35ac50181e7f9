"""Host-to-device upload for the torch engine (port of
``blt_tpu/pipeline/feeder.py::upload_owned``).

The pipeline stages themselves (``prefetch_iter`` and its ``stage_stats``)
and the multithreaded pack (``pack_into``) are the JAX package's own,
imported. What changes is the upload: each encoder packs into one pinned
host staging buffer, the copy is asynchronous on a side stream, and
``upload`` returns only after a CUDA event recorded after the copy has
completed. So the staging buffer can be refilled at once: without that
wait the next batch would overwrite it while the previous one is still in
flight.
"""

from __future__ import annotations

import numpy as np
import torch

from blt_tpu.pipeline.feeder import pack_into, prefetch_iter, stage_stats

__all__ = ["pack_into", "pinned_buffer", "prefetch_iter", "stage_stats", "upload"]


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
