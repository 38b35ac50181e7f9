"""``torch.profiler`` integration (port of ``blt_tpu/utils/profiling.py``).

Setting ``BLT_PROFILE=<dir>`` wraps a tokenizer run in
``torch.profiler.profile`` and writes one Chrome trace
(``blt_trace_<pid>_<ns>.json``) into ``<dir>``: host activity always,
the device's kernels and copies too when the run's device is a CUDA
device. Open it in Perfetto or ``chrome://tracing``. Unset, it costs
nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

from blt_tpu_torch.utils.logging import get_logger

log = get_logger("profiling")

ENV_VAR = "BLT_PROFILE"


@contextlib.contextmanager
def maybe_profile(device=None) -> Iterator[None]:
    """Trace the block under ``torch.profiler`` when ``BLT_PROFILE`` is set;
    ``device`` is the run's ``torch.device`` (None: the host only)."""
    outdir = os.environ.get(ENV_VAR)
    if not outdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"blt_trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    log.info("Wrote the torch.profiler trace %s", path)
