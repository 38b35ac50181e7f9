"""Device probe for the torch port (replaces ``blt_tpu/utils/platform.py``
and ``blt_tpu.pipeline.engines._probe_device_engine``).

The probe is ``torch.cuda.is_available()``. A broken CUDA runtime is not
caught and turned into a quiet host fallback: it raises where it is found.
"""

from __future__ import annotations

import torch


def cuda_device() -> torch.device | None:
    """The first CUDA device, or None when the process sees none."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else None


def require_cuda() -> torch.device:
    """The first CUDA device; raises RuntimeError when there is none."""
    device = cuda_device()
    if device is None:
        raise RuntimeError(
            "the torch engine needs a CUDA device and torch.cuda.is_available() "
            "is false"
        )
    return device
