"""Basic byte->u16 tokenization (the default mode; copy of
``blt_tpu/ops/basic.py``).

Reference: blt_core/src/tokenizer.rs:106-124 ``BasicTokenizationStrategy`` —
each input byte b becomes the u16 token with value b (0-255, despite the
doc comment claiming 256-511; the code and tests pin no offset,
tokenizer.rs:248-258), serialized big-endian, so output is exactly 2x the
input. Chunk-size invariant by construction.

On host this is a single vectorized widening (`astype('>u2')`), which is the
memory-bandwidth speed-of-light for the operation. The card's widen is the
CUDA kernel ``csrc/widen.cu`` (``ops.bpe_cuda.basic_encode``).
"""

from __future__ import annotations

import numpy as np


def basic_encode_np(data: np.ndarray) -> np.ndarray:
    """bytes (uint8[n]) -> token ids int32[n] (identity widen)."""
    return data.astype(np.int32, copy=False)


def basic_encode_bytes_np(data: np.ndarray) -> bytes:
    """bytes (uint8[n]) -> u16 BE wire format, zero-fill high bytes."""
    return data.astype(">u2").tobytes()
