"""Passthrough mode: exact byte copy, no tokenization (copy of
``blt_tpu/ops/passthrough.py``).

Reference: blt_core/src/tokenizer.rs:136-145 ``PassthroughStrategy`` — the
chunk is returned unchanged; with a content-type header the output is the
2-byte header followed by a raw copy (lib.rs:254-263, tests/cli.rs:196-214).

This is a host-only device-bypass path: round-tripping bytes through the card
would only add PCIe traffic for an identity map.
"""

from __future__ import annotations

import numpy as np


def passthrough_encode_np(data: np.ndarray) -> np.ndarray:
    return data
