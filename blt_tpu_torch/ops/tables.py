"""Merge tables and stream state carried over from the JAX package.

The Pallas flat kernel ships a merge table in one of four lookup layouts
(chd, perfect, cuckoo, direct; ``blt_tpu/ops/bpe_pallas.py``), because a
TPU vector gather is 128 lanes wide. All four compute one function: the
pre-byteswapped rule value of a byte pair, or "no rule". On the card one
dense 64K-entry u16 table (128 KB) computes it for every table size.
"""

from __future__ import annotations

import numpy as np
import torch

from blt_tpu.merges import NO_RULE


def wire_table(dense: np.ndarray, device=None) -> torch.Tensor:
    """``MergeTable.dense`` (int32[65536], ``NO_RULE`` = no rule) -> uint16.

    Values are byteswapped, so a hit is emitted as-is on the u16-BE wire,
    and "no rule" is 0. 0 is a legal sentinel because the flat kernel only
    takes tables whose values are all >= 256, which stay nonzero when
    swapped. 0xFFFF is an ordinary value here (rule (255,255) -> 65535
    needs no special case).
    """
    dense = np.asarray(dense)
    if dense.shape != (65536,):
        raise ValueError(f"dense table must have 65536 entries, got {dense.shape}")
    rules = dense != NO_RULE
    if np.any(rules & ((dense < 256) | (dense > 0xFFFF))):
        raise ValueError("wire table requires every rule value in [256, 65535]")
    v = np.where(rules, dense, 0).astype(np.uint32)
    swapped = (((v & 0xFF) << 8) | (v >> 8)).astype(np.uint16)
    return torch.from_numpy(swapped).to(device)


def state_from_jax(carry, prev_slot, device=None):
    """The JAX encoder's stream state -> the port's on-device state.

    ``carry`` is the (1,1) int32 carry a Pallas flat encoder returns and
    ``prev_slot`` its int32 last raw slot. Returns ``(carry, prev_slot)``
    as int32 tensors of the same shapes, (1,1) and (), on ``device``.
    """
    c = torch.tensor(np.asarray(carry, dtype=np.int32).reshape(1, 1), device=device)
    p = torch.tensor(int(np.asarray(prev_slot)), dtype=torch.int32, device=device)
    return c, p
