"""Merge tables on the device, and state carried over from the JAX package.

Flat tables: the Pallas flat kernel ships a merge table in one of four
lookup layouts (chd, perfect, cuckoo, direct; ``blt_tpu/ops/bpe_pallas.py``),
because a TPU vector gather is 128 lanes wide. All four compute one
function: the pre-byteswapped rule value of a byte pair, or "no rule". On
the card one dense 64K-entry u16 table (128 KB) computes it for every table
size (``wire_table``).

General tables: keys are any (u16, u16) pair, too many for a dense table,
so the token passes keep the JAX package's two-plane cuckoo32 layout
(``MergeTable.build_cuckoo32``): four int32 planes of ``slots`` entries and
two hash multipliers (``CuckooPlanes``). A table of more than 8192 rules,
which that placement refuses, is placed on wider planes of up to 65,536
slots (``cuckoo32_placement``), which the kernels take as they are: the
slot count is a launch argument.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from blt_tpu_torch.merges import NO_RULE, MergeTable
from blt_tpu_torch.pipeline import feeder

# The wide cuckoo32 placement (``cuckoo32_placement``): planes of 16,384 to
# 65,536 slots, at most 0.8 rules a slot of one plane.
WIDE_MIN_SLOTS = 16384
WIDE_MAX_SLOTS = 65536
WIDE_MAX_LOAD = 0.8
_WIDE_MEMO = "_cuckoo32_wide_memo"


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


@dataclass(frozen=True)
class CuckooPlanes:
    """A general table's cuckoo32 planes on a device.

    ``k1, v1, k2, v2`` are int32[slots] (slots a power of two; an empty
    slot holds value -1); a pair's key ``p = a * 65536 + b`` wrapped to
    int32 sits at ``((p * a_j) >> shift) & (slots - 1)`` in plane j.
    """

    k1: torch.Tensor
    v1: torch.Tensor
    k2: torch.Tensor
    v2: torch.Tensor
    a1: int
    a2: int
    shift: int

    @property
    def slots(self) -> int:
        return self.k1.numel()


def planes_from_jax(k1, v1, k2, v2, a1, a2, device=None) -> CuckooPlanes:
    """The JAX ``PallasTokenEncoder``'s planes and hash constants (numpy
    arrays of shape (slots/128, 128) or (slots,), and ints) -> the port's
    ``CuckooPlanes`` on ``device``. ``shift = 32 - log2(slots)``, as
    ``bpe_pallas.py`` computes it."""
    planes = [np.array(x, dtype=np.int32).reshape(-1) for x in (k1, v1, k2, v2)]
    slots = planes[0].shape[0]
    if slots < 1 or slots & (slots - 1) or any(p.shape[0] != slots for p in planes):
        raise ValueError(f"cuckoo32 planes must share a power-of-two size, got "
                         f"{[p.shape[0] for p in planes]}")
    t = [torch.from_numpy(p).to(device) for p in planes]
    return CuckooPlanes(*t, a1=int(a1), a2=int(a2),
                        shift=32 - (slots.bit_length() - 1))


def wide_cuckoo_slots(n_rules: int) -> int | None:
    """The wide placement's slot count: the smallest power of two from
    ``WIDE_MIN_SLOTS`` that holds ``n_rules`` at ``WIDE_MAX_LOAD`` a slot or
    fewer (a two-plane load of at most 0.4), or None past ``WIDE_MAX_SLOTS``
    (more than 52,428 rules)."""
    slots = WIDE_MIN_SLOTS
    while n_rules > int(slots * WIDE_MAX_LOAD):
        if slots == WIDE_MAX_SLOTS:
            return None
        slots *= 2
    return slots


def cuckoo32_placement(table: MergeTable):
    """The planes the token passes run on, as numpy arrays and ints: the
    default placement (``table.build_cuckoo32()``, up to 8192 slots, the
    JAX package's), else the wide one (``build_cuckoo32`` at
    ``wide_cuckoo_slots``: the same hash, wrap-around and seed sequence,
    planes the JAX package never makes), else None (the table takes the
    plain twin). The wide placement is asked for only where the default
    fails, is memoized on the table as the default build is, and counts
    each placement made once under ``cuckoo.wide`` (bytes: its four
    planes) in ``feeder.stage_stats``."""
    built = table.build_cuckoo32()
    if built is not None:
        return built
    if _WIDE_MEMO not in table.__dict__:
        slots = wide_cuckoo_slots(len(table))
        wide = None if slots is None else table.build_cuckoo32(slots=slots)
        if wide is not None:
            feeder.count("cuckoo.wide", 1, 4 * 4 * slots)
        table.__dict__[_WIDE_MEMO] = wide
    return table.__dict__[_WIDE_MEMO]


def cuckoo_planes(table: MergeTable, device=None):
    """``cuckoo32_placement(table)`` on ``device``, or None when neither
    placement takes the table."""
    built = cuckoo32_placement(table)
    return None if built is None else planes_from_jax(*built, device=device)
