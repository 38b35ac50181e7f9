"""Sharded (multi-device) tokenization steps (port of
``blt_tpu/parallel/sharded.py``).

Corpus chunks are the rows of a (B, N) batch, row r on ``mesh[r]``
(``parallel/mesh.py``); the merges table is replicated. A batch is a 2-D
tensor or a sequence of B row tensors, each on its own device; ``lengths``
are host values (the engine lays the rows out on the host). Cross-row BPE
stitching is the JAX package's carry composition, in torch ops:

1. every row computes its match bits and last-non-match scan locally;
2. each row also computes its boundary carry-out for both possible
   carry-in values: a boolean transfer function per row;
3. the B transfer functions are composed in row order (the composition
   does not commute) on ``mesh[0]``: two bits a row cross devices;
4. rows resolve their starts with the true carry-in and compact locally
   (``torch.cummax``, a compaction by ``cumsum``).

Chained output equals the single-sequence reference for every flat table,
whatever B, N or the devices. ``pair_count_hist`` is the per-pair count
reduction: a ``bincount`` per row, the rows' histograms summed on
``mesh[0]``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from blt_tpu_torch.merges import NO_RULE
from blt_tpu_torch.ops import bpe_cuda
from blt_tpu_torch.ops.bpe_torch import _compact

_NEG_INF32 = -(2**31) + 1


def _scalar(value, dtype, device) -> torch.Tensor:
    """A host value or a one-element tensor -> 0-d tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype).reshape(())
    return torch.tensor(value, dtype=dtype, device=device)


def _replica(table, device) -> torch.Tensor:
    """The copy of a replicated table on ``device`` (a tensor or array, or
    the dict ``mesh.replicated`` returns)."""
    if isinstance(table, dict):
        return table[device]
    if isinstance(table, np.ndarray):
        table = torch.from_numpy(table)
    return table if table.device == device else table.to(device)


def _host_lengths(lengths) -> List[int]:
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.cpu()
    return [int(x) for x in np.asarray(lengths).reshape(-1)]


def _next_bytes(rows, lengths, next_byte_last) -> List[torch.Tensor]:
    """The one-byte halo of each row, on its device: the first byte of the
    next row. Rows are filled front to back, so an empty next row means
    every later row is empty too, and the stream continues at
    ``next_byte_last`` (the next batch's first byte, -1 at EOF)."""
    out = []
    for r, row in enumerate(rows):
        if r + 1 < len(rows) and lengths[r + 1] > 0:
            out.append(rows[r + 1][0].to(device=row.device, dtype=torch.int32))
        else:
            out.append(_scalar(next_byte_last, torch.int32, row.device))
    return out


def _pairs(row: torch.Tensor, length: int, next_byte: torch.Tensor):
    """A row's bytes as int32, its pair indices ``t * 256 + next`` and which
    pairs are valid (both bytes in the stream)."""
    n = row.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=row.device)
    t = row.to(torch.int32)
    nxt = torch.roll(t, -1)
    nxt[max(length - 1, 0)] = torch.clamp(next_byte, min=0)
    valid = (idx < length - 1) | ((idx == length - 1) & (next_byte >= 0))
    return idx, t, t * 256 + nxt, valid


def _row_phase1(row, length: int, next_byte, dense):
    """Per row: pair values, match bits, last-non-match scan, and the
    carry-out under carry-in 0 and 1."""
    idx, t, pair, valid = _pairs(row, length, next_byte)
    pv = dense[pair.long()]
    match = valid & (pv != NO_RULE)
    lnm = torch.cummax(torch.where(match, _NEG_INF32, idx), 0).values
    last_i = max(length - 1, 0)

    def carry_out(carry_in: int) -> torch.Tensor:
        if length == 0:
            # an empty row is the identity transfer: a pending consumed-byte
            # flag passes through it to the next non-empty row
            return torch.tensor(bool(carry_in), device=row.device)
        lz = torch.clamp(lnm[last_i], min=-1 - carry_in)
        s_last = match[last_i] & (((last_i - lz) & 1) == 1)
        return s_last & (next_byte >= 0)

    return idx, t, pv, match, lnm, carry_out(0), carry_out(1)


def _row_phase2(idx, t, pv, match, lnm, length: int, carry_in: torch.Tensor):
    """Per row: resolve starts with the true carry, compact."""
    lz = torch.maximum(lnm, -1 - carry_in.to(torch.int32))
    starts = match & (((idx - lz) & 1) == 1)
    consumed = torch.roll(starts, 1)
    consumed[0] = carry_in & (length > 0)
    keep = (~consumed) & (idx < length)
    return _compact(torch.where(starts, pv, t), keep)


def _finish(phase1, lengths, row_carry) -> Tuple[List[torch.Tensor], torch.Tensor]:
    tokens, counts = [], []
    for p, length, carry in zip(phase1, lengths, row_carry):
        toks, count = _row_phase2(*p[:5], length, carry)
        tokens.append(toks)
        counts.append(count)
    dev0 = tokens[0].device
    return tokens, torch.stack([c.to(dev0) for c in counts])


def sharded_flat_encode(
    batch,  # uint8 (B, N) tensor, or B row tensors; rows = consecutive chunks
    lengths,  # host ints (B,)
    dense,  # int32[65536] array or tensor, or mesh.replicated's dict
    carry_in=False,  # did the previous batch's final byte start a merge?
    next_byte_last=-1,  # first byte of the next batch, -1 at EOF
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Exact flat BPE over a row-sharded batch.

    Returns (tokens: B int32[N] tensors, each on its row's device and
    compacted to its count; counts int32[B] on row 0's device; carry_out, a
    0-d bool tensor on row 0's device). Output rows concatenated in order
    (each trimmed to its count) equal single-sequence encoding of the
    concatenated input rows; threading ``carry_out`` into the next call's
    ``carry_in`` (with ``next_byte_last``) extends that across batches.
    """
    rows = list(batch)
    lengths = _host_lengths(lengths)
    next_bytes = _next_bytes(rows, lengths, next_byte_last)
    phase1 = [
        _row_phase1(row, length, nb, _replica(dense, row.device))
        for row, length, nb in zip(rows, lengths, next_bytes)
    ]
    # compose the transfer functions in row order: row r's carry-in is the
    # batch's carry_in through rows 0..r-1
    dev0 = rows[0].device
    carry = _scalar(carry_in, torch.bool, dev0)
    row_carry = []
    for row, p in zip(rows, phase1):
        row_carry.append(carry.to(row.device))
        carry = torch.where(carry, p[6].to(dev0), p[5].to(dev0))
    tokens, counts = _finish(phase1, lengths, row_carry)
    return tokens, counts, carry


def sharded_flat_encode_rowlocal(batch, lengths, dense):
    """Per-row independent flat encode: no carry composition, no halo, so
    deliberately not exact at row boundaries. The scaling benchmark's
    decomposition control (the same per-row compute as
    ``sharded_flat_encode`` minus the composition and the halo). Returns
    (tokens, counts) as ``sharded_flat_encode``."""
    rows = list(batch)
    lengths = _host_lengths(lengths)
    phase1 = [
        _row_phase1(row, length, _scalar(-1, torch.int32, row.device),
                    _replica(dense, row.device))
        for row, length in zip(rows, lengths)
    ]
    zero = [torch.zeros((), dtype=torch.bool, device=row.device) for row in rows]
    return _finish(phase1, lengths, zero)


def sharded_basic_encode(batch) -> List[torch.Tensor]:
    """uint8 rows -> uint16 rows ``b << 8`` (LE image = u16-BE wire), K1 on
    each row (``bpe_cuda.basic_encode``: the kernel on a CUDA row, its plain
    version on a CPU row)."""
    return [bpe_cuda.basic_encode(row) for row in batch]


def pair_count_hist(batch, lengths) -> torch.Tensor:
    """Global byte-pair frequency histogram (int64[65536] on row 0's
    device): a ``bincount`` per row, including the pair across each row
    boundary (the same one-byte halo as encoding), summed on row 0's
    device."""
    rows = list(batch)
    lengths = _host_lengths(lengths)
    dev0 = rows[0].device
    hist = torch.zeros(65536, dtype=torch.int64, device=dev0)
    for row, length, nb in zip(rows, lengths, _next_bytes(rows, lengths, -1)):
        _, _, pair, valid = _pairs(row, length, nb)
        hist += torch.bincount(pair[valid].long(), minlength=65536).to(dev0)
    return hist
