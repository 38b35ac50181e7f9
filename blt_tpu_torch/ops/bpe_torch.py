"""Plain PyTorch tokenization ops: the port of ``blt_tpu/ops/bpe_jax.py``.

``flat_encode`` is the single parity-scan pass over raw bytes, exact for
flat tables, with the same batch stitching as the JAX version: ``carry_in``
says the batch's first byte was consumed by a merge that ended the previous
batch, and ``next_byte`` is a one-byte halo from the following batch.
``lax.cummax`` becomes ``torch.cummax`` and the unique-index scatter
compaction becomes ``scatter_`` into a buffer with one trash slot, so no
step waits on the host.

This module serves two purposes: it is the torch engine's route for flat
tables that the kernel encoder rejects (rule values below 256), and it is a
second CPU reference, independent of the kernels' plain versions.
General-table multipass is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

from blt_tpu.merges import NO_RULE

_NEG_INF32 = -(2**31) + 1


def basic_encode(data: torch.Tensor) -> torch.Tensor:
    """uint8[N] -> uint16[N] whose little-endian image is the u16-BE stream
    (value b << 8 stores as [0, b])."""
    return (data.to(torch.int32) << 8).to(torch.uint16)


def tokens_to_be_bytes_device(tokens: torch.Tensor) -> torch.Tensor:
    """int32 token ids -> uint16 whose little-endian image is the u16-BE
    wire stream (a byteswap)."""
    swapped = ((tokens & 0xFF) << 8) | ((tokens >> 8) & 0xFF)
    return swapped.to(torch.uint16)


def _compact(vals: torch.Tensor, keep: torch.Tensor):
    """Stream compaction: kept vals to the front; returns (out, count)."""
    n = vals.shape[0]
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    scatter_idx = torch.where(keep, pos, torch.full_like(pos, n))
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    out.scatter_(0, scatter_idx, vals)
    return out[:n], keep.sum(dtype=torch.int32)


def flat_encode(
    data: torch.Tensor,  # uint8[N] padded byte buffer
    length: int,  # valid bytes
    dense: torch.Tensor,  # int32[65536] pair -> value, NO_RULE = miss
    carry_in: torch.Tensor,  # bool scalar: first byte already consumed
    next_byte: int,  # first byte of the next batch, -1 = end of stream
    emit_bytes: bool = True,
):
    """Single-pass flat BPE over a padded byte buffer with batch stitching.

    Returns (tokens int32[N] compacted, token_count, carry_out bool, and
    with ``emit_bytes`` the uint16[N] u16-BE image of the tokens).
    ``carry_out`` is True when a merge started on the final valid byte and
    consumed ``next_byte``.
    """
    n = data.shape[0]
    dev = data.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    t = data.to(torch.int32)
    nxt = torch.roll(t, -1)
    last_i = max(length - 1, 0)
    nxt[last_i] = next_byte if next_byte >= 0 else 0
    valid_pair = (idx < length - 1) | ((idx == length - 1) & (next_byte >= 0))

    pv = dense[(t * 256 + nxt).long()]
    match = valid_pair & (pv != NO_RULE)

    lnm = torch.cummax(torch.where(match, _NEG_INF32, idx), 0).values
    carry = carry_in.to(torch.int32).reshape(())
    lz = torch.maximum(lnm, -1 - carry)
    starts = match & (((idx - lz) & 1) == 1)
    consumed = torch.roll(starts, 1)
    consumed[0] = carry_in.reshape(()) & (length > 0)

    out_vals = torch.where(starts, pv, t)
    keep = (~consumed) & (idx < length)
    tokens, count = _compact(out_vals, keep)

    if length > 0:
        carry_out = starts[last_i] & (next_byte >= 0)
    else:
        carry_out = torch.zeros((), dtype=torch.bool, device=dev)

    if emit_bytes:
        return tokens, count, carry_out, tokens_to_be_bytes_device(tokens)
    return tokens, count, carry_out
