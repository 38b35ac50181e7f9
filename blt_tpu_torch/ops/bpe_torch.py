"""Plain PyTorch tokenization ops: the port of ``blt_tpu/ops/bpe_jax.py``.

``flat_encode`` is the single parity-scan pass over raw bytes, exact for
flat tables, with the same batch stitching as the JAX version: ``carry_in``
says the batch's first byte was consumed by a merge that ended the previous
batch, and ``next_byte`` is a one-byte halo from the following batch.
``lax.cummax`` becomes ``torch.cummax`` and the unique-index scatter
compaction becomes ``scatter_`` into a buffer with one trash slot, so no
step waits on the host.

``multipass_encode`` is the whole-sequence loop for general tables
(hierarchical rules, values that collide with bytes), exact reference
per-chunk semantics: ``jnp.searchsorted`` over the sorted pair keys becomes
``torch.searchsorted``, and ``lax.while_loop`` a Python loop that reads
"any merge, and at least two tokens left" on the host once per pass.
Each chunk's loop is one ``mp.chunk`` span, each read an ``mp.read`` span
inside it (``utils/logging``), and ``log_loop`` counts it, as the kernel
loops of ``multipass_cuda`` count theirs.

This module serves two purposes: it is the torch engine's twin route for
tables that the kernel encoders reject (flat tables with rule values below
256; general tables that cuckoo32 cannot place, more than 52,428 rules),
and it is a second CPU reference, independent of the kernels' plain
versions. ``_compact`` is also the kernel loops' compaction, and
``tokens_to_be_bytes_device`` the general route's wire.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from blt_tpu_torch.merges import NO_RULE, MergeTable
from blt_tpu_torch.pipeline import feeder
from blt_tpu_torch.utils.logging import MP_CHUNK, MP_READ, get_logger, span

log = get_logger("multipass")

_NEG_INF32 = -(2**31) + 1

# (passes, compactions) of each chunk's multipass loop, in order: the
# twin's and the kernel loops' (``multipass_cuda.loop_log`` is this list)
loop_log: list = []


def log_loop(route: str, nbytes: int, passes: int, compactions: int) -> None:
    """Count one chunk's multipass loop: its entry in ``loop_log``, and in
    ``feeder.stage_stats`` ``mp.<route>`` (items: chunks, bytes: input
    bytes) and ``mp.passes`` (items: passes)."""
    loop_log.append((passes, compactions))
    feeder.count(f"mp.{route}", 1, nbytes)
    feeder.count("mp.passes", passes)


def basic_encode(data: torch.Tensor) -> torch.Tensor:
    """uint8[N] -> uint16[N] whose little-endian image is the u16-BE stream
    (value b << 8 stores as [0, b])."""
    return (data.to(torch.int32) << 8).to(torch.uint16)


def tokens_to_be_bytes_device(tokens: torch.Tensor) -> torch.Tensor:
    """int32 token ids -> uint16 whose little-endian image is the u16-BE
    wire stream (a byteswap)."""
    swapped = ((tokens & 0xFF) << 8) | ((tokens >> 8) & 0xFF)
    return swapped.to(torch.uint16)


def _compact(vals: torch.Tensor, keep: torch.Tensor, fill: int = 0):
    """Stable stream compaction: kept vals to the front in order, ``fill``
    after them; returns (out, count)."""
    n = vals.shape[0]
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    scatter_idx = torch.where(keep, pos, torch.full_like(pos, n))
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
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


def _sparse_lookup(
    tokens: torch.Tensor,
    next_tok: torch.Tensor,
    keys: torch.Tensor,
    vals: torch.Tensor,
    valid_pair: torch.Tensor,
):
    """Sorted-key binary search for general (u16,u16) rule keys; the keys
    are uint32 values ``a << 16 | b`` held in int64."""
    k = ((tokens.to(torch.int64) << 16) | next_tok.to(torch.int64)) & 0xFFFFFFFF
    pos = torch.searchsorted(keys, k)
    pos_c = torch.clamp(pos, max=keys.shape[0] - 1)
    v = vals[pos_c]
    hit = (keys[pos_c] == k) & valid_pair & (v != NO_RULE)
    return torch.where(hit, v, NO_RULE), hit


def multipass_encode(
    data: torch.Tensor,  # uint8[N] padded
    length: int,  # valid bytes
    keys: torch.Tensor,  # int64[R] sorted pair keys (a<<16 | b)
    vals: torch.Tensor,  # int32[R] merge values (NO_RULE entries are ignored)
):
    """Whole-sequence passes until quiescence (tokenizer.rs:63-86 semantics).

    Exact for arbitrary tables including hierarchical rules. State is a
    fixed-size token buffer plus a length; each pass is the same lookup ->
    parity-scan -> compaction pipeline as ``flat_encode``. Returns (tokens
    int32[N], the token count as an int32 tensor).
    """
    n = data.shape[0]
    dev = data.device
    passes = 0
    with span(log, MP_CHUNK):
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        tokens = data.to(torch.int32)
        cur_len = torch.tensor(length, dtype=torch.int32, device=dev)
        go = length >= 2  # lax.while_loop's cond before the first pass
        while go:
            nxt = torch.roll(tokens, -1)
            valid_pair = idx < (cur_len - 1)
            pv, match = _sparse_lookup(tokens, nxt, keys, vals, valid_pair)
            lnm = torch.cummax(torch.where(match, _NEG_INF32, idx), 0).values
            starts = match & (((idx - torch.clamp(lnm, min=-1)) & 1) == 1)
            consumed = torch.roll(starts, 1)
            # a slice, filled on the device: an element write copies a host
            # scalar in, which waits on the stream (a second read a pass)
            consumed[:1] = False
            out_vals = torch.where(starts, pv, tokens)
            keep = (~consumed) & (idx < cur_len)
            tokens, cur_len = _compact(out_vals, keep)
            passes += 1
            with span(log, MP_READ):
                go = bool(starts.any() & (cur_len >= 2))  # one host read per pass
    log_loop("twin", length, passes, 0)
    return tokens, cur_len


def sparse_table_device(table: MergeTable, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table's sorted pair keys (int64) and values (int32) on ``device``."""
    keys = table.sparse_keys
    vals = table.sparse_vals
    if keys is None or len(keys) == 0:
        # Keep shapes non-empty; the NO_RULE value guarantees the
        # placeholder entry can never register as a hit.
        keys = np.array([0xFFFFFFFF], dtype=np.uint32)
        vals = np.array([NO_RULE], dtype=np.int32)
    return (
        torch.from_numpy(keys.astype(np.int64)).to(device),
        torch.from_numpy(np.ascontiguousarray(vals, dtype=np.int32)).to(device),
    )
