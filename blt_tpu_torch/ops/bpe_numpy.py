"""Vectorized NumPy BPE engine (host/CPU path; copy of
``blt_tpu/ops/bpe_numpy.py``).

Same observable semantics as the reference algorithm
(reference: blt_core/src/tokenizer.rs:56-93), re-derived as data-parallel
primitives instead of a sequential scan. The core identity: within one pass,
the reference's leftmost-first non-overlapping matching obeys

    merge_start[i] = match[i] AND NOT merge_start[i-1]

which, over each maximal run of consecutive matches, alternates
merge/no-merge starting at the run head. So per pass:

1. ``match[i]`` — pair (t[i], t[i+1]) is in the table (vectorized lookup);
2. run-parity resolve via a cumulative max of "last non-match position";
3. masked compaction.

For *flat* tables (no merge value ever re-merges; all file-loaded tables,
see blt_tpu_torch.merges.MergeTable.flat) the multi-pass loop provably terminates
after a single merging pass, so ``bpe_encode_flat`` does one parity scan over
raw bytes. These same building blocks map 1:1 onto the JAX/Pallas device
kernels in bpe_jax.py / bpe_pallas.py.
"""

from __future__ import annotations

import numpy as np

from blt_tpu_torch.merges import NO_RULE, MergeTable


def _merge_starts(match: np.ndarray) -> np.ndarray:
    """Resolve merge_start[i] = match[i] & ~merge_start[i-1] by run parity."""
    n = match.shape[0]
    idx = np.arange(n, dtype=np.int64)
    # Position of the most recent non-match at or before i (-1 if none).
    last_nonmatch = np.maximum.accumulate(np.where(~match, idx, -1))
    # Run offset parity: the run head (offset 0) merges, alternating after.
    return match & (((idx - last_nonmatch) & 1) == 1)


def _pair_values_dense(tokens: np.ndarray, dense: np.ndarray) -> np.ndarray:
    """Dense 256x256 lookup of pair values; NO_RULE where no rule/tokens>=256."""
    left = tokens[:-1]
    right = tokens[1:]
    in_range = (left < 256) & (right < 256)
    pair_idx = np.where(in_range, left * 256 + right, 0)
    vals = dense[pair_idx]
    return np.where(in_range, vals, NO_RULE)


def _pair_values_sparse(tokens: np.ndarray, table: MergeTable) -> np.ndarray:
    """Sorted-key binary-search lookup for general (u16,u16) keys."""
    if len(table.sparse_keys) == 0:
        return np.full(max(tokens.shape[0] - 1, 0), NO_RULE, dtype=np.int32)
    keys = (tokens[:-1].astype(np.uint32) << 16) | tokens[1:].astype(np.uint32)
    pos_c = np.minimum(np.searchsorted(table.sparse_keys, keys),
                       len(table.sparse_keys) - 1)
    hit = table.sparse_keys[pos_c] == keys
    return np.where(hit, table.sparse_vals[pos_c], NO_RULE)


def bpe_encode_flat_carry(
    data: np.ndarray,
    table: MergeTable,
    carry_in: bool,
    next_byte: int,
) -> tuple[np.ndarray, bool]:
    """Carry-chained single-pass encode for one chunk of a larger stream.

    Mirror of the device kernel bpe_jax.flat_encode: ``carry_in`` marks the
    first byte as already consumed by a merge that ended the previous chunk
    (shifting the parity of the initial match run); ``next_byte`` (-1 at EOF)
    is a one-byte halo so a merge may start on the final byte, whose merged
    token is emitted HERE and reported via ``carry_out``. Chaining chunks
    with these carries is bit-equal to encoding the concatenated stream in
    one call — the chunk-size-invariance mechanism (SURVEY.md 2.1.6).
    """
    assert table.flat, "carry chaining requires a flat merge table"
    n = data.shape[0]
    if n == 0:
        # an empty chunk consumes nothing: the pending carry (the previous
        # chunk's final merge reaching into the next real byte) passes
        # through untouched, keeping the chaining identity exact
        return np.empty(0, dtype=np.int32), carry_in
    b = data.astype(np.int32, copy=False)
    nxt = np.empty(n, dtype=np.int32)
    nxt[:-1] = b[1:]
    nxt[-1] = next_byte if next_byte >= 0 else 0
    pair_idx = b * 256 + nxt
    pair_vals = table.dense[pair_idx]
    match = pair_vals != NO_RULE
    if next_byte < 0:
        match[-1] = False

    idx = np.arange(n, dtype=np.int64)
    sentinel = -2 if carry_in else -1
    last_nonmatch = np.maximum.accumulate(np.where(~match, idx, np.int64(-(2**31))))
    last_nonmatch = np.maximum(last_nonmatch, sentinel)
    starts = match & (((idx - last_nonmatch) & 1) == 1)

    consumed = np.empty(n, dtype=bool)
    consumed[0] = carry_in
    consumed[1:] = starts[:-1]
    out_vals = np.where(starts, pair_vals, b)
    carry_out = bool(starts[-1]) and next_byte >= 0
    return out_vals[~consumed].astype(np.int32, copy=False), carry_out


def bpe_encode_flat(data: np.ndarray, table: MergeTable) -> np.ndarray:
    """Single-parity-pass encode over raw bytes, exact for flat tables.

    Bit-equal to the reference run with chunk size >= input, for every table
    loadable from a merges file (keys < 256, values >= 256).
    Returns int32 token ids.
    """
    assert table.flat, "bpe_encode_flat requires a flat merge table"
    n = data.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int32)
    b = data.astype(np.int32, copy=False)
    if n == 1:
        return b.copy()
    pair_vals = _pair_values_dense(b, table.dense)
    match = pair_vals != NO_RULE
    starts = _merge_starts(match)
    consumed = np.empty(n, dtype=bool)
    consumed[0] = False
    consumed[1:] = starts
    out_vals = np.where(np.append(starts, False), np.append(pair_vals, NO_RULE), b)
    return out_vals[~consumed].astype(np.int32, copy=False)


def bpe_encode_multipass(data: np.ndarray, table: MergeTable) -> np.ndarray:
    """General multi-pass encode, exact for arbitrary tables.

    Handles hierarchical rules (e.g. (256,99)->257, tokenizer.rs:204-212) and
    value/byte collisions (tokenizer.rs:283-291). Each pass is vectorized;
    the pass loop mirrors the reference's outer ``loop``.
    """
    tokens = data.astype(np.int32, copy=False)
    if tokens.shape[0] == 0:
        return np.empty(0, dtype=np.int32)
    while tokens.shape[0] >= 2:
        pair_vals = _pair_values_sparse(tokens, table)
        match = pair_vals != NO_RULE
        if not match.any():
            break
        starts = _merge_starts(match)
        n = tokens.shape[0]
        consumed = np.empty(n, dtype=bool)
        consumed[0] = False
        consumed[1:] = starts
        out_vals = np.where(
            np.append(starts, False), np.append(pair_vals, NO_RULE), tokens
        )
        tokens = out_vals[~consumed]
    return tokens.astype(np.int32, copy=False)


def bpe_encode(data: np.ndarray, table: MergeTable) -> np.ndarray:
    """Dispatch to the flat fast path when exact, else multi-pass."""
    if table.flat:
        return bpe_encode_flat(data, table)
    return bpe_encode_multipass(data, table)
