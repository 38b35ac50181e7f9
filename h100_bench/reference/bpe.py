"""The plain reference: what ``blt`` writes for a file, in plain PyTorch.

The semantics (the reference ``blt`` binary, ``tokenizer.rs`` BpeStrategy):
a chunk's bytes become tokens; passes repeat until one merges nothing; in a
pass the pairs are scanned left to right and a pair with a rule merges into
the rule's value, the scan then skipping past it (leftmost, non-overlapping,
no rank order). Chunks are independent. The output is a content-type header
token, when one is asked for, then every token as u16 big-endian.

The port's documented chunking: a *flat* table (every key a byte pair and
no rule's value a member of any key) makes one pass over the whole file,
which is ``blt`` run at a chunk of the file's size; a general table keeps
``blt``'s chunks of the configured size. This module decides flatness from
the table itself.

A pass in tensors: ``match[i]`` says the pair (t[i], t[i+1]) has a rule; a
run of matches that begins after the non-match at ``j`` merges at j+1, j+3,
..., so ``start = match & ((i - last_nonmatch(i)) odd)``. The last non-match
is found by a count and a gather (``torch.cummax`` is slow at this length).
Everything runs in blocks, so that it fits beside nothing else on the card.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

# content-type header tokens (blt_core/src/lib.rs ContentType)
HEADER_TOKENS = {"text": 0xFF01, "audio": 0xFF02, "bin": 0xFF03, "video": 0xFF04}

FLAT_BLOCK = 64 << 20  # bytes a block of the flat pass
GROUP_BYTES = 128 << 20  # input bytes a group of general chunks

Rules = Mapping[Tuple[int, int], int]


def is_flat(rules: Rules) -> bool:
    """Every key a byte pair, and no value a member of any key."""
    members = {x for pair in rules for x in pair}
    return all(a < 256 and b < 256 for a, b in rules) and not (set(rules.values()) & members)


def _starts(match: torch.Tensor, last_nonmatch_before: int) -> torch.Tensor:
    """The pairs that merge in one pass: ``match`` at an odd distance from
    the last non-match at or before it (``last_nonmatch_before``, as an index
    relative to this block, when the block holds none before it)."""
    n = match.numel()
    idx = torch.arange(n, device=match.device)
    nonmatch = ~match
    count = torch.cumsum(nonmatch, 0)
    where = torch.nonzero(nonmatch).flatten()
    if where.numel():
        lnm = torch.where(count > 0, where[(count - 1).clamp(min=0)],
                          torch.full_like(idx, last_nonmatch_before))
    else:
        lnm = torch.full_like(idx, last_nonmatch_before)
    return match & (((idx - lnm) & 1) == 1)


def flat_pass(data: np.ndarray, dense: torch.Tensor,
              block: int = FLAT_BLOCK) -> Iterator[torch.Tensor]:
    """One pass of a flat table (``dense``: int32[65536], the rule value of
    byte pair ``a * 256 + b`` or -1) over the whole of ``data`` (uint8), in
    blocks: int32 tokens on the table's device, block by block."""
    device = dense.device
    n = data.shape[0]
    last_nonmatch, carry = -1, False  # global index; the last pair of the block before merged
    for s in range(0, n, block):
        e = min(s + block, n)
        d = torch.from_numpy(np.ascontiguousarray(data[s : e + 1])).to(device).to(torch.int32)
        nxt = d[1:] if e < n else torch.cat([d[1:], d.new_zeros(1)])
        d = d[: e - s]
        val = dense[d * 256 + nxt]
        if e == n:
            val[-1] = -1  # the file's last byte has no pair
        match = val >= 0
        start = _starts(match, last_nonmatch - s)
        consumed = torch.empty_like(start)
        consumed[0] = carry
        consumed[1:] = start[:-1]
        yield torch.where(start, val, d)[~consumed]
        nm = torch.nonzero(~match).flatten()
        if nm.numel():
            last_nonmatch = s + int(nm[-1])
        carry = bool(start[-1])


def multipass(tokens: torch.Tensor, last: torch.Tensor, keys: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """Passes until none merges over int32 ``tokens``,
    where ``last[i]`` marks the last token of its chunk: no pair crosses a
    chunk's end. ``keys``: sorted int64 ``a << 16 | b``; ``vals``: int64 rule
    values in the same order."""
    t = tokens
    while t.numel() >= 2:
        k = (t[:-1].to(torch.int64) << 16) | t[1:].to(torch.int64)
        pos = torch.searchsorted(keys, k).clamp_(max=keys.numel() - 1)
        match = (keys[pos] == k) & ~last[:-1]
        if not bool(match.any()):
            break
        start = _starts(match, -1)
        merged = t.clone()
        merged[:-1] = torch.where(start, vals[pos].to(torch.int32), t[:-1])
        now_last = last.clone()
        now_last[:-1] |= start & last[1:]  # a merged pair ends a chunk when its second did
        keep = torch.ones_like(last)
        keep[1:] = ~start
        t, last = merged[keep], now_last[keep]
    return t


def _arrays(rules: Rules) -> Tuple[np.ndarray, np.ndarray]:
    """Rules -> (int64 [n, 2] keys, int64 [n] values)."""
    keys = np.array(list(rules.keys()), dtype=np.int64).reshape(-1, 2)
    return keys, np.fromiter(rules.values(), dtype=np.int64, count=len(rules))


def rule_tensors(rules: Rules, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rules -> (sorted int64 keys ``a << 16 | b``, int64 values) on ``device``."""
    pairs, vals = _arrays(rules)
    keys = (pairs[:, 0] << 16) | pairs[:, 1]
    order = np.argsort(keys, kind="stable")
    return (torch.from_numpy(keys[order]).to(device), torch.from_numpy(vals[order]).to(device))


def dense_table(rules: Rules, device: torch.device) -> torch.Tensor:
    """A byte-pair table as int32[65536]: the rule value of ``a * 256 + b``, or -1."""
    pairs, vals = _arrays(rules)
    dense = np.full(65536, -1, dtype=np.int32)
    dense[pairs[:, 0] * 256 + pairs[:, 1]] = vals
    return torch.from_numpy(dense).to(device)


def chunked_multipass(data: np.ndarray, keys: torch.Tensor, vals: torch.Tensor, chunk: int,
                      group: int = GROUP_BYTES) -> Iterator[torch.Tensor]:
    """``blt``'s chunks of ``chunk`` bytes, each to the end of its passes
    (``keys`` and ``vals`` as ``rule_tensors`` gives them), several chunks a
    group: int32 tokens on the keys' device, group by group."""
    device = keys.device
    n = data.shape[0]
    step = max(group // chunk, 1) * chunk
    for s in range(0, n, step):
        e = min(s + step, n)
        t = torch.from_numpy(np.ascontiguousarray(data[s:e])).to(device).to(torch.int32)
        last = torch.zeros(e - s, dtype=torch.bool, device=device)
        last[chunk - 1 :: chunk] = True
        last[-1] = True
        yield multipass(t, last, keys, vals)


class Reference:
    """The reference's tokens of a file under one table: one pass over the
    whole file for a flat table, else ``blt``'s chunks of ``chunk`` bytes
    (None: the whole file)."""

    def __init__(self, rules: Rules, chunk: Optional[int], device: torch.device):
        self.flat = is_flat(rules)
        self.chunk = chunk
        self.keys, self.vals = rule_tensors(rules, device)
        self.dense = dense_table(rules, device) if self.flat else None

    def encode(self, data: np.ndarray) -> Iterator[torch.Tensor]:
        if self.flat:
            return flat_pass(data, self.dense)
        return chunked_multipass(data, self.keys, self.vals, self.chunk or max(data.shape[0], 1))

    def encode_host(self, data: np.ndarray) -> np.ndarray:
        """``encode`` gathered into one int32 host array."""
        parts = [t.cpu().numpy() for t in self.encode(data)]
        return np.concatenate(parts) if parts else np.empty(0, np.int32)
