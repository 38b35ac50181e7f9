"""Detokenization: invert a u16-BE token stream back to the original bytes
(copy of ``blt_tpu/ops/decode.py``).

The reference cannot invert its own output — there is no decode path
anywhere in it (verified: no decode/detokenize symbol in reference/src,
blt_core/src, or blt_python/). This module closes that loop:
``decode(encode(x)) == x`` for every mode, giving the conformance suite a
roundtrip property the reference could never test.

Semantics (exact inverse of the encoder's, SURVEY.md 2.1):

- token ids 0-255 decode to their literal byte;
- a rule value decodes to the recursive expansion of its pair through the
  *final* merge map (last-line-wins, matching the encoder's id accounting,
  reference: config_loader.rs:167-202);
- ids >= 256 with no rule (including ids orphaned by duplicate-pair lines,
  which the encoder can never emit) raise ``DecodeError``;
- tables where decoding is ambiguous are rejected up front: a rule value
  < 256 collides with the literal byte range (the encoder emits the same
  token for both, e.g. the (120,121)->90 collision pinned by
  tokenizer.rs:283-291), and two rules sharing one value make the inverse
  non-functional.

The kernel is a variable-length gather (np.repeat + cumsum indexing) —
memory-bound host work with data-dependent output shape, which is exactly
what XLA's static-shape model is worst at; the device adds nothing here,
so decode runs on the host by design (the encoder's fixed-capacity Pallas
machinery stays encode-only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import numpy as np

from blt_tpu_torch.merges import BpeMerges

# Any id representable in a u16 token stream.
_ID_SPACE = 1 << 16
# Cap on the total expansion blob; a chain of hierarchical rules can grow
# expansions exponentially (exp[v] = exp[a] + exp[b]), so an adversarial
# in-memory table must fail loudly instead of allocating the universe.
# Margin below INT32_MAX: every offset (including the 256 literal slots
# and the final expansion's start) must fit the int32 offsets array.
_MAX_BLOB_BYTES = (1 << 31) - (1 << 17)


class DecodeError(ValueError):
    """Token stream or merge table cannot be decoded."""


def odd_trailing_error() -> DecodeError:
    return DecodeError(
        "token stream has an odd trailing byte (truncated u16 token)"
    )


def missing_header_error() -> DecodeError:
    return DecodeError(
        "token stream ended before the expected content-type header"
    )


def header_mismatch_error(content_type, found: int) -> DecodeError:
    return DecodeError(
        f"expected content-type header 0x{content_type.token_value:04X} "
        f"({content_type.value}), found 0x{found:04X}"
    )


@dataclass
class ExpansionTable:
    """Per-id byte expansions, flattened for the vectorized gather.

    ``blob[offsets[id] : offsets[id] + lengths[id]]`` is the byte expansion
    of ``id``; ``lengths[id] == 0`` marks an id the decoder must reject.
    """

    blob: np.ndarray  # uint8[total]
    offsets: np.ndarray  # int32[65536] (blob is capped below 2 GiB)
    lengths: np.ndarray  # int32[65536]

    @staticmethod
    def build(merges: Mapping[Tuple[int, int], int]) -> "ExpansionTable":
        by_value: dict[int, Tuple[int, int]] = {}
        for (a, b), v in merges.items():
            if not (0 <= a <= 0xFFFF and 0 <= b <= 0xFFFF and 0 <= v <= 0xFFFF):
                # mirror MergeTable.build's range check so the decode path
                # reports a DecodeError, not a raw IndexError
                raise DecodeError(
                    f"merge rule ({a},{b})->{v} outside the u16 token range"
                )
            if v < 256:
                raise DecodeError(
                    f"merge table is not invertible: rule ({a},{b})->{v} "
                    "collides with the literal byte range 0-255"
                )
            if v in by_value and by_value[v] != (a, b):
                raise DecodeError(
                    f"merge table is not invertible: token {v} is produced "
                    f"by both {by_value[v]} and {(a, b)}"
                )
            by_value[v] = (a, b)

        # Expansion per id; None marks a DEAD rule — one whose members are
        # not producible from bytes (a member that is neither a byte nor
        # any rule's value, or a rule cycle). The encoder can provably
        # never emit a dead rule's value (every emitted token was built
        # from real bytes, so producible tokens have finite byte
        # expansions by induction), so a dead rule does not make the
        # TABLE invalid — its value is simply rejected if it ever appears
        # in a stream, exactly like an orphaned id. This keeps
        # decode(encode(x)) == x for every table the encoder accepts.
        expansions: dict[int, Optional[bytes]] = {}
        blob_total = 0

        def expand(root: int) -> None:
            # Iterative two-phase DFS (hierarchical tables can nest deeper
            # than the Python recursion limit). ``path`` holds only the
            # DFS ANCESTORS of the current node — a member found on the
            # path is a true rule cycle; a pending sibling is not (an
            # earlier revision confused the two and wrongly killed
            # producible diamond-shaped tables).
            nonlocal blob_total
            stack = [(root, False)]
            path: set = set()
            while stack:
                t, children_done = stack.pop()
                if children_done:
                    path.discard(t)
                    parts: Optional[list] = []
                    for m in by_value[t]:
                        if m < 256:
                            parts.append(bytes([m]))
                        else:
                            # missing => m is a GRAY ancestor (cycle);
                            # None => m itself is dead: either way t dies
                            e = expansions.get(m)
                            if e is None:
                                parts = None
                                break
                            parts.append(e)
                    if parts is None:
                        expansions[t] = None
                        continue
                    expansions[t] = b"".join(parts)
                    blob_total += len(expansions[t])
                    if blob_total > _MAX_BLOB_BYTES:
                        raise DecodeError(
                            "merge table expansions exceed the 2 GiB decode "
                            "blob limit"
                        )
                    continue
                if t < 256 or t in expansions or t in path:
                    # resolved already, or an in-progress ancestor (its own
                    # done-frame will settle it; the consumer sees a cycle)
                    continue
                pair = by_value.get(t)
                if pair is None:
                    expansions[t] = None  # not a byte, not a rule: dead
                    continue
                path.add(t)
                stack.append((t, True))
                for m in pair:
                    if m >= 256 and m not in expansions:
                        stack.append((m, False))

        for v in by_value:
            expand(v)

        lengths = np.zeros(_ID_SPACE, dtype=np.int32)
        offsets = np.zeros(_ID_SPACE, dtype=np.int32)
        parts = [np.arange(256, dtype=np.uint8)]
        lengths[:256] = 1
        offsets[:256] = np.arange(256)
        pos = 256
        for v in sorted(expansions):
            e = expansions[v]
            if e is None:
                continue  # dead rule: length stays 0 -> rejected in streams
            offsets[v] = pos
            lengths[v] = len(e)
            parts.append(np.frombuffer(e, dtype=np.uint8))
            pos += len(e)
        return ExpansionTable(
            blob=np.concatenate(parts), offsets=offsets, lengths=lengths
        )


def build_expansion_table(merges: BpeMerges | None) -> ExpansionTable:
    return ExpansionTable.build(merges or {})


def decode_tokens(tokens: np.ndarray, table: ExpansionTable) -> np.ndarray:
    """Vectorized id->bytes gather. ``tokens`` is any uint16/int array."""
    tokens = np.ascontiguousarray(tokens).astype(np.int32, copy=False)
    lens = table.lengths[tokens]
    bad = np.nonzero(lens == 0)[0]
    if bad.size:
        i = int(bad[0])
        raise DecodeError(
            f"invalid token {int(tokens[i])} at position {i}: no such rule "
            "in the merge table"
        )
    total = int(lens.sum(dtype=np.int64))
    ends = np.cumsum(lens, dtype=np.int64)
    if total < np.iinfo(np.int32).max:
        ends = ends.astype(np.int32)
    # out position p belongs to token t with ends[t-1] <= p < ends[t];
    # within-token offset = p - (ends[t] - lens[t]).
    idx = (
        np.arange(total, dtype=ends.dtype)
        - np.repeat(ends - lens, lens)
        + np.repeat(table.offsets[tokens], lens)
    )
    return table.blob[idx]


def decode_wire(
    data: np.ndarray, table: ExpansionTable, threads: int = 0
) -> np.ndarray:
    """Decode a u16-BE wire chunk (even byte length) to raw bytes.

    Uses the native engine when built (parse + expand fused, multithreaded,
    blt_decode_size/_fill in native/feeder.cpp); NumPy otherwise.
    ``threads`` carries the CLI --threads policy (0 = auto).
    """
    assert data.shape[0] % 2 == 0, "wire chunk must be an even byte count"
    from blt_tpu_torch import native

    if native.available() and data.shape[0] >= 1 << 16:
        out = native.decode_expand(
            data, table.offsets, table.lengths, table.blob, threads
        )
        if isinstance(out, int):  # first invalid token position
            tok = (int(data[2 * out]) << 8) | int(data[2 * out + 1])
            raise DecodeError(
                f"invalid token {tok} at position {out}: no such rule "
                "in the merge table"
            )
        return out
    tokens = data.view(np.uint8).reshape(-1, 2).astype(np.int32)
    tokens = (tokens[:, 0] << 8) | tokens[:, 1]
    return decode_tokens(tokens, table)
