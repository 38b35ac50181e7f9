"""A literal transcription of ``blt``'s merge loop (``tokenizer.rs``
BpeStrategy::process_chunk), one token at a time, for the tests of the
tensor reference at small sizes."""

from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple


def encode_chunk(data: Sequence[int], rules: Mapping[Tuple[int, int], int]) -> List[int]:
    tokens = [int(b) for b in data]
    while True:
        out, i, merged = [], 0, False
        while i < len(tokens):
            if i + 1 < len(tokens) and (tokens[i], tokens[i + 1]) in rules:
                out.append(rules[(tokens[i], tokens[i + 1])])
                i += 2
                merged = True
            else:
                out.append(tokens[i])
                i += 1
        tokens = out
        if not merged:
            return tokens


def encode(data: Sequence[int], rules: Mapping[Tuple[int, int], int], chunk: int) -> List[int]:
    """``blt`` at ``chunk`` bytes a chunk."""
    out: List[int] = []
    for s in range(0, len(data), chunk):
        out += encode_chunk(data[s : s + chunk], rules)
    return out
