"""Trusted pure-Python BPE oracle — the conformance judge (copy of
``blt_tpu/ops/bpe_oracle.py``).

This is a literal transcription of the reference algorithm
(reference: blt_core/src/tokenizer.rs:56-93 ``BpeStrategy::process_chunk``):

    tokens = [b as u16 for b in chunk]
    loop:
        merges_found = false
        new_tokens = []
        i = 0
        while i < len(tokens):
            if i < len(tokens)-1 and (tokens[i], tokens[i+1]) in merges:
                new_tokens.push(merges[(tokens[i], tokens[i+1])]); i += 2
                merges_found = true
            else:
                new_tokens.push(tokens[i]); i += 1
        tokens = new_tokens
        if not merges_found: break

Properties pinned by the reference tests (tokenizer.rs:152-292):
- whole-sequence passes repeat until a pass makes zero merges;
- within a pass, leftmost-first non-overlapping pair matching (no rank order);
- newly merged tokens participate only on the NEXT pass;
- merge values may collide with byte values and re-merge on later passes.

Deliberately unoptimized: every fast implementation (NumPy, PyTorch, the
CUDA kernels) is validated bit-for-bit against this function.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple


def bpe_encode_oracle(
    data: bytes | Sequence[int],
    merges: Mapping[Tuple[int, int], int],
) -> List[int]:
    """Return the token-id list for one chunk, exact reference semantics."""
    if len(data) == 0:
        return []
    tokens: List[int] = [int(b) for b in data]
    while True:
        merges_found = False
        new_tokens: List[int] = []
        i = 0
        n = len(tokens)
        while i < n:
            if i < n - 1 and (tokens[i], tokens[i + 1]) in merges:
                new_tokens.append(merges[(tokens[i], tokens[i + 1])])
                i += 2
                merges_found = True
            else:
                new_tokens.append(tokens[i])
                i += 1
        tokens = new_tokens
        if not merges_found:
            break
    return tokens


def tokens_to_be_bytes(tokens: Sequence[int]) -> bytes:
    """Serialize token ids as u16 big-endian (tokenizer.rs:88-92)."""
    out = bytearray(len(tokens) * 2)
    for j, t in enumerate(tokens):
        out[2 * j] = (t >> 8) & 0xFF
        out[2 * j + 1] = t & 0xFF
    return bytes(out)
