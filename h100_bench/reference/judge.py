"""The comparison that decides ``correct``: a job's whole output stream, the
header token included, against the reference's tokens.

``wrong_tokens`` counts the token positions at which a u16 big-endian
stream differs from the expected tokens, plus the tokens one of the two
has past the other's end (an odd trailing byte counts as one).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

# the numbers compared, each with its limit: an exact comparison
LIMITS = {"jobs_wrong": 0, "tokens_wrong": 0}


def wrong_tokens(stream: np.ndarray, header: Optional[int], blocks: Iterable[torch.Tensor],
                 device: torch.device) -> Tuple[int, Optional[int]]:
    """(differing tokens, index of the first) of ``stream`` (uint8 bytes)
    against ``header`` (or None) followed by ``blocks`` of int32 tokens."""
    def expected():
        if header is not None:
            yield torch.tensor([header], dtype=torch.int32, device=device)
        yield from blocks

    wrong, first, pos = 0, None, 0  # pos counts tokens
    n_tokens = stream.shape[0] // 2
    for blk in expected():
        k = blk.numel()
        have = max(min(k, n_tokens - pos), 0)
        bad = k - have
        if have:
            raw = torch.from_numpy(np.ascontiguousarray(stream[2 * pos : 2 * (pos + have)])).to(device)
            got = raw.view(have, 2).to(torch.int32)
            diff = (got[:, 0] * 256 + got[:, 1]) != blk[:have]
            nd = int(diff.sum())
            if nd and first is None:
                first = pos + int(torch.nonzero(diff)[0])
            bad += nd
        if bad and first is None:
            first = pos + have
        wrong += bad
        pos += k
    extra = max(n_tokens - pos, 0) + stream.shape[0] % 2
    if extra and first is None:
        first = pos
    return wrong + extra, first
