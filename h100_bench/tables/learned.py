"""A general table learned from text of the run's kind (``recipes.text_sample``),
as a pipeline learns its own table: rules on merged tokens, with no merges
file to hold them.

Each round counts the adjacent pairs of the sample's current tokens and
takes up to ``per_round`` of the most frequent pairs seen at least twice,
most frequent first (ties by the smaller pair), as the next rules, numbered
``256 + index``. The current tokens then run to the end of their passes
under the whole table (``reference/bpe.py``'s ``multipass``). Rounds repeat
until the table holds ``rules`` rules. The sample is the first
``sample_bytes`` of its 4 MiB, one chunk, on the run's device; the same
seed gives the same table.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.common import recipes
from h100_bench.reference import bpe
from h100_bench.tables import Table


def build(params: dict, seed: int, device: torch.device) -> Table:
    want, per_round = params["rules"], params["per_round"]
    sample = recipes.text_sample(seed)[: params["sample_bytes"]]
    tokens = torch.from_numpy(np.ascontiguousarray(sample)).to(device).to(torch.int32)
    keys = torch.empty(0, dtype=torch.int64, device=device)  # sorted ``a << 16 | b``
    vals = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < want:
        pairs, counts = torch.unique((tokens[:-1].to(torch.int64) << 16) | tokens[1:],
                                     return_counts=True)  # sorted by pair
        top = torch.sort(counts, descending=True, stable=True).indices
        top = top[: min(per_round, want - keys.numel())]
        top = top[counts[top] >= 2]
        if top.numel() == 0:
            raise ValueError(f"the sample repeats no pair after {keys.numel()} rules; "
                             f"{want} need a larger one")
        new = torch.arange(top.numel(), dtype=torch.int64, device=device) + 256 + keys.numel()
        keys, order = torch.sort(torch.cat([keys, pairs[top]]))
        vals = torch.cat([vals, new])[order]
        last = torch.zeros(tokens.numel(), dtype=torch.bool, device=device)
        last[-1] = True
        tokens = bpe.multipass(tokens, last, keys, vals)
    k, v = keys.cpu().numpy(), vals.cpu().numpy()
    return Table({(int(a) >> 16, int(a) & 0xFFFF): int(b) for a, b in zip(k, v)})
