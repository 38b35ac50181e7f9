"""The control: the reference put in the program's place with one stated
guarantee broken, the step that would tempt a later change. It has to come
out as not correct.

The configuration's flat table applies only its first 8192 rules
(merges-file lines), as if it were cut to fit an 8192-slot structure: the
guarantee broken is that every rule of the table applies. A second
candidate, each 16 MiB device batch tokenized on its own, was dropped: on
periodic text its batch edges can all fall alike, so that no pair across
one merges.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from h100_bench.reference import bpe

KEPT_RULES = 8192


class Control:
    def __init__(self, rules: bpe.Rules, chunk: Optional[int], device: torch.device):
        if not bpe.is_flat(rules):
            raise ValueError("the control cuts a flat table; this one has token keys")
        kept = {k: v for k, v in rules.items() if v < 256 + KEPT_RULES}
        self.reference = bpe.Reference(kept, chunk, device)

    def encode(self, data: np.ndarray) -> Iterator[torch.Tensor]:
        return self.reference.encode(data)
