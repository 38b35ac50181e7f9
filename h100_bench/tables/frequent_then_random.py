"""A flat table of byte-pair rules, as a merges file holds it
(``chip_smoke.py``'s 50k table): the ``frequent`` most frequent byte pairs
of text of the run's kind (``recipes.text_sample``), then distinct random pairs
from the seed, ``rules`` in all; line i makes token 256 + i."""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.common import recipes
from h100_bench.tables import Table


def build(params: dict, seed: int, device: torch.device) -> Table:
    first = recipes.frequent_pairs(recipes.text_sample(seed), params["frequent"])
    rng = np.random.default_rng(recipes.seed_of(seed, recipes.TABLE))
    pairs = recipes.fifty_k_pairs(rng, first, params["rules"])
    return Table(recipes.numbered(pairs), pairs)
