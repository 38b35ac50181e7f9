"""Table recipes, one module a recipe, found by the ``table.recipe`` name of a
configuration's file. Each has ``build(params, seed, device) -> Table``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class Table:
    rules: Dict[Tuple[int, int], int]
    # the merges file's pairs in order (line i makes token 256 + i), for a
    # table that a merges file can hold; None for one with token keys
    pairs: Optional[List[Tuple[int, int]]] = None
