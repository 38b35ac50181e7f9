"""The tokenizer as a model: a forward step over fixed-size byte buffers
(port of ``blt_tpu/models/tokenizer.py``).

The reference has no neural models; its unit of computation is the
tokenization strategy. This module packages the flat-BPE encode step as an
``nn.Module``: the dense merge table is a buffer, ``forward`` is
``bpe_torch.flat_encode`` (the counterpart of the ``bpe_jax.flat_encode``
the JAX model calls, which is XLA, not Pallas).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import bpe_torch
from blt_tpu_torch.utils.device import require_cuda


class TokenizerModel(torch.nn.Module):
    """Flat-BPE tokenizer as a forward step. ``device``: where the table
    lives (default: the first CUDA device; raises without one)."""

    def __init__(self, table: MergeTable, device=None):
        super().__init__()
        if not table.flat:
            raise ValueError("TokenizerModel requires a flat merge table")
        self.table = table
        device = require_cuda() if device is None else torch.device(device)
        self.register_buffer("dense", torch.from_numpy(table.dense.astype(np.int32)).to(device))

    def forward(
        self,
        data: torch.Tensor,  # uint8[N]
        length: int,  # valid bytes
        carry_in: torch.Tensor,  # bool scalar
        next_byte: int,  # first byte of the next buffer, -1 at the end
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(tokens int32[N], count, carry_out, be_bytes uint16[N]: the
        tokens' u16-BE image)."""
        return bpe_torch.flat_encode(data, length, self.dense, carry_in, next_byte)

    def example_args(self, n: int = 65536, seed: int = 0):
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 256, n, dtype=np.uint8)
        device = self.dense.device
        return (
            torch.from_numpy(data).to(device),
            n,
            torch.zeros((), dtype=torch.bool, device=device),
            -1,
        )
