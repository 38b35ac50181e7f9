"""Cost split of the flat-BPE pass: lookup, scan and emit, at 64 MiB.

    python -m blt_tpu_torch.tools.exp_parts [--size-mib 64] [--k 8] [--seed 0]
        [--device cuda|cpu]

Port of ``tools/exp_parts.py`` (T8; its sublane-gather probe ``subgather``,
T9, is not ported yet). Four variants of the pass move the same bytes
(``csrc/flat_parts.cu``, ``bpe_cuda.flat_encode_slots(..., variant)``):

- ``emit``: no lookup (a pair "matches" when its next byte is a multiple
  of 8, and its value is the pair itself) and no scan (every match starts);
- ``noscan``: the wire-table lookup, every match starts;
- ``nolookup``: the trivial match, then the parity scan;
- ``full``: lookup and scan, K2's function.

Each emits the tool's slot, ``byteswap(start ? val : d)`` with 0 at
consumed positions: K2's slot except that a start holds its value
byteswapped (the raw rule value, since the table ships swapped values).
Without the scan a pass is one launch, so ``full - noscan`` is the scan's
cost on the card and ``full - nolookup`` the lookup's. Each variant is
chained k times through its carry over the corpus with its 500 most
frequent pairs, beside K2 itself (``k2``), timed as launched and as a
CUDA-graph replay. One JSON line, as ``exp_chain``, plus the split. Exits 1
when a timed result differs from the plain chain's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.ops import bpe_cuda
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.tools import _common as C

K = 8
VARIANTS = tuple(bpe_cuda.FLAT_VARIANTS)


def flat_parts_plain(variant: str, data, n: int, next_byte: int, table, carry_in):
    """One pass of a T8 variant as plain tensor ops: (slots uint16[cap],
    carry_out int32 (1,1)); ``bpe_cuda.flat_slots_plain``'s arguments."""
    return bpe_cuda.flat_slots_plain(data, n, next_byte, table, carry_in, variant)


def flat_parts(variant: str, data, n: int, next_byte: int, table, carry_in):
    """One pass of a T8 variant: kernel on CUDA tensors, plain on CPU
    tensors. Arguments and results as ``bpe_cuda.flat_encode_slots``."""
    return bpe_cuda.flat_encode_slots(data, n, next_byte, table, carry_in, variant)


def chain(variant: str, data, n: int, next_byte: int, table, carry, k: int = K):
    """k passes of a variant over one batch, each taking the carry the pass
    before wrote (the original's ``chain``); returns the last (slots,
    carry)."""
    return bpe_cuda.flat_encode_chained(data, n, next_byte, table, carry, k, variant)


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """The four variants and K2 on ``device``; see the module docstring."""
    corpus = C.make_corpus(np.random.default_rng(seed), size_bytes)
    data = torch.from_numpy(corpus).to(device)
    table = wire_table(C.frequent_pair_table(corpus).dense, device)
    carry = torch.zeros((1, 1), dtype=torch.int32, device=device)
    n = size_bytes
    rows = []
    for variant in (*VARIANTS, None):
        name = variant or "k2"
        uses_table = variant is None or bpe_cuda.FLAT_VARIANTS[variant][0]

        def plain(c, variant=variant):
            return bpe_cuda.flat_slots_plain(data, n, -1, table, c, variant)

        rows.append({
            "name": name, "kernel": "T8" if variant else "K2",
            **C.time_chain(lambda variant=variant: chain(variant, data, n, -1, table, carry, k),
                           k, n, device, bpe_cuda.chain_passes(plain, carry, k)),
            "bound_ms": C.bound_ms(3 * n + (table.numel() * 2 if uses_table else 0)),
            "plain_ms": C.median_ms(lambda: plain(carry), device),
            "library_ms": None,
        })
    ms = {r["name"]: r[("graph" if r["graph"] else "eager")]["ms_per_launch"]["median"]
          for r in rows}
    split = {"scan_ms": ms["full"] - ms["noscan"], "lookup_ms": ms["full"] - ms["nolookup"],
             "emit_ms": ms["emit"], "full_ms": ms["full"], "k2_ms": ms["k2"]}
    return {"tool": "exp_parts", "device": C.describe(device), "size_bytes": n,
            "rules": C.RULES, "seed": seed, "exact": all(r["exact"] for r in rows),
            "rows": rows, "split": split}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], K).parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
