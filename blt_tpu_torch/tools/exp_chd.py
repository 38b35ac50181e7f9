"""Flat-BPE pass variants at 64 MiB: the valid-pair mask's cost, and the scan
without its cross-row phase.

    python -m blt_tpu_torch.tools.exp_chd [--size-mib 64] [--k 8] [--seed 0]
        [--device cuda|cpu]

Port of ``tools/exp_chd.py`` (T10). The original's lookup is its CHD probe;
the port's is the dense wire table, as in K2 (the same function). Three
variants, each chained k times through its carry over the corpus with its
500 most frequent pairs:

- ``prod``: K2 itself (``bpe_cuda.flat_encode_slots``). The original runs it
  at rows_per_block 512, 1024 and 2048; K2 on the card has no such
  parameter, so the three rows time one function and record the rpb only;
- ``novalid``: no valid-pair mask (``FlatFlags(valid=False)``): every
  position below the capacity may match, its next byte ``max(next_byte,
  0)`` at n-1, so slots differ from ``prod`` only where that makes a pair;
- ``noscan2``: the scan's first phase alone, within each 128-byte row, with
  the Pallas block's sentinel and a carry chained from block to block
  (``tools_cuda.row_scan``, ``csrc/scan_parts.cu``): its function depends
  on rows_per_block, 1024 as in the original.

Each is timed as launched and as a CUDA-graph replay beside its plain
version and the byte bound. One JSON line, as ``exp_chain``, plus the cost
of each variant against ``prod``; exits 1 when a timed result differs from
the plain chain's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.ops import bpe_cuda, tools_cuda
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.tools import _common as C

K = 8
RPB = 1024
PROD_RPBS = (512, 1024, 2048)  # the original's sweep of prod
VARIANTS = ("prod", "noscan2", "novalid")


def _flags(variant: str) -> bpe_cuda.FlatFlags:
    """prod's and novalid's flat pass (noscan2 has none)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return bpe_cuda.FLAT_PASSES["flat_bpe" if variant == "prod" else "chd_novalid"]


def chd_pass(variant: str, data, n: int, next_byte: int, table, carry_in, rpb: int = RPB):
    """One pass of a T10 variant: kernel on CUDA tensors, plain on CPU
    tensors. The arguments and results of ``bpe_cuda.flat_encode_slots``,
    plus ``rpb``, the rows of a Pallas block, on which noscan2 depends."""
    if variant == "noscan2":
        return tools_cuda.row_scan(data, n, next_byte, table, carry_in, rpb)
    return bpe_cuda.flat_encode_slots(data, n, next_byte, table, carry_in, _flags(variant))


def chd_pass_plain(variant: str, data, n: int, next_byte: int, table, carry_in,
                   rpb: int = RPB):
    """``chd_pass`` as plain tensor ops."""
    if variant == "noscan2":
        return tools_cuda.row_scan_plain(data, n, next_byte, table, carry_in, rpb)
    return bpe_cuda.flat_pass_plain(data, n, next_byte, table, carry_in, _flags(variant))


def chain(variant: str, data, n: int, next_byte: int, table, carry, k: int = K,
          rpb: int = RPB):
    """k passes of a variant over one batch, each taking the carry the pass
    before wrote (the original's ``chain``); returns the last (slots,
    carry)."""
    return bpe_cuda.chain_passes(
        lambda c: chd_pass(variant, data, n, next_byte, table, c, rpb), carry, k)


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """The original's runs on ``device``: prod at each rpb of its sweep,
    then noscan2 and novalid at 1024; see the module docstring."""
    corpus = C.make_corpus(np.random.default_rng(seed), size_bytes)
    data = torch.from_numpy(corpus).to(device)
    table = wire_table(C.frequent_pair_table(corpus).dense, device)
    carry = torch.zeros((1, 1), dtype=torch.int32, device=device)
    n = size_bytes
    rows = []
    for variant, rpb in [("prod", r) for r in PROD_RPBS] + [(v, RPB) for v in VARIANTS[1:]]:
        def plain(c, variant=variant, rpb=rpb):
            return chd_pass_plain(variant, data, n, -1, table, c, rpb)

        rows.append({
            "name": variant, "kernel": "T10", "rpb": rpb,
            **C.time_chain(lambda variant=variant, rpb=rpb: chain(variant, data, n, -1, table,
                                                                  carry, k, rpb),
                           k, n, device, C.chain_by_carry(plain, carry, k)),
            "bound_ms": C.bound_ms(3 * n + table.numel() * 2),
            "bound_by": "bytes",
            "plain_ms": C.median_ms(lambda plain=plain: plain(carry), device),
            "library_ms": None,
        })
    ms = {r["name"]: (r["graph"] or r["eager"])["ms_per_launch"]["median"]
          for r in rows if r["rpb"] == RPB}
    return {"tool": "exp_chd", "device": C.describe(device), "size_bytes": n,
            "rules": C.RULES, "seed": seed, "exact": all(r["exact"] for r in rows),
            "rows": rows,
            "split": {"prod_ms": ms["prod"],
                      **{f"{v}_saves_ms": ms["prod"] - ms[v] for v in VARIANTS[1:]}}}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], K).parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
