"""Design probes of the flat-BPE pass at 64 MiB: the scan's cross-tile phase
as one look-back launch, and the table staged in shared memory.

    python -m blt_tpu_torch.tools.exp_opt [--size-mib 64] [--k 8] [--seed 0]
        [--device cuda|cpu]

Port of ``tools/exp_opt.py`` (T2). The original stacks four variants of the
flat kernel over cuckoo planes; all four compute one function, K2's slots
with each merge start's value byteswapped (T8's ``full``). The port defines
them on the dense wire table, as K2 does, and asks each variant's question
in the card's terms, each a flag set of K2's own pass
(``csrc/flat_pass.cuh``, ``bpe_cuda.FLAT_PASSES``):

- ``base``: T8's ``full`` (reduce / tile scan / emit, three launches);
- ``p2``: the original relays its scan's cross-block phase; here the
  cross-tile phase is a single-pass decoupled look-back (one launch);
- ``p2+hoist``: the original copies its table rows into VMEM once; here the
  128 KB table is staged in shared memory once per block, on a persistent
  grid of one block per SM;
- ``p2+hoist+swap``: ``p2+hoist`` with the byteswap moved into the table
  (the table byteswapped once more, the original's ``preswap``).

Each is chained k times through its carry over the corpus with its 500 most
frequent pairs, timed as launched and as a CUDA-graph replay, beside its
plain version and the byte bound. Every timed result must equal one chain of
T8 ``full``'s plain version (the original checks each variant against the
NumPy engine). One JSON line, as ``exp_chain``; exits 1 when one differs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.ops import bpe_cuda
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.tools import _common as C

K = 8
# the original's variants, by the flat pass each runs
VARIANTS = {"base": "parts_full", "p2": "opt_p2", "p2+hoist": "opt_hoist",
            "p2+hoist+swap": "opt_swap"}


def _pass_name(variant: str) -> str:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {tuple(VARIANTS)}")
    return VARIANTS[variant]


def variant_table(variant: str, table: torch.Tensor) -> torch.Tensor:
    """The table a variant runs over, from K2's wire table: the same, or for
    ``p2+hoist+swap`` byteswapped once more (the raw rule values)."""
    if _pass_name(variant) != "opt_swap":
        return table
    t = table.to(torch.int32)
    return (((t & 0xFF) << 8) | (t >> 8)).to(torch.uint16)


def opt_pass(variant: str, data, n: int, next_byte: int, table, carry_in):
    """One pass of a T2 variant over ``variant_table(variant, K2's table)``:
    kernel on CUDA tensors, plain on CPU tensors. Arguments and results as
    ``bpe_cuda.flat_encode_slots``."""
    flags = bpe_cuda.FLAT_PASSES[_pass_name(variant)]
    return bpe_cuda.flat_encode_slots(data, n, next_byte, table, carry_in, flags)


def opt_pass_plain(variant: str, data, n: int, next_byte: int, table, carry_in):
    """``opt_pass`` as plain tensor ops."""
    flags = bpe_cuda.FLAT_PASSES[_pass_name(variant)]
    return bpe_cuda.flat_pass_plain(data, n, next_byte, table, carry_in, flags)


def chain(variant: str, data, n: int, next_byte: int, table, carry, k: int = K):
    """k passes of a variant over one batch, each taking the carry the pass
    before wrote (the original's ``chain``); returns the last (slots,
    carry)."""
    return bpe_cuda.chain_passes(
        lambda c: opt_pass(variant, data, n, next_byte, table, c), carry, k)


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """The four variants on ``device``; see the module docstring."""
    corpus = C.make_corpus(np.random.default_rng(seed), size_bytes)
    data = torch.from_numpy(corpus).to(device)
    table = wire_table(C.frequent_pair_table(corpus).dense, device)
    carry = torch.zeros((1, 1), dtype=torch.int32, device=device)
    n = size_bytes
    expect = C.chain_by_carry(lambda c: opt_pass_plain("base", data, n, -1, table, c), carry, k)
    rows = []
    for variant in VARIANTS:
        vt = variant_table(variant, table)
        rows.append({
            "name": variant, "kernel": "T2",
            **C.time_chain(lambda variant=variant, vt=vt: chain(variant, data, n, -1, vt, carry, k),
                           k, n, device, expect),
            "bound_ms": C.bound_ms(3 * n + table.numel() * 2),
            "bound_by": "bytes",
            "plain_ms": C.median_ms(
                lambda variant=variant, vt=vt: opt_pass_plain(variant, data, n, -1, vt, carry),
                device),
            "library_ms": None,
        })
    ms = {r["name"]: (r["graph"] or r["eager"])["ms_per_launch"]["median"] for r in rows}
    split = {f"{v}_saves_ms": ms["base"] - ms[v] for v in VARIANTS if v != "base"}
    return {"tool": "exp_opt", "device": C.describe(device), "size_bytes": n,
            "rules": C.RULES, "seed": seed, "exact": all(r["exact"] for r in rows),
            "rows": rows, "split": {"base_ms": ms["base"], **split}}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], K).parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
