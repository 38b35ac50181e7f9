"""Cost split of the flat-BPE pass at 64 MiB, and the row-gather probe.

    python -m blt_tpu_torch.tools.exp_parts [--size-mib 64] [--k 8] [--seed 0]
        [--device cuda|cpu]

Port of ``tools/exp_parts.py``: T8, the cost split, and T9, its probe
``subgather``. Four variants of the pass move the same bytes; each is a
flag set of K2's own pass (``csrc/flat_bpe.cu``,
``bpe_cuda.flat_encode_slots(..., bpe_cuda.FLAT_VARIANTS[variant])``):

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
CUDA-graph replay.

``subgather`` (T9, ``csrc/subgather.cu``, ``tools_cuda.subgather``) gathers
``out[i, j] = block[idx[i, j], j]`` within each block of 1024 rows, over
``--size-mib`` of int32 indices and a table of the same shape. The
original's ``main`` feeds indices in ``[0, rows)``, past the block, where
the function is not defined on the TPU; its log names what it meant, the
block's row range. So the rows here draw indices from ``[0, 1024)``, then
from the original's small ranges ``[0, 8)``, ``[0, 64)`` and ``[0, 256)``,
each k single launches back to back beside ``torch.gather`` on the same
tensors; where the rows allow (8 MiB and up), one more row at 16384 rows
per block over the whole block, where no column slab fits in shared memory
and the kernel takes its direct path. One JSON line, as ``exp_chain``,
plus the split. Exits 1 when a timed result differs from the plain
version's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.ops import bpe_cuda, tools_cuda
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.tools import _common as C

K = 8
VARIANTS = tuple(bpe_cuda.FLAT_VARIANTS)
SUBGATHER_RPB = 1024
SUBGATHER_RANGES = (SUBGATHER_RPB, 8, 64, 256)  # the whole block, then the original's
SUBGATHER_DIRECT_RPB = 16384  # blocks too tall for a slab (subgather.cu's direct path)


def _flags(variant: str | None) -> bpe_cuda.FlatFlags:
    """K2's flags for None, else the T8 variant's."""
    if variant is None:
        return bpe_cuda.FlatFlags()
    if variant not in bpe_cuda.FLAT_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return bpe_cuda.FLAT_VARIANTS[variant]


def flat_parts_plain(variant: str, data, n: int, next_byte: int, table, carry_in):
    """One pass of a T8 variant as plain tensor ops: (slots uint16[cap],
    carry_out int32 (1,1)); ``bpe_cuda.flat_pass_plain``'s arguments."""
    return bpe_cuda.flat_pass_plain(data, n, next_byte, table, carry_in, _flags(variant))


def flat_parts(variant: str, data, n: int, next_byte: int, table, carry_in):
    """One pass of a T8 variant: kernel on CUDA tensors, plain on CPU
    tensors. Arguments and results as ``bpe_cuda.flat_encode_slots``."""
    return bpe_cuda.flat_encode_slots(data, n, next_byte, table, carry_in, _flags(variant))


def chain(variant: str | None, data, n: int, next_byte: int, table, carry, k: int = K):
    """k passes of a variant (K2 for None) over one batch, each taking the
    carry the pass before wrote (the original's ``chain``); returns the last
    (slots, carry)."""
    return bpe_cuda.flat_encode_chained(data, n, next_byte, table, carry, k, _flags(variant))


def table_words_read(idx: torch.Tensor, rpb: int) -> int:
    """The table words T9 reads for these indices: the distinct (row,
    column) pairs they reach inside their blocks (interpret mode's
    wrap-around included; a filled element reads none)."""
    rows = idx.shape[0]
    x = idx.to(torch.int64)
    inside = (x >= -rpb) & (x < rpb)
    block_row = torch.arange(rows, device=idx.device).div(rpb, rounding_mode="floor") * rpb
    row = block_row.unsqueeze(1) + torch.where(x < 0, x + rpb, x)
    word = row * C.LANES + torch.arange(C.LANES, device=idx.device)
    read = torch.zeros(rows * C.LANES, dtype=torch.bool, device=idx.device)
    read[word[inside]] = True
    return int(read.sum())


def subgather_rows(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> list:
    """T9 over ``size_bytes`` of int32 indices, one row per index range,
    and the direct path's row where the rows allow it."""
    rng = np.random.default_rng(seed)
    rows = size_bytes // (4 * C.LANES)
    cases = [(SUBGATHER_RPB, top) for top in SUBGATHER_RANGES]
    if rows % SUBGATHER_DIRECT_RPB == 0:
        cases.append((SUBGATHER_DIRECT_RPB, SUBGATHER_DIRECT_RPB))
    tbl = torch.from_numpy(rng.integers(0, 1 << 30, (rows, C.LANES), dtype=np.int32)).to(device)
    out = []
    for rpb, top in cases:
        shape = (rows // rpb, rpb, C.LANES)
        idx = torch.from_numpy(rng.integers(0, top, (rows, C.LANES), dtype=np.int32)).to(device)
        expect = tools_cuda.subgather_plain(tbl, idx, rpb)
        out.append({
            "name": "subgather", "kernel": "T9", "idx_range": top, "rpb": rpb,
            **C.time_chain(lambda idx=idx, rpb=rpb: C.repeat(
                lambda: tools_cuda.subgather(tbl, idx, rpb), k), k, size_bytes, device, expect),
            # idx read, out and done written, and the table words these
            # indices reach, each once
            "bound_ms": C.bound_ms(2 * size_bytes + 4 + 4 * table_words_read(idx, rpb)),
            "bound_by": "bytes",
            "plain_ms": C.median_ms(
                lambda idx=idx, rpb=rpb: tools_cuda.subgather_plain(tbl, idx, rpb), device),
            "library_ms": C.chained_ms(
                lambda idx=idx, shape=shape: (torch.gather(tbl.view(shape), 1, idx.view(shape)),),
                k, size_bytes, device, (expect[0].view(shape),)),
        })
    return out


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """The four variants, K2 and T9 on ``device``; see the module docstring."""
    corpus = C.make_corpus(np.random.default_rng(seed), size_bytes)
    data = torch.from_numpy(corpus).to(device)
    table = wire_table(C.frequent_pair_table(corpus).dense, device)
    carry = torch.zeros((1, 1), dtype=torch.int32, device=device)
    n = size_bytes
    rows = []
    for variant in (*VARIANTS, None):
        name = variant or "k2"
        uses_table = _flags(variant).lookup

        def plain(c, variant=variant):
            return flat_parts_plain(variant, data, n, -1, table, c)

        rows.append({
            "name": name, "kernel": "T8" if variant else "K2",
            **C.time_chain(lambda variant=variant: chain(variant, data, n, -1, table, carry, k),
                           k, n, device, bpe_cuda.chain_passes(plain, carry, k)),
            "bound_ms": C.bound_ms(3 * n + (table.numel() * 2 if uses_table else 0)),
            "bound_by": "bytes",
            "plain_ms": C.median_ms(lambda: plain(carry), device),
            "library_ms": None,
        })
    ms = {r["name"]: r[("graph" if r["graph"] else "eager")]["ms_per_launch"]["median"]
          for r in rows}
    rows += subgather_rows(device, size_bytes, k, seed)
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
