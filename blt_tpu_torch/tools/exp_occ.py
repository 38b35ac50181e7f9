"""K2 fused with its pack on flat tables whose pairs spread over fewer first bytes.

    python -m blt_tpu_torch.tools.exp_occ [--size-mib 64] [--k 8] [--seed 1]
        [--device cuda|cpu] [--out OUT.json]

Port of ``tools/exp_occ.py``. The original asked whether the TPU's
packed-dense chain was chain-bound: its cost grew with the occupied
first-byte segments of the packed table, so rate × segments stayed
constant. The port has no packed-dense segments: one dense 128 KB wire
table (``tables.wire_table``) serves every flat table. The rows here answer
another question: whether K2's rate depends on how a table's entries spread
over that dense table, where its pairs' first bytes fall.

The original's four points, (rules, first bytes) = (50k, 256), (30k, 160),
(12k, 96) and (9k, 48), from ``make_table`` (a copy: the same draws, so
the same tables from the same generator), drawn after the corpus from one
``default_rng(--seed)`` (the original's 1). Each is K2 fused with its pack
(``bpe_cuda.flat_encode_packed``) over ``--size-mib`` MiB of the corpus,
chained ``--k`` times through the carry and the last slot, at the
original's rows_per_block 1024 (which sets nothing on the card: the tile
is fixed; ``rpb`` names the original's row), timed as ``exp_dense``'s rows
and checked as they are (the whole chain against its plain version, the
first 1 MiB alone against ``bpe_numpy.bpe_encode_flat``, every token).
Each point reports ``occupied_first_bytes`` (the distinct first bytes of
its pairs) in place of the original's ``occupied_segments``, and
``gb_per_s_times_first_bytes``. ``--out`` writes the sweep as the
original's artifact, with those keys. One JSON line; exits 1 when a check
fails.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from blt_tpu_torch.merges import NO_RULE, MergeTable
from blt_tpu_torch.tools import _common as C
from blt_tpu_torch.tools.exp_dense import k2_rows

K = 8
SIZE_MIB = 64
SEED = 1  # the original's default_rng(1)
RPB = 1024
POINTS = ((50_000, 256), (30_000, 160), (12_000, 96), (9_000, 48))


def make_table(rng: np.random.Generator, rules: int, first_bytes: int) -> MergeTable:
    """``rules`` unique pairs whose first bytes span ``first_bytes`` values
    (the original's draws, in its order)."""
    firsts = rng.permutation(256)[:first_bytes]
    pairs = set()
    while len(pairs) < rules:
        a = int(firsts[rng.integers(0, first_bytes)])
        b = int(rng.integers(0, 256))
        pairs.add((a, b))
        if len(pairs) >= first_bytes * 256:
            break
    merges = {p: 256 + i for i, p in enumerate(sorted(pairs))}
    return MergeTable.build(merges)


def occupied_first_bytes(table: MergeTable) -> int:
    """The distinct first bytes of the table's pairs."""
    return int(np.unique(np.flatnonzero(table.dense != NO_RULE) // 256).size)


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = SEED) -> dict:
    """The four points on ``device``; see the module docstring."""
    rng = np.random.default_rng(seed)
    host = C.make_corpus(rng, size_bytes)
    rows = []
    for rules, first_bytes in POINTS:
        table = make_table(rng, rules, first_bytes)
        (row,) = k2_rows(host, table, device, k, (RPB,))
        occupied = occupied_first_bytes(table)
        row.update(name="occ", first_bytes=first_bytes, occupied_first_bytes=occupied,
                   gb_per_s_times_first_bytes=row["bytes_per_sec"] * occupied / 1e9)
        rows.append(row)
    return {"tool": "exp_occ", "device": C.describe(device), "size_bytes": size_bytes,
            "seed": seed, "exact": all(r["exact"] for r in rows), "rows": rows}


def artifact(result: dict, k: int) -> dict:
    """The original's ``--out`` artifact, with the port's keys."""
    return {
        "device": result["device"], "buffer_bytes": result["size_bytes"],
        "chained_kernels": k,
        "points": [{key: r[key] for key in ("rules", "occupied_first_bytes", "bytes_per_sec",
                                            "gb_per_s_times_first_bytes", "exact_prefix")}
                   for r in result["rows"]],
        "note": "K2 fused with its pack, one dense 128 KB wire table for every flat table: "
                "rate against the first bytes a table's pairs occupy (a constant rate is "
                "a kernel indifferent to where the entries fall)",
    }


def main(argv=None) -> int:
    ap = C.parser(__doc__.splitlines()[0], K, SIZE_MIB)
    ap.add_argument("--out", default=None, help="write the sweep as a JSON artifact here")
    ap.set_defaults(seed=SEED)
    args = ap.parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact(result, args.k), f, indent=1)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
