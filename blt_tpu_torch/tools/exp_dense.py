"""K2 fused with its pack on a 50k-rule table, chained on the card.

    python -m blt_tpu_torch.tools.exp_dense [--size-mib 64] [--k 8] [--seed 0]
        [--device cuda|cpu]

Port of ``tools/exp_dense.py``. The original's 50k-rule table (the first
50000 of ``default_rng(1).permutation(65536)`` as byte pairs, numbered
256, 257, ...) timed the TPU's packed-dense layout. The port has no such
layout: one dense 128 KB wire table (``tables.wire_table``) serves every
flat table, so the rows here are K2 fused with its pack
(``bpe_cuda.flat_encode_packed``, the main path's kernel) with that table,
over ``--size-mib`` MiB of the corpus, chained ``--k`` times through the
carry and the last slot (``exp_lookback.packed_chain``), timed as launched
and as a CUDA-graph replay beside the plain version and the bound (the
input read, the wire written, the table and the state words, once each).

The original ran rows_per_block 512 and 1024. The port's tile is fixed, so
both rows run the same kernel and ``rpb`` says only which of the
original's rows each stands for. Checks: the chain against its plain
version over the whole buffer, and the first 1 MiB, encoded on its own and
expanded on the host (``bpe_cuda.unpack_slots_host``), against
``bpe_numpy.bpe_encode_flat``, every token (the original compared all but
the last two). One JSON line with the GB/s device-chained; exits 1 when a
check fails.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import bpe_cuda
from blt_tpu_torch.ops.bpe_numpy import bpe_encode_flat
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.tools import _common as C
from blt_tpu_torch.tools.exp_lookback import packed_chain, packed_chain_plain

K = 8
SIZE_MIB = 64
RULES = 50_000
TABLE_SEED = 1  # the original's default_rng(1)
RPBS = (512, 1024)
PREFIX = C.MIB


def dense_merges(rng: np.random.Generator, rules: int = RULES) -> dict:
    """The original's table: the first ``rules`` of a permutation of the
    65536 byte pairs, numbered 256 + i."""
    pairs = rng.permutation(65536)[:rules]
    return {(int(p) // 256, int(p) % 256): 256 + i for i, p in enumerate(pairs)}


def _state(device: torch.device):
    return (torch.zeros((1, 1), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def prefix_exact(host: np.ndarray, table: MergeTable, wire_tbl: torch.Tensor) -> bool:
    """The first ``PREFIX`` bytes of ``host`` through K2 fused with its pack
    alone (end of stream), expanded on the host, against ``bpe_encode_flat``."""
    m = min(PREFIX, host.shape[0])
    data = torch.from_numpy(np.ascontiguousarray(host[:m])).to(wire_tbl.device)
    wire, _, _ = bpe_cuda.flat_encode_packed(data, m, -1, wire_tbl, *_state(wire_tbl.device))
    wire = wire.cpu().numpy()
    got = np.frombuffer(bpe_cuda.unpack_slots_host(wire[:m], wire[m:], m).tobytes(), ">u2")
    return np.array_equal(got.astype(np.int64), bpe_encode_flat(host[:m], table))


def k2_rows(host: np.ndarray, table: MergeTable, device: torch.device, k: int, rpbs) -> list:
    """K2 fused with its pack over all of ``host`` with ``table``, chained k
    times, a row for each original rows_per_block in ``rpbs``."""
    n = host.shape[0]
    data = torch.from_numpy(host).to(device)
    tbl = wire_table(table.dense, device)
    state = _state(device)
    expect = packed_chain_plain(data, n, tbl, state, k)
    plain_ms = C.median_ms(lambda: bpe_cuda.flat_packed_plain(data, n, -1, tbl, *state), device)
    exact_prefix = prefix_exact(host, table, tbl)
    rows = []
    for rpb in rpbs:
        t = C.time_chain(lambda: packed_chain(data, n, tbl, state, k), k, n, device, expect)
        rows.append({
            "name": "dense", "kernel": "K2+pack", "rpb": rpb, "rules": len(table), **t,
            "exact": t["exact"] and exact_prefix, "exact_prefix": exact_prefix,
            "bytes_per_sec": (t["graph"] or t["eager"])["GB_per_s"]["median"] * 1e9,
            "bound_ms": C.bound_ms(n + n + n // 8 + 2 * tbl.numel() + 16), "bound_by": "bytes",
            "plain_ms": plain_ms, "library_ms": None,
        })
    return rows


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """Both rows on ``device``; see the module docstring."""
    host = C.make_corpus(np.random.default_rng(seed), size_bytes)
    table = MergeTable.build(dense_merges(np.random.default_rng(TABLE_SEED)))
    rows = k2_rows(host, table, device, k, RPBS)
    return {"tool": "exp_dense", "device": C.describe(device), "size_bytes": size_bytes,
            "rules": len(table), "seed": seed, "exact": all(r["exact"] for r in rows),
            "rows": rows}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], K, SIZE_MIB).parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
