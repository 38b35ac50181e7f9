"""Block-count sweep of a raw u8 copy, then K1 and K2, at 64 MiB.

    python -m blt_tpu_torch.tools.exp_sweep [--size-mib 64] [--k 8] [--seed 0]
        [--device cuda|cpu]

Port of ``tools/exp_sweep.py``. ``copy_pallas`` (T7, ``csrc/chain.cu``) is
the copy floor that every byte-moving kernel is held to. The Pallas copy
runs a grid of ``rows // rows_per_block`` steps and returns the last step
(``done``); on the card the copy launches that many CUDA blocks, and each
streams its whole grid step (rows_per_block x 128 bytes) through a ring of
shared-memory stages by bulk asynchronous copies, so the sweep over
rows_per_block 512 / 2048 / 8192 is a sweep over the launch's block count:
1024, 256 and 64 blocks at 64 MiB. Both are recorded. Then K1 (``basic_encode``) and K2 (``flat_encode_slots``, 500
rules), which have no block-size knob on the card.

Every row is k single launches back to back (the original's ITERS calls),
timed as launched and as a CUDA-graph replay. One JSON line, as
``exp_chain``; ``clone()``'s ms beside the copy rows. Exits 1 when a timed
result differs from the plain version's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.ops import bpe_cuda
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.tools import _common as C

ITERS = 8
RPBS = (512, 2048, 8192)


def copy_plain(data2, rpb: int = 2048):
    """T7 as plain tensor ops: (a copy of data2, done = rows // rpb - 1)."""
    return bpe_cuda.chain_plain("copy_sweep", data2, None, 1, rpb)


def copy_pallas(data2, rpb: int = 2048):
    """Raw u8 copy of a (rows, 128) tensor in ``rows // rpb`` CUDA blocks
    (T7): kernel on a CUDA tensor, plain on a CPU one. Returns (out, done
    int32 (1,1))."""
    return bpe_cuda.chain_encode("copy_sweep", data2, None, 1, rpb)


def measure(device: torch.device, size_bytes: int, k: int = ITERS, seed: int = 0) -> dict:
    """The sweep on ``device``; see the module docstring."""
    corpus = C.make_corpus(np.random.default_rng(seed), size_bytes)
    data = torch.from_numpy(corpus).to(device)
    data2 = data.reshape(-1, C.LANES)
    n = size_bytes
    rows = []

    def row(name, kernel, fn, plain, out_bytes, library=False, **extra):
        rows.append({
            "name": name, "kernel": kernel, **extra,
            **C.time_chain(lambda: C.repeat(fn, k), k, n, device, plain()),
            "bound_ms": C.bound_ms(n + out_bytes),
            "plain_ms": C.median_ms(plain, device),
            "library_ms": (C.chained_ms(lambda: (data2.clone(),), k, n, device, (data2,))
                           if library else None),
        })

    for rpb in RPBS:
        row("copy", "T7", lambda rpb=rpb: copy_pallas(data2, rpb),
            lambda rpb=rpb: copy_plain(data2, rpb), n, library=True,
            rpb=rpb, blocks=data2.shape[0] // rpb)
    row("basic", "K1", lambda: (bpe_cuda.basic_encode(data2),),
        lambda: (bpe_cuda.widen_plain(data2),), 2 * n)
    table = wire_table(C.frequent_pair_table(corpus).dense, device)
    carry = torch.zeros((1, 1), dtype=torch.int32, device=device)
    row("bpe", "K2", lambda: bpe_cuda.flat_encode_slots(data, n, -1, table, carry),
        lambda: bpe_cuda.flat_pass_plain(data, n, -1, table, carry),
        2 * n + table.numel() * 2)
    return {"tool": "exp_sweep", "device": C.describe(device), "size_bytes": n,
            "rules": C.RULES, "seed": seed, "exact": all(r["exact"] for r in rows),
            "rows": rows}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], ITERS).parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
