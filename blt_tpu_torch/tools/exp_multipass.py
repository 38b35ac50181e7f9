"""The general-table encoders on a 9-rule hierarchical table: host compaction and the twin route.

    python -m blt_tpu_torch.tools.exp_multipass [--size-mib 16] [--k 1] [--seed 0]
        [--device cuda|cpu]

Port of ``tools/exp_multipass.py``. Its 9-rule hierarchical table (byte
pairs and rules chained over merged tokens) on ``--size-mib`` MiB of the
corpus (``_common.make_corpus`` from ``--seed``):

- ``encode``: ``CudaTokenEncoder(table, device, capacity_tokens=n).encode``,
  K4 a round (one look-back launch) with the tombstones compacted on the
  host between rounds, so each round uploads and downloads the tokens. The
  first call (``first_s``: it builds and loads the kernels where no earlier
  call did) and ``--k`` warm calls; the last warm result is held to
  ``bpe_numpy.bpe_encode_multipass`` over the whole input, and the same
  encoder's result on the first 1 MiB alone to the oracle on that prefix
  (``exact_prefix``);
- ``twin``: ``bpe_torch.multipass_encode`` with ``sparse_table_device`` on
  that 1 MiB (the twin route, the counterpart of the original's
  ``bpe_jax.multipass_encode``), first and ``--k`` warm calls, held to the
  oracle.

Both rows are timed by the wall clock (``_common.time_wall``: one call a
sample, the twin's count read on the host), beside ``bound_ms``: the bytes
the loop must move (each round reads its live int32 tokens and writes the
survivors) over the card's memory rate. One JSON line; exits 1 when a
result differs from the oracle's.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import bpe_torch
from blt_tpu_torch.ops.bpe_numpy import bpe_encode_multipass
from blt_tpu_torch.ops.multipass_cuda import CudaTokenEncoder
from blt_tpu_torch.tools import _common as C
from blt_tpu_torch.utils.chunking import align_up

K = 1  # warm calls (the original's one)
SIZE_MIB = 16
PREFIX = C.MIB  # the exactness prefix and the twin route's input
# byte pairs and chained rules over merged ids (the original's)
MERGES = {(101, 116): 256, (256, 97): 257, (257, 111): 258,
          (32, 101): 259, (259, 116): 260, (115, 104): 261,
          (261, 114): 262, (100, 108): 263, (258, 263): 264}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """Both rows on ``device``; see the module docstring."""
    table = MergeTable.build(MERGES)
    if table.flat:
        raise RuntimeError("the 9-rule table must be hierarchical")
    chunk = C.make_corpus(np.random.default_rng(seed), size_bytes)
    m = min(PREFIX, size_bytes)
    small = chunk[:m]
    expected = bpe_encode_multipass(chunk, table)
    exp_small = bpe_encode_multipass(small, table)
    counts = C.rounds_host(chunk, table)[1]
    counts_small = C.rounds_host(small, table)[1]

    enc = CudaTokenEncoder(table, device, capacity_tokens=size_bytes)
    t0 = time.perf_counter()
    enc.encode(chunk)
    first = time.perf_counter() - t0
    timing, got = C.time_wall(lambda: enc.encode(chunk), size_bytes, device, reps=k,
                              force=None, warm=False)
    exact_prefix = np.array_equal(enc.encode(small), exp_small)
    rows = [C.wall_row("encode", "K4", timing, C.loop_bytes(counts),
                       np.array_equal(got, expected), first_s=first, rounds=len(counts) - 1)]

    keys, vals = bpe_torch.sparse_table_device(table, device)
    buf = torch.zeros(align_up(m), dtype=torch.uint8, device=device)
    buf[:m] = torch.from_numpy(small).to(device)
    t0 = time.perf_counter()
    bpe_torch.multipass_encode(buf, m, keys, vals)
    _sync(device)
    first = time.perf_counter() - t0
    timing, (toks, count) = C.time_wall(lambda: bpe_torch.multipass_encode(buf, m, keys, vals),
                                        m, device, reps=k, warm=False)
    host = toks[: int(count)].cpu().numpy()
    rows.append(C.wall_row("twin", None, timing, C.loop_bytes(counts_small),
                           np.array_equal(host, exp_small), first_s=first, tokens=m,
                           rounds=len(counts_small) - 1))
    return {"tool": "exp_multipass", "device": C.describe(device), "size_bytes": size_bytes,
            "rules": len(MERGES), "seed": seed, "exact_prefix": bool(exact_prefix),
            "exact": bool(exact_prefix) and all(r["exact"] for r in rows), "rows": rows}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], K, SIZE_MIB, "warm calls").parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
