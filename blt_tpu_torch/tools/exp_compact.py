"""The sort loop's parts, each alone: one K4 round, the compaction candidates and the whole loop.

    python -m blt_tpu_torch.tools.exp_compact [--size-mib 8] [--k 3] [--seed 0]
        [--device cuda|cpu] [--json OUT]

Port of ``tools/exp_compact.py``. ``--size-mib`` Mi tokens of the corpus
(CAP, the original's 8 Mi: one token a byte) with the original's
four-rule table (``exp_mp_ablate.HIER``), resident on the card. Rows:

- ``pass``: K4 (``multipass_cuda.token_pass``, one look-back launch) over
  the CAP tokens, held to ``_common.pass_host`` (one NumPy round);
- on pass 1's output and its real tombstones (``alive = out != -1``):
  ``sortkv`` (``torch.sort`` of the unique keys ``alive ? i : CAP + i``,
  then a gather), ``sort1bit`` (``torch.sort(stable=True)`` keyed by
  ``~alive``, then a gather), both held to the stable partition;
  ``cumsum`` (``alive`` summed in int32), held to ``np.cumsum``; ``take``
  (the monotone gather ``vals[idx]``, ``idx = min(i + cumsum(~alive),
  CAP - 1)``) and ``scatter`` (``zeros.scatter_`` of the alive values to
  their unique ranks, the dead ones to a trash slot past the end), held to
  NumPy fancy indexing;
- ``compact``: ``bpe_torch._compact(vals, alive)``, the compaction step
  ``CudaTokenEncoder._sort_loop`` runs (the counterpart of the original's
  ``sort_key_val`` in the loop), held to the stable partition with a zero
  tail, and its count;
- ``fullloop``: ``_sort_loop`` end to end (K4 and ``_compact`` a round, the
  count read on the host each round), held to ``bpe_numpy``'s multipass,
  with its MB/s of input (``mb_per_s``, the original's key).

Each row is timed by the wall clock (``_common.time_wall``): 5 samples of
``--k`` calls back to back (the original's INNER 3) ended by a synchronize,
ms per call (``ms``: median and spread; the original reported the median)
beside ``bound_ms``: the bytes the function must move (its inputs read
once, its outputs written once; the loop: each round reads its live int32
tokens and writes the survivors) over the card's memory rate. ``--json``
also writes the line to a file. Exits 1 when a row differs from its NumPy
result.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import multipass_cuda
from blt_tpu_torch.ops.bpe_numpy import bpe_encode_multipass
from blt_tpu_torch.ops.bpe_torch import _compact
from blt_tpu_torch.ops.multipass_cuda import CudaTokenEncoder
from blt_tpu_torch.tools import _common as C
from blt_tpu_torch.tools.exp_mp_ablate import HIER

K = 3  # calls back to back a sample (the original's INNER)
SIZE_MIB = 8
ROWS = ("pass", "sortkv", "sort1bit", "cumsum", "take", "scatter", "compact", "fullloop")


def sortkv(vals: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """The original's ``sort_key_val`` compaction: sort the unique keys,
    gather the values."""
    cap = vals.numel()
    iota = torch.arange(cap, dtype=torch.int32, device=vals.device)
    keys = torch.where(alive, iota, cap + iota)
    return vals[torch.sort(keys).indices]


def sort1bit(vals: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """A stable sort keyed by the one-bit dead flag, then a gather."""
    return vals[torch.sort((~alive).to(torch.uint8), stable=True).indices]


def cumsum(alive: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(alive.to(torch.int32), 0, dtype=torch.int32)


def take(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return vals[idx]


def scatter(vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``vals`` to the unique positions ``pos``; a position of CAP (the
    dead) lands in the trash slot past the end."""
    cap = vals.numel()
    out = torch.zeros(cap + 1, dtype=vals.dtype, device=vals.device)
    return out.scatter_(0, pos.to(torch.int64), vals)[:cap]


def host_inputs(out1: np.ndarray):
    """The original's inputs of ``take`` and ``scatter`` from pass 1's
    output: (alive, idx, pos), computed on the host."""
    alive = out1 != -1
    cap = out1.shape[0]
    idx = np.minimum(np.arange(cap, dtype=np.int32) + np.cumsum(~alive).astype(np.int32),
                     cap - 1).astype(np.int32)
    pos = np.where(alive, np.cumsum(alive).astype(np.int32) - 1, cap).astype(np.int32)
    return alive, idx, pos


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """Every row on ``device``; see the module docstring."""
    cap = size_bytes
    host = C.make_corpus(np.random.default_rng(seed), cap)
    table = MergeTable.build(HIER)
    enc = CudaTokenEncoder(table, device, capacity_tokens=cap)
    planes = enc.planes
    tokens = torch.from_numpy(host.astype(np.int32)).to(device)

    out1_h = C.pass_host(host, table)
    alive_h, idx_h, pos_h = host_inputs(out1_h)
    partition = np.concatenate([out1_h[alive_h], out1_h[~alive_h]])
    zero_tail = np.concatenate([out1_h[alive_h], np.zeros(cap - int(alive_h.sum()), np.int32)])
    final, counts = C.rounds_host(host, table)
    if not np.array_equal(final, bpe_encode_multipass(host, table)):
        raise RuntimeError("the NumPy rounds differ from bpe_numpy's multipass")

    vals = torch.from_numpy(out1_h).to(device)
    alive = torch.from_numpy(alive_h).to(device)
    idx = torch.from_numpy(idx_h).to(device)
    pos = torch.from_numpy(pos_h).to(device)

    def same(t, want) -> bool:
        return np.array_equal(t.cpu().numpy(), want)

    # name: (the call, its check, input bytes a call for MB/s, bytes bound)
    cases = {
        "pass": (lambda: multipass_cuda.token_pass(tokens, cap, planes),
                 lambda t: same(t, out1_h), cap, 8 * cap + 4 * 4 * planes.slots),
        "sortkv": (lambda: sortkv(vals, alive), lambda t: same(t, partition), 4 * cap, 9 * cap),
        "sort1bit": (lambda: sort1bit(vals, alive), lambda t: same(t, partition), 4 * cap,
                     9 * cap),
        "cumsum": (lambda: cumsum(alive),
                   lambda t: same(t, np.cumsum(alive_h, dtype=np.int32)), 4 * cap, 5 * cap),
        "take": (lambda: take(vals, idx), lambda t: same(t, out1_h[idx_h]), 4 * cap, 12 * cap),
        "scatter": (lambda: scatter(vals, pos), lambda t: same(t, zero_tail), 4 * cap,
                    12 * cap),
        "compact": (lambda: _compact(vals, alive),
                    lambda r: same(r[0], zero_tail) and int(r[1]) == int(alive_h.sum()),
                    4 * cap, 9 * cap + 4),
        "fullloop": (lambda: enc._sort_loop(tokens),
                     lambda r: same(r[0][: int(r[1])], final), cap, C.loop_bytes(counts)),
    }
    rows = []
    for name in ROWS:
        fn, check, in_bytes, bound = cases[name]
        exact = check(fn())
        timing, out = C.time_wall(fn, in_bytes, device, pipe=k, force=None)
        extra = {}
        if name == "fullloop":
            extra = {"rounds": multipass_cuda.loop_log[-1][0],
                     "mb_per_s": timing["MB_per_s"]["median"]}
        kernel = "K4" if name in ("pass", "fullloop") else None
        rows.append(C.wall_row(name, kernel, timing, bound, exact and check(out), **extra))
    return {"tool": "exp_compact", "device": C.describe(device), "size_bytes": size_bytes,
            "cap": cap, "rules": len(HIER), "seed": seed,
            "tombstones": int(cap - alive_h.sum()), "exact": all(r["exact"] for r in rows),
            "rows": rows}


def main(argv=None) -> int:
    ap = C.parser(__doc__.splitlines()[0], K, SIZE_MIB, "calls back to back a sample")
    ap.add_argument("--json", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    if args.json:
        with open(args.json, "w") as f:
            f.write(json.dumps(result))
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
