"""The gap loop's glue, four variants and the port's own, timed round-robin in one process.

    python -m blt_tpu_torch.tools.exp_gapvar [--size-mib 8] [--k 2] [--seed 0]
        [--device cuda|cpu]

Port of ``tools/exp_gapvar.py``. ``loop_variant`` is a copy of
``CudaTokenEncoder._gap_loop`` (K3 rounds until one merges nothing, the
port's ``_compact(buf, buf >= 0, fill=-1)`` every ``GAP_COMPACT_EVERY``
rounds when another round will run) that differs from it only in the glue
of a round, as the original's four do:

- ``A``: a fresh ``torch.full(-1)`` buffer a round, K3's output copied in;
  m from K3's fused count;
- ``B``: K3's output copied into the carry buffer; m from the count;
- ``C``: B, with m from a reduce, ``(out >= 0).sum()``;
- ``D``: A, with m from the reduce;
- ``port``: ``CudaTokenEncoder._gap_loop`` itself, whose next buffer is
  K3's fresh output and m its count.

On ``--size-mib`` MiB of the corpus (the original's 8 MB) with the
original's four-rule table (``exp_mp_ablate.HIER``), the input already on
the card. Each is held to ``bpe_numpy.bpe_encode_multipass`` (the alive
tokens and the count), then all five are timed round-robin by the wall
clock: 5 rounds, in each one sample of each variant, ``--k`` calls back to
back (the original's 2), the last call's count read on the host. MB/s of
input beside the bytes the loop must move (each round reads its live int32
tokens and writes the survivors) over the card's memory rate. One JSON
line; exits 1 when a variant differs from the oracle.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import multipass_cuda
from blt_tpu_torch.ops.bpe_numpy import bpe_encode_multipass
from blt_tpu_torch.ops.bpe_torch import _compact
from blt_tpu_torch.ops.multipass_cuda import GAP_COMPACT_EVERY, CudaTokenEncoder
from blt_tpu_torch.tools import _common as C
from blt_tpu_torch.tools.exp_mp_ablate import HIER

K = 2  # calls back to back a sample (the original's 2)
SIZE_MIB = 8
ROUNDS = 5  # round-robin rounds (the original's)
GLUES = ("A", "B", "C", "D")
VARIANTS = (*GLUES, "port")


def loop_variant(enc: CudaTokenEncoder, data, glue: str):
    """``enc._gap_loop(data)`` with the glue ``glue`` (A-D) between
    rounds. Returns (int32[capacity] with -1 tombstones, the alive count)."""
    if glue not in GLUES:
        raise ValueError(f"unknown glue {glue!r}; one of {GLUES}")
    buf, n, capacity = enc._buffer(data, -1)
    m, prev, rounds = n, n + 1, 0
    count = None
    while count is None or (m < prev and m > 1):
        out, fused = multipass_cuda.token_pass_gap(buf, enc.planes)
        count = fused if glue in ("A", "B") else (out >= 0).sum(dtype=torch.int32)
        if glue in ("A", "D"):
            buf = torch.full((capacity,), -1, dtype=torch.int32, device=out.device)
        buf.copy_(out)
        m2 = int(count)  # the round's one host read
        rounds += 1
        if rounds % GAP_COMPACT_EVERY == 0 and m2 < m and m2 > 1:
            buf, _ = _compact(buf, buf >= 0, fill=-1)
        prev, m = m, m2
    return buf, count


def run(enc: CudaTokenEncoder, data, variant: str):
    """One loop of ``variant`` (A-D or ``port``)."""
    if variant == "port":
        return enc._gap_loop(data)[:2]
    return loop_variant(enc, data, variant)


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """The five loops on ``device``; see the module docstring."""
    host = C.make_corpus(np.random.default_rng(seed), size_bytes)
    table = MergeTable.build(HIER)
    expected = bpe_encode_multipass(host, table)
    bound = C.loop_bytes(C.rounds_host(host, table)[1])
    enc = CudaTokenEncoder(table, device, capacity_tokens=size_bytes)
    x = torch.from_numpy(host.astype(np.int32)).to(device)

    def exact(out) -> bool:
        toks, m = out
        toks = toks.cpu().numpy()
        return np.array_equal(toks[toks >= 0], expected) and int(m) == expected.size

    exacts = {v: exact(run(enc, x, v)) for v in VARIANTS}
    rounds = multipass_cuda.loop_log[-1][0]
    samples = {v: [] for v in VARIANTS}
    for _ in range(ROUNDS):
        for v in VARIANTS:
            timing, out = C.time_wall(lambda v=v: run(enc, x, v), size_bytes, device,
                                      reps=1, pipe=k, warm=False)
            exacts[v] = exacts[v] and exact(out)
            samples[v].append(timing["ms"]["median"])
    rows = []
    for v in VARIANTS:
        timing = {"reps": ROUNDS, "pipe": k, "ms": C.rate_stats(samples[v]),
                  "MB_per_s": C.rate_stats([size_bytes / ms / 1e3 for ms in samples[v]])}
        rows.append(C.wall_row(v, "K3", timing, bound, exacts[v], tokens=size_bytes,
                               rounds=rounds))
    return {"tool": "exp_gapvar", "device": C.describe(device), "size_bytes": size_bytes,
            "rules": len(HIER), "seed": seed, "exact": all(exacts.values()), "rows": rows}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], K, SIZE_MIB,
                    "calls back to back a sample").parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
