"""Ablation of the flat-BPE pass's non-lookup stages, at 64 MiB.

    python -m blt_tpu_torch.tools.exp_scan [--size-mib 64] [--k 64] [--seed 0]
        [--device cuda|cpu] [--rpb 1024]

Port of ``tools/exp_scan.py`` (T6). Six variants of K2's pass, each
chained k times through its carry over the corpus with its 500 most
frequent pairs. The first four are flag sets of K2's own pass
(``csrc/flat_bpe.cu``, ``bpe_cuda.flat_encode_slots``), the last two
``csrc/scan_parts.cu`` (``tools_cuda.block_scan``):

- ``full``: K2's function (K2 itself);
- ``noscan``: the parity scan replaced by a guess (a match starts at an odd
  position; one launch);
- ``nolookup``: a pair "matches" when its next byte is a multiple of 8 and
  its value is the pair itself, then the scan;
- ``noshifts``: the next byte and ``consumed`` wrap inside each 128-byte
  row (the original's in-register rolls);
- ``scan16``: the original's 16-bit row scan, which keeps no parity from
  one block of ``--rpb`` rows to the next;
- ``swarpack``: the original's SWAR-packed scan of row pairs (its
  docstring calls it approximate; the port computes exactly what it
  computes). The original could not lower it on the TPU and left it out of
  its default list; here it is in.

scan16 and swarpack are one launch each (after one memset of its flags and
ticket): a CTA takes a job of whole segments of ``--rpb`` rows from a ticket
and streams its tiles in order through two stages of bulk-copied bytes,
the running maximum reset at every segment start; swarpack keeps the job's
match bits and scans its row pairs before it emits; each job publishes its
last start for the next job's first slot (``tools_cuda.block_scan_plan``).
The original's CHD probe is the dense wire table here, as in K2. Each
variant is timed as launched and as a CUDA-graph replay beside its plain
version and the byte bound. One JSON line, as ``exp_chain``, plus the
stage split against ``full``; exits 1 when a timed result differs from the
plain chain's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.ops import bpe_cuda, tools_cuda
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.tools import _common as C

K = 64
RPB = 1024
# the variants in the original's order: a flat pass's switches, or None for
# the two whose scan is local to a block of rows
VARIANTS = {"full": bpe_cuda.FlatFlags(),
            **{v: bpe_cuda.FLAT_PASSES[f"scan_parts_{v}"]
               for v in ("noscan", "nolookup", "noshifts")},
            **dict.fromkeys(tools_cuda.BLOCK_SCANS)}


def _flags(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {tuple(VARIANTS)}")
    return VARIANTS[variant]


def scan_parts(variant: str, data, n: int, next_byte: int, table, carry_in, rpb: int = RPB):
    """One pass of a T6 variant: kernel on CUDA tensors, plain on CPU
    tensors. The arguments and results of ``bpe_cuda.flat_encode_slots``,
    plus ``rpb``, the rows of a Pallas block, on which scan16 and swarpack
    depend."""
    flags = _flags(variant)
    if flags is None:
        return tools_cuda.block_scan(variant, data, n, next_byte, table, carry_in, rpb)
    return bpe_cuda.flat_encode_slots(data, n, next_byte, table, carry_in, flags)


def scan_parts_plain(variant: str, data, n: int, next_byte: int, table, carry_in,
                     rpb: int = RPB):
    """``scan_parts`` as plain tensor ops."""
    flags = _flags(variant)
    if flags is None:
        return tools_cuda.block_scan_plain(variant, data, n, next_byte, table, carry_in, rpb)
    return bpe_cuda.flat_pass_plain(data, n, next_byte, table, carry_in, flags)


def chain(variant: str, data, n: int, next_byte: int, table, carry, k: int = K,
          rpb: int = RPB):
    """k passes of a variant over one batch, each taking the carry the pass
    before wrote (the original's ``chain``); returns the last (slots,
    carry)."""
    return bpe_cuda.chain_passes(
        lambda c: scan_parts(variant, data, n, next_byte, table, c, rpb), carry, k)


def chain_plain(variant: str, data, n: int, next_byte: int, table, carry, k: int = K,
                rpb: int = RPB):
    """``chain`` through the plain version (at most two plain passes run)."""
    return C.chain_by_carry(
        lambda c: scan_parts_plain(variant, data, n, next_byte, table, c, rpb), carry, k)


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0,
            rpb: int = RPB) -> dict:
    """The six variants on ``device``; see the module docstring."""
    corpus = C.make_corpus(np.random.default_rng(seed), size_bytes)
    data = torch.from_numpy(corpus).to(device)
    table = wire_table(C.frequent_pair_table(corpus).dense, device)
    carry = torch.zeros((1, 1), dtype=torch.int32, device=device)
    n = size_bytes
    rows = []
    for variant in VARIANTS:
        uses_table = variant != "nolookup"
        rows.append({
            "name": variant, "kernel": "T6", "rpb": rpb,
            **C.time_chain(lambda variant=variant: chain(variant, data, n, -1, table, carry, k, rpb),
                           k, n, device, chain_plain(variant, data, n, -1, table, carry, k, rpb)),
            "bound_ms": C.bound_ms(3 * n + (table.numel() * 2 if uses_table else 0)),
            "bound_by": "bytes",
            "plain_ms": C.median_ms(
                lambda variant=variant: scan_parts_plain(variant, data, n, -1, table, carry, rpb),
                device),
            "library_ms": None,
        })
    ms = {r["name"]: (r["graph"] or r["eager"])["ms_per_launch"]["median"] for r in rows}
    split = {f"{v}_saves_ms": ms["full"] - ms[v] for v in VARIANTS if v != "full"}
    return {"tool": "exp_scan", "device": C.describe(device), "size_bytes": n,
            "rules": C.RULES, "rpb": rpb, "seed": seed,
            "exact": all(r["exact"] for r in rows), "rows": rows,
            "split": {"full_ms": ms["full"], **split}}


def main(argv=None) -> int:
    ap = C.parser(__doc__.splitlines()[0], K)
    ap.add_argument("--rpb", type=int, default=RPB,
                    help=f"rows of a Pallas block, for scan16 and swarpack (default {RPB})")
    args = ap.parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed,
                     args.rpb)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
