"""Pair -> value lookup designs over a packed 50k-rule table.

    python -m blt_tpu_torch.tools.exp_gather [--rows 4096] [--k 16]
        [--only name,name] [--tile 512] [--seed 1] [--device cuda|cpu]

Port of ``tools/exp_gather.py``'s Pallas kernels (T13, ``make_pallas``). The
table: 50,000 rules on distinct random pairs (seed 0), their u16 values
packed two to an int32 word, i32[256, 128] (the original's ``build_table``).
Five variants, i32 (rows, 128) -> i32 (rows, 128), each one design of one
CUDA kernel (``csrc/lookup.cu``, ``tools_cuda.lookup``):

- ``chain``: the original's 256-segment select chain as written, over the
  table staged in shared memory (the TPU's baseline design);
- ``g2d``: a gather from the table staged in shared memory, on a persistent
  grid of one block per SM;
- ``g2d_flat``: a gather from the table in device memory (``__ldg``);
- ``gax0``: the probe ``packed[p >> 8, lane]``, from shared memory;
- ``g8bit``: the probe ``tbl8[(q >> 7) & 31, q & 127]`` (q = p & 4095) over
  a u8[32, 128] table, from shared memory.

The first three compute ``val16[p]``; the probes are checked against their
own references, as in the original. p: int32 in ``[0, 65536)`` (seed 1),
the domain the original feeds; outside it the original's bodies disagree
with each other, so the port takes p to 16 bits first. Each variant's single
lookup is checked; then its chain, k links ``q = (p + (c & 1)) & 65535``
(c = p at the first link) each fused into one launch, is timed as launched
and as a CUDA-graph replay beside the plain chain and the byte bound, and
for the ``val16`` designs beside ``torch.take`` of the table as int32 with
int64 indices (the original's ``xla_take`` row), called k times. Per
variant, the original's keys ``exact`` and ``rate`` (lookups per second,
graph replay on a card). The original's MXU rows (``pmxu_i8``,
``pmxu_bf16``, ``mxu_bf16``, ``mxu_int8``) are not in this port yet;
``--tile`` (their grid step) is recorded only. One JSON line; exits 1 when a
result differs from its reference.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from blt_tpu_torch.ops import tools_cuda
from blt_tpu_torch.tools import _common as C

ROWS = 4096
K = 16
VARIANTS = tools_cuda.LOOKUPS
VAL16 = ("chain", "g2d", "g2d_flat")  # the designs of the real lookup


def build_table(n_rules: int = 50_000, seed: int = 0):
    """(val16 u16[65536], packed int32 (256, 128)): ``n_rules`` rules on
    distinct random pairs numbered from 256 (0 kept as "no rule"), two
    values to a word, pair 2k in the low half of word k (a copy of the
    original's ``build_table``)."""
    rng = np.random.default_rng(seed)
    pairs = rng.permutation(65536)[:n_rules]
    val16 = np.zeros(65536, np.uint16)
    val16[pairs] = (256 + np.arange(n_rules)) % 65536
    val16[pairs[val16[pairs] == 0]] = 256
    packed = (val16[1::2].astype(np.uint32) << 16 | val16[0::2].astype(np.uint32)).astype(np.int32)
    return val16, packed.reshape(256, C.LANES)


def build_tbl8() -> np.ndarray:
    """The original's u8[32, 128] probe table."""
    return (np.arange(4096, dtype=np.int64) * 2654435761 % 251).astype(np.uint8).reshape(32, C.LANES)


def reference(variant: str, val16: np.ndarray, packed: np.ndarray, tbl8: np.ndarray,
              p: np.ndarray) -> np.ndarray:
    """What the original checks each variant against, on ``0 <= p < 65536``."""
    if variant == "gax0":
        return packed[(p >> 1) >> 7, np.arange(C.LANES)[None, :]]
    if variant == "g8bit":
        q = p & 4095
        return tbl8[(q >> 7) & 31, q & 127].astype(np.int32)
    return val16[p].astype(np.int32)


def chained(variant: str, tbl, p: torch.Tensor, k: int = K) -> torch.Tensor:
    """The original's ``chained``: k links, c = p at the first, each the
    lookup of ``(p + (c & 1)) & 65535`` in one launch: kernel on CUDA
    tensors, plain on CPU tensors."""
    c = p
    for _ in range(k):
        c = tools_cuda.lookup(variant, tbl, p, c)
    return c


def chained_plain(variant: str, tbl, p: torch.Tensor, k: int = K) -> torch.Tensor:
    c = p
    for _ in range(k):
        c = tools_cuda.lookup_plain(variant, tbl, p, c)
    return c


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 1, only=(),
            tile: int = 512) -> dict:
    """The variants on ``device`` over ``size_bytes`` of p (rows =
    size_bytes // 512), or those of ``only``; see the module docstring."""
    unknown = sorted(set(only) - set(VARIANTS))
    if unknown:
        raise ValueError(f"not ported: {unknown}; the variants are {VARIANTS}")
    rows = size_bytes // (4 * C.LANES)
    val16, packed = build_table()
    tbl8 = build_tbl8()
    p_np = np.random.default_rng(seed).integers(0, 65536, (rows, C.LANES)).astype(np.int32)
    p = torch.from_numpy(p_np).to(device)
    tables = {"packed": torch.from_numpy(packed).to(device),
              "tbl8": torch.from_numpy(tbl8).to(device)}
    take_table = torch.from_numpy(val16.astype(np.int32)).to(device)
    p64 = p.long()
    n = rows * C.LANES
    out, results = [], {}
    for variant in VARIANTS:
        if only and variant not in only:
            continue
        tbl = tables["tbl8" if variant == "g8bit" else "packed"]
        want = reference(variant, val16, packed, tbl8, p_np)
        once = tools_cuda.lookup(variant, tbl, p)
        exact = np.array_equal(once.cpu().numpy(), want)
        expect = chained_plain(variant, tbl, p, k)
        row = {
            "name": variant, "kernel": "T13", "p_rows": rows, "once_exact": exact,
            **C.time_chain(lambda variant=variant, tbl=tbl: (chained(variant, tbl, p, k),),
                           k, 4 * n, device, (expect,)),
            # a link reads p and c and writes out, once each, plus the table
            "bound_ms": C.bound_ms(12 * n + tbl.numel() * tbl.element_size()),
            "bound_by": "bytes",
            "plain_ms": C.median_ms(
                lambda variant=variant, tbl=tbl: tools_cuda.lookup_plain(variant, tbl, p, p),
                device),
            "library_ms": (C.chained_ms(lambda: (torch.take(take_table, p64),), k, 4 * n,
                                        device, (torch.from_numpy(want).to(device),))
                           if variant in VAL16 else None),
        }
        row["exact"] = row["exact"] and exact
        timed = row["graph"] or row["eager"]
        row["rate"] = n / (timed["ms_per_launch"]["median"] / 1e3)
        results[variant] = {"exact": row["exact"], "rate": row["rate"]}
        out.append(row)
    return {"tool": "exp_gather", "device": C.describe(device), "size_bytes": 4 * n,
            "p_rows": rows, "k": k, "seed": seed, "tile": tile,
            "exact": all(r["exact"] for r in out), "rows": out, "results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    ap.add_argument("--rows", type=int, default=ROWS,
                    help=f"rows of 128 lookups (default {ROWS}, the original's)")
    ap.add_argument("--k", type=int, default=K, help=f"links per chain (default {K})")
    ap.add_argument("--only", default="", help="comma-separated variants to run")
    ap.add_argument("--tile", type=int, default=512,
                    help="the MXU rows' grid step (recorded; those rows are not ported yet)")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    only = [s for s in args.only.split(",") if s]
    result = measure(C.device_of(args.device), args.rows * 4 * C.LANES, args.k, args.seed,
                     only, args.tile)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
