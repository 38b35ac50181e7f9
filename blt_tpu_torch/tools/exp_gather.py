"""Pair -> value lookup designs over a packed 50k-rule table.

    python -m blt_tpu_torch.tools.exp_gather [--rows 4096] [--k 16]
        [--only name,name] [--tile 512] [--seed 1] [--device cuda|cpu]

Port of ``tools/exp_gather.py``: its Pallas kernels (T13 ``make_pallas``,
T14 ``make_pmxu``) and its three XLA rows. The table: 50,000 rules on
distinct random pairs (seed 0), their u16 values ``val16``, packed two to an
int32 word, i32[256, 128] (the original's ``build_table``). Ten rows, i32
(rows, 128) -> i32 (rows, 128), in the original's order; the first seven
are hand-written CUDA kernels (``route: "cuda"``):

- ``chain``: the Hopper design of the original's production lookup (its
  body is a 256-segment select chain, the TPU's way round a missing dynamic
  gather): one shared-memory read an element;
- ``g2d``: the same read as a dynamic gather, which on Hopper is chain's
  kernel, counted and timed as its own row;
- ``g2d_flat``: a gather from the table in device memory (``__ldg``);
- ``gax0``: the probe ``packed[p >> 8, lane]``, from shared memory;
- ``g8bit``: the probe ``tbl8[(q >> 7) & 31, q & 127]`` (q = p & 4095) over
  a u8[32, 128] table, from shared memory;
  (these five: ``csrc/lookup.cu``'s one kernel template,
  ``tools_cuda.lookup``: the table staged by ``cp.async.bulk`` while the
  first p and c loads are in flight, four groups of 4 elements a thread a
  step, the grid sized to the work, ``tools_cuda.lookup_plan``)
- ``pmxu_i8``, ``pmxu_bf16``: T14, ``onehot(p >> 8) @ planes`` on the
  tensor cores (hand-written Hopper ``wgmma``, m64n256k32 s8 -> s32 or
  m64n256k16 bf16 -> f32, the one-hot rows in registers, the planes in
  shared memory by ``cp.async.bulk``), then the columns ``p & 255`` and
  ``256 + (p & 255)``, ``--tile`` positions per block step
  (``csrc/onehot_mma.cu``, ``tools_cuda.pmxu``; planes
  ``tools_cuda.mxu_planes``, their shared-memory image
  ``tools_cuda.mxu_image``);

and the last three are PyTorch's own calls (``route: "torch"``, no kernel
of the port): ``xla_take`` (``torch.take`` of ``val16`` as int32 with int64
indices), ``mxu_bf16`` (the one-hot ``torch.matmul`` in bf16) and
``mxu_int8`` (the one-hot ``torch._int_mm``, int8 to int32), both in pieces
of 2**20 positions (``tools_cuda.pmxu_plain``).

All but the two probes compute ``val16[p]``; the probes are checked against
their own references, as in the original. p: int32 in ``[0, 65536)`` (seed
1), the domain the original feeds; outside it the original's T13 bodies
disagree with each other, so T13 takes p to 16 bits first (T14's function
is defined everywhere and is kept). Each row's single lookup is checked;
then its chain, k links ``q = (p + (c & 1)) & 65535`` (c = p at the first
link; each kernel link one launch), is timed as launched and as a CUDA-graph
replay beside the plain chain (library rows: beside the T13 ``g2d`` plain
chain) and its bound: the bytes (p, c and out, plus the table), for T14 and
the ``mxu`` rows the larger of those and the tensor-core operations, 2 · 256
· 512 per position over the data sheet's dense peak. The kernel rows also
carry ``library_ms``, one PyTorch call of the same function called k times,
its int64 indices made before the timing: ``torch.take`` of val16 for the
rows computing ``val16[p]``, ``torch.gather(packed, 0, p >> 8)`` for
``gax0``, ``torch.take`` of tbl8 as int32 at ``p & 4095`` for ``g8bit``.
Per row, the original's keys ``exact`` and ``rate`` (lookups per second,
graph replay on a card). One JSON line; exits 1 when a result differs from
its reference.
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

from blt_tpu_torch.ops import tools_cuda
from blt_tpu_torch.tools import _common as C

ROWS = 4096
K = 16
TILE = 512
LIBRARY = ("xla_take", "mxu_bf16", "mxu_int8")  # PyTorch's own calls, not ports
VARIANTS = tools_cuda.LOOKUPS + tools_cuda.MXU_LOOKUPS + LIBRARY  # the original's order
# the one-hot rows' dtype (make_pmxu's name)
MXU_DTYPE = {"pmxu_i8": "int8", "pmxu_bf16": "bf16", "mxu_bf16": "bf16", "mxu_int8": "int8"}
OPS_PER_POSITION = 2 * 256 * 512  # the one-hot product's multiply-adds, twice


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


def _links(link, p: torch.Tensor, k: int) -> torch.Tensor:
    """k links ``c = link(c)``, c = p at the first: the last c."""
    c = p
    for _ in range(k):
        c = link(c)
    return c


def chained(variant: str, tbl, p: torch.Tensor, k: int = K) -> torch.Tensor:
    """The original's ``chained``: k links, c = p at the first, each the
    lookup of ``(p + (c & 1)) & 65535`` in one launch: kernel on CUDA
    tensors, plain on CPU tensors."""
    return _links(lambda c: tools_cuda.lookup(variant, tbl, p, c), p, k)


def chained_plain(variant: str, tbl, p: torch.Tensor, k: int = K) -> torch.Tensor:
    return _links(lambda c: tools_cuda.lookup_plain(variant, tbl, p, c), p, k)


def chained_mxu(dtype: str, planes, p: torch.Tensor, k: int = K, tile: int = TILE,
                plain: bool = False) -> torch.Tensor:
    """T14's chain as ``chained``: k links of ``tools_cuda.pmxu`` (kernel on
    CUDA tensors, plain on CPU tensors), or of ``pmxu_plain`` with
    ``plain``."""
    fn = tools_cuda.pmxu_plain if plain else tools_cuda.pmxu
    return _links(lambda c: fn(dtype, planes, p, c, tile), p, k)


def library_link(name: str, table, p: torch.Tensor, c=None, tile: int = TILE) -> torch.Tensor:
    """One lookup (or chain link, with ``c``) of a library row, PyTorch's
    own calls: ``xla_take`` ``torch.take`` of ``table``, the int32 val16;
    ``mxu_*`` the one-hot product over ``table``, the planes."""
    if name == "xla_take":
        q = p if c is None else (p + (c & 1)) & 0xFFFF
        return torch.take(table, q.long())
    return tools_cuda.pmxu_plain(MXU_DTYPE[name], table, p, c, tile)


def library_chain(name: str, table, p: torch.Tensor, k: int = K,
                  tile: int = TILE) -> torch.Tensor:
    """A library row's chain: k links, c = p at the first."""
    return _links(lambda c: library_link(name, table, p, c, tile), p, k)


def _bound(n: int, table_bytes: int, dtype=None) -> dict:
    """A row's bound: its bytes (p and c read, out written, once each, plus
    the table), for the one-hot product the larger of those and its
    tensor-core operations."""
    ms = {"bytes": C.bound_ms(12 * n + table_bytes)}
    if dtype is not None:
        ms["operations"] = C.tensor_bound_ms(OPS_PER_POSITION * n, dtype)
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_by": by}


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 1, only=(),
            tile: int = TILE) -> dict:
    """The rows on ``device`` over ``size_bytes`` of p (rows = size_bytes //
    512), or those of ``only``; see the module docstring."""
    unknown = sorted(set(only) - set(VARIANTS))
    if unknown:
        raise ValueError(f"unknown variants: {unknown}; the variants are {VARIANTS}")
    rows = size_bytes // (4 * C.LANES)
    val16, packed = build_table()
    tbl8 = build_tbl8()
    p_np = np.random.default_rng(seed).integers(0, 65536, (rows, C.LANES)).astype(np.int32)
    p = torch.from_numpy(p_np).to(device)
    tables = {"packed": torch.from_numpy(packed).to(device),
              "tbl8": torch.from_numpy(tbl8).to(device),
              "xla_take": torch.from_numpy(val16.astype(np.int32)).to(device),
              **{d: tools_cuda.mxu_planes(val16, d).to(device) for d in tools_cuda.MXU_DTYPES}}
    n = rows * C.LANES
    single = {}  # library call -> its ms, each timed once

    def single_call(variant: str) -> float:
        """One PyTorch call of ``variant``'s function, k calls: ``torch.take``
        of val16 (every row but the probes), ``torch.gather`` along the
        packed table's rows (gax0), ``torch.take`` of tbl8 as int32
        (g8bit); its int64 index made here, outside the timing."""
        key = variant if variant in ("gax0", "g8bit") else "take"
        if key not in single:
            if key == "gax0":
                call = functools.partial(torch.gather, tables["packed"], 0, (p >> 8).long())
            elif key == "g8bit":
                call = functools.partial(torch.take, tables["tbl8"].to(torch.int32),
                                         (p & 4095).long())
            else:
                call = functools.partial(torch.take, tables["xla_take"], p.long())
            want = reference("g2d" if key == "take" else key, val16, packed, tbl8, p_np)
            single[key] = C.chained_ms(lambda: (call(),), k, 4 * n, device,
                                       (torch.from_numpy(want).to(device),))
        return single[key]

    out, results = [], {}
    for variant in VARIANTS:
        if only and variant not in only:
            continue
        if variant in tools_cuda.LOOKUPS:
            tbl = tables["tbl8" if variant == "g8bit" else "packed"]
            want = reference(variant, val16, packed, tbl8, p_np)
            once = tools_cuda.lookup(variant, tbl, p)
            row = {
                "name": variant, "kernel": "T13", "route": "cuda", "p_rows": rows,
                **C.time_chain(lambda variant=variant, tbl=tbl: (chained(variant, tbl, p, k),),
                               k, 4 * n, device, (chained_plain(variant, tbl, p, k),)),
                **_bound(n, tbl.numel() * tbl.element_size()),
                "plain_ms": C.median_ms(
                    lambda variant=variant, tbl=tbl: tools_cuda.lookup_plain(variant, tbl, p, p),
                    device),
                "library_ms": single_call(variant),
            }
        elif variant in tools_cuda.MXU_LOOKUPS:
            dtype = MXU_DTYPE[variant]
            planes = tables[dtype]
            want = reference("g2d", val16, packed, tbl8, p_np)
            once = tools_cuda.pmxu(dtype, planes, p, tile=tile)
            row = {
                "name": variant, "kernel": "T14", "route": "cuda", "p_rows": rows, "tile": tile,
                **C.time_chain(
                    lambda dtype=dtype, planes=planes: (chained_mxu(dtype, planes, p, k, tile),),
                    k, 4 * n, device, (chained_mxu(dtype, planes, p, k, tile, plain=True),)),
                **_bound(n, planes.numel() * planes.element_size(), dtype),
                "plain_ms": C.median_ms(
                    lambda dtype=dtype, planes=planes: tools_cuda.pmxu_plain(dtype, planes, p, p,
                                                                             tile),
                    device),
                "library_ms": single_call("g2d"),
            }
        else:
            table = tables[variant if variant == "xla_take" else MXU_DTYPE[variant]]
            want = reference("g2d", val16, packed, tbl8, p_np)
            once = library_link(variant, table, p, tile=tile)
            row = {
                "name": variant, "kernel": None, "route": "torch", "p_rows": rows,
                **C.time_chain(
                    lambda variant=variant, table=table: (library_chain(variant, table, p, k,
                                                                        tile),),
                    k, 4 * n, device,
                    (chained_plain("g2d", tables["packed"], p, k),)),
                **_bound(n, table.numel() * table.element_size(),
                         MXU_DTYPE.get(variant)),
                "plain_ms": None, "library_ms": None,
            }
        exact = np.array_equal(once.cpu().numpy(), want)
        row["once_exact"] = exact
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
    ap.add_argument("--tile", type=int, default=TILE,
                    help=f"T14's positions per block step, a multiple of 16 that divides "
                         f"rows x 128 (default {TILE}, the original's)")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    only = [s for s in args.only.split(",") if s]
    result = measure(C.device_of(args.device), args.rows * 4 * C.LANES, args.k, args.seed,
                     only, args.tile)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
