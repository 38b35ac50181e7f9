"""K3's gap round chained at the main path's shape (16 Mi tokens, 8192 slots), and the gap and sort loops.

    python -m blt_tpu_torch.tools.exp_gap [--size-mib 16] [--k 8] [--seed 0]
        [--device cuda|cpu]

A name clash: this module (``gap_row``, since the port's K3 redesign) is
not the JAX package's ``tools/exp_gap.py``, which compares the gap loop
with the sort loop on 8 MB. That tool's rows are ported here under their
own names (``loop_rows``, below); ``gap_row`` and its chain are unchanged.

K3 (``csrc/token_pass_gap.cu``, ``multipass_cuda.token_pass_gap``) is the
round of the default resident loop. Here it runs on ``--size-mib`` Mi
tokens of the corpus (one token per byte, as ``chip_smoke.py`` and the
device-rate tools make it from the seed) with leg 4's general table
(``hierarchical_rules``: 8000 rules that cuckoo32 places at 8192 slots),
chained k times with each round's output fed back as the next input, so
tombstones arrive from the second round on. One row, timed as launched and
as a CUDA-graph replay beside the plain version and the bound (tokens read
and written, the planes and the count, once each). One JSON line, as
``exp_chain``; exits 1 when a timed result differs from the plain chain's.

The JAX tool's rows (``loop_rows``) run on min(``--size-mib``, 8) MiB of
the corpus (its 8 MB) with its four-rule table (``exp_mp_ablate.HIER``),
each loop ``CudaTokenEncoder``'s with the input already on the card:

- ``gap_wire_loop``: ``gap_wire_dispatch`` (``CudaTokenEncoder._gap_loop``:
  K3 rounds, a compaction every third; then the JAX package's gap wire,
  the u16-BE image of every position and an alive-flag plane, which only
  this tool builds since the port ships the loop's compacted prefix), its
  wire expanded on the host by ``expand_gap_wire_host`` and held to
  ``bpe_numpy.bpe_encode_multipass`` byte for byte, with the count;
  ``expand_host_ms``: that expansion, 3 calls (the mean, the original's
  figure, and their spread);
- ``gap_wire_loop`` at ``rpb`` 1024: the original's rows_per_block sweep.
  The port's tile is fixed (``multipass_cuda._TILE``), so the row runs the
  same loop again and its ``rpb`` says only which of the original's rows it
  stands for;
- ``sort_loop``: ``_sort_loop`` (K4 rounds, a compaction after each),
  reached through ``encode_resident_dispatch`` under
  ``BLT_MP_COMPACT=sort``, held to the oracle.

Each loop is timed by the wall clock (``_common.time_wall``): 5 samples of
6 calls back to back, the last call's count read on the host, MB/s of
input, beside the bytes the loop must move (each round reads its live int32
tokens and writes the survivors; the gap loop also writes its wire) over
the card's memory rate.

To time another checkout's K3 in the same run, run that checkout's own
copy: ``cd OTHER && python -m blt_tpu_torch.tools.exp_gap``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import multipass_cuda
from blt_tpu_torch.ops.bpe_numpy import bpe_encode_multipass
from blt_tpu_torch.ops.multipass_cuda import CudaTokenEncoder
from blt_tpu_torch.ops.tables import cuckoo_planes
from blt_tpu_torch.tools import _common as C
from blt_tpu_torch.tools.exp_mp import sort_loop
from blt_tpu_torch.tools.exp_mp_ablate import HIER, feed_back

K = 8
SIZE_MIB = 16
LOOP_BYTES = 8 * C.MIB  # the JAX tool's NBYTES
LOOP_REPS = 5  # samples of each loop (the original's REPS)
PIPE = 6  # calls back to back a sample (the original's PIPE)
EXPAND_CALLS = 3


def hierarchical_rules(corpus: np.ndarray, rounds: int = 16, per_round: int = 500) -> dict:
    """Leg 4's general table, built from the corpus: ``rounds`` rounds, each
    adding the ``per_round`` most frequent token pairs of the first 1 MiB
    after the rounds before (new tokens 256, 257, ...), so later rules merge
    merged tokens."""
    toks = corpus[: C.MIB].astype(np.int64)
    rules = {}
    for _ in range(rounds):
        pairs, counts = np.unique((toks[:-1] << 16) | toks[1:], return_counts=True)
        for p in pairs[np.argsort(-counts, kind="stable")][:per_round]:
            rules[(int(p) >> 16, int(p) & 0xFFFF)] = 256 + len(rules)
        toks = bpe_encode_multipass(toks, MergeTable.build(rules)).astype(np.int64)
    return rules


def _gap_tokens_to_wire(toks: torch.Tensor, capacity: int) -> torch.Tensor:
    """Tombstoned int32 tokens -> one uint8 wire: the u16-BE image of every
    position (2 * capacity bytes) followed by the LSB-first alive-flag
    plane (capacity // 8 bytes). Host expansion: ``expand_gap_wire_host``."""
    t = toks.reshape(-1)[:capacity]
    data8 = torch.stack([(t >> 8) & 0xFF, t & 0xFF], dim=1).reshape(-1)
    flag = (t >= 0).to(torch.int32).reshape(-1, 8)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=t.device)
    fbytes = (flag * weights).sum(1)
    return torch.cat([data8.to(torch.uint8), fbytes.to(torch.uint8)])


def expand_gap_wire_host(wire: np.ndarray, capacity: int) -> np.ndarray:
    """Host expansion of the gap wire (copy of the JAX package's): drops
    the tombstoned entries. Returns byteswapped u16 tokens (LE image ==
    u16-BE wire stream)."""
    data = wire[: 2 * capacity]
    flags = wire[2 * capacity :]
    mask = np.unpackbits(
        np.ascontiguousarray(flags), bitorder="little"
    )[:capacity].astype(bool)
    return data.view(np.uint16)[mask]


def gap_wire_dispatch(enc: CudaTokenEncoder, data):
    """The gap loop plus its wire (the JAX package's
    ``encode_resident_wire_dispatch``). Returns (wire uint8[2 * capacity +
    capacity // 8] on the device, the count, capacity)."""
    toks, m, _ = enc._gap_loop(data)
    capacity = toks.shape[0]
    return _gap_tokens_to_wire(toks, capacity), m, capacity


def gap_row(tokens: torch.Tensor, planes, k: int = K) -> dict:
    """K3 chained k times over ``tokens`` (int32, -1 = dead) with ``planes``."""
    device = tokens.device
    n = tokens.numel()
    planes_bytes = 4 * 4 * planes.slots
    return {
        "name": "gap_round", "kernel": "K3", "tokens": n, "slots": planes.slots,
        **C.time_chain(
            lambda: feed_back(lambda t: multipass_cuda.token_pass_gap(t, planes), tokens, k),
            k, 4 * n, device,
            feed_back(lambda t: multipass_cuda.token_pass_gap_plain(t, planes), tokens, k)),
        # tokens read and written, the planes and the count, once each
        "bound_ms": C.bound_ms(8 * n + planes_bytes + 4), "bound_by": "bytes",
        "plain_ms": C.median_ms(
            lambda: multipass_cuda.token_pass_gap_plain(tokens, planes), device),
        "library_ms": None,
    }


def loop_rows(host: np.ndarray, device: torch.device):
    """The JAX tool's rows over the bytes ``host`` with its four-rule
    table: (rows, the host expansion's ms)."""
    table = MergeTable.build(HIER)
    n = host.shape[0]
    expected = bpe_encode_multipass(host, table)
    exp_wire = expected.astype(">u2").tobytes()
    bound = C.loop_bytes(C.rounds_host(host, table)[1])
    enc = CudaTokenEncoder(table, device, capacity_tokens=n)
    x = torch.from_numpy(host.astype(np.int32)).to(device)  # resident, as the original's

    def gap():
        return gap_wire_dispatch(enc, x)

    def gap_exact(out) -> bool:
        wire, m, cap = out
        toks = expand_gap_wire_host(wire.cpu().numpy(), cap)
        return toks.shape[0] == int(m) and toks.tobytes() == exp_wire

    def sort():
        return sort_loop(enc, x)

    def sort_exact(out) -> bool:
        toks, m = out
        return np.array_equal(toks[: int(m)].cpu().numpy(), expected)

    wire, _, cap = gap()
    wire_h = wire.cpu().numpy()
    expand = []
    for _ in range(EXPAND_CALLS):
        t0 = time.perf_counter()
        expand_gap_wire_host(wire_h, cap)
        expand.append((time.perf_counter() - t0) * 1e3)
    wire_bytes = 2 * cap + cap // 8
    rows = []
    for name, fn, check, rpb, extra in (("gap_wire_loop", gap, gap_exact, 512, wire_bytes),
                                        ("gap_wire_loop", gap, gap_exact, 1024, wire_bytes),
                                        ("sort_loop", sort, sort_exact, 512, 0)):
        exact = check(fn())
        timing, out = C.time_wall(fn, n, device, reps=LOOP_REPS, pipe=PIPE)
        rows.append(C.wall_row(name, "K3" if name.startswith("gap") else "K4", timing,
                               bound + extra, exact and check(out), rpb=rpb, tokens=n,
                               rounds=multipass_cuda.loop_log[-1][0]))
    return rows, {"mean": sum(expand) / len(expand), **C.rate_stats(expand)}


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """Leg 4's table and ``size_bytes`` tokens of the corpus on ``device``,
    then the loops; see the module docstring."""
    # a whole number of the recipe's 4 MiB periods: the same first bytes as
    # chip_smoke.py's corpus from the same seed
    period = 4 * C.MIB
    corpus = C.make_corpus(np.random.default_rng(seed), -(-max(size_bytes, 1) // period) * period)
    rules = hierarchical_rules(corpus)
    planes = cuckoo_planes(MergeTable.build(rules), device)
    if planes is None:
        raise RuntimeError(f"cuckoo32 cannot place the {len(rules)}-rule table")
    tokens = torch.from_numpy(corpus[:size_bytes].astype(np.int32)).to(device)
    rows = [gap_row(tokens, planes, k)]
    loop_n = min(size_bytes, LOOP_BYTES)
    loops, expand = loop_rows(C.make_corpus(np.random.default_rng(seed), loop_n), device)
    rows += loops
    return {"tool": "exp_gap", "device": C.describe(device), "size_bytes": size_bytes,
            "rules": len(rules), "slots": planes.slots, "seed": seed,
            "loop_bytes": loop_n, "loop_rules": len(HIER), "expand_host_ms": expand,
            "exact": all(r["exact"] for r in rows), "rows": rows}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], K, SIZE_MIB).parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
