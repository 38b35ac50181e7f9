"""The main path's one-launch K2 and K4 beside their three-launch designs, chained;
K2's standalone pack.

    python -m blt_tpu_torch.tools.exp_lookback [--size-mib 64] [--k 8] [--seed 0]
        [--device cuda|cpu]

Two pairs of rows, each pair computing one function two ways in the same
run, and one row of K2's pack alone, timed as launched and as a CUDA-graph
replay beside the plain version and the bound:

- K2 and its packed wire over ``--size-mib`` MiB of the corpus with its 500
  most frequent pairs, chained k times through the carry and the last slot
  (each batch's ``last_slot`` is the next one's ``prev_slot``): ``packed``,
  one launch (``bpe_cuda.flat_encode_packed``, the main path's), and
  ``k2_pack``, K2's reduce / scan / emit and then ``pack_slots`` (four
  launches). Bound: 1 byte in and 1.125 bytes of wire out per position, the
  table and the four state words, once each.
- K4 over ``--size-mib`` / 8 Mi tokens of the corpus (T4's 8 Mi tokens at
  the default) with T4's four-rule hierarchical table, chained k times with
  each round's output fed back (tombstones from the second round on):
  ``lookback``, one launch (``multipass_cuda.K4_FLAGS``, the main path's),
  and ``three_launch`` (the default ``TokenFlags``, T4's ``full``). Bound:
  4 bytes in and 4 out per token and the planes.
- K2's standalone pack (``bpe_cuda.pack_slots``, which the main path no
  longer launches) over the slots K2 gives for the corpus's first
  ``--size-mib`` / 4 MiB (16 Mi slots at the default), every slot valid,
  chained k times through the last slot: ``pack``. Bound: 2 bytes in and
  1.125 bytes of wire out per slot, and the two slot words.

``k2_rows``, ``k4_rows`` and ``pack_row`` take any inputs (``chip_smoke.py``
also runs K4 at 16 Mi tokens with leg 4's 8192-slot table). One JSON line, as
``exp_chain``, with each pair's ratio one launch / three; exits 1 when a
timed result differs from its plain chain's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import bpe_cuda, multipass_cuda
from blt_tpu_torch.ops.tables import cuckoo_planes, wire_table
from blt_tpu_torch.tools import _common as C
from blt_tpu_torch.tools.exp_mp_ablate import HIER, feed_back

K = 8


def packed_chain(data, n: int, table, state, k: int, fused: bool = True):
    """k passes of K2 and its pack over one batch, each taking the (carry,
    prev_slot) the pass before returned: one launch each (``fused``) or
    K2's three and the pack's one. Returns the last (wire, carry, last_slot)."""
    def one(s):
        carry, prev = s
        if fused:
            wire, c, last = bpe_cuda.flat_encode_packed(data, n, -1, table, carry, prev)
        else:
            slots, c = bpe_cuda.flat_encode_slots(data, n, -1, table, carry)
            wire, last = bpe_cuda.pack_slots(slots, n, prev)
        return (wire, c, last), (c, last)

    return bpe_cuda.chain_passes(one, state, k)[0]


def packed_chain_plain(data, n: int, table, state, k: int):
    """``packed_chain`` through the plain version."""
    def one(s):
        out = bpe_cuda.flat_packed_plain(data, n, -1, table, *s)
        return out, (out[1], out[2])

    return bpe_cuda.chain_passes(one, state, k)[0]


def _ratio(rows) -> float:
    """The first row's ms per launch over the second's (graph replay on a
    card)."""
    one, three = ((r["graph"] or r["eager"])["ms_per_launch"]["median"] for r in rows)
    return one / three


def k2_rows(data: torch.Tensor, n: int, table: torch.Tensor, k: int = K) -> list:
    """``packed`` and ``k2_pack`` over one batch (uint8[cap], n valid, the
    wire table), chained k times from carry 0 and prev_slot 0."""
    device = data.device
    state = (torch.zeros((1, 1), dtype=torch.int32, device=device),
             torch.zeros((), dtype=torch.int32, device=device))
    expect = packed_chain_plain(data, n, table, state, k)
    cap = data.numel()
    bound = C.bound_ms(cap + cap + cap // 8 + 2 * table.numel() + 16)
    return [{
        "name": name, "kernel": "K2+pack", "launches_per_pass": launches,
        **C.time_chain(lambda fused=fused: packed_chain(data, n, table, state, k, fused),
                       k, cap, device, expect),
        "bound_ms": bound, "bound_by": "bytes",
        "plain_ms": C.median_ms(lambda: bpe_cuda.flat_packed_plain(data, n, -1, table, *state),
                                device),
        "library_ms": None,
    } for name, fused, launches in (("packed", True, 1), ("k2_pack", False, 4))]


def k4_rows(tokens: torch.Tensor, n: int, planes, k: int = K) -> list:
    """``lookback`` and ``three_launch`` over int32 tokens (n valid) with
    ``planes``, chained k times through their own output."""
    device = tokens.device
    cap = tokens.numel()
    rows = []
    for name, flags, launches in (("lookback", multipass_cuda.K4_FLAGS, 1),
                                  ("three_launch", multipass_cuda.TokenFlags(lookback=False), 3)):
        rows.append({
            "name": name, "kernel": "K4", "launches_per_pass": launches, "tokens": cap,
            "slots": planes.slots,
            **C.time_chain(
                lambda flags=flags: (feed_back(
                    lambda t: multipass_cuda.token_pass(t, n, planes, flags), tokens, k),),
                k, 4 * cap, device,
                (feed_back(lambda t: multipass_cuda.token_pass_plain(t, n, planes), tokens, k),)),
            "bound_ms": C.bound_ms(8 * cap + 4 * 4 * planes.slots), "bound_by": "bytes",
            "plain_ms": C.median_ms(lambda: multipass_cuda.token_pass_plain(tokens, n, planes),
                                    device),
            "library_ms": None,
        })
    return rows


def pack_chain(slots: torch.Tensor, k: int, pack=bpe_cuda.pack_slots):
    """k passes of ``pack`` over uint16 slots, all valid, each taking the
    last slot the pass before returned (the first 0). The last (wire,
    last_slot)."""
    cap = slots.numel()

    def one(prev):
        out = pack(slots, cap, prev)
        return out, out[1]

    return bpe_cuda.chain_passes(one, torch.zeros((), dtype=torch.int32, device=slots.device),
                                 k)[0]


def pack_row(slots: torch.Tensor, k: int = K) -> dict:
    """``pack`` over uint16 slots, all valid, chained k times (``pack_chain``)."""
    device = slots.device
    cap = slots.numel()
    prev = torch.zeros((), dtype=torch.int32, device=device)
    return {
        "name": "pack", "kernel": "K2 pack", "launches_per_pass": 1, "slots": cap,
        **C.time_chain(lambda: pack_chain(slots, k), k, 2 * cap, device,
                       pack_chain(slots, k, bpe_cuda.pack_slots_plain)),
        "bound_ms": C.bound_ms(2 * cap + cap + cap // 8 + 8), "bound_by": "bytes",
        "plain_ms": C.median_ms(lambda: bpe_cuda.pack_slots_plain(slots, cap, prev), device),
        "library_ms": None,
    }


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """Both pairs on ``device``; see the module docstring."""
    corpus = C.make_corpus(np.random.default_rng(seed), size_bytes)
    data = torch.from_numpy(corpus).to(device)
    table = wire_table(C.frequent_pair_table(corpus).dense, device)
    k2 = k2_rows(data, size_bytes, table, k)
    tokens = data[: size_bytes // 8].to(torch.int32)
    k4 = k4_rows(tokens, tokens.numel(), cuckoo_planes(MergeTable.build(HIER), device), k)
    cap = size_bytes // 4
    slots, _ = bpe_cuda.flat_encode_slots(data[:cap], cap, -1, table,
                                          torch.zeros((1, 1), dtype=torch.int32, device=device))
    rows = k2 + k4 + [pack_row(slots, k)]
    return {"tool": "exp_lookback", "device": C.describe(device), "size_bytes": size_bytes,
            "rules": C.RULES, "seed": seed, "exact": all(r["exact"] for r in rows),
            "rows": rows, "ratio": {"k2": _ratio(k2), "k4": _ratio(k4)}}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], K).parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
