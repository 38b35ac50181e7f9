"""The main path's kernels and their encoders (port of the Pallas flat and
basic encoders in ``blt_tpu/ops/bpe_pallas.py``).

Five wrappers launch hand-written CUDA kernels (``blt_tpu_torch/csrc``):

- ``basic_encode``: the widen, K1 (``widen.cu``);
- ``flat_encode_slots``: one flat-BPE pass, K2 (``flat_bpe.cu``), or with
  other ``FlatFlags`` one of the device-rate tools' variants of it: T8's
  cost split, four of T6's ablations, T2's design probes and T10's
  ``novalid`` (``FLAT_PASSES``);
- ``pack_slots``: K2's packed-wire epilogue (``flat_bpe.cu``);
- ``flat_encode_packed``: K2 and its packed-wire epilogue fused into one
  launch with a decoupled look-back (``flat_bpe.cu``), the main path's
  flat pass;
- ``chain_encode``: a copy or widen launched k times through a token
  (``chain.cu``): K5 (``basic_encode_chained``, what ``bench.py`` times)
  and the device-rate tools' T1 and T7.

``flat_encode_chained`` runs K2 k times through its device carry.

Each has a plain PyTorch version of the same function beside it
(``*_plain``). Dispatch is by the tensor alone: a CUDA tensor launches the
kernel, a CPU tensor runs the plain version, anything else raises. Nothing
else chooses between them and nothing falls back: a kernel that does not
build or launch raises. Each kernel launch adds one to ``launches[name]``.

``CudaBasicEncoder`` and ``CudaFlatEncoder`` keep the Pallas encoders'
interfaces and return values (shapes and types), with an explicit
``torch.device``. The Pallas input buffer's 8 halo rows are a BlockSpec
artefact and are dropped: ``padded_bytes == capacity``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import _cuda_build
from blt_tpu_torch.ops.tables import wire_table

LANES = 128  # capacity granularity: slots come back as (capacity // 128, 128)
_TILE = 4096  # positions per CUDA block in csrc/flat_pass.cuh

# chain.cu's users, by launch counter: (widen, one CUDA block per grid step)
CHAINS = {
    "basic_chained": (True, False),  # K5
    "chain_copy": (False, False),  # T1 copy_chain
    "chain_widen": (True, False),  # T1 widen_chain
    "copy_sweep": (False, True),  # T7 copy_pallas
}


class FlatFlags(NamedTuple):
    """The switches of one flat pass (``csrc/flat_pass.cuh``; see
    ``flat_pass_plain``), in ``blt_flat_pass``'s bit order. The defaults
    are K2. ``lookback`` and ``smem_table`` change how the pass runs (one
    launch with a decoupled look-back; the table staged in shared memory),
    not what it computes."""

    lookup: bool = True
    scan: bool = True
    swap: bool = False
    odd: bool = False
    row_wrap: bool = False
    lookback: bool = False
    smem_table: bool = False
    valid: bool = True

    @property
    def bits(self) -> int:
        return sum(int(on) << i for i, on in enumerate(self))


# The flat passes the port launches, by the name each counts its launches
# under: K2; T8's cost split, whose starts emit their value byteswapped (the
# tool's ``byteswap(tok)``); T6's ablations that are flat passes (T6's
# ``full`` is K2 itself); T2's design probes (its ``base`` is T8's ``full``;
# ``opt_swap`` runs over a table byteswapped once more, so it emits what the
# others do); and T10's ``novalid`` (its ``prod`` is K2). ``flat_bpe.cu``
# instantiates these flag sets and no other.
FLAT_PASSES = {
    "flat_bpe": FlatFlags(),
    "parts_emit": FlatFlags(lookup=False, scan=False, swap=True),
    "parts_noscan": FlatFlags(scan=False, swap=True),
    "parts_nolookup": FlatFlags(lookup=False, swap=True),
    "parts_full": FlatFlags(swap=True),
    "scan_parts_noscan": FlatFlags(scan=False, odd=True),
    "scan_parts_nolookup": FlatFlags(lookup=False),
    "scan_parts_noshifts": FlatFlags(row_wrap=True),
    "opt_p2": FlatFlags(swap=True, lookback=True),
    "opt_hoist": FlatFlags(swap=True, lookback=True, smem_table=True),
    "opt_swap": FlatFlags(lookback=True, smem_table=True),
    "chd_novalid": FlatFlags(valid=False),
}
_FLAT_NAMES = {flags: name for name, flags in FLAT_PASSES.items()}
# T8's variants, in the tool's order
FLAT_VARIANTS = {v: FLAT_PASSES[f"parts_{v}"] for v in ("emit", "noscan", "nolookup", "full")}

# kernel launches made by the wrappers below, by kernel name
launches = {"widen": 0, "pack_slots": 0, "flat_bpe_packed": 0, **dict.fromkeys(CHAINS, 0),
            **dict.fromkeys(FLAT_PASSES, 0)}


def reset_launches() -> None:
    _cuda_build.reset_counts(launches)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when every one
    is on the CPU; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("tensors are on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"expected all-CUDA or all-CPU tensors, got {sorted(kinds)}")


def _check_aligned(t: torch.Tensor, what: str, align: int = 16) -> None:
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{what} must be contiguous and {align}-byte aligned")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _as_state(value, shape, device) -> torch.Tensor:
    """A bool/int host value or an int32 tensor -> int32 tensor of shape."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int32).reshape(shape)
    return torch.full(shape, int(value), dtype=torch.int32, device=device)


# --- K1: widen --------------------------------------------------------------


def widen_plain(data: torch.Tensor) -> torch.Tensor:
    """uint8 -> uint16 ``b << 8`` (LE image = u16-BE wire), any shape."""
    return (data.to(torch.int32) << 8).to(torch.uint16)


def basic_encode(data: torch.Tensor) -> torch.Tensor:
    """Widen a uint8 tensor of any shape: kernel on CUDA, plain on CPU."""
    if data.dtype != torch.uint8:
        raise ValueError(f"widen takes uint8, got {data.dtype}")
    if not _on_cuda(data):
        return widen_plain(data)
    _check_aligned(data, "widen input")
    out = torch.empty(data.shape, dtype=torch.uint16, device=data.device)
    lib = _cuda_build.load()
    with torch.cuda.device(data.device):
        err = lib.blt_widen(
            data.data_ptr(), out.data_ptr(), data.numel(), _stream(data.device)
        )
    _cuda_build.check(err, "widen")
    _cuda_build.count(launches, "widen")
    return out


# --- K5, T1, T7: copy and widen chained through a token -----------------------


def chain_passes(pass_fn, carry, k: int):
    """k passes of ``pass_fn(carry) -> (out, carry)``, each taking the
    carry the pass before returned; the last (out, carry)."""
    if k < 1:
        raise ValueError(f"a chain needs k >= 1, got {k}")
    for _ in range(k):
        out, carry = pass_fn(carry)
    return out, carry


# chain.cu's copy ring (kStages, kStageBytes, kBlocksPerSm there)
RING_STAGES = 4
RING_STAGE_BYTES = 16 * 1024
RING_BLOCKS_PER_SM = 8


def _ceil_div(a, b):
    return -(-a // b)


def copy_plan(n: int, blocks: int, sms: int) -> dict:
    """chain.cu's copy launch over n bytes (a multiple of 16), computed as
    ``copy_chain`` and ``copy_ring_kernel`` compute it, for the CPU tests:
    the grid, each block's span, the ring's stages and shared memory, and
    every bulk copy as arrays ``block``, ``offset``, ``length`` (a load and
    then a store of the same bytes), in each block's order. ``blocks``: the
    block count (T7: ``rows // rpb``), or 0 for ``RING_BLOCKS_PER_SM`` per
    SM of ``sms``."""
    want = blocks if blocks > 0 else sms * RING_BLOCKS_PER_SM
    span = _ceil_div(_ceil_div(n, want), 16) * 16
    grid = _ceil_div(n, span)
    stages = min(RING_STAGES, _ceil_div(span, RING_STAGE_BYTES))
    begin = np.arange(grid, dtype=np.int64) * span
    length = np.minimum(span, n - begin)
    chunks = _ceil_div(length, RING_STAGE_BYTES)
    block = np.repeat(np.arange(grid, dtype=np.int64), chunks)
    chunk = np.arange(int(chunks.sum()), dtype=np.int64) - np.repeat(np.cumsum(chunks) - chunks,
                                                                      chunks)
    offset = begin[block] + chunk * RING_STAGE_BYTES
    return {"grid": grid, "span": span, "stages": stages,
            "smem_bytes": stages * (RING_STAGE_BYTES + 8), "block": block, "offset": offset,
            "length": np.minimum(RING_STAGE_BYTES, begin[block] + length[block] - offset)}


def _chain_steps(name: str, data2: torch.Tensor, tok, k: int, rows_per_block: int) -> int:
    """Validate a chain's arguments; the Pallas grid's steps ``rows //
    rows_per_block``. Raises where that grid would leave rows unwritten."""
    if name not in CHAINS:
        raise ValueError(f"unknown chain {name!r}; one of {tuple(CHAINS)}")
    if k < 1:
        raise ValueError(f"a chain needs k >= 1, got {k}")
    if tok is None and k != 1:
        raise ValueError("a chain with no token input is one launch")
    if data2.dim() != 2 or data2.shape[1] != LANES or data2.dtype != torch.uint8:
        raise ValueError(f"expected uint8 (rows, {LANES}), got {data2.dtype} "
                         f"{tuple(data2.shape)}")
    rows = data2.shape[0]
    if rows_per_block < 1 or rows == 0 or rows % rows_per_block:
        raise ValueError(
            f"{rows} rows are not a positive multiple of rows_per_block "
            f"{rows_per_block}: the Pallas grid would not write the rest"
        )
    return rows // rows_per_block


def chain_plain(
    name: str, data2: torch.Tensor, tok, k: int, rows_per_block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``chain_encode`` as plain tensor ops: (the copy or widen of data2,
    the token the last of the k Pallas grids writes: each grid's last step
    writes ``program_id + token``, 0 for ``tok`` None)."""
    steps = _chain_steps(name, data2, tok, k, rows_per_block)
    out = widen_plain(data2) if CHAINS[name][0] else data2.clone()
    if tok is None:
        return out, torch.full((1, 1), steps - 1, dtype=torch.int32, device=data2.device)
    return out, tok.reshape(1, 1).to(torch.int32) + k * (steps - 1)


def chain_encode(
    name: str, data2: torch.Tensor, tok, k: int, rows_per_block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k launches of ``chain.cu`` back to back, chained through a device
    token, counted under ``launches[name]``: kernel on CUDA tensors, plain
    on CPU tensors. ``name`` is a key of ``CHAINS``: it picks copy (u8 out)
    or widen (u16 out), and whether the launch has a CUDA block per Pallas
    grid step (the T7 sweep) or a grid sized to the card.

    data2: uint8 (rows, 128), rows a multiple of ``rows_per_block``; tok:
    int32 (1,1), or None for one launch with no token input. Returns (last
    out (rows, 128), last token int32 (1,1) = tok + k * (rows // rpb - 1)).
    """
    steps = _chain_steps(name, data2, tok, k, rows_per_block)
    if not _on_cuda(data2, *([] if tok is None else [tok])):
        return chain_plain(name, data2, tok, k, rows_per_block)
    _check_aligned(data2, "chain input")
    widen, per_step = CHAINS[name]
    dev = data2.device
    out = torch.empty(data2.shape, dtype=torch.uint16 if widen else torch.uint8,
                      device=dev)
    _check_aligned(out, "chain output")
    toks = torch.empty((2, 1), dtype=torch.int32, device=dev)
    tok_in = 0
    if tok is not None:
        tok = tok.reshape(1, 1).to(dtype=torch.int32).contiguous()
        tok_in = tok.data_ptr()
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_chain(
            int(widen), data2.data_ptr(), out.data_ptr(), data2.numel(), tok_in,
            toks[0].data_ptr(), toks[1].data_ptr(), steps - 1, k,
            steps if per_step else 0, _stream(dev),
        )
    _cuda_build.check(err, name)
    _cuda_build.count(launches, name, k)
    return out, toks[(k - 1) & 1].reshape(1, 1)


def basic_chained_plain(
    data2: torch.Tensor, tok: torch.Tensor, k: int = 8, rows_per_block: int = 512
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 as plain tensor ops."""
    return chain_plain("basic_chained", data2, tok, k, rows_per_block)


def basic_encode_chained(
    data2: torch.Tensor, tok: torch.Tensor, k: int = 8, rows_per_block: int = 512
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k widens back to back, chained through a device token (port of
    ``bpe_pallas.basic_encode_chained``, K5); ``chain_encode``'s arguments
    and results. Returns (last_out uint16 (rows, 128), last_tok int32
    (1,1) = tok + k * (rows // rpb - 1))."""
    return chain_encode("basic_chained", data2, tok, k, rows_per_block)


# --- K2: one flat-BPE pass --------------------------------------------------


def _flat_name(flags: FlatFlags) -> str:
    """The launch counter of a flat pass; raises for a flag set that is not
    one of ``FLAT_PASSES``."""
    if flags not in _FLAT_NAMES:
        raise ValueError(f"{flags} is not a flat pass of FLAT_PASSES")
    return _FLAT_NAMES[flags]


def flat_pass_plain(
    data: torch.Tensor,
    n: int,
    next_byte: int,
    table: torch.Tensor,
    carry_in: torch.Tensor,
    flags: FlatFlags = FlatFlags(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One flat-BPE pass as plain tensor ops, with the parts of
    ``csrc/flat_pass.cuh`` that ``flags`` switches: K2 with the defaults
    (the function of the Pallas ``_kernel_body``).

    data: uint8[cap] (stale past ``n``); table: the uint16[65536] wire
    table; carry_in: int32, one element. Returns (slots uint16[cap],
    carry_out int32 (1,1)).

    No ``lookup``: m = (next byte & 7) == 0, val = the pair ``d*256 +
    next``. No ``scan``: every match starts, or with ``odd`` every match at
    an odd position. ``swap``: a start emits its value byteswapped.
    ``row_wrap``: the next byte and consumed wrap inside each 128-byte row,
    with no next_byte patch and no carry into consumed (cap a multiple of
    128). No ``valid``: every position below cap may match (its next byte
    ``max(next_byte, 0)`` at n-1, 0 at cap-1). ``lookback`` and
    ``smem_table`` compute the same function as without them.
    """
    _flat_name(flags)
    d, val, m = flat_pairs_plain(data, n, next_byte, table, flags.lookup, flags.row_wrap,
                                 flags.valid)
    idx = torch.arange(d.shape[0], dtype=torch.int32, device=d.device)
    carry = carry_in.reshape(()).to(torch.int32)
    if flags.scan:
        lnm = torch.cummax(torch.where(m, -(2**31) + 1, idx), 0).values
        lz = torch.maximum(lnm, -1 - carry)
        start = m & (((idx - lz) & 1) == 1)
    else:
        start = m & ((idx & 1) == 1) if flags.odd else m
    return flat_emit_plain(d, n, val, start, carry, flags.swap, flags.row_wrap)


def flat_pairs_plain(data, n: int, next_byte: int, table, lookup: bool = True,
                     row_wrap: bool = False, valid: bool = True):
    """A flat pass's pairs: (the bytes as int32, each pair's value, its
    match bit), with ``flat_pass_plain``'s ``lookup``, ``row_wrap`` and
    ``valid``."""
    d = data.reshape(-1).to(torch.int32)
    idx = torch.arange(d.shape[0], dtype=torch.int32, device=d.device)
    if row_wrap:
        nxt = d.reshape(-1, LANES).roll(-1, 1).reshape(-1)
    else:
        nxt = torch.zeros_like(d)
        nxt[:-1] = d[1:]
        if n > 0:
            nxt[n - 1] = max(next_byte, 0)
    if valid:
        ok = (idx < n - 1) | ((idx == n - 1) & (next_byte >= 0))
    else:
        ok = torch.ones_like(idx, dtype=torch.bool)
    if lookup:
        val = torch.where(ok, table.to(torch.int32)[(d * 256 + nxt).long()], 0)
        return d, val, val != 0
    return d, d * 256 + nxt, ok & ((nxt & 7) == 0)


def flat_emit_plain(d, n, val, start, carry, swap=False, row_wrap=False):
    """A flat pass's slots and carry_out from its starts: consumed =
    start[i-1] (carry at 0, or under ``row_wrap`` the start at lane
    (l-1) mod 128 of the row), slot = 0 / val / ``d << 8``, carry_out =
    start[n-1] (carry when n == 0)."""
    if row_wrap:
        consumed = start.reshape(-1, LANES).roll(1, 1).reshape(-1)
    else:
        consumed = torch.empty_like(start)
        consumed[1:] = start[:-1]
        consumed[0] = carry != 0
    if swap:
        val = ((val & 0xFF) << 8) | ((val >> 8) & 0xFF)
    slot = torch.where(start, val, d << 8)
    slot = torch.where(consumed, 0, slot)
    if n > 0:
        carry_out = start[n - 1].to(torch.int32).reshape(1, 1)
    else:
        carry_out = carry.reshape(1, 1).clone()
    return slot.to(torch.uint16), carry_out


def check_flat(data, n: int, next_byte: int, table, carry_in, row_wrap: bool = False) -> bool:
    """Validate a flat pass's arguments; True when they are CUDA tensors
    (then also checked for a launch: data and table 16-byte aligned),
    False when they are CPU tensors."""
    cap = data.numel()
    if row_wrap and cap % LANES:
        raise ValueError(f"a pass with row_wrap takes whole rows of {LANES}, got {cap} bytes")
    if data.dtype != torch.uint8 or table.dtype != torch.uint16:
        raise ValueError("flat pass takes uint8 data and a uint16 table")
    if table.numel() != 65536 or carry_in.numel() != 1:
        raise ValueError("flat pass takes a 65536-entry table and a 1-element carry")
    if not 0 <= n <= cap:
        raise ValueError(f"batch of {n} bytes does not fit capacity {cap}")
    if not -1 <= next_byte <= 255:
        raise ValueError(f"next_byte {next_byte} outside -1..255")
    if not _on_cuda(data, table, carry_in):
        return False
    _check_aligned(data, "flat pass input")
    _check_aligned(table, "flat pass table")
    if cap % 16 or cap == 0 or cap >= 2**31 - _TILE:
        raise ValueError(
            f"flat pass capacity {cap} must be a positive multiple of 16 "
            f"below 2**31 - {_TILE}"
        )
    if carry_in.dtype != torch.int32:
        raise ValueError("flat pass takes an int32 carry")
    return True


def flat_encode_slots(
    data: torch.Tensor,
    n: int,
    next_byte: int,
    table: torch.Tensor,
    carry_in: torch.Tensor,
    flags: FlatFlags = FlatFlags(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One flat-BPE pass: kernel on CUDA tensors, plain on CPU tensors.

    Same arguments and results as ``flat_pass_plain``. ``carry_in`` is
    read on the device, so batches chain without a host sync. The default
    ``flags`` launch K2; every flag set of ``FLAT_PASSES`` runs through the
    one entry ``blt_flat_pass`` (``flat_bpe.cu``) and counts under its name
    there.
    """
    name = _flat_name(flags)
    if not check_flat(data, n, next_byte, table, carry_in, flags.row_wrap):
        return flat_pass_plain(data, n, next_byte, table, carry_in, flags)
    cap = data.numel()
    dev = data.device
    slots = torch.empty(cap, dtype=torch.uint16, device=dev)
    carry_out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    # the tiles' scan words (the look-back's status words and ticket)
    scratch = torch.empty(2 * (-(-cap // _TILE)) + 2, dtype=torch.int32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_flat_pass(
            flags.bits, data.data_ptr(), cap, n, next_byte, table.data_ptr(),
            carry_in.contiguous().data_ptr(), slots.data_ptr(), carry_out.data_ptr(),
            scratch.data_ptr(), _stream(dev),
        )
    _cuda_build.check(err, name)
    _cuda_build.count(launches, name)
    return slots, carry_out


def flat_encode_chained(
    data: torch.Tensor,
    n: int,
    next_byte: int,
    table: torch.Tensor,
    carry_in: torch.Tensor,
    k: int = 8,
    flags: FlatFlags = FlatFlags(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 (or another flat pass of ``FLAT_PASSES``) k times back to back
    over one batch, each pass taking the carry the pass before wrote (port
    of ``bpe_pallas.flat_encode_chained``). The carry stays on the device,
    so the k passes run with no host sync. Returns the last pass's (slots,
    carry_out)."""
    return chain_passes(
        lambda c: flat_encode_slots(data, n, next_byte, table, c, flags), carry_in, k
    )


# --- K2 epilogue: packed wire -----------------------------------------------


def pack_slots_plain(
    slots: torch.Tensor, n: int, prev_slot: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slots -> one byte per position + LSB-first flag plane (the Pallas
    package's ``_pack_slots_core`` plus its last-slot rule), in int32.

    Returns (wire uint8[cap + cap // 8], last_slot int32 ()).
    """
    s = slots.reshape(-1).to(torch.int32)
    prev = torch.cat([prev_slot.reshape(1).to(torch.int32), s[:-1]])
    is_start = (s & 0xFF) != 0
    is_consumed = (prev & 0xFF) != 0
    byte = torch.where(
        is_start, s & 0xFF, torch.where(is_consumed, (prev >> 8) & 0xFF, s >> 8)
    )
    flag = (is_start | is_consumed).to(torch.int32).reshape(-1, 8)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=s.device)
    fbytes = (flag * weights).sum(1)
    wire = torch.cat([byte.to(torch.uint8), fbytes.to(torch.uint8)])
    last = s[n - 1] if n > 0 else prev_slot.reshape(()).to(torch.int32)
    return wire, last.clone()


def pack_slots(
    slots: torch.Tensor, n: int, prev_slot: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack epilogue: kernel on CUDA tensors, plain on CPU tensors."""
    cap = slots.numel()
    if slots.dtype != torch.uint16 or cap % 8 or prev_slot.numel() != 1:
        raise ValueError("pack takes uint16 slots (a multiple of 8) and one prev slot")
    if not 0 <= n <= cap:
        raise ValueError(f"{n} valid slots do not fit capacity {cap}")
    if not _on_cuda(slots, prev_slot):
        return pack_slots_plain(slots, n, prev_slot)
    _check_aligned(slots, "pack input")
    if cap >= 2**31 or prev_slot.dtype != torch.int32:
        raise ValueError("pack takes fewer than 2**31 slots and an int32 prev slot")
    dev = slots.device
    wire = torch.empty(cap + cap // 8, dtype=torch.uint8, device=dev)
    last = torch.empty((), dtype=torch.int32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_pack_slots(
            slots.data_ptr(), cap, n, prev_slot.contiguous().data_ptr(),
            wire.data_ptr(), last.data_ptr(), _stream(dev),
        )
    _cuda_build.check(err, "pack_slots")
    _cuda_build.count(launches, "pack_slots")
    return wire, last


# --- K2 and its epilogue in one launch ----------------------------------------


def flat_packed_plain(
    data: torch.Tensor,
    n: int,
    next_byte: int,
    table: torch.Tensor,
    carry_in: torch.Tensor,
    prev_slot: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flat_encode_packed`` as plain tensor ops: K2's slots, packed.
    Returns (wire uint8[cap + cap // 8], carry_out int32 (1,1), last_slot
    int32 ())."""
    slots, carry_out = flat_pass_plain(data, n, next_byte, table, carry_in)
    wire, last = pack_slots_plain(slots, n, prev_slot)
    return wire, carry_out, last


def flat_encode_packed(
    data: torch.Tensor,
    n: int,
    next_byte: int,
    table: torch.Tensor,
    carry_in: torch.Tensor,
    prev_slot: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 and its packed-wire epilogue as one launch (``blt_flat_packed``):
    kernel on CUDA tensors, plain on CPU tensors. The arguments of
    ``flat_encode_slots`` (K2's flags) plus ``prev_slot`` (int32, one
    element: the raw slot before position 0); the results of
    ``flat_packed_plain``. The carry and the slot before stay on the device,
    so batches chain without a host sync; no slot reaches device memory."""
    if prev_slot.numel() != 1:
        raise ValueError("the packed pass takes one prev slot")
    on_cuda = check_flat(data, n, next_byte, table, carry_in)
    _on_cuda(data, prev_slot)  # raises unless prev_slot lies where data does
    if not on_cuda:
        return flat_packed_plain(data, n, next_byte, table, carry_in, prev_slot)
    if prev_slot.dtype != torch.int32:
        raise ValueError("the packed pass takes an int32 prev slot")
    cap = data.numel()
    dev = data.device
    wire = torch.empty(cap + cap // 8, dtype=torch.uint8, device=dev)
    carry_out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    last = torch.empty((), dtype=torch.int32, device=dev)
    # the tiles' status words and the ticket
    scratch = torch.empty(2 * (-(-cap // _TILE)) + 2, dtype=torch.int32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_flat_packed(
            data.data_ptr(), cap, n, next_byte, table.data_ptr(),
            carry_in.contiguous().data_ptr(), prev_slot.contiguous().data_ptr(),
            wire.data_ptr(), carry_out.data_ptr(), last.data_ptr(), scratch.data_ptr(),
            _stream(dev),
        )
    _cuda_build.check(err, "flat_bpe_packed")
    _cuda_build.count(launches, "flat_bpe_packed")
    return wire, carry_out, last


# --- encoders -----------------------------------------------------------------


def _round_capacity(nbytes: int) -> int:
    return -(-nbytes // LANES) * LANES


def _pad(data: np.ndarray, capacity: int) -> np.ndarray:
    buf = np.zeros(capacity, np.uint8)
    buf[: data.shape[0]] = data
    return buf


class _Uploader:
    """Pack into a reusable host buffer and upload (``feeder.upload``),
    on a side copy stream when the device is a CUDA device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

    def upload(self, data: np.ndarray, buf, threads: int = 0):
        """Returns (device uint8 (rows, 128), n). Tail bytes past ``n`` stay
        stale: every kernel masks by length."""
        from blt_tpu_torch.pipeline.feeder import pack_into, upload

        n = data.shape[0]
        if n > self.capacity or buf.shape[0] != self.padded_bytes:
            raise ValueError(
                f"batch of {n} bytes / buffer of {buf.shape[0]} does not match "
                f"capacity {self.capacity}"
            )
        host = buf.numpy() if isinstance(buf, torch.Tensor) else buf
        pack_into(host, data, threads)
        dev = upload(buf, self.device, self._copy_stream)
        return dev.reshape(self.capacity // LANES, LANES), n


class CudaBasicEncoder(_Uploader):
    """Fixed-capacity basic-mode encoder (port of ``PallasBasicEncoder``)."""

    def __init__(self, capacity_bytes: int, device):
        super().__init__(device)
        self.capacity = _round_capacity(capacity_bytes)

    @property
    def padded_bytes(self) -> int:
        return self.capacity

    def encode_device(self, data2: torch.Tensor, n: int):
        return basic_encode(data2), n

    def encode(self, data: np.ndarray):
        if data.shape[0] > self.capacity:
            raise ValueError(f"batch of {data.shape[0]} exceeds capacity {self.capacity}")
        dev = torch.from_numpy(_pad(data, self.capacity)).to(self.device)
        return self.encode_device(dev.reshape(-1, LANES), data.shape[0])


class CudaFlatEncoder(_Uploader):
    """Flat-table BPE encoder (port of ``PallasFlatEncoder``).

    Holds the wire table on ``device`` and runs ``flat_encode_slots``, or
    ``flat_encode_packed`` for the packed wire, over padded batches.
    ``capacity_bytes`` fixes the batch shape; 0 sizes each ``encode`` call
    to its input.
    """

    def __init__(self, table: MergeTable, device, capacity_bytes: int = 0):
        super().__init__(device)
        self._merge_table = table
        if not self.supports(table):
            raise ValueError(
                "flat kernel requires a flat table with all merge values >= 256 "
                "(drop-after-merge drain rule)"
            )
        self.table = wire_table(table.dense, self.device)
        self.capacity = _round_capacity(capacity_bytes)

    def with_capacity(self, capacity_bytes: int) -> "CudaFlatEncoder":
        """A sibling encoder for another batch capacity, same table."""
        return CudaFlatEncoder(self._merge_table, self.device, capacity_bytes)

    @staticmethod
    def supports(table: MergeTable) -> bool:
        if not table.flat:
            return False
        values = list(table.merges.values())
        return not values or min(values) >= 256

    @property
    def padded_bytes(self) -> int:
        """Host-buffer size for upload() (no halo rows on the card)."""
        if not self.capacity:
            raise ValueError("padded_bytes requires a fixed capacity")
        return self.capacity

    def encode_device(self, data: torch.Tensor, n: int, carry_in, next_byte: int):
        """One pass over an uploaded batch. Returns (slots uint16
        (capacity//128, 128), n, carry_out int32 (1,1))."""
        carry = _as_state(carry_in, (1, 1), self.device)
        slots, carry_out = flat_encode_slots(
            data.reshape(-1), n, next_byte, self.table, carry
        )
        return slots.reshape(-1, LANES), n, carry_out

    def encode_packed_device(
        self, data: torch.Tensor, n: int, carry_in, next_byte: int, prev_slot
    ):
        """Pass + packed-wire epilogue in one launch
        (``flat_encode_packed``). Returns (wire uint8[capacity +
        capacity//8], carry_out, last_slot); split the wire at
        ``self.capacity``. ``last_slot`` is the raw slot at n-1 (it may be
        a merge start) and threads into the next batch's ``prev_slot``."""
        if not self.capacity:
            raise ValueError("packed encode requires a fixed capacity")
        carry = _as_state(carry_in, (1, 1), self.device)
        prev = _as_state(prev_slot, (), self.device)
        return flat_encode_packed(data.reshape(-1), n, next_byte, self.table, carry, prev)

    def encode(self, data: np.ndarray, carry_in, next_byte: int):
        """Pad one batch and run the pass (the Pallas encoder's ``encode``)."""
        n = data.shape[0]
        capacity = self.capacity or _round_capacity(n)
        if n > capacity:
            raise ValueError(f"batch {n} exceeds encoder capacity {capacity}")
        dev = torch.from_numpy(_pad(data, capacity)).to(self.device)
        return self.encode_device(dev, n, carry_in, next_byte)


def filter_slots(slots: np.ndarray, prev_token: int) -> Tuple[np.ndarray, int]:
    """Drop-after-merge drain on the host (copy of
    ``blt_tpu.ops.bpe_pallas.filter_slots``, which lives in a JAX module).

    slots: byteswapped uint16[n]; a slot is dropped when the previous slot
    holds a merged token (swapped low byte != 0). Returns (be_tokens_u16,
    last_slot).
    """
    if slots.shape[0] == 0:
        return slots, prev_token
    prev = np.empty_like(slots)
    prev[0] = prev_token
    prev[1:] = slots[:-1]
    keep = (prev & 0xFF) == 0
    return slots[keep], int(slots[-1])


def unpack_slots_host(
    packed: np.ndarray, flags: np.ndarray, n: int, start: int = 0
) -> np.ndarray:
    """Expand the packed wire to u16-BE bytes (copy of
    ``blt_tpu.ops.bpe_pallas.unpack_slots_host``; NumPy stand-in for
    ``native.unpack_slots``): flag-0 positions expand to (0x00, byte),
    flag-1 positions to their single byte."""
    if n == 0:
        return np.empty(0, np.uint8)
    end = start + n
    bits = np.unpackbits(
        np.ascontiguousarray(flags[: (end + 7) // 8]), bitorder="little"
    )[start:end].astype(np.int64)
    total = int(2 * n - bits.sum())
    off = 2 * np.arange(n, dtype=np.int64)
    off[1:] -= np.cumsum(bits[:-1])
    out = np.zeros(total, np.uint8)
    out[off + (1 - bits)] = packed[start:end]
    return out
