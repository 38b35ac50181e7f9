"""The device-rate tools' probe and ablation kernels (ports of Pallas kernels
in ``tools/``).

These wrappers launch hand-written CUDA kernels (``blt_tpu_torch/csrc``):

- ``subgather``: a row gather inside each block of rows, T9
  (``subgather.cu``; ``tools/exp_parts.py::subgather``): each (block,
  column slab) job stages its indices and the table rows they reach in
  shared memory (``subgather_plan``), or, for blocks too tall for that, the
  direct gather ``subgather_direct``;
- ``op_mix``: an integer op mix in int32, int16 or int8, chained through a
  token, T5 (``op_mix.cu``; ``tools/exp_pack.py``);
- ``copy_tokens``: T4's copy floor (``token_parts.cu``;
  ``tools/exp_mp_ablate.py``); T4's other variants are flag sets of
  ``multipass_cuda.token_pass``;
- ``block_scan``: T6's scan16 and swarpack, the flat pass with its parity
  scan run block by block, one launch in which each CTA streams the whole
  segments of a job through a ring of bulk-copied tiles
  (``block_scan_plan``; ``scan_parts.cu`` on ``flat_pass.cuh``;
  ``tools/exp_scan.py``); T6's other variants are flag sets of
  ``bpe_cuda.flat_encode_slots``;
- ``row_scan``: T10's noscan2, the flat pass with the scan's row phase alone
  and a carry chained from block to block, one launch in which tiles taken
  from a ticket find their block's carry by a look-back over the blocks'
  carry maps (``row_scan_plan``; ``scan_parts.cu``; ``tools/exp_chd.py``);
  T10's prod and novalid are flag sets of ``bpe_cuda.flat_encode_slots``;
- ``mask_scan``: T12, the block-local parity scan of a u8 mask in int32 or
  in bf16 pairs, one launch in which tiles taken from a ticket carry the
  parity of their last zero by a decoupled look-back (``mask_scan_plan``;
  ``scan_parts.cu``; ``tools/exp_bf16scan.py``);
- ``lookup``: T13, five designs of a pair -> value lookup over a packed
  table, with the tool's chain link fused in (``lookup.cu``;
  ``tools/exp_gather.py::make_pallas``) on one kernel template: each reads
  one word (or byte) an element, from a table staged by bulk copies, or for
  g2d_flat from device memory (``lookup_plan``);
- ``pmxu``: T14, the same lookup as a one-hot matrix product on the tensor
  cores (Hopper ``wgmma``) in int8 or bf16, the link fused in, the planes
  staged from their shared-memory image ``mxu_image`` (``onehot_mma.cu``;
  ``tools/exp_gather.py::make_pmxu``);
- ``probe16``: T3 and T11, eight 16-bit elementwise and shuffle probes, a
  warp a row (``probe16.cu``; ``tools/exp_16bit.py``,
  ``tools/canary_16bit.py``).

Each has a plain PyTorch version of the same function beside it
(``*_plain``). Dispatch is by the tensors alone, as in ``bpe_cuda``: CUDA
tensors launch the kernel, CPU tensors run the plain version, anything else
raises, and nothing falls back. Each kernel launch adds one to
``launches[name]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from blt_tpu_torch.ops import _cuda_build
from blt_tpu_torch.ops.bpe_cuda import (
    LANES,
    _check_aligned,
    _on_cuda,
    _stream,
    check_flat,
    flat_emit_plain,
    flat_pairs_plain,
)
from blt_tpu_torch.ops.multipass_cuda import _wrap32

INT32_MIN = -(2**31)

MIX_DTYPES = {"int32": torch.int32, "int16": torch.int16, "int8": torch.int8}
MIX_REPS = 8  # the tool's OPS_REPS
BLOCK_SCANS = ("scan16", "swarpack")  # in blt_block_scan's order
MAX_RPB = 1024  # swarpack keeps 4 bytes of bits and a parity byte a row of a segment
MASK_SCANS = ("i32", "bf16")  # in blt_mask_scan's order
LOOKUPS = ("chain", "g2d", "g2d_flat", "gax0", "g8bit")  # in blt_lookup's order
# T14's dtype (make_pmxu's name) -> (its row, the planes' type, the offset),
# in blt_pmxu's order
MXU_DTYPES = {"int8": ("pmxu_i8", torch.int8, 128), "bf16": ("pmxu_bf16", torch.bfloat16, 0)}
MXU_LOOKUPS = tuple(row for row, _, _ in MXU_DTYPES.values())
MXU_PIECE = 1 << 20  # positions per one-hot product of the plain version
# T3's six probes and T11's two, in blt_probe16's order; each its counter
PROBES16 = tuple(f"probe16_{b}" for b in ("bf16_roll", "bf16_max", "bf16_select",
                                          "bf16_rowroll", "i16_roll", "bf16_scan7")) + (
    "canary_i16_roll", "canary_strided_sublane")

# kernel launches made by the wrappers below, by kernel name
launches = {"subgather": 0, "subgather_direct": 0, **{f"op_mix_{d}": 0 for d in MIX_DTYPES},
            "token_parts_copy": 0, **{f"scan_parts_{v}": 0 for v in BLOCK_SCANS}, "chd_noscan2": 0,
            **{f"bf16scan_{v}": 0 for v in MASK_SCANS},
            **{f"gather_{v}": 0 for v in LOOKUPS + MXU_LOOKUPS},
            **dict.fromkeys(PROBES16, 0)}


def reset_launches() -> None:
    _cuda_build.reset_counts(launches)


def _blocks(rows: int, rpb: int, what: str) -> int:
    """The Pallas grid's steps ``rows // rpb``; raises where that grid would
    leave rows unwritten."""
    if rpb < 1 or rows == 0 or rows % rpb:
        raise ValueError(
            f"{what}: {rows} rows are not a positive multiple of rows_per_block "
            f"{rpb}: the Pallas grid would not write the rest"
        )
    return rows // rpb


# --- T9: row gather within each block ------------------------------------------


# T9's slab path (subgather.cu's kBoxRows, kSmemBytes): a job stages its
# indices and table rows in boxes of SUBGATHER_BOX_ROWS rows, both in at
# most SUBGATHER_SMEM_BYTES of shared memory, SUBGATHER_MAX_WIDTH columns
# wide where that fits
SUBGATHER_MAX_WIDTH = 8
SUBGATHER_BOX_ROWS = 32
SUBGATHER_SMEM_BYTES = 226 * 1024


def subgather_plan(rows: int, rpb: int) -> dict:
    """The launch ``subgather`` makes for ``rows`` rows in blocks of
    ``rpb``: the slab's columns (``width``: ``SUBGATHER_MAX_WIDTH``, halved
    until the job's index tile and table slab fit, down to 4; 0 where not
    even 4 fit, the direct path), their shared memory (``smem_bytes``), the
    jobs (``jobs``: one CTA per block and slab) and the launch counter
    (``kernel``)."""
    blocks = _blocks(rows, rpb, "subgather")
    staged_rows = -(-rpb // SUBGATHER_BOX_ROWS) * SUBGATHER_BOX_ROWS
    width = SUBGATHER_MAX_WIDTH
    while width >= 4 and 2 * staged_rows * width * 4 > SUBGATHER_SMEM_BYTES:
        width //= 2
    if width < 4:
        return {"width": 0, "smem_bytes": 0, "jobs": 0, "kernel": "subgather_direct"}
    return {"width": width, "smem_bytes": 2 * staged_rows * width * 4,
            "jobs": blocks * (LANES // width), "kernel": "subgather"}


def _check_subgather(tbl: torch.Tensor, idx: torch.Tensor, rpb: int) -> int:
    if tbl.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"subgather takes int32 tables and indices, got {tbl.dtype}, "
                         f"{idx.dtype}")
    if tbl.dim() != 2 or tbl.shape[1] != LANES or idx.shape != tbl.shape:
        raise ValueError(f"subgather takes two (rows, {LANES}) arrays of one shape, got "
                         f"{tuple(tbl.shape)} and {tuple(idx.shape)}")
    return _blocks(tbl.shape[0], rpb, "subgather")


def subgather_plain(
    tbl: torch.Tensor, idx: torch.Tensor, rpb: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor]:
    """T9 as plain tensor ops. In each block of ``rpb`` rows, ``out[i, j] =
    block[x, j]`` for ``x = idx[i, j]`` in ``[0, rpb)``, ``block[x + rpb,
    j]`` for ``x`` in ``[-rpb, 0)`` and ``INT32_MIN`` otherwise (the Pallas
    kernel as interpret mode computes it). Returns (out int32 (rows, 128),
    done int32 (1,1) = rows // rpb - 1)."""
    nb = _check_subgather(tbl, idx, rpb)
    x = idx.reshape(nb, rpb, LANES).to(torch.int64)
    inside = (x >= -rpb) & (x < rpb)
    row = torch.where(x < 0, x + rpb, x).clamp(0, rpb - 1)
    out = torch.gather(tbl.reshape(nb, rpb, LANES), 1, row)
    out = torch.where(inside, out, INT32_MIN).reshape(tbl.shape)
    return out, torch.full((1, 1), nb - 1, dtype=torch.int32, device=tbl.device)


def subgather(
    tbl: torch.Tensor, idx: torch.Tensor, rpb: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor]:
    """T9: kernel on CUDA tensors, plain on CPU tensors. Arguments and
    results as ``subgather_plain``; no element reads outside its block."""
    _check_subgather(tbl, idx, rpb)
    if not _on_cuda(tbl, idx):
        return subgather_plain(tbl, idx, rpb)
    _check_aligned(tbl, "subgather table")
    _check_aligned(idx, "subgather indices")
    plan = subgather_plan(tbl.shape[0], rpb)
    dev = tbl.device
    out = torch.empty_like(tbl)
    done = torch.empty((1, 1), dtype=torch.int32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_subgather(tbl.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                tbl.shape[0], rpb, plan["width"], done.data_ptr(), _stream(dev))
    _cuda_build.check(err, plan["kernel"])
    _cuda_build.count(launches, plan["kernel"])
    return out, done


# --- T5: the op mix ------------------------------------------------------------


def _mix_steps(x: torch.Tensor, tok: torch.Tensor, k: int, rpb: int) -> str:
    """Validate an op-mix chain; returns the dtype's name."""
    names = {v: k for k, v in MIX_DTYPES.items()}
    if x.dtype not in names:
        raise ValueError(f"op mix takes int32, int16 or int8, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"op mix takes (rows, {LANES}), got {tuple(x.shape)}")
    if k < 1 or tok.numel() != 1:
        raise ValueError(f"an op-mix chain needs k >= 1 and one token, got k={k}")
    _blocks(x.shape[0], rpb, "op mix")
    return names[x.dtype]


def _wrap(v: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 -> the value with the same low ``bits`` bits, signed."""
    half = 1 << (bits - 1)
    return ((v + half) & ((1 << bits) - 1)) - half


def op_mix_plain(
    x: torch.Tensor, tok: torch.Tensor, k: int = 1, rpb: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor]:
    """T5 as plain tensor ops: ``MIX_REPS`` repetitions of the tool's op mix
    per element, every op wrapping in x's type (computed in int64 and
    wrapped after each op). Returns (out, x's type and shape; the last
    token int32 (1,1) = tok + k * (rows // rpb - 1))."""
    _mix_steps(x, tok, k, rpb)
    bits = 8 * x.element_size()
    lane = torch.arange(LANES, device=x.device)
    acc = x.to(torch.int64)
    for _ in range(MIX_REPS):
        y = _wrap(acc * 31, bits) >> 3
        y = y & 0x3F
        r = acc.roll(1, 1)  # pltpu.roll(acc, 1, axis=1): lane l takes lane l-1
        y = torch.where(y == (acc & 0x3F), r, y)
        z = torch.maximum(y, acc)
        acc = _wrap(torch.where(lane >= 2, z, y) + 1, bits)
    steps = x.shape[0] // rpb
    return acc.to(x.dtype), tok.reshape(1, 1).to(torch.int32) + k * (steps - 1)


def op_mix(
    x: torch.Tensor, tok: torch.Tensor, k: int = 1, rpb: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k launches of ``op_mix.cu`` back to back, chained through a device
    token, counted under ``launches["op_mix_<dtype>"]``: kernel on CUDA
    tensors, plain on CPU tensors. Arguments and results as
    ``op_mix_plain``; each launch reads the same x."""
    name = _mix_steps(x, tok, k, rpb)
    if not _on_cuda(x, tok):
        return op_mix_plain(x, tok, k, rpb)
    _check_aligned(x, "op mix input")
    dev = x.device
    out = torch.empty_like(x)
    toks = torch.empty((2, 1), dtype=torch.int32, device=dev)
    tok = tok.reshape(1, 1).to(dtype=torch.int32).contiguous()
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_op_mix(x.element_size(), x.data_ptr(), out.data_ptr(), x.shape[0],
                             tok.data_ptr(), toks[0].data_ptr(), toks[1].data_ptr(),
                             x.shape[0] // rpb - 1, k, _stream(dev))
    _cuda_build.check(err, f"op_mix_{name}")
    _cuda_build.count(launches, f"op_mix_{name}", k)
    return out, toks[(k - 1) & 1].reshape(1, 1)


# --- T4: the token pass's copy floor ---------------------------------------------


def copy_tokens_plain(tokens: torch.Tensor) -> torch.Tensor:
    """T4's copy as plain tensor ops: the tokens, flat. int32[cap]."""
    return tokens.reshape(-1).clone()


def copy_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """T4's copy: kernel on CUDA tensors, plain on CPU tensors; counted
    under ``launches["token_parts_copy"]``. tokens: int32, a multiple of
    16 on the card."""
    if tokens.dtype != torch.int32:
        raise ValueError(f"copy takes int32 tokens, got {tokens.dtype}")
    if not _on_cuda(tokens):
        return copy_tokens_plain(tokens)
    _check_aligned(tokens, "copy input")
    cap = tokens.numel()
    if cap % 16 or cap == 0 or cap >= 2**31:
        raise ValueError(f"copy takes a positive multiple of 16 tokens below 2**31, got {cap}")
    dev = tokens.device
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_copy_tokens(tokens.data_ptr(), cap, out.data_ptr(), _stream(dev))
    _cuda_build.check(err, "token_parts_copy")
    _cuda_build.count(launches, "token_parts_copy")
    return out


# --- T6: the flat pass with a block-local parity scan -----------------------------


def _check_block_scan(variant: str, cap: int, rpb: int, variants=BLOCK_SCANS) -> None:
    """Raises on a variant or a shape ``scan_parts.cu`` does not take."""
    if variant not in variants:
        raise ValueError(f"unknown variant {variant!r}; one of {variants}")
    if rpb % 8 or not 8 <= rpb <= MAX_RPB:
        raise ValueError(f"rows_per_block {rpb} must be a multiple of 8 in 8..{MAX_RPB}")
    if cap == 0 or cap % (rpb * LANES):
        raise ValueError(f"{variant} takes whole blocks of {rpb} rows of {LANES}, "
                         f"got {cap} bytes")


def block_scan_plain(
    variant: str,
    data: torch.Tensor,
    n: int,
    next_byte: int,
    table: torch.Tensor,
    carry_in: torch.Tensor,
    rpb: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """scan16 or swarpack as plain tensor ops: K2's pass with the parity of
    each position's last non-match found inside its block of ``rpb`` rows
    (see ``csrc/scan_parts.cu``). Arguments and results as
    ``bpe_cuda.flat_pass_plain``, plus ``variant`` and ``rpb``."""
    _check_block_scan(variant, data.numel(), rpb)
    d, val, m = flat_pairs_plain(data, n, next_byte, table)
    nb = d.shape[0] // (rpb * LANES)
    m = m.reshape(nb, rpb, LANES)
    lane = torch.arange(LANES, dtype=torch.int64, device=d.device)
    local = torch.arange(rpb * LANES, dtype=torch.int64, device=d.device).reshape(rpb, LANES)
    # the last non-match of the earlier rows of the block; -1 if none
    row_last = torch.where(m, -1, local).amax(2)
    excl = torch.full_like(row_last, -1)
    excl[:, 1:] = torch.cummax(row_last, 1).values[:, :-1]
    # none: the Pallas sentinel -(2**31) + 1, which is odd
    row_par = torch.where(excl >= 0, excl & 1, 1).unsqueeze(2)
    if variant == "scan16":
        last = torch.cummax(torch.where(m, -1, local).reshape(nb, -1), 1).values
        par = torch.where(last >= 0, last & 1, 1).reshape(nb, rpb, LANES)
    else:
        code = torch.where(m, 0, (lane + 1) * 2 + (lane & 1))
        s = (code[:, 0::2] & 0x7FFF) | (code[:, 1::2] << 16)
        guard = -2147450880  # 0x80008000 as int32
        sh = 1
        while sh < LANES:
            cand = torch.where(lane >= sh, s.roll(sh, 2), 0)
            g = _wrap32((s | guard) - cand) & guard
            k = _wrap32(g - (g >> 15)) | g
            s = (s & k) | (cand & ~k)
            sh *= 2
        field = torch.cat([s & 0xFFFF, (s >> 16) & 0xFFFF], 1)
        par = torch.where(field > 0, field & 1, row_par)
    start = m & (((lane & 1) ^ par) == 1)
    carry = carry_in.reshape(()).to(torch.int32)
    return flat_emit_plain(d, n, val, start.reshape(-1), carry)


# segment_scan's tile (scan_parts.cu's kSegTile: kSegThreads x 16
# positions): a job holds as many whole segments as fit in one, at least one
BLOCK_SCAN_TILE = 4096


def block_scan_plan(cap: int, rpb: int) -> dict:
    """The launch ``block_scan`` makes for ``cap`` positions in segments of
    ``rpb`` rows (``scan_parts.cu``'s ``jobs_of``): the segment's positions
    (``segment``), a job's (``job``: ``max(1, BLOCK_SCAN_TILE // segment)``
    segments), the tiles of a full job (``tiles``), the jobs (``jobs``, one
    CTA each, taken from a ticket; the last may hold fewer segments) and the
    int32 scratch (``scratch``: a flag a job, then the ticket)."""
    seg = rpb * LANES
    job = max(1, BLOCK_SCAN_TILE // seg) * seg
    jobs = -(-cap // job)
    return {"segment": seg, "job": job, "tiles": -(-job // BLOCK_SCAN_TILE), "jobs": jobs,
            "scratch": jobs + 1}


def block_scan(
    variant: str,
    data: torch.Tensor,
    n: int,
    next_byte: int,
    table: torch.Tensor,
    carry_in: torch.Tensor,
    rpb: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """scan16 or swarpack: kernel on CUDA tensors, plain on CPU tensors;
    counted under ``launches["scan_parts_<variant>"]`` (one launch after one
    memset of its flags and ticket, ``block_scan_plan``). Arguments and
    results as ``block_scan_plain``; ``carry_in`` is read on the device."""
    on_cuda = check_flat(data, n, next_byte, table, carry_in)
    _check_block_scan(variant, data.numel(), rpb)
    if not on_cuda:
        return block_scan_plain(variant, data, n, next_byte, table, carry_in, rpb)
    cap = data.numel()
    dev = data.device
    slots = torch.empty(cap, dtype=torch.uint16, device=dev)
    carry_out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    scratch = torch.empty(block_scan_plan(cap, rpb)["scratch"], dtype=torch.int32, device=dev)
    carry_in = carry_in.contiguous()
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_block_scan(
            BLOCK_SCANS.index(variant), data.data_ptr(), cap, n, next_byte,
            table.data_ptr(), carry_in.data_ptr(), slots.data_ptr(), carry_out.data_ptr(),
            scratch.data_ptr(), rpb, _stream(dev),
        )
    _cuda_build.check(err, f"scan_parts_{variant}")
    _cuda_build.count(launches, f"scan_parts_{variant}")
    return slots, carry_out


# --- T10: the flat pass with the scan's row phase alone -----------------------------


def row_scan_plain(
    data: torch.Tensor,
    n: int,
    next_byte: int,
    table: torch.Tensor,
    carry_in: torch.Tensor,
    rpb: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """noscan2 as plain tensor ops (see ``csrc/scan_parts.cu``): K2's pass
    with lz the last non-match within the position's 128-byte row, or the
    sentinel of its block of ``rpb`` rows, whose carry is the previous
    block's start at its last position below n. Arguments and results as
    ``bpe_cuda.flat_pass_plain``, plus ``rpb``."""
    _check_block_scan("noscan2", data.numel(), rpb, ("noscan2",))
    d, val, m = flat_pairs_plain(data, n, next_byte, table)
    block = rpb * LANES
    nb = d.shape[0] // block
    idx = torch.arange(d.shape[0], dtype=torch.int64, device=d.device)
    lnm = torch.cummax(torch.where(m, INT32_MIN, idx).reshape(-1, LANES), 1).values.reshape(-1)
    block_start = idx - idx % block

    def starts(carry_of_block):  # carry_of_block: int64[nb]
        sentinel = block_start - 1 - carry_of_block.repeat_interleave(block)
        return m & (((idx - torch.maximum(lnm, sentinel)) & 1) == 1)

    # each block's carry out for carry in 0 and 1, then the chain on the host
    ones = torch.ones(nb, dtype=torch.int64, device=d.device)
    last_pos = torch.clamp(torch.arange(1, nb + 1, device=d.device) * block - 1, max=n - 1)
    passes = last_pos >= torch.arange(nb, device=d.device) * block
    at = last_pos.clamp(min=0)
    outs = [torch.where(passes, starts(c * ones)[at].to(torch.int64), c * ones).tolist()
            for c in (0, 1)]
    carries = [int(carry_in.reshape(()))]
    for j in range(nb):
        carries.append(outs[carries[j]][j])
    carry = torch.tensor(carries, dtype=torch.int64, device=d.device)
    start = starts(carry[:nb])
    consumed = torch.empty_like(start)
    consumed[1:] = start[:-1]
    consumed[::block] = carry[:nb] != 0
    slot = torch.where(consumed, 0, torch.where(start, val, d << 8))
    return slot.to(torch.uint16), carry[nb:].to(torch.int32).reshape(1, 1)


# row_scan's tile (scan_parts.cu's kRowScanTile: kRowScanUnroll sub-tiles
# of 256 threads x 16 positions), one CTA each
ROW_SCAN_UNROLL = 2
ROW_SCAN_TILE = ROW_SCAN_UNROLL * 256 * 16


def row_scan_plan(positions: int, rpb: int) -> dict:
    """The launch ``row_scan`` makes for a buffer of ``positions`` bytes in
    blocks of ``rpb`` rows: the tiles (``tiles``, one CTA each, taken from a
    ticket in order; the last may be partial), the blocks (``blocks``) and
    the scratch in int32 words (``scratch``: a flag a block, then the
    ticket)."""
    tiles = -(-positions // ROW_SCAN_TILE)
    blocks = positions // (rpb * LANES)
    return {"tiles": tiles, "blocks": blocks, "scratch": blocks + 1}


def row_scan(
    data: torch.Tensor,
    n: int,
    next_byte: int,
    table: torch.Tensor,
    carry_in: torch.Tensor,
    rpb: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """noscan2: kernel on CUDA tensors, plain on CPU tensors; counted under
    ``launches["chd_noscan2"]`` (one launch after one memset of its flags
    and ticket, ``row_scan_plan``). Arguments and results as
    ``row_scan_plain``; ``carry_in`` is read on the device."""
    on_cuda = check_flat(data, n, next_byte, table, carry_in)
    _check_block_scan("noscan2", data.numel(), rpb, ("noscan2",))
    if not on_cuda:
        return row_scan_plain(data, n, next_byte, table, carry_in, rpb)
    cap = data.numel()
    dev = data.device
    slots = torch.empty(cap, dtype=torch.uint16, device=dev)
    carry_out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    scratch = torch.empty(row_scan_plan(cap, rpb)["scratch"], dtype=torch.int32, device=dev)
    carry_in = carry_in.contiguous()
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_row_scan(
            data.data_ptr(), cap, n, next_byte, table.data_ptr(), carry_in.data_ptr(),
            slots.data_ptr(), carry_out.data_ptr(), scratch.data_ptr(), rpb, _stream(dev),
        )
    _cuda_build.check(err, "chd_noscan2")
    _cuda_build.count(launches, "chd_noscan2")
    return slots, carry_out


# --- T12: the block-local parity scan of a mask --------------------------------------


def _check_mask(variant: str, mask: torch.Tensor, rpb: int) -> None:
    if mask.dtype != torch.uint8 or mask.dim() != 2 or mask.shape[1] != LANES:
        raise ValueError(f"mask scan takes uint8 (rows, {LANES}), got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    _check_block_scan(variant, mask.numel(), rpb, MASK_SCANS)


def mask_scan_plain(mask: torch.Tensor, rpb: int = 1024) -> torch.Tensor:
    """T12 as plain tensor ops: in each block of ``rpb`` rows, ``start = m
    & ((i - lz) & 1)`` with m = mask != 0 and lz the last zero at or before
    i within the block, -1 if none. uint8 (rows, 128) -> uint8 starts."""
    _check_mask("i32", mask, rpb)
    m = (mask != 0).reshape(-1, rpb * LANES)
    local = torch.arange(rpb * LANES, dtype=torch.int32, device=mask.device)
    lz = torch.cummax(torch.where(m, -1, local), 1).values
    return (m & (((local - lz) & 1) == 1)).to(torch.uint8).reshape(mask.shape)


# mask_scan's tile (scan_parts.cu's kMaskTile: kMaskUnroll sub-tiles of 256
# threads x 16 positions), one CTA each
MASK_SCAN_TILE = 4 * 256 * 16


def mask_scan_plan(positions: int) -> dict:
    """The launch ``mask_scan`` makes for ``positions`` mask bytes: the tiles
    (``tiles``, one CTA each, taken from a ticket in order; the last may be
    partial) and the scratch in 64-bit words (``scratch``: a status word a
    tile, then the ticket)."""
    tiles = -(-positions // MASK_SCAN_TILE)
    return {"tiles": tiles, "scratch": tiles + 1}


def mask_scan(variant: str, mask: torch.Tensor, rpb: int = 1024) -> torch.Tensor:
    """T12's ``i32`` or ``bf16`` kernel: kernel on CUDA tensors, plain on
    CPU tensors (both variants compute ``mask_scan_plain``'s function);
    counted under ``launches["bf16scan_<variant>"]`` (one launch after one
    memset of its status words and ticket, ``mask_scan_plan``)."""
    _check_mask(variant, mask, rpb)
    if not _on_cuda(mask):
        return mask_scan_plain(mask, rpb)
    _check_aligned(mask, "mask", 16)
    out = torch.empty_like(mask)
    scratch = torch.empty(mask_scan_plan(mask.numel())["scratch"], dtype=torch.int64,
                          device=mask.device)
    lib = _cuda_build.load()
    with torch.cuda.device(mask.device):
        err = lib.blt_mask_scan(MASK_SCANS.index(variant), mask.data_ptr(), out.data_ptr(),
                                mask.shape[0], rpb, scratch.data_ptr(), _stream(mask.device))
    _cuda_build.check(err, f"bf16scan_{variant}")
    _cuda_build.count(launches, f"bf16scan_{variant}")
    return out


# --- T13: pair -> value lookups -------------------------------------------------------


def _check_lookup(variant: str, tbl: torch.Tensor, p: torch.Tensor, c) -> None:
    if variant not in LOOKUPS:
        raise ValueError(f"unknown variant {variant!r}; one of {LOOKUPS}")
    want = (torch.uint8, (32, LANES)) if variant == "g8bit" else (torch.int32, (256, LANES))
    if (tbl.dtype, tuple(tbl.shape)) != want:
        raise ValueError(f"{variant} takes a {want[0]} {want[1]} table, got {tbl.dtype} "
                         f"{tuple(tbl.shape)}")
    if p.dtype != torch.int32 or p.dim() != 2 or p.shape[1] != LANES or p.shape[0] == 0:
        raise ValueError(f"lookup takes int32 (rows, {LANES}), got {p.dtype} {tuple(p.shape)}")
    if c is not None and (c.dtype != torch.int32 or c.shape != p.shape):
        raise ValueError("a link's previous output must be int32 of p's shape")


def lookup_plain(variant: str, tbl: torch.Tensor, p: torch.Tensor, c=None) -> torch.Tensor:
    """T13 as plain tensor ops: the lookup of ``q = p & 0xFFFF``, or in a
    chain link (``c`` the previous output) of ``q = (p + (c & 1)) &
    0xFFFF`` (see ``csrc/lookup.cu``). int32 (rows, 128) -> int32."""
    _check_lookup(variant, tbl, p, c)
    q = (p if c is None else p + (c & 1)) & 0xFFFF
    flat = tbl.reshape(-1).to(torch.int32)
    if variant == "gax0":
        lane = torch.arange(LANES, dtype=torch.int32, device=p.device)
        return flat[((q >> 8) * LANES + lane).long()]
    if variant == "g8bit":
        return flat[(q & 4095).long()]
    w = flat[(q >> 1).long()]
    return torch.where((q & 1) == 1, (w >> 16) & 0xFFFF, w & 0xFFFF)


# lookup_kernel's shape (lookup.cu's kLookupThreads, kUnroll, kStaged and
# kPerCta): CTAs of 1024 threads, each taking at least LOOKUP_PER_CTA
# elements and staging LOOKUP_STAGED bytes of its table, at most as many as
# the SMs hold at once; a thread takes LOOKUP_UNROLL groups of 4 elements a
# step
LOOKUP_THREADS = 1024
LOOKUP_UNROLL = 4
LOOKUP_PER_CTA = {"chain": 4 * 1024, "g2d": 4 * 1024, "g2d_flat": 8 * 1024,
                  "gax0": 4 * 1024, "g8bit": 4 * 1024}
LOOKUP_STAGED = {"chain": 4 * 256 * LANES, "g2d": 4 * 256 * LANES, "g2d_flat": 0,
                 "gax0": 4 * 256 * LANES, "g8bit": 32 * LANES}


def lookup_plan(variant: str, n: int, sms: int = 132, ctas_per_sm: int = 1) -> dict:
    """The launch ``lookup(variant, ...)`` makes for ``n`` elements on a card
    of ``sms`` SMs that holds ``ctas_per_sm`` of its CTAs an SM (the
    occupancy query, ``_cuda_build.ctas_per_sm("lookup_<variant>")``; one
    for the 128 KiB tables): its CTAs (``ctas``), the grid's threads
    (``stride``: thread g takes the groups of 4 elements g + (s *
    LOOKUP_UNROLL + u) * stride, for each step s and u < LOOKUP_UNROLL, below
    ``groups``), the most steps a thread takes (``steps``) and the table
    bytes the CTAs stage (``staged_bytes``)."""
    if variant not in LOOKUPS:
        raise ValueError(f"unknown variant {variant!r}; one of {LOOKUPS}")
    groups = n // 4
    ctas = min(ctas_per_sm * sms, max(1, -(-n // LOOKUP_PER_CTA[variant])))
    stride = ctas * LOOKUP_THREADS
    return {"ctas": ctas, "stride": stride, "groups": groups,
            "steps": -(-groups // (stride * LOOKUP_UNROLL)),
            "staged_bytes": ctas * LOOKUP_STAGED[variant]}


def lookup(variant: str, tbl: torch.Tensor, p: torch.Tensor, c=None) -> torch.Tensor:
    """One T13 lookup (or chain link, with ``c``): kernel on CUDA tensors,
    plain on CPU tensors; counted under ``launches["gather_<variant>"]``.
    Arguments and results as ``lookup_plain``; no element reads outside
    its table, whatever p holds."""
    _check_lookup(variant, tbl, p, c)
    if not _on_cuda(tbl, p, *([] if c is None else [c])):
        return lookup_plain(variant, tbl, p, c)
    for t, what in ((tbl, "lookup table"), (p, "lookup input"),
                    *([] if c is None else [(c, "lookup link input")])):
        _check_aligned(t, what)
    if p.numel() >= 2**31:
        raise ValueError(f"lookup takes fewer than 2**31 elements, got {p.numel()}")
    out = torch.empty_like(p)
    lib = _cuda_build.load()
    with torch.cuda.device(p.device):
        err = lib.blt_lookup(LOOKUPS.index(variant), tbl.data_ptr(), p.data_ptr(),
                             0 if c is None else c.data_ptr(), out.data_ptr(), p.numel(),
                             _stream(p.device))
    _cuda_build.check(err, f"gather_{variant}")
    _cuda_build.count(launches, f"gather_{variant}")
    return out


# --- T14: the lookup as a one-hot product on the tensor cores ---------------------------


def mxu_planes(val16, dtype: str) -> torch.Tensor:
    """T14's planes (256, 512) from the 65536 u16 values ``val16`` (array
    or tensor; a copy of make_pmxu's recipe): the low bytes of the values of
    pairs (a, *) in row a's first 256 columns, their high bytes in the last
    256; as int8 less 128 for ``"int8"``, as bf16 for ``"bf16"``. On
    ``val16``'s device when it is a tensor."""
    if dtype not in MXU_DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; one of {tuple(MXU_DTYPES)}")
    v = torch.as_tensor(val16).to(torch.int32).reshape(256, 256)
    planes = torch.cat([v & 0xFF, v >> 8], 1)
    if dtype == "int8":
        return (planes - 128).to(torch.int8)
    return planes.to(torch.bfloat16)


def mxu_image(planes: torch.Tensor) -> torch.Tensor:
    """``onehot_mma.cu``'s shared-memory image of T14's planes (256, 512),
    int8 or bf16: uint8 of 128 KB or 256 KB on the planes' device. Per
    plane (columns 0..255, lo, then 256..511, hi), wgmma's K-major operand
    in the canonical 128-byte swizzle: K slices of 128 bytes (32 KB each),
    in each the 256 columns in groups of 8, 1024 bytes apart, column n's
    128 bytes (its K values, little-endian) in one 128-byte row, the 16-byte
    chunk i at chunk ``i ^ (n & 7)``."""
    esize = planes.element_size()
    o = torch.arange(256 * 512 * esize, device=planes.device)
    plane, o = o // (256 * 256 * esize), o % (256 * 256 * esize)
    kslice, o = o // (256 * 128), o % (256 * 128)
    n = plane * 256 + o // 128
    r = n & 7
    kbyte = kslice * 128 + (((o % 128) // 16) ^ r) * 16 + o % 16
    src = (kbyte // esize) * (512 * esize) + n * esize + kbyte % esize
    return planes.contiguous().view(torch.uint8).reshape(-1)[src]


_images: dict = {}  # id(planes) -> (planes, its version, its image)


def _image_of(planes: torch.Tensor) -> torch.Tensor:
    """``mxu_image(planes)``, laid out once per planes tensor and kept while
    the tensor is not written (its version counter); the last 8 are kept.
    Not kept while the stream is capturing a CUDA graph, where the image is
    written only at replay."""
    hit = _images.get(id(planes))
    if hit is not None and hit[0] is planes and hit[1] == planes._version:
        return hit[2]
    image = mxu_image(planes)
    if not (planes.is_cuda and torch.cuda.is_current_stream_capturing()):
        _images.pop(id(planes), None)
        _images[id(planes)] = (planes, planes._version, image)
        while len(_images) > 8:
            _images.pop(next(iter(_images)))
    return image


def _check_pmxu(dtype: str, planes: torch.Tensor, p: torch.Tensor, c, tile: int):
    """Raises on what ``onehot_mma.cu`` does not take; T14's (row, planes'
    type, offset)."""
    if dtype not in MXU_DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; one of {tuple(MXU_DTYPES)}")
    spec = MXU_DTYPES[dtype]
    if planes.dtype != spec[1] or tuple(planes.shape) != (256, 512):
        raise ValueError(f"{dtype} takes {spec[1]} planes (256, 512), got {planes.dtype} "
                         f"{tuple(planes.shape)}")
    if p.dtype != torch.int32 or p.dim() != 2 or p.shape[1] != LANES or p.shape[0] == 0:
        raise ValueError(f"one-hot lookup takes int32 (rows, {LANES}), got {p.dtype} "
                         f"{tuple(p.shape)}")
    if c is not None and (c.dtype != torch.int32 or c.shape != p.shape):
        raise ValueError("a link's previous output must be int32 of p's shape")
    m = p.numel()
    if tile < 16 or tile % 16 or m % tile:
        raise ValueError(f"tile {tile} must be a positive multiple of 16 that divides the {m} "
                         "positions: the Pallas grid m // tile would drop the rest")
    if m >= 2**31:
        raise ValueError(f"one-hot lookup takes fewer than 2**31 positions, got {m}")
    return spec


def pmxu_plain(dtype: str, planes: torch.Tensor, p: torch.Tensor, c=None,
               tile: int = 512) -> torch.Tensor:
    """T14 as plain tensor ops: for ``q = p`` (or in a chain link, c the
    previous output, ``q = (p + (c & 1)) & 0xFFFF``), ``a = q >> 8``, ``b =
    q & 255``, ``r = onehot(a) @ planes`` in the planes' type (``torch._int_mm``
    to int32 for int8, ``torch.matmul`` for bf16), ``out = (r[256 + b] + off)
    * 256 + (r[b] + off)``: ``val16[q]`` inside ``[0, 65536)``, 32896 (int8)
    or 0 (bf16) for a outside ``[0, 256)``. In pieces of ``MXU_PIECE``
    positions (the whole product at 16 Mi positions would need 40 GiB).
    p: int32 (rows, 128); the result int32 of p's shape. ``tile`` is checked
    only."""
    _, _, off = _check_pmxu(dtype, planes, p, c, tile)
    q = (p if c is None else (p + (c & 1)) & 0xFFFF).reshape(-1)
    iota = torch.arange(256, dtype=torch.int32, device=p.device)
    out = torch.empty_like(q)
    for s in range(0, q.numel(), MXU_PIECE):
        piece = q[s:s + MXU_PIECE]
        oh = ((piece >> 8)[:, None] == iota).to(planes.dtype)
        # a piece has 128 or more rows, as cuBLASLt's int8 product needs
        r = torch._int_mm(oh, planes) if dtype == "int8" else torch.matmul(oh, planes)
        b = (piece & 255).long()[:, None]
        vlo = r.gather(1, b).to(torch.int32) + off
        vhi = r.gather(1, b + 256).to(torch.int32) + off
        out[s:s + piece.numel()] = (vhi * 256 + vlo)[:, 0]
    return out.reshape(p.shape)


def pmxu(dtype: str, planes: torch.Tensor, p: torch.Tensor, c=None,
         tile: int = 512) -> torch.Tensor:
    """One T14 lookup (or chain link, with ``c``): ``onehot_mma.cu`` on CUDA
    tensors, ``tile`` positions per block step; plain on CPU tensors;
    counted under ``launches["gather_pmxu_i8"]`` or ``["gather_pmxu_bf16"]``.
    Arguments and results as ``pmxu_plain``.

    On the card the whole product runs on the tensor cores as Hopper's
    ``wgmma`` (m64n256k32 s8 -> s32, m64n256k16 bf16 -> f32), the one-hot
    rows built in registers, the planes read from shared memory, where they
    arrive by ``cp.async.bulk`` from their image (``mxu_image``, laid out at
    the first call with a planes tensor and kept while it is unchanged)."""
    row, _, _ = _check_pmxu(dtype, planes, p, c, tile)
    if not _on_cuda(planes, p, *([] if c is None else [c])):
        return pmxu_plain(dtype, planes, p, c, tile)
    for t, what in ((p, "one-hot lookup input"),
                    *([] if c is None else [(c, "one-hot lookup link input")])):
        _check_aligned(t, what, 4)
    image = _image_of(planes)
    _check_aligned(image, "planes' image")
    out = torch.empty_like(p)
    lib = _cuda_build.load()
    with torch.cuda.device(p.device):
        err = lib.blt_pmxu(tuple(MXU_DTYPES).index(dtype), image.data_ptr(), p.data_ptr(),
                           0 if c is None else c.data_ptr(), out.data_ptr(), p.numel(), tile,
                           _stream(p.device))
    _cuda_build.check(err, f"gather_{row}")
    _cuda_build.count(launches, f"gather_{row}")
    return out


# --- T3 and T11: 16-bit probes ------------------------------------------------------------


def _check_probe16(probe: str, x: torch.Tensor) -> None:
    if probe not in PROBES16:
        raise ValueError(f"unknown probe {probe!r}; one of {PROBES16}")
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != LANES or x.shape[0] == 0:
        raise ValueError(f"16-bit probes take int32 (rows, {LANES}), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError(f"16-bit probes take fewer than 2**31 elements, got {x.numel()}")


def probe16_plain(probe: str, x: torch.Tensor) -> torch.Tensor:
    """A T3 or T11 probe as plain tensor ops in ``torch.bfloat16`` /
    ``torch.int16`` (see ``csrc/probe16.cu``): int32 (rows, 128) -> int32
    (rows, 128), ``canary_strided_sublane`` -> rows 0, 2, 4, .... bf16(x)
    is torch's cast, which equals the JAX tools' for |x| < 2**30 (past that
    XLA saturates the way back to int32 and torch does not)."""
    _check_probe16(probe, x)
    body = probe.split("_", 1)[1]
    if body == "strided_sublane":
        return x[0::2].clone()
    if body == "i16_roll":
        return x.to(torch.int16).roll(1, 1).to(torch.int32)
    lane = torch.arange(LANES, device=x.device)
    neg1 = torch.tensor(-1.0, dtype=torch.bfloat16, device=x.device)
    b = x.to(torch.bfloat16)
    if body == "bf16_roll":
        r = b.roll(1, 1)
    elif body == "bf16_max":
        r = torch.maximum(b, b * 0.5)
    elif body == "bf16_select":
        r = torch.where(lane >= 5, b, neg1)
    elif body == "bf16_rowroll":
        r = b.roll(1, 0)
    else:  # bf16_scan7: seven roll-and-max steps
        r = torch.where((x & 3) == 0, neg1, lane.to(torch.bfloat16))
        sh = 1
        while sh < LANES:
            r = torch.maximum(r, torch.where(lane >= sh, r.roll(sh, 1), neg1))
            sh *= 2
    return r.to(torch.int32)


def probe16(probe: str, x: torch.Tensor) -> torch.Tensor:
    """One T3 or T11 probe: ``probe16.cu`` on a CUDA tensor, plain on a CPU
    tensor; counted under ``launches[probe]``. Arguments and results as
    ``probe16_plain``."""
    _check_probe16(probe, x)
    if not _on_cuda(x):
        return probe16_plain(probe, x)
    _check_aligned(x, "probe input", 16)
    rows = x.shape[0]
    out_rows = (rows + 1) // 2 if probe == "canary_strided_sublane" else rows
    out = torch.empty((out_rows, LANES), dtype=torch.int32, device=x.device)
    lib = _cuda_build.load()
    with torch.cuda.device(x.device):
        err = lib.blt_probe16(PROBES16.index(probe), x.data_ptr(), out.data_ptr(), rows,
                              _stream(x.device))
    _cuda_build.check(err, probe)
    _cuda_build.count(launches, probe)
    return out
