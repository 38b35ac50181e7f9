"""The device-rate tools' probe and ablation kernels (ports of Pallas kernels
in ``tools/``).

Four wrappers launch hand-written CUDA kernels (``blt_tpu_torch/csrc``):

- ``subgather``: a row gather inside each block of rows, T9
  (``subgather.cu``; ``tools/exp_parts.py::subgather``);
- ``op_mix``: an integer op mix in int32, int16 or int8, chained through a
  token, T5 (``op_mix.cu``; ``tools/exp_pack.py``);
- ``copy_tokens``: T4's copy floor (``token_parts.cu``;
  ``tools/exp_mp_ablate.py``); T4's other variants are flag sets of
  ``multipass_cuda.token_pass``;
- ``block_scan``: T6's scan16 and swarpack, the flat pass with its parity
  scan run block by block (``scan_parts.cu`` on ``flat_pass.cuh``;
  ``tools/exp_scan.py``); T6's other variants are flag sets of
  ``bpe_cuda.flat_encode_slots``.

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
MAX_RPB = 1024  # scan_parts.cu keeps 36 bytes of shared memory per row

# kernel launches made by the wrappers below, by kernel name
launches = {"subgather": 0, **{f"op_mix_{d}": 0 for d in MIX_DTYPES}, "token_parts_copy": 0,
            **{f"scan_parts_{v}": 0 for v in BLOCK_SCANS}}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
    dev = tbl.device
    out = torch.empty_like(tbl)
    done = torch.empty((1, 1), dtype=torch.int32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_subgather(tbl.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                tbl.shape[0], rpb, done.data_ptr(), _stream(dev))
    _cuda_build.check(err, "subgather")
    launches["subgather"] += 1
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
    launches[f"op_mix_{name}"] += k
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
    launches["token_parts_copy"] += 1
    return out


# --- T6: the flat pass with a block-local parity scan -----------------------------


def _check_block_scan(variant: str, cap: int, rpb: int) -> None:
    """Raises on a variant or a shape ``scan_parts.cu`` does not take."""
    if variant not in BLOCK_SCANS:
        raise ValueError(f"unknown variant {variant!r}; one of {BLOCK_SCANS}")
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
    counted under ``launches["scan_parts_<variant>"]``. Arguments and
    results as ``block_scan_plain``; ``carry_in`` is read on the device."""
    on_cuda = check_flat(data, n, next_byte, table, carry_in)
    _check_block_scan(variant, data.numel(), rpb)
    if not on_cuda:
        return block_scan_plain(variant, data, n, next_byte, table, carry_in, rpb)
    cap = data.numel()
    dev = data.device
    slots = torch.empty(cap, dtype=torch.uint16, device=dev)
    carry_out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    blk_last = torch.empty(cap // (rpb * LANES), dtype=torch.int32, device=dev)
    carry_in = carry_in.contiguous()
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_block_scan(
            BLOCK_SCANS.index(variant), data.data_ptr(), cap, n, next_byte,
            table.data_ptr(), carry_in.data_ptr(), slots.data_ptr(), carry_out.data_ptr(),
            blk_last.data_ptr(), rpb, _stream(dev),
        )
    _cuda_build.check(err, f"scan_parts_{variant}")
    launches[f"scan_parts_{variant}"] += 1
    return slots, carry_out
