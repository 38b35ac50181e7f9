"""The main path's kernels and their encoders (port of the Pallas flat and
basic encoders in ``blt_tpu/ops/bpe_pallas.py``).

Three wrappers launch hand-written CUDA kernels (``blt_tpu_torch/csrc``):

- ``basic_encode``: the widen, K1 (``widen.cu``);
- ``flat_encode_slots``: one flat-BPE pass, K2 (``flat_bpe.cu``);
- ``pack_slots``: K2's packed-wire epilogue (``flat_bpe.cu``).

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

from typing import Tuple

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import _cuda_build
from blt_tpu_torch.ops.tables import wire_table

LANES = 128  # capacity granularity: slots come back as (capacity // 128, 128)
_TILE = 4096  # positions per CUDA block in flat_bpe.cu

# kernel launches made by the wrappers below, by kernel name
launches = {"widen": 0, "flat_bpe": 0, "pack_slots": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
    launches["widen"] += 1
    return out


# --- K2: one flat-BPE pass --------------------------------------------------


def flat_slots_plain(
    data: torch.Tensor,
    n: int,
    next_byte: int,
    table: torch.Tensor,
    carry_in: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One flat-BPE pass as plain tensor ops (the function of the Pallas
    ``_kernel_body`` and of ``flat_bpe.cu``).

    data: uint8[cap] (stale past ``n``); table: the uint16[65536] wire
    table; carry_in: int32, one element. Returns (slots uint16[cap],
    carry_out int32 (1,1)).
    """
    d = data.reshape(-1).to(torch.int32)
    cap = d.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=d.device)
    nxt = torch.zeros_like(d)
    nxt[:-1] = d[1:]
    if n > 0:
        nxt[n - 1] = max(next_byte, 0)
    valid = (idx < n - 1) | ((idx == n - 1) & (next_byte >= 0))
    val = torch.where(valid, table.to(torch.int32)[(d * 256 + nxt).long()], 0)
    m = val != 0
    carry = carry_in.reshape(()).to(torch.int32)
    lnm = torch.cummax(torch.where(m, -(2**31) + 1, idx), 0).values
    lz = torch.maximum(lnm, -1 - carry)
    start = m & (((idx - lz) & 1) == 1)
    consumed = torch.empty_like(start)
    consumed[1:] = start[:-1]
    consumed[0] = carry != 0
    slot = torch.where(start, val, d << 8)
    slot = torch.where(consumed, 0, slot)
    if n > 0:
        carry_out = start[n - 1].to(torch.int32).reshape(1, 1)
    else:
        carry_out = carry.reshape(1, 1).clone()
    return slot.to(torch.uint16), carry_out


def flat_encode_slots(
    data: torch.Tensor,
    n: int,
    next_byte: int,
    table: torch.Tensor,
    carry_in: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One flat-BPE pass: kernel on CUDA tensors, plain on CPU tensors.

    Same arguments and results as ``flat_slots_plain``. ``carry_in`` is
    read on the device, so batches chain without a host sync.
    """
    cap = data.numel()
    if data.dtype != torch.uint8 or table.dtype != torch.uint16:
        raise ValueError("flat pass takes uint8 data and a uint16 table")
    if table.numel() != 65536 or carry_in.numel() != 1:
        raise ValueError("flat pass takes a 65536-entry table and a 1-element carry")
    if not 0 <= n <= cap:
        raise ValueError(f"batch of {n} bytes does not fit capacity {cap}")
    if not -1 <= next_byte <= 255:
        raise ValueError(f"next_byte {next_byte} outside -1..255")
    if not _on_cuda(data, table, carry_in):
        return flat_slots_plain(data, n, next_byte, table, carry_in)
    _check_aligned(data, "flat pass input")
    if cap % 16 or cap == 0 or cap >= 2**31 - _TILE:
        raise ValueError(
            f"flat pass capacity {cap} must be a positive multiple of 16 "
            f"below 2**31 - {_TILE}"
        )
    if carry_in.dtype != torch.int32 or not table.is_contiguous():
        raise ValueError("flat pass takes an int32 carry and a contiguous table")
    dev = data.device
    slots = torch.empty(cap, dtype=torch.uint16, device=dev)
    carry_out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * (-(-cap // _TILE)), dtype=torch.int32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_flat_bpe(
            data.data_ptr(), cap, n, next_byte, table.data_ptr(),
            carry_in.contiguous().data_ptr(), slots.data_ptr(),
            carry_out.data_ptr(), scratch.data_ptr(), _stream(dev),
        )
    _cuda_build.check(err, "flat_bpe")
    launches["flat_bpe"] += 1
    return slots, carry_out


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
    launches["pack_slots"] += 1
    return wire, last


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

    Holds the wire table on ``device`` and runs ``flat_encode_slots`` (and
    ``pack_slots``) over padded batches. ``capacity_bytes`` fixes the batch
    shape; 0 sizes each ``encode`` call to its input.
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
        """Pass + packed-wire epilogue. Returns (wire uint8[capacity +
        capacity//8], carry_out, last_slot); split the wire at
        ``self.capacity``. ``last_slot`` is the raw slot at n-1 (it may be
        a merge start) and threads into the next batch's ``prev_slot``."""
        if not self.capacity:
            raise ValueError("packed encode requires a fixed capacity")
        slots, _, carry_out = self.encode_device(data, n, carry_in, next_byte)
        prev = _as_state(prev_slot, (), self.device)
        wire, last = pack_slots(slots.reshape(-1)[: self.capacity], n, prev)
        return wire, carry_out, last

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
