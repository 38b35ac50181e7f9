"""General-table (multipass) kernels and their encoder (port of the Pallas
token passes and ``PallasTokenEncoder`` in ``blt_tpu/ops/bpe_pallas.py``).

Two wrappers launch hand-written CUDA kernels (``blt_tpu_torch/csrc``):

- ``token_pass_gap``: one merge round over a tombstoned stream, K3
  (``token_pass_gap.cu``), the round of the default resident loop;
- ``token_pass``: one merge round over compacted tokens, K4
  (``token_pass.cu``): under the default ``TokenFlags`` (``K4_FLAGS``)
  one launch with a decoupled look-back, the round of ``encode`` and of
  the ``BLT_MP_COMPACT=sort`` loop; under ``TokenFlags(lookback=False)``
  the same function as reduce / tile scan / emit; with other
  ``TokenFlags``, the rounds of the device-rate tool T4's ablation
  (``TOKEN_PASSES``).

Each has a plain PyTorch version of the same function beside it
(``*_plain``). Dispatch is by the tensors alone: CUDA tensors launch the
kernel, CPU tensors run the plain version, anything else raises. Nothing
else chooses between them and nothing falls back. Each kernel launch adds
one to ``launches[name]``; each resident loop appends its (rounds,
compactions) to ``loop_log``.

``CudaTokenEncoder`` keeps ``PallasTokenEncoder``'s methods and return
shapes, with an explicit ``torch.device``. The loop's XLA glue becomes
torch ops: ``lax.while_loop`` a Python loop that reads the round's alive
count on the host (4 bytes, one sync per round); the stable compaction
(``sort_key_val``) the cumsum-and-scatter of ``bpe_torch._compact``; the
wire's byteswap and flag plane plain tensor ops. The Pallas buffers' 8
halo rows (sort loop) and prefetched halos (gap loop) are BlockSpec
artefacts and are dropped: a buffer is ``capacity`` tokens.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import _cuda_build
from blt_tpu_torch.ops.bpe_cuda import (
    _check_aligned,
    _on_cuda,
    _round_capacity,
    _stream,
    _Uploader,
)
from blt_tpu_torch.ops.bpe_torch import _compact
from blt_tpu_torch.ops.tables import CuckooPlanes, cuckoo_planes

GAP_LOOKAHEAD = 4  # next-alive window: a pair survives tombstone runs <= 3
GAP_COMPACT_EVERY = 3  # rounds between compactions (gap growth 0 -> 1 -> 3)
_TILE = 4096  # positions per CUDA block in token_pass*.cu
_NEG = -(2**31) + 1


class TokenFlags(NamedTuple):
    """The switches of one merge round (``csrc/token_pass.cuh``; see
    ``token_pass_plain``), in ``blt_token_pass``'s bit order. The defaults
    are K4 as the main path runs it; ``lookback`` changes how the round
    runs (one launch with a decoupled look-back, or three), not what it
    computes. Only K4's function has the look-back launch, so the other
    rounds of ``TOKEN_PASSES`` clear it."""

    lookup: bool = True
    scan: bool = True
    shift: bool = True
    lookback: bool = True

    @property
    def bits(self) -> int:
        return sum(int(on) << i for i, on in enumerate(self))


# The merge rounds the port launches, by the name each counts its launches
# under: K4 as the main path runs it (one look-back launch), K4's function
# in three launches (T4's ``full``), and T4's ablations that are rounds.
# ``token_pass.cu`` instantiates these flag sets and no other.
TOKEN_PASSES = {
    "token_pass_lookback": TokenFlags(),
    "token_pass": TokenFlags(lookback=False),
    "token_parts_noscan": TokenFlags(scan=False, lookback=False),
    "token_parts_nolookup": TokenFlags(lookup=False, lookback=False),
    "token_parts_noshift": TokenFlags(shift=False, lookback=False),
}
_TOKEN_NAMES = {flags: name for name, flags in TOKEN_PASSES.items()}
K4_FLAGS = TOKEN_PASSES["token_pass_lookback"]  # the main path's round

# kernel launches made by the wrappers below, by kernel name
launches = {"token_pass_gap": 0, **dict.fromkeys(TOKEN_PASSES, 0)}
# (rounds, compactions) of each resident loop, in order
loop_log: list = []


def reset_launches() -> None:
    _cuda_build.reset_counts(launches)
    loop_log.clear()


def mp_compact_mode() -> str:
    """Resident-loop compaction policy (``BLT_MP_COMPACT``, as the JAX
    package's ``_mp_compact_mode``): ``gap`` (default) runs K3 and compacts
    every third round; ``sort`` runs K4 and compacts every round."""
    mode = os.environ.get("BLT_MP_COMPACT", "gap")
    return mode if mode in ("gap", "sort") else "gap"


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (still int64)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _lookup(d: torch.Tensor, nxt: torch.Tensor, planes: CuckooPlanes):
    """Two-plane cuckoo32 lookup of the pairs (d, nxt): (hit, value).
    int32 wrap-around arithmetic, done in int64 and wrapped."""
    p = _wrap32(d.to(torch.int64) * 65536 + nxt.to(torch.int64))
    mask = planes.slots - 1
    h1 = (_wrap32(p * planes.a1) >> planes.shift) & mask
    h2 = (_wrap32(p * planes.a2) >> planes.shift) & mask
    e_k1, e_v1 = planes.k1[h1], planes.v1[h1]
    e_k2, e_v2 = planes.k2[h2], planes.v2[h2]
    hit1 = (e_k1 == p) & (e_v1 >= 0)
    hit2 = (e_k2 == p) & (e_v2 >= 0)
    return hit1 | hit2, torch.where(hit1, e_v1, e_v2)


def _check_planes(planes: CuckooPlanes) -> None:
    for t in (planes.k1, planes.v1, planes.k2, planes.v2):
        if t.dtype != torch.int32 or t.numel() != planes.slots or not t.is_contiguous():
            raise ValueError("cuckoo32 planes must be contiguous int32 of one size")


def _launch_args(tokens: torch.Tensor, planes: CuckooPlanes, extra: int = 0):
    """Checks a CUDA launch's buffer; returns (device, capacity, scratch):
    two int32 per 4096-token tile and ``extra`` more."""
    cap = tokens.numel()
    _check_aligned(tokens, "token pass input")
    if cap % 16 or cap == 0 or cap >= 2**31 - _TILE:
        raise ValueError(
            f"token pass capacity {cap} must be a positive multiple of 16 "
            f"below 2**31 - {_TILE}"
        )
    dev = tokens.device
    scratch = torch.empty(2 * (-(-cap // _TILE)) + extra, dtype=torch.int32, device=dev)
    return dev, cap, scratch


# --- K4: one merge round over compacted tokens ------------------------------


def _token_name(flags: TokenFlags) -> str:
    """The launch counter of a merge round; raises for a flag set that is
    not one of ``TOKEN_PASSES``."""
    if flags not in _TOKEN_NAMES:
        raise ValueError(f"{flags} is not a merge round of TOKEN_PASSES")
    return _TOKEN_NAMES[flags]


def token_pass_plain(
    tokens: torch.Tensor, n: int, planes: CuckooPlanes, flags: TokenFlags = TokenFlags()
) -> torch.Tensor:
    """One merge round over compacted int32 tokens as plain tensor ops, with
    the parts of ``csrc/token_pass.cuh`` that ``flags`` switches: K4 with
    the defaults (the function of the Pallas ``_token_pass_kernel``).

    tokens: int32[cap], valid in [0, n). Returns int32[cap]: the merged
    value at a merge start, -1 at a consumed position, else the token.
    No ``shift``: each token pairs with itself. No ``lookup``: m =
    ((d ^ next) & 7) == 3, val = d + 1 (int32 wrap). No ``scan``: every
    match starts. ``lookback`` computes the same function as without it.
    """
    _token_name(flags)
    d = tokens.reshape(-1)
    cap = d.shape[0]
    if cap == 0:
        return d.clone()
    idx = torch.arange(cap, dtype=torch.int32, device=d.device)
    if flags.shift:
        nxt = torch.zeros_like(d)
        nxt[:-1] = d[1:]
    else:
        nxt = d
    if flags.lookup:
        hit, val = _lookup(d, nxt, planes)
    else:
        hit, val = ((d ^ nxt) & 7) == 3, _wrap32(d.to(torch.int64) + 1)
    m = hit & (idx < n - 1)
    if flags.scan:
        lnm = torch.cummax(torch.where(m, _NEG, idx), 0).values
        start = m & (((idx - torch.clamp(lnm, min=-1)) & 1) == 1)
    else:
        start = m
    consumed = torch.zeros_like(start)
    consumed[1:] = start[:-1]
    return torch.where(consumed, -1, torch.where(start, val, d)).to(torch.int32)


def token_pass(
    tokens: torch.Tensor, n: int, planes: CuckooPlanes, flags: TokenFlags = TokenFlags()
) -> torch.Tensor:
    """One merge round: kernel on CUDA tensors, plain on CPU tensors. Same
    arguments and result as ``token_pass_plain``. The default flags
    (``K4_FLAGS``) launch K4 as the main path runs it, ``lookback=False``
    its three-launch design;
    every flag set of ``TOKEN_PASSES`` runs through the one entry
    ``blt_token_pass`` and counts under its name there."""
    name = _token_name(flags)
    if tokens.dtype != torch.int32:
        raise ValueError(f"token pass takes int32 tokens, got {tokens.dtype}")
    if not 0 <= n <= tokens.numel():
        raise ValueError(f"{n} valid tokens do not fit capacity {tokens.numel()}")
    _check_planes(planes)
    if not _on_cuda(tokens, planes.k1, planes.v1, planes.k2, planes.v2):
        return token_pass_plain(tokens, n, planes, flags)
    # the scan's tile words, or the look-back's status words and ticket
    dev, cap, scratch = _launch_args(tokens, planes, extra=2)
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_token_pass(
            flags.bits, tokens.data_ptr(), cap, n, planes.k1.data_ptr(),
            planes.v1.data_ptr(), planes.k2.data_ptr(), planes.v2.data_ptr(),
            planes.slots, planes.a1, planes.a2, planes.shift, out.data_ptr(),
            scratch.data_ptr(), _stream(dev),
        )
    _cuda_build.check(err, name)
    _cuda_build.count(launches, name)
    return out


# --- K3: one merge round over a tombstoned stream ---------------------------


def token_pass_gap_plain(
    tokens: torch.Tensor, planes: CuckooPlanes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gap-tolerant merge round as plain tensor ops (the function of
    the Pallas ``_token_pass_gap_kernel`` and of ``token_pass_gap.cu``).

    tokens: int32[cap], -1 marking tombstones and padding. A position pairs
    with the first alive value among the next ``GAP_LOOKAHEAD``. Returns
    (int32[cap] with -1 where dead, the alive count as an int32 tensor).
    The kernel composes per-position transforms; this version takes the
    same recurrence over the alive subsequence by run parity instead.
    """
    d = tokens.reshape(-1)
    cap = d.shape[0]
    alive = d >= 0
    nxt = None
    for k in range(1, GAP_LOOKAHEAD + 1):
        t = torch.full_like(d, -1)
        if k < cap:
            t[:-k] = d[k:]
        nxt = t if nxt is None else torch.where(nxt >= 0, nxt, t)
    if nxt is None or cap == 0:
        return d.clone(), torch.zeros((), dtype=torch.int32, device=d.device)
    hit, val = _lookup(d, nxt, planes)
    m = hit & alive & (nxt >= 0)
    # merge_start[j] = m[j] & ~merge_start[j-1] over the alive positions:
    # alternation from the last alive non-match, counted in alive ranks
    rank = torch.cumsum(alive.to(torch.int64), 0) - 1
    lnm = torch.cummax(torch.where(alive & ~m, rank, -1), 0).values
    start = m & (((rank - lnm) & 1) == 1)
    # a position is consumed when the previous alive position started a merge
    idx = torch.arange(cap, dtype=torch.int64, device=d.device)
    last_alive = torch.cummax(torch.where(alive, idx, -1), 0).values
    prev_alive = torch.full_like(last_alive, -1)
    prev_alive[1:] = last_alive[:-1]
    consumed = alive & (prev_alive >= 0) & start[prev_alive.clamp(min=0)]
    dead = consumed | ~alive
    out = torch.where(dead, -1, torch.where(start, val, d)).to(torch.int32)
    return out, (~dead).sum(dtype=torch.int32)


def token_pass_gap(
    tokens: torch.Tensor, planes: CuckooPlanes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gap-tolerant round: kernel on CUDA tensors, plain on CPU
    tensors. Same arguments and results as ``token_pass_gap_plain``; the
    count stays on the device."""
    if tokens.dtype != torch.int32:
        raise ValueError(f"token pass takes int32 tokens, got {tokens.dtype}")
    _check_planes(planes)
    if not _on_cuda(tokens, planes.k1, planes.v1, planes.k2, planes.v2):
        return token_pass_gap_plain(tokens, planes)
    # the tiles' status words (uint64), the ticket and the count, zeroed by
    # one memset on the stream before the launch
    dev, cap, scratch = _launch_args(tokens, planes, extra=2)
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.blt_token_pass_gap(
            tokens.data_ptr(), cap, planes.k1.data_ptr(), planes.v1.data_ptr(),
            planes.k2.data_ptr(), planes.v2.data_ptr(), planes.slots, planes.a1,
            planes.a2, planes.shift, out.data_ptr(), scratch.data_ptr(), _stream(dev),
        )
    _cuda_build.check(err, "token_pass_gap")
    _cuda_build.count(launches, "token_pass_gap")
    return out, scratch[-1]


# --- the wire ----------------------------------------------------------------


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


# --- the encoder --------------------------------------------------------------


class CudaTokenEncoder(_Uploader):
    """Multipass encoder for general tables (port of ``PallasTokenEncoder``).

    Holds the table's cuckoo32 planes on ``device``. ``encode_resident*``
    keep the repeat-until-no-merges loop on the device (one upload and one
    download per chunk); ``encode`` compacts -1 tombstones on the host
    between rounds. Both implement the reference's loop (tokenizer.rs:63-86)
    with per-chunk semantics. ``capacity_tokens`` fixes the buffer size
    (rounded up to 128); 0 sizes each call to its input.
    """

    def __init__(self, table: MergeTable, device, capacity_tokens: int = 0):
        super().__init__(device)
        planes = cuckoo_planes(table, self.device)
        if planes is None:
            raise ValueError("cuckoo32 placement failed for this table")
        self.planes = planes
        self.capacity = _round_capacity(capacity_tokens) if capacity_tokens else 0

    @staticmethod
    def supports(table: MergeTable) -> bool:
        return table.build_cuckoo32() is not None

    @property
    def padded_bytes(self) -> int:
        """Host staging-buffer size for ``upload`` (one byte per token)."""
        if not self.capacity:
            raise ValueError("padded_bytes requires a fixed capacity")
        return self.capacity

    def _capacity_for(self, n: int) -> int:
        return self.capacity or _round_capacity(max(n, 1))

    def _buffer(self, data, fill: int):
        """``data`` (numpy bytes or tokens, or a 1-D tensor) as int32 on the
        device, ``fill`` past its end. Returns (buffer, n, capacity)."""
        n = data.shape[0]
        capacity = self._capacity_for(n)
        if n > capacity:
            raise ValueError(f"batch of {n} tokens exceeds encoder capacity {capacity}")
        buf = torch.full((capacity,), fill, dtype=torch.int32, device=self.device)
        if n:
            src = data if isinstance(data, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(data)
            )
            buf[:n] = src.reshape(-1)[:n].to(device=self.device, dtype=torch.int32)
        return buf, n, capacity

    def encode_pass(self, tokens: np.ndarray) -> np.ndarray:
        """Run one merge round (K4); returns int32 tokens with -1 tombstones."""
        buf, n, _ = self._buffer(tokens, 0)
        return token_pass(buf, n, self.planes, K4_FLAGS)[:n].cpu().numpy()

    def encode(self, data: np.ndarray) -> np.ndarray:
        """Full multipass encode of one chunk with host compaction."""
        toks = data.astype(np.int32)
        while toks.shape[0] > 1:
            out = self.encode_pass(toks)
            kept = out[out != -1]
            if kept.shape[0] == toks.shape[0]:
                return kept
            toks = np.ascontiguousarray(kept)
        return toks

    def _gap_loop(self, data):
        """K3 rounds until one merges nothing, compacting every third round
        when another round will run (``_multipass_gap_resident_call``)."""
        buf, n, _ = self._buffer(data, -1)
        m, prev, rounds, compactions = n, n + 1, 0, 0
        count = None
        while count is None or (m < prev and m > 1):
            buf, count = token_pass_gap(buf, self.planes)
            m2 = int(count)  # the round's one host read
            rounds += 1
            if rounds % GAP_COMPACT_EVERY == 0 and m2 < m and m2 > 1:
                buf, _ = _compact(buf, buf >= 0, fill=-1)
                compactions += 1
            prev, m = m, m2
        loop_log.append((rounds, compactions))
        return buf, count

    def _sort_loop(self, data):
        """K4 rounds with a compaction after each (``_multipass_resident_call``)."""
        buf, n, capacity = self._buffer(data, 0)
        idx = torch.arange(capacity, dtype=torch.int32, device=self.device)
        m, prev, rounds = n, n + 1, 0
        count = None
        while count is None or (m < prev and m > 1):
            out = token_pass(buf, m, self.planes, K4_FLAGS)
            buf, count = _compact(out, (out != -1) & (idx < m))
            rounds += 1
            prev, m = m, int(count)  # the round's one host read
        loop_log.append((rounds, rounds))
        return buf, count

    def encode_resident_dispatch(self, data):
        """The device-resident multipass of one chunk. Returns (tokens
        int32[capacity] on the device, the count as an int32 tensor).

        With the default gap loop (``BLT_MP_COMPACT=gap``) the tokens hold
        -1 tombstones between the count's alive entries; under
        ``BLT_MP_COMPACT=sort`` they are a compacted prefix.
        """
        if mp_compact_mode() == "sort":
            return self._sort_loop(data)
        return self._gap_loop(data)

    def encode_resident_wire_dispatch(self, data):
        """The gap loop plus its wire. Returns (wire uint8[2 * capacity +
        capacity // 8] on the device, the count, capacity); expand on the
        host with ``expand_gap_wire_host``."""
        toks, m = self._gap_loop(data)
        capacity = toks.shape[0]
        return _gap_tokens_to_wire(toks, capacity), m, capacity

    def encode_resident(self, data: np.ndarray) -> np.ndarray:
        """Full multipass encode, the repeat-until-done loop on the device."""
        if data.shape[0] <= 1:
            return data.astype(np.int32)
        toks_d, m_d = self.encode_resident_dispatch(data)
        toks = toks_d.cpu().numpy()
        if mp_compact_mode() == "sort":
            return toks[: int(m_d)]
        out = toks[toks >= 0]
        if out.shape[0] != int(m_d):
            raise RuntimeError(f"{out.shape[0]} alive tokens, count says {int(m_d)}")
        return out
