"""Multi-device encoders (port of ``ShardedFlatEncoder`` and
``ShardedTokenEncoder`` in ``blt_tpu/ops/bpe_pallas.py``).

Row r of a batch runs on ``mesh[r]`` (``parallel/mesh.py``) through the
main path's kernel wrappers, on that device's current stream: K2 fused with
its pack (``bpe_cuda.flat_encode_packed``) for a flat slab, the K3 gap loop
or, under ``BLT_MP_COMPACT=sort``, the K4 loop for a general table's chunk
(``multipass_cuda.CudaTokenEncoder``). A CPU row runs the wrappers' plain
versions, as the single-device encoders do. Nothing catches a failure to
build or launch a kernel.

``CudaShardedFlatEncoder`` is the JAX package's halo convergence: each slab
is ``HALO`` bytes of the stream before it, then its payload, encoded from
carry 0. The parity recurrence ``start[i] = match[i] & ~start[i-1]``
forgets its initial condition at the first non-matching pair, so when the
halo holds one (``halo_converges``, a host lookup), every slot of the
payload equals the sequential result. The caller checks that per slab and
sends a batch whose halo holds none to the exact carry-composition path
(``parallel.sharded.sharded_flat_encode``). The JAX route runs the slots
kernel and then ``pack_slots_batch`` as two dispatches; here one launch a
slab writes the same packed wire over the slab's payload.

``CudaShardedTokenEncoder`` holds one ``CudaTokenEncoder`` a row, or with
``plain`` one ``PlainTokenEncoder`` (a table neither cuckoo32 placement
takes, or ``BLT_MULTIPASS=xla``). General
tables keep the reference's per-chunk semantics, so rows never stitch: a
batch of up to B chunks is B independent loops. Each loop reads its alive
count on the host once a round, so the rows of a batch run one after
another from the calling thread.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from blt_tpu_torch.merges import NO_RULE, MergeTable
from blt_tpu_torch.ops.bpe_cuda import (
    CudaFlatEncoder,
    _round_capacity,
    flat_encode_packed,
)
from blt_tpu_torch.ops.bpe_torch import tokens_to_be_bytes_device
from blt_tpu_torch.ops.multipass_cuda import (
    CudaTokenEncoder,
    PlainTokenEncoder,
    expand_gap_wire_host,
    mp_compact_mode,
)
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.parallel.mesh import make_mesh
from blt_tpu_torch.pipeline.feeder import upload


def copy_streams(mesh) -> dict:
    """A side copy stream per distinct CUDA device of the mesh."""
    return {d: torch.cuda.Stream(d) for d in dict.fromkeys(mesh) if d.type == "cuda"}


class CudaShardedFlatEncoder:
    """Halo-convergence data parallelism for K2 over a mesh."""

    HALO = 1024  # bytes of left context a slab

    def __init__(self, table: MergeTable, mesh=None, capacity_bytes: int = 0,
                 streams: Optional[dict] = None):
        if not self.supports(table):
            raise ValueError(
                "flat kernel requires a flat table with all merge values >= 256"
            )
        self.mesh = make_mesh(mesh)
        self.n_rows = len(self.mesh)
        # one wire table a distinct device
        self._tables = {d: wire_table(table.dense, d) for d in dict.fromkeys(self.mesh)}
        self.capacity = _round_capacity(capacity_bytes)
        if not self.capacity:
            raise ValueError("CudaShardedFlatEncoder requires a fixed capacity")
        # a slab is HALO bytes of context then the payload; payload >= HALO
        # keeps every halo inside a stream full and the halo's extra work
        # at most half
        self.payload = self.capacity - self.HALO
        if self.payload < self.HALO:
            raise ValueError(
                f"capacity {self.capacity} leaves a payload under the {self.HALO}-byte halo"
            )
        self.table = table
        # the side copy stream a CUDA device (``copy_streams``): a caller
        # that uploads to the same devices passes its own
        self._streams = copy_streams(self.mesh) if streams is None else streams

    @staticmethod
    def supports(table: MergeTable) -> bool:
        return CudaFlatEncoder.supports(table)

    @property
    def padded_bytes(self) -> int:
        return self.capacity

    @staticmethod
    def halo_converges(dense: np.ndarray, halo_plus_one: np.ndarray) -> bool:
        """True iff the parity recurrence converges within this halo.

        ``halo_plus_one``: the slab's halo bytes and its first payload byte,
        so every halo pair is whole. An empty halo converges only at the
        true stream start (carry 0 is exact there)."""
        if halo_plus_one.shape[0] < 2:
            return True
        a = halo_plus_one[:-1].astype(np.int32)
        b = halo_plus_one[1:].astype(np.int32)
        return bool((dense[a * 256 + b] == NO_RULE).any())

    def encode_batch(self, batch, lengths, next_bytes):
        """Run every slab, each from carry 0 and previous slot 0.

        batch: uint8 (n_rows, padded_bytes), numpy or a (pinned) host
        tensor: each slab's halo then its payload; lengths: valid bytes a
        slab, halo included; next_bytes: the byte after each slab, -1 at
        EOF. Returns (wires: one uint8[capacity + capacity // 8] a slab,
        packed bytes then the flag plane, on the slab's device; carries:
        one int32 (1, 1) a slab). Slab r's payload is positions
        [halo_r, length_r) of its wire; the last non-empty slab's carry is
        the sequential carry at the batch's end. A slab of length 0 is not
        run (its entries are None)."""
        if tuple(batch.shape) != (self.n_rows, self.padded_bytes):
            raise ValueError(f"batch of shape {tuple(batch.shape)}, expected "
                             f"{(self.n_rows, self.padded_bytes)}")
        wires, carries = [], []
        for r, dev in enumerate(self.mesh):
            n = int(lengths[r])
            if n == 0:
                wires.append(None)
                carries.append(None)
                continue
            data = upload(batch[r], dev, self._streams.get(dev))
            zero = torch.zeros((1, 1), dtype=torch.int32, device=dev)
            wire, carry, _ = flat_encode_packed(
                data, n, int(next_bytes[r]), self._tables[dev], zero, zero.reshape(())
            )
            wires.append(wire)
            carries.append(carry)
        return wires, carries


class CudaShardedTokenEncoder:
    """Row-parallel multipass for general tables over a mesh: one
    ``CudaTokenEncoder`` a row; with ``plain``, one ``PlainTokenEncoder``,
    whose rows only ``dispatch``."""

    def __init__(self, table: MergeTable, mesh=None, capacity_tokens: int = 0,
                 plain: bool = False):
        self.mesh = make_mesh(mesh)
        self.n_rows = len(self.mesh)
        if not capacity_tokens:
            raise ValueError("CudaShardedTokenEncoder requires a fixed capacity")
        row = PlainTokenEncoder if plain else CudaTokenEncoder
        self.rows = [row(table, d, capacity_tokens) for d in self.mesh]
        self.capacity = self.rows[0].capacity
        self.plain = plain

    @staticmethod
    def supports(table: MergeTable) -> bool:
        return CudaTokenEncoder.supports(table)

    def _check(self, chunks: list) -> None:
        if len(chunks) > self.n_rows:
            raise ValueError(f"{len(chunks)} chunks for {self.n_rows} rows")

    def encode_pass_batch(self, rows: list) -> list:
        """One merge round (K4) over up to n_rows int32 token arrays, each
        on its own row's device; per-row arrays with -1 tombstones."""
        self._check(rows)
        return [enc.encode_pass(toks) for enc, toks in zip(self.rows, rows)]

    def encode_batch(self, chunks: list) -> list:
        """Full multipass of up to n_rows chunks with host compaction
        between rounds -> int32 token arrays."""
        self._check(chunks)
        toks = [c.astype(np.int32) for c in chunks]
        active = [t.shape[0] > 1 for t in toks]
        while any(active):
            outs = self.encode_pass_batch(toks)
            for r, out in enumerate(outs):
                if not active[r]:
                    continue
                kept = out[out != -1]
                if kept.shape[0] == toks[r].shape[0] or kept.shape[0] <= 1:
                    active[r] = False
                toks[r] = np.ascontiguousarray(kept)
        return toks

    def dispatch(self, r: int, data):
        """Row r's device-resident loop over one chunk (numpy bytes, or a
        1-D tensor on its device). Returns (uint8 wire on the device, the
        alive count as a tensor, capacity): the gap loop's wire, expanded on
        the host by ``expand_gap_wire_host``; under ``BLT_MP_COMPACT=sort``
        or ``plain`` the u16-BE image of the loop's compacted prefix as
        bytes and capacity None (the count's first tokens are the output)."""
        enc = self.rows[r]
        if self.plain or mp_compact_mode() == "sort":
            toks, m = enc.encode_resident_dispatch(data)
            return tokens_to_be_bytes_device(toks).view(torch.uint8), m, None
        return enc.encode_resident_wire_dispatch(data)

    @staticmethod
    def download(wire: torch.Tensor, m, capacity):
        """A ``dispatch`` result -> (its wire on the host, the count as an
        int): the whole gap wire, or the compacted prefix's ``2 m`` bytes."""
        m = int(m)
        if capacity is None:
            wire = wire[: 2 * m]
        return wire.cpu().numpy(), m

    @staticmethod
    def expand(wire: np.ndarray, m: int, capacity) -> np.ndarray:
        """A ``download``ed wire -> byteswapped u16 tokens (LE image = the
        u16-BE wire stream)."""
        if capacity is None:
            return wire.view(np.uint16)[:m]
        toks = expand_gap_wire_host(wire, capacity)
        if toks.shape[0] != m:
            raise RuntimeError(f"{toks.shape[0]} alive tokens, count says {m}")
        return toks

    def encode_batch_resident_wire(self, chunks: list) -> List[np.ndarray]:
        """Full multipass of up to n_rows chunks, one device-resident loop a
        row (one upload and one download a chunk). Returns byteswapped u16
        rows whose LE image is the u16-BE wire stream."""
        self._check(chunks)
        outs = [self.dispatch(r, c) for r, c in enumerate(chunks)]
        return [self.expand(*self.download(w, m, cap), cap) for w, m, cap in outs]

    def encode_batch_resident(self, chunks: list) -> List[np.ndarray]:
        """Full multipass of up to n_rows chunks -> int32 token arrays (the
        wire unswapped)."""
        return [
            (be.astype(np.int32) >> 8) | ((be.astype(np.int32) & 0xFF) << 8)
            for be in self.encode_batch_resident_wire(chunks)
        ]
