"""Multi-device encoders (port of ``ShardedFlatEncoder`` and
``ShardedTokenEncoder`` in ``blt_tpu/ops/bpe_pallas.py``).

Row r of a batch runs on ``mesh[r]`` (``parallel/mesh.py``) through the
main path's kernel wrappers, on that device's current stream: K2 fused with
its pack (``bpe_cuda.flat_encode_packed``) for a flat slab, and for a
general table's chunk the encoder ``multipass_cuda.token_encoder`` chooses
(the K3 gap loop, the K4 loop under ``BLT_MP_COMPACT=sort``, or the plain
twin). A CPU row runs the wrappers' plain versions, as the single-device
encoders do. Nothing catches a failure to build or launch a kernel.

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

``CudaShardedTokenEncoder`` holds one ``token_encoder`` a row. General
tables keep the reference's per-chunk semantics, so rows never stitch: a
batch of up to B chunks is B independent loops. Each loop reads its alive
count on the host once a round, so the rows of a batch run one after
another from the calling thread. Every route's wire is the u16-BE image of
the loop's compacted prefix: its first ``2 * count`` bytes are the output.
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
from blt_tpu_torch.ops.multipass_cuda import token_encoder
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
    ``token_encoder`` a row (a ``PlainTokenEncoder`` row only ``dispatch``es)."""

    def __init__(self, table: MergeTable, mesh=None, capacity_tokens: int = 0):
        self.mesh = make_mesh(mesh)
        self.n_rows = len(self.mesh)
        if not capacity_tokens:
            raise ValueError("CudaShardedTokenEncoder requires a fixed capacity")
        self.rows = [token_encoder(table, d, capacity_tokens) for d in self.mesh]
        self.capacity = self.rows[0].capacity

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
        1-D tensor on its device). Returns (the u16-BE image of the loop's
        compacted prefix as uint8 on the device, the count as a tensor)."""
        toks, m = self.rows[r].encode_resident_dispatch(data)
        return tokens_to_be_bytes_device(toks).view(torch.uint8), m

    @staticmethod
    def download(wire: torch.Tensor, m) -> np.ndarray:
        """A ``dispatch`` result -> its ``2 m`` bytes on the host as
        byteswapped u16 tokens (LE image = the u16-BE wire stream)."""
        return wire[: 2 * int(m)].cpu().numpy().view(np.uint16)

    def encode_batch_resident_wire(self, chunks: list) -> List[np.ndarray]:
        """Full multipass of up to n_rows chunks, one device-resident loop a
        row (one upload and one download a chunk). Returns byteswapped u16
        rows whose LE image is the u16-BE wire stream."""
        self._check(chunks)
        return [self.download(*self.dispatch(r, c)) for r, c in enumerate(chunks)]

    def encode_batch_resident(self, chunks: list) -> List[np.ndarray]:
        """Full multipass of up to n_rows chunks -> int32 token arrays (the
        wire unswapped)."""
        return [
            (be.astype(np.int32) >> 8) | ((be.astype(np.int32) & 0xFF) << 8)
            for be in self.encode_batch_resident_wire(chunks)
        ]
