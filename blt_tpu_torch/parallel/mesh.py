"""The row layout of a multi-device run (port of ``blt_tpu/parallel/mesh.py``).

The JAX package's mesh is a 1-D ``jax.sharding.Mesh`` with a ``data``
axis: corpus chunks are laid out as rows of a (B, N) batch sharded over it,
the merges table is replicated. Torch has no sharding annotation, so the
mesh here is the explicit tuple of ``torch.device`` that row r lives on:
``mesh[r]``. Each row is uploaded to its own device (the JAX package does
the same to avoid a reshard, ``ShardedTokenEncoder``), a replicated tensor
is one copy per distinct device, and a per-row scalar is a host value.

A device may appear several times: ``[cpu] * 4`` is the counterpart of the
JAX tests' virtual CPU mesh, ``[cuda:0] * 4`` runs four rows on one card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from blt_tpu_torch.utils.device import require_cuda

Mesh = Tuple[torch.device, ...]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D row layout over ``devices`` (default: every CUDA device; raises
    without one)."""
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def row_sharding(mesh: Mesh, batch) -> List[torch.Tensor]:
    """(B, N) host batch (numpy or tensor) -> B row tensors, row r on
    ``mesh[r]``."""
    if len(batch) != len(mesh):
        raise ValueError(f"{len(batch)} rows for a mesh of {len(mesh)} devices")
    rows = torch.from_numpy(batch) if isinstance(batch, np.ndarray) else batch
    return [row.to(dev, copy=True) for row, dev in zip(rows, mesh)]


def vec_sharding(mesh: Mesh, vec) -> List[torch.Tensor]:
    """(B,) per-row values -> B one-element tensors, element r on ``mesh[r]``."""
    return row_sharding(mesh, np.asarray(vec).reshape(len(mesh), 1))


def replicated(mesh: Mesh, array) -> Dict[torch.device, torch.Tensor]:
    """One copy of ``array`` on each distinct device of the mesh."""
    t = torch.from_numpy(np.ascontiguousarray(array)) if isinstance(array, np.ndarray) else array
    return {dev: t.to(dev) for dev in dict.fromkeys(mesh)}
