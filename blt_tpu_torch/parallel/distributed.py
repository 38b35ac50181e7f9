"""Multi-process initialisation and corpus sharding (port of
``blt_tpu/parallel/distributed.py``).

The process group is ``torch.distributed`` over gloo. Every collective of
the multi-process runner carries host data (the per-process output counts,
the end-of-run barrier), and gloo, unlike NCCL, lets several ranks share
one CUDA device, which a single-card machine needs to run more than one.

    from blt_tpu_torch.parallel import distributed as dist
    dist.initialize("host0:29500", 2, rank)   # or argless under torchrun
    lo, hi = dist.host_byte_range(total)      # this process's corpus slice

The runner (``parallel/multihost.py``) reads the ``BLT_COORDINATOR_ADDRESS``
/ ``BLT_NUM_PROCESSES`` / ``BLT_PROCESS_ID`` contract and calls
``initialize`` with it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch.distributed as tdist

from blt_tpu_torch.parallel.mesh import make_mesh
from blt_tpu_torch.utils.logging import get_logger

log = get_logger("distributed")

BACKEND = "gloo"
# torchrun's variables, read by the argless call (env:// initialisation)
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")

# None = never attempted, "solo" = the argless call found no process group
# to join, "real" = a process group is up. A later explicit (coordinator)
# call must still run after a solo outcome: treating it as final would turn
# an explicit multi-process launch into N independent solo runs.
_init_state: Optional[str] = None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``init_process_group`` with idempotence and the solo state.

    With an explicit ``coordinator_address`` (``host:port``), joins the
    group ``tcp://host:port`` as rank ``process_id`` of ``num_processes``;
    a failure raises, since a silent solo run would corrupt the shared
    output. With no arguments, joins through torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` where they are set;
    otherwise, or if that fails, the process runs solo.
    """
    global _init_state
    if _init_state == "real" or tdist.is_initialized():
        _init_state = "real"
        return
    if coordinator_address is None:
        if _init_state == "solo":
            return
        if not all(v in os.environ for v in _TORCHRUN_ENV):
            log.debug("distributed init skipped: no coordinator and no torchrun env")
            _init_state = "solo"
            return
        try:
            tdist.init_process_group(BACKEND, init_method="env://")
        except (ValueError, RuntimeError) as e:
            log.debug("distributed init skipped: %s", e)
            _init_state = "solo"
            return
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes and process_id")
        tdist.init_process_group(
            BACKEND,
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes),
            rank=int(process_id),
        )
    _init_state = "real"
    log.info("distributed initialized: process %d/%d", process_index(), process_count())


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def global_mesh():
    """Row layout over every CUDA device this process sees."""
    return make_mesh()


def host_byte_range(total_bytes: int) -> Tuple[int, int]:
    """This process's naive contiguous corpus slice (an even split), for
    the size-deterministic modes (basic, passthrough, decode). BPE runs
    must not split here: ``multihost.plan_bounds`` owns the
    merge-transparent and chunk-aligned planning the runner uses."""
    from blt_tpu_torch.parallel.multihost import even_bounds

    p = process_index()
    bounds = even_bounds(total_bytes, process_count())
    return bounds[p], bounds[p + 1]
