"""Multi-device and multi-process layer of the torch port: the row mesh,
the sharded encode steps, ``torch.distributed`` initialisation and the
multi-process runner (port of ``blt_tpu/parallel``)."""

from blt_tpu_torch.parallel.mesh import make_mesh, replicated, row_sharding, vec_sharding

__all__ = ["make_mesh", "replicated", "row_sharding", "vec_sharding"]
