"""Data and model parallelism over ``torch.distributed`` device meshes.

PyTorch counterpart of ``curvlinops_tpu/parallel``: every operator accepts
``mesh=`` and splits each batch over the mesh's data axis, one process per
device, reducing with the axis's process group
(:mod:`curvlinops_tpu_torch.parallel.mesh`).
"""

from curvlinops_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
    shard_params,
)

__all__ = ["make_mesh", "replicate", "shard_batch", "shard_params"]
