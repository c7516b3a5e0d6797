"""Mesh construction (counterpart of
``steroscopic_hardware_tpu/parallel/mesh.py``).

A ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group, whose dims carry the JAX mesh's roles: ``rows`` = spatial
data parallelism over image bands, ``batch`` = independent frames or
streams. A JAX ``axis_name`` becomes ``mesh.get_group(axis_name)``.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_rows: int | None = None, n_batch: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (batch, rows) mesh of shape (n_batch, n_rows) over every rank,
    batch-major. Needs an initialized process group
    (``multihost.init_distributed``).

    Unlike the JAX ``make_mesh``, which truncates a device list that does
    not match, it raises ValueError unless n_rows * n_batch is the world
    size: in SPMD a rank left off the mesh would wait forever in the first
    collective."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.multihost.init_distributed)")
    world = dist.get_world_size()
    if n_rows is None:
        n_rows = world // n_batch
    if n_rows * n_batch != world:
        raise ValueError(
            f"a ({n_batch}, {n_rows}) mesh needs {n_rows * n_batch} ranks; "
            f"the world has {world}, and every rank must be on the mesh")
    return init_device_mesh(device_type, (n_batch, n_rows),
                            mesh_dim_names=("batch", "rows"))
