"""The sum over a process group that the sharded solvers need (JAX
``psum``), kept below ``models/`` so that the solvers do not import the
multi-process tier (``parallel/``), which imports them."""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(tensors, group) -> list[torch.Tensor]:
    """Sums over ``group`` of float tensors of one dtype, in one
    all_reduce of their concatenation; every rank gets the same sums."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    sizes = [t.numel() for t in tensors]
    return [s.view(t.shape) for s, t in zip(flat.split(sizes), tensors)]
