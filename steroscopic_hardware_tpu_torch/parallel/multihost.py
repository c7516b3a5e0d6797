"""Multi-process runtime on ``torch.distributed`` (counterpart of
``steroscopic_hardware_tpu/parallel/multihost.py``).

The JAX package runs this tier as one controller over a device ``Mesh``,
with ``shard_map`` and named-axis collectives. The port runs it SPMD: one
process per rank, each calling the same function on its own shard, with
the collectives on a ``torch.distributed`` process group: the counterpart
of multi-host JAX, where every process runs the same program.

* :func:`init_distributed` joins (or, alone, makes) the process group and
  picks the rank's device; :func:`global_mesh` builds the (batch, rows)
  mesh over every rank;
* :func:`shard` cuts this rank's block out of an array (``device_put``
  with a ``NamedSharding``) and :func:`all_gather` joins the blocks again
  (``multihost_utils.process_allgather(..., tiled=True)``);
* :func:`all_to_all` and :func:`broadcast` are the collectives of the
  sharded operations (``all_to_all`` and ``ppermute``'s neighbour rows;
  the solvers' ``psum`` is ``utils.collectives.all_reduce``). Under gloo
  they take CUDA tensors as they are and gloo stages them through the
  host itself; gloo's point-to-point send / recv of a CUDA tensor aborts
  the process (``gloo_probe``), so the halo exchange is an all_to_all
  too;
* :func:`launch` runs a function on ``world_size`` ranks of this host, the
  counterpart of the JAX tests' two-process harness
  (``tests/test_multiprocess.py``).

Ranks on one card need ``backend="gloo"``: NCCL refuses two ranks of one
communicator on the same device. ``backend="nccl"`` needs one card per
rank.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from steroscopic_hardware_tpu_torch.runtime.logger import get_logger
from steroscopic_hardware_tpu_torch.utils.device import resolve_device

BACKENDS = ("gloo", "nccl")
# a collective that waits this long has lost a rank: fail, do not hang
TIMEOUT = datetime.timedelta(seconds=300)

# Bytes this process sent to other ranks since reset_sent_bytes(), by the
# tag of the exchange ("halo": the SAD bands' neighbour rows, "all_to_all":
# the SGM reshard); the exchanges add where they send and nowhere else.
sent_bytes = {"halo": 0, "all_to_all": 0}


def reset_sent_bytes() -> None:
    for tag in sent_bytes:
        sent_bytes[tag] = 0


def _ranks_on_host(num_processes: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def rank_device(backend: str, device, local_rank: int,
                ranks_on_host: int) -> torch.device:
    """The device of a rank: ``cuda:{local_rank % device_count()}`` for
    "cuda" (which raises without a usable GPU), the CPU for "cpu". Raises
    ValueError for an unknown backend and for "nccl" on the CPU or with
    more ranks on this host than cards."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' runs on CUDA tensors only; "
                             "ranks on the CPU need backend 'gloo'")
        cards = torch.cuda.device_count()
        if ranks_on_host > cards:
            raise ValueError(
                f"backend 'nccl' needs one card per rank, and {ranks_on_host}"
                f" ranks on this host share {cards} card(s): NCCL refuses "
                "two ranks of one communicator on one device; pass backend "
                "'gloo' for ranks that share a card")
    dev = resolve_device(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, backend: str,
                     device="cuda") -> dict:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` (``init_process_group`` at ``coordinator_address``, a
    ``tcp://host:port`` URL), or, alone, make a one-rank group, so the same
    code runs everywhere; a second call returns the summary and changes
    nothing. With no arguments it reads torchrun's variables (MASTER_ADDR
    / MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK). The rank's tensors live
    on ``rank_device``; on a card it becomes the current CUDA device.

    Returns the JAX summary (process_id, num_processes, local_devices: the
    ranks on this host, global_devices: every rank) plus the rank's
    ``device`` and the ``backend``."""
    log = get_logger("multihost")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"tcp://{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    on_host = _ranks_on_host(num_processes)
    dev = rank_device(backend, device, local_rank, on_host)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if num_processes > 1:
            if coordinator_address is None:
                raise ValueError(
                    f"{num_processes} processes need a coordinator address "
                    "(tcp://host:port, or MASTER_ADDR / MASTER_PORT)")
            dist.init_process_group(
                backend, init_method=coordinator_address,
                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
            log.info("process group up: rank %d/%d, %s, %s on %s",
                     process_id, num_processes, coordinator_address,
                     backend, dev)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0, timeout=TIMEOUT)
            log.info("single-process group (%s on %s)", backend, dev)
    return {
        "process_id": dist.get_rank(),
        "num_processes": dist.get_world_size(),
        "local_devices": on_host,
        "global_devices": dist.get_world_size(),
        "device": dev,
        "backend": dist.get_backend(),
    }


def global_mesh(device_type: str = "cuda"):
    """A (batch, rows) mesh over every rank, batch-major, so that the rows
    axis (the SAD halo and the SGM all_to_all) stays inside a host."""
    from steroscopic_hardware_tpu_torch.parallel.mesh import make_mesh

    n_total = dist.get_world_size()
    n_local = min(_ranks_on_host(n_total), n_total)
    return make_mesh(n_rows=n_local, n_batch=max(1, n_total // n_local),
                     device_type=device_type)


# -- sharding and collectives -------------------------------------------------

def _axis(mesh, axis_name: str):
    """(process group, size, this rank's index) of a mesh axis."""
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), dist.get_rank(group)


def shard(x: torch.Tensor, mesh, axis_name: str = "rows",
          dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` over the mesh
    axis (a view). Raises ValueError unless the axis size divides it."""
    _, n, i = _axis(mesh, axis_name)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"size {size} along dim {dim} not divisible by "
                         f"mesh axis {axis_name}={n}")
    k = size // n
    return x.narrow(dim, i * k, k)


def all_gather(x: torch.Tensor, mesh, axis_name: str = "rows",
               dim: int = 0) -> torch.Tensor:
    """The blocks of every rank on the mesh axis, joined along ``dim`` in
    rank order (the inverse of :func:`shard`), on every rank."""
    group, n, _ = _axis(mesh, axis_name)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def all_to_all(x: torch.Tensor, group, send_rows=None, recv_rows=None, *,
               tag: str) -> torch.Tensor:
    """``all_to_all_single`` along dim 0: rank j gets ``send_rows[j]``
    consecutive rows of ``x`` (equal blocks when None), and the result
    holds the ``recv_rows[j]`` rows of each rank j in rank order. Adds the
    bytes sent to other ranks to ``sent_bytes[tag]``."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    if recv_rows is None:
        out = torch.empty_like(x)
        sent = (len(x) // n) * (n - 1)
    else:
        out = x.new_empty((sum(recv_rows), *x.shape[1:]))
        sent = sum(r for j, r in enumerate(send_rows) if j != i)
    dist.all_to_all_single(out, x, output_split_sizes=recv_rows,
                           input_split_sizes=send_rows, group=group)
    sent_bytes[tag] += sent * x[0].numel() * x.element_size()
    return out


def broadcast(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of the group's first rank, on every rank of ``group``."""
    x = x.clone()
    dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x


# -- launcher -----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world_size, port, backend, device, args):
    # the ranks share the host's cores
    torch.set_num_threads(1)
    info = init_distributed(f"tcp://127.0.0.1:{port}", world_size, rank,
                            backend=backend, device=device)
    try:
        fn(info, *args)
    finally:
        dist.destroy_process_group()


def launch(fn, world_size: int, *, backend: str, device, args=()) -> None:
    """Run ``fn(info, *args)`` on ``world_size`` ranks of this host, each a
    spawned process that joins the group at a free localhost port
    (``info``: :func:`init_distributed`'s summary) and leaves it at the
    end. ``fn`` must be importable (a module-level function). On a card
    the kernels are built here, once, before the ranks start. A rank that
    raises fails the launch (the others are stopped)."""
    import torch.multiprocessing as mp

    rank_device(backend, device, 0, world_size)
    if torch.device(device).type == "cuda":
        from steroscopic_hardware_tpu_torch import _kernels

        _kernels.build()
    mp.spawn(_rank_main,
             args=(fn, world_size, _free_port(), backend, device, tuple(args)),
             nprocs=world_size, join=True)
