"""Scaling of SAD disparity (BASELINE config #5), the counterpart of the
repository's ``tools/bench_scaling.py``.

    python -m steroscopic_hardware_tpu_torch.tools.bench_scaling
    python -m steroscopic_hardware_tpu_torch.tools.bench_scaling --batch-axis
    python -m steroscopic_hardware_tpu_torch.tools.bench_scaling \\
        --device cpu --height 32 --width 64 --disp 16 -n 2

``--batch-axis``: frames per launch F = 1, 2, 4 and 8 on one card, each
launch B1 (``sad_wta``, ``ops.sad.disparity_batch``) over F frames. Each
launch's output is the next launch's left input, as the original's
``lax.scan`` carry is, so the ``-n`` launches run back to back on the
device; timed between CUDA events, the best of 3 after one untimed chain.
A line per F: ms a frame, frames/s, Mpix/s and the throughput against
F = 1.

Without it: row-sharded disparity (``parallel.disparity_shard``, B1 on
each rank's band plus its halo) over 1, 2, 4, ... ranks, one process each
(``parallel.multihost.launch``), up to the cards present (on the CPU, up
to its cores, at most 16), H divisible by the ranks. The backend is
nccl on cards (one card a rank) and gloo on the CPU, as the dry run
chooses it. A line per rank count: ms a frame (the slowest rank's host
clock around ``-n`` synchronised frames), frames/s and the efficiency
against one rank.

The flags are the original's, plus ``--device``. Each line ends with the
device and the number of cards; on one card the rank mode runs one NCCL
rank, the baseline a multi-card host extends.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch

BATCHES = (1, 2, 4, 8)
RANKS = (1, 2, 4, 8, 16)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def chain(lefts, rights, *, block, disp, n):
    """``n`` launches of B1, each on the previous launch's output as its
    left frames: (first output, last output)."""
    from steroscopic_hardware_tpu_torch.ops.sad import disparity_batch

    x = first = None
    for i in range(n):
        x = disparity_batch(lefts if i == 0 else x, rights,
                            block_size=block, max_disparity=disp)
        if i == 0:
            first = x
    return first, x


def _chain_seconds(lefts, rights, args) -> float:
    """Seconds of one chain of ``args.n`` launches: CUDA events on a card,
    the host clock on the CPU (whose plain versions run synchronously)."""
    kw = dict(block=args.block, disp=args.disp, n=args.n)
    if lefts.device.type != "cuda":
        t0 = time.perf_counter()
        chain(lefts, rights, **kw)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    chain(lefts, rights, **kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def bench_batch_axis(args, device):
    """Yields a dict per F of ``BATCHES``: its time and rates, its inputs
    (``lefts``, ``rights``) and the chain's ``first`` and ``last``
    outputs."""
    rng = np.random.default_rng(0)
    base = None
    for F in BATCHES:
        shape = (F, args.height, args.width)
        lefts = torch.from_numpy(rng.integers(0, 256, shape,
                                              dtype=np.uint8)).to(device)
        rights = torch.from_numpy(rng.integers(0, 256, shape,
                                               dtype=np.uint8)).to(device)
        first, last = chain(lefts, rights, block=args.block, disp=args.disp,
                            n=args.n)  # builds or loads the kernels
        _sync(device)
        best = min(_chain_seconds(lefts, rights, args)
                   for _ in range(3)) / args.n
        fps = F / best
        if base is None:
            base = fps
        # throughput against one frame a launch: the frames share the card
        yield {"batch": F, "ms_frame": best * 1e3 / F, "fps": fps,
               "mpix_s": args.height * args.width * F / 1e6 / best,
               "gain_pct": fps / base * 100, "lefts": lefts,
               "rights": rights, "first": first, "last": last}


def rank_sizes(device, height: int) -> list[int]:
    """Rank counts of ``RANKS`` up to the cards present (the CPU's cores
    on the CPU) that divide ``height``."""
    avail = (torch.cuda.device_count() if device.type == "cuda"
             else os.cpu_count() or 1)
    return [s for s in RANKS if s <= avail and height % s == 0]


def rank_bench(info, left, right, block, disp, n, out_path) -> None:
    """Rank function (``multihost.launch``): this rank's band of the pair,
    one untimed sharded frame, then ``n`` timed ones; rank 0 writes the
    gathered map, the slowest rank's seconds a frame and each rank's
    kernel launches to ``out_path`` (pickle)."""
    import torch.distributed as dist

    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.parallel.disparity_shard import (
        disparity_sharded,
    )
    from steroscopic_hardware_tpu_torch.parallel.mesh import make_mesh
    from steroscopic_hardware_tpu_torch.parallel.multihost import (
        all_gather,
        shard,
    )

    dev = info["device"]
    _kernels.reset_launches()
    mesh = make_mesh(device_type=dev.type)
    L = shard(torch.from_numpy(left).to(dev), mesh)
    R = shard(torch.from_numpy(right).to(dev), mesh)

    def frame():
        return disparity_sharded(L, R, block_size=block,
                                 max_disparity=disp, mesh=mesh)

    out = frame()
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        out = frame()
    _sync(dev)
    seconds = (time.perf_counter() - t0) / n
    full = all_gather(out, mesh)
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, (seconds, dict(_kernels.launches)))
    if dist.get_rank() == 0:
        with open(out_path, "wb") as f:
            pickle.dump({"disp": full.cpu().numpy(),
                         "seconds": max(s for s, _ in per_rank),
                         "launches": [c for _, c in per_rank]}, f)


def bench_ranks(args, device, sizes=None):
    """Yields a dict per rank count (``rank_sizes`` unless ``sizes``): the
    ranks, ms and frames/s, the efficiency against the first count, each
    rank's kernel launches, the gathered map and the seeded (left, right)
    it came from."""
    from steroscopic_hardware_tpu_torch.parallel import multihost

    rng = np.random.default_rng(0)
    shape = (args.height, args.width)
    left = rng.integers(0, 256, shape, dtype=np.uint8)
    right = rng.integers(0, 256, shape, dtype=np.uint8)
    sizes = rank_sizes(device, args.height) if sizes is None else sizes
    backend = "nccl" if device.type == "cuda" else "gloo"
    base = None
    for n in sizes:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "result.pkl")
            multihost.launch(rank_bench, n, backend=backend,
                             device=device.type,
                             args=(left, right, args.block, args.disp,
                                   args.n, path))
            with open(path, "rb") as f:
                res = pickle.load(f)
        fps = 1.0 / res["seconds"]
        if base is None:
            base = fps
        yield {"ranks": n, "backend": backend,
               "ms_frame": res["seconds"] * 1e3, "fps": fps,
               "efficiency_pct": fps / (base * n / sizes[0]) * 100,
               "launches": res["launches"], "disp": res["disp"],
               "left": left, "right": right}


def where(device) -> str:
    """The device and the number of cards, for the end of a line."""
    if device.type == "cuda":
        return (f"[{torch.cuda.get_device_name(device)}, "
                f"{torch.cuda.device_count()} card(s)]")
    return "[cpu, 0 cards]"


def batch_line(row, device) -> str:
    return (f"batch={row['batch']}  {row['ms_frame']:7.3f} ms/frame  "
            f"{row['fps']:8.1f} fps  {row['mpix_s']:7.1f} Mpix/s  "
            f"vs batch=1 {row['gain_pct']:5.1f}%  {where(device)}")


def rank_line(row, device) -> str:
    return (f"ranks={row['ranks']:2d} ({row['backend']})  "
            f"{row['ms_frame']:8.2f} ms/frame  {row['fps']:8.1f} fps  "
            f"efficiency {row['efficiency_pct']:5.1f}%  {where(device)}")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="SAD disparity scaling (PyTorch + CUDA)")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--block", type=int, default=7)
    ap.add_argument("--disp", type=int, default=64)
    ap.add_argument("-n", type=int, default=10)
    ap.add_argument("--batch-axis", action="store_true",
                    help="frames per launch on one card")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels (fails without a "
                         "usable GPU); cpu: the plain torch versions")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from steroscopic_hardware_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.batch_axis:
        for row in bench_batch_axis(args, device):
            print(batch_line(row, device), flush=True)
        return 0
    for row in bench_ranks(args, device):
        print(rank_line(row, device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
