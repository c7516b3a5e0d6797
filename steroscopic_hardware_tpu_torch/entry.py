"""Entry points, the counterpart of the repository's ``__graft_entry__.py``.

``entry()``             the single-card forward step: SAD disparity at
                        BASELINE config #1's shapes (a 480x640 uint8 pair,
                        block 7, maxDisparity 64), B1 (``sad_wta``) on a
                        CUDA tensor, its plain torch version on a CPU one.
``dryrun_multichip(n)`` the sharded pipeline once over n ranks
                        (``parallel.dryrun``'s cases: row-band SAD with its
                        halo exchange, scanline-sharded SGM, landmark-
                        sharded BA, the edge-sharded pose graph), raising
                        unless every stage matches one rank.

    python -m steroscopic_hardware_tpu_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from steroscopic_hardware_tpu_torch.utils.device import resolve_device

BLOCK, MAX_DISPARITY = 7, 64
SIZE = (480, 640)


def entry(device="cuda"):
    """``(fn, (left, right))``: ``fn`` is ``ops.sad.disparity`` at block 7
    / maxDisparity 64, the pair drawn from ``np.random.default_rng(0)`` as
    the original draws it, on ``device`` (cuda raises without a usable
    GPU)."""
    from steroscopic_hardware_tpu_torch.ops.sad import disparity
    dev = resolve_device(device)

    def fn(left, right):
        return disparity(left, right, block_size=BLOCK,
                         max_disparity=MAX_DISPARITY)

    rng = np.random.default_rng(0)
    left = rng.integers(0, 256, SIZE, dtype=np.uint8)
    right = rng.integers(0, 256, SIZE, dtype=np.uint8)
    return fn, (torch.from_numpy(left).to(dev),
                torch.from_numpy(right).to(dev))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The dry run's cases over ``n_devices`` ranks of this host (nccl on
    cards, one card a rank; gloo on the CPU) at the original's shapes (8
    rows a rank, 128 columns), each against the same case on one rank.
    Returns the stages' comparison; raises RuntimeError without a usable
    GPU for cuda, and unless SAD and SGM match bit for bit and BA and the
    pose graph within the JAX tests' tolerances."""
    from steroscopic_hardware_tpu_torch.parallel import dryrun, multihost
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    cases = dryrun.dryrun_cases(n_devices, 8 * n_devices, 128)
    sharded = dryrun.launch_cases(cases, n_devices, backend=backend,
                                  device=device)
    single = dryrun.single_rank(cases, multihost.rank_device(
        backend, device, 0, 1))
    stages = dryrun.compare(sharded, single)
    if not (stages["sad"]["equal"] and stages["sgm"]["equal"]
            and stages["ba"]["within_tolerance"]
            and stages["pg"]["within_tolerance"]):
        raise RuntimeError(f"dry run over {n_devices} ranks differs from "
                           f"one rank: {stages}")
    return stages


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the entry step, then the dry run over every card")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    fn, pair = entry(args.device)
    print("entry ok:", tuple(fn(*pair).shape))
    cuda = torch.device(args.device).type == "cuda"
    dryrun_multichip(torch.cuda.device_count() if cuda else 1, args.device)
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
