"""Headline benchmark of the port: SAD disparity throughput on one card, the
counterpart of the repository's root ``bench.py``.

Config #1 of BASELINE.json: a 640x480 stereo pair, block 7, maxDisparity
64, through ``ops/sad.py::disparity`` (on a CUDA tensor one launch of B1,
``sad_wta``). Prints ONE JSON line with the original's fields:
``metric`` (``disparity_fps_640x480_b7_d64``), ``value`` (fps), ``unit``,
``vs_baseline`` (fps / 30, the real-time target of BASELINE.md) and
``detail``, which names the platform (``gpu``) and the card's name and
power limit as ``nvidia-smi`` gives them.

    python -m steroscopic_hardware_tpu_torch.bench --synthetic
    python -m steroscopic_hardware_tpu_torch.bench --left L.png --right R.png

Timing protocol (the original's, on eager launches): each frame's uint8
output feeds the next frame's left input on the device, so no frame can
be skipped or overlapped with the one before it; an 8-byte fetch closes
each chain. Chains of N1 = 25 and N2 = 100 frames, the best of 3 of each,
on a host clock started after ``torch.cuda.synchronize()``; the per-frame
time is the two-point difference (T(N2) - T(N1)) / (N2 - N1), which
cancels every cost a chain pays once (the first launch's latency, the
fetch).

Not a CUDA graph: the original's ``lax.scan`` made one dispatch of the
whole chain, while here every frame is a launch from Python. Where a
frame's kernel is shorter than the launch path on the host, the per-frame
number is the host's dispatch rate, not the kernel's time.

Guard: the kernel's map of the original's crop (rows 200-263, columns
200-327) equals ``ops/sad_golden.disparity_numpy`` bit for bit, and the
full frame equals ``disparity_plain`` on the same device. A failed guard,
or a non-positive difference, prints the original's error line instead
and exits 1.

Input: ``--left`` / ``--right`` (the reference's ``L_00001.png`` /
``R_00001.png`` under ``TESTDATA`` by default; absent files raise), or
``--synthetic``, a seeded 640x480 textured pair. ``--device cpu`` runs
the plain torch versions (tests only).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from steroscopic_hardware_tpu_torch.tools.run_sweep import TESTDATA
from steroscopic_hardware_tpu_torch.utils.device import card_name

METRIC = "disparity_fps_640x480_b7_d64"
BLOCK, MAXD = 7, 64
TARGET_FPS = 30.0
N1, N2 = 25, 100
REPS = 3
PROTOCOL = f"two-point differenced chain of eager launches, best of {REPS}"
CROP = np.s_[200:264, 200:328]
SIZE = (480, 640)


def textured_pair(rng, size):
    """A uint8 textured pair from ``rng``: the right image is the left
    shifted 6 px left with +-3 grey levels of noise (the original tools'
    pair)."""
    left = rng.integers(0, 256, size, dtype=np.uint8)
    right = np.clip(np.roll(left, -6, 1).astype(int)
                    + rng.integers(-3, 4, size), 0, 255).astype(np.uint8)
    return left, right


def synthetic_pair():
    """The ``--synthetic`` pair: :func:`textured_pair` at 640x480, seed 0."""
    return textured_pair(np.random.default_rng(0), SIZE)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _first_leaf(carry):
    while isinstance(carry, (tuple, list)):
        carry = carry[0]
    return carry


def diff_time(step, carry0, n1: int, n2: int):
    """Two-point differenced chained timing of ``step`` (carry -> carry):
    ``(T(n2) - T(n1)) / (n2 - n1)`` seconds a step, each T the best of
    ``REPS`` chains on a host clock started after a synchronise and
    stopped by an 8-element fetch of the carry's first tensor. Both chain
    lengths run once first (warm-up). Raises when T(n2) <= T(n1)."""
    device = _first_leaf(carry0).device

    def chain(length):
        c = carry0
        for _ in range(length):
            c = step(c)
        return _first_leaf(c).reshape(-1)[:8].cpu()

    chain(n1)
    chain(n2)
    t1 = t2 = float("inf")
    for _ in range(REPS):
        _sync(device)
        t0 = time.perf_counter()
        chain(n1)
        t1 = min(t1, time.perf_counter() - t0)
        _sync(device)
        t0 = time.perf_counter()
        chain(n2)
        t2 = min(t2, time.perf_counter() - t0)
    if t2 <= t1:
        raise RuntimeError(
            f"non-positive timing difference (T({n1})={t1 * 1e3:.3f}ms >= "
            f"T({n2})={t2 * 1e3:.3f}ms)")
    return (t2 - t1) / (n2 - n1)


def _error(msg: str) -> dict:
    return {"metric": METRIC, "value": 0.0, "unit": "fps",
            "vs_baseline": 0.0, "error": msg}


def _tensors(left, right, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (left, right))


def guard(left, right, device) -> str | None:
    """The error message of a failed guard, or None: the kernel's map of
    ``CROP`` of a 640x480 host pair equals ``disparity_numpy`` bit for bit,
    and its full frame equals ``disparity_plain`` on ``device``."""
    from steroscopic_hardware_tpu_torch.ops.sad import (
        disparity,
        disparity_plain,
    )
    from steroscopic_hardware_tpu_torch.ops.sad_golden import (
        disparity_numpy,
    )

    L, R = _tensors(left, right, device)
    kw = dict(block_size=BLOCK, max_disparity=MAXD)
    want = disparity_numpy(left[CROP], right[CROP], BLOCK, MAXD)
    got = disparity(L[CROP].contiguous(), R[CROP].contiguous(), **kw)
    if not np.array_equal(want, got.cpu().numpy()):
        return "bit-exactness check failed"
    if not torch.equal(disparity(L, R, **kw), disparity_plain(L, R, **kw)):
        return ("bit-exactness check failed (full frame against "
                "disparity_plain)")
    return None


def run(left, right, device) -> dict:
    """The bench's line as a dict (with ``error`` when the guard fails or
    the difference is not positive) for a 640x480 uint8 host pair on
    ``device``: the guard, then chains of N1 and N2 frames."""
    from steroscopic_hardware_tpu_torch.ops.sad import disparity

    device = torch.device(device)
    err = guard(left, right, device)
    if err is not None:
        return _error(err)
    L, R = _tensors(left, right, device)

    def step(x):
        return disparity(x, R, block_size=BLOCK, max_disparity=MAXD)

    try:
        dt = diff_time(step, L, N1, N2)
    except RuntimeError as e:
        return _error(str(e))
    fps = 1.0 / dt
    return {
        "metric": METRIC,
        "value": fps,
        "unit": "fps",
        "vs_baseline": fps / TARGET_FPS,
        "detail": {
            "mpix_per_s": left.size / 1e6 / dt,
            "ms_per_frame": dt * 1e3,
            "platform": "gpu" if device.type == "cuda" else device.type,
            "card": card_name(device),
            "block_size": BLOCK,
            "max_disparity": MAXD,
            "chain": [N1, N2],
            "protocol": PROTOCOL,
        },
    }


def load_pair(args):
    if args.synthetic:
        return synthetic_pair()
    from steroscopic_hardware_tpu_torch.ops.gray import load_gray

    for path in (args.left, args.right):
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} does not exist: give --left/--right, or "
                "--synthetic for the seeded pair")
    return load_gray(args.left), load_gray(args.right)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--left", default=os.path.join(TESTDATA, "L_00001.png"))
    ap.add_argument("--right", default=os.path.join(TESTDATA, "R_00001.png"))
    ap.add_argument("--synthetic", action="store_true",
                    help="a seeded 640x480 textured pair instead of files")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels (fails without a "
                         "usable GPU); cpu: the plain torch versions")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from steroscopic_hardware_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    left, right = load_pair(args)
    line = run(left, right, device)
    print(json.dumps(line), flush=True)
    return 1 if "error" in line else 0


if __name__ == "__main__":
    sys.exit(main())
