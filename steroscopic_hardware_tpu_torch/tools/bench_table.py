"""The kernel table on one card, the counterpart of the repository's
``tools/bench_table.py``: the same rows under the same names, each timed
by ``bench.diff_time``'s two-point differenced chain.

    python -m steroscopic_hardware_tpu_torch.tools.bench_table \\
        [--filter sgm] [--scale 1.0] [--json out] [--device cuda]

Protocol (``steroscopic_hardware_tpu_torch/bench.py``): each step's uint8
output feeds the next step's input on the device, an 8-byte fetch closes
the chain, and the per-frame time is (T(2n) - T(n // 2)) / (2n - n // 2),
each T the best of 3 on a host clock started after a synchronise. ``n``
is the original's per row, times ``--scale`` (at least 2). The chain is
eager launches, not one dispatch as the original's ``lax.scan``: where a
step's kernels are shorter than its launches from Python (the SLAM and SGM
rows, whose plain-torch parts launch hundreds to thousands of small
kernels), a row reads the host's launch rate, not the device's time.

The rows, in the original's order:

* SAD ``disparity`` (B1, ``sad_wta``) at 640x480 b7 d64, 1080p b7 / b16
  d64 and b31 d256, 4K b9 d128;
* ``disparity_batch`` with B = 1, 2, 4, 8 VGA frames a launch (per frame);
* fused LEFT+RIGHT (``disparity_lr``, B2, ``sad_lr``) and LR + SUBPIXEL
  (``disparity_subpixel``: B2 with costs, then the parabola);
* SGM (``sgm_disparity`` / ``sgm_disparity_lr``, subpixel: the census
  costs, B4 ``sgm_transpose_add``, B3 ``sgm_aggregate`` twice, the
  argmin) at VGA and 1080p, d64 / 128 / 256, and fused LR at VGA;
* SLAM: the VGA front end (``models/slam.py::_frame_frontend``: the
  disparity, FAST / ORB, triangulation), and the whole tracking step
  (front end, ``ops/matching.match`` against the previous frame,
  ``pnp_ransac``) with the ``sad``, ``sgm`` and ``sgm_half`` front ends
  at VGA and 1080p. A tracking step threads its result back into the
  next image as a flipped low bit, as the original does; its RANSAC
  scores for step i come from the CPU generator seeded (0 << 32) + i
  (``models/slam.frame_scores``), drawn and copied each step as
  ``StereoVO`` does.

A row that raises prints ``FAILED`` and records an ``error``; the table
goes on. ``--json`` writes ``{"device", "protocol", "rows"}``; each row
has ``name``, ``n``, ``ms``, ``mpix_s`` and ``fps`` (per frame), or
``error``. On a card the command line's rows also have, from 3 more
chained steps under ``torch.profiler``, ``device_ms`` (the kernels' and
copies' summed device time a frame), ``kernels`` (device launches a
frame) and ``device_share`` (``device_ms / ms``): near 1 the row is bound
by the device, well below it by the host's launches.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from steroscopic_hardware_tpu_torch.bench import (
    PROTOCOL,
    diff_time,
    textured_pair,
)
from steroscopic_hardware_tpu_torch.utils.device import card_name


def diff_time_n(step, carry0, n: int) -> float:
    """The original's chain lengths for a row of ``n``: n // 2 and 2n."""
    return diff_time(step, carry0, max(1, n // 2), 2 * n)


# torch.profiler's device-side spans of the record_function labels of
# models/slam.py, which are not kernels
LABELS = ("vo.", "slam.")


def device_profile(step, carry0, steps: int = 3):
    """(device ms, device launches) a step: the summed device time of the
    kernels and copies of ``steps`` chained steps under ``torch.profiler``,
    after one unprofiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    c = step(carry0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            c = step(c)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(LABELS)]
    us = sum(e.time_range.elapsed_us() for e in kernels)
    return us / 1e3 / steps, len(kernels) / steps


def _u8(x, scale: float):
    return (x * scale).clamp(0, 255).to(torch.uint8)


# -- steps: each maps a chain's carry to the next --------------------------------

def sad_step(R, b, d):
    from steroscopic_hardware_tpu_torch.ops.sad import disparity

    return lambda x: disparity(x, R, block_size=b, max_disparity=d)


def batch_step(Rs, b, d):
    from steroscopic_hardware_tpu_torch.ops.sad import disparity_batch

    return lambda x: disparity_batch(x, Rs, block_size=b, max_disparity=d)


def lr_step(R, b=7, d=64):
    from steroscopic_hardware_tpu_torch.ops.sad import disparity_lr

    def step(x):
        dL, _ = disparity_lr(x, R, block_size=b, max_disparity=d)
        return (dL * 255 // d).to(torch.uint8)
    return step


def subpixel_step(R, b=7, d=64):
    from steroscopic_hardware_tpu_torch.ops.sad import disparity_subpixel

    def step(x):
        dL, _ = disparity_subpixel(x, R, block_size=b, max_disparity=d)
        return _u8(dL, 4.0)
    return step


def sgm_step(R, d, lr=False):
    from steroscopic_hardware_tpu_torch.ops import sgm

    def step(x):
        if lr:
            disp, _ = sgm.sgm_disparity_lr(x, R, max_disparity=d,
                                           subpixel=True)
        else:
            disp = sgm.sgm_disparity(x, R, max_disparity=d, subpixel=True)
        return _u8(disp, 4.0)
    return step


def slam_frontend(R, h, w, d, frontend, kpts=512):
    """The front end of a (h, w) frame against the fixed right image."""
    from steroscopic_hardware_tpu_torch.models.slam import _frame_frontend

    intr = (h / 2.0, h / 2.0, w / 2.0, h / 2.0)
    return intr, lambda x: _frame_frontend(
        x, R, block_size=7, max_disparity=d, fast_threshold=20,
        max_keypoints=kpts, intr=intr, baseline=0.4, frontend=frontend)


def frontend_step(R, h, w, d, frontend):
    """Front end only: every output folds into the next image's low bit."""
    _, fe = slam_frontend(R, h, w, d, frontend)

    def step(x):
        xy, xy_sub, desc, valid, pts, ok = fe(x)
        bump = (xy.sum() + desc.sum()
                + torch.round(pts.abs().sum()).to(torch.int64)
                + ok.sum() + valid.sum()
                + torch.round(xy_sub.sum()).to(torch.int64))
        return x ^ (bump.to(torch.uint8) & 1)
    return step


def track_step(R, h, w, d, frontend, kpts=512):
    """Front end, matching against the carried previous features and
    RANSAC PnP; carry (image, features, step index)."""
    from steroscopic_hardware_tpu_torch.models.slam import frame_scores
    from steroscopic_hardware_tpu_torch.models.vo import pnp_ransac
    from steroscopic_hardware_tpu_torch.ops.matching import match

    intr, fe = slam_frontend(R, h, w, d, frontend, kpts)
    gen = torch.Generator()

    def step(c):
        x, (pxy, pxy_sub, pdesc, pvalid, ppts, pok), i = c
        xy, xy_sub, desc, valid, pts, ok = fe(x)
        idx, good = match(pdesc, desc, pvalid, valid, ratio=0.9,
                          max_distance=80.0)
        good = good & pok
        uv = xy_sub[idx].to(torch.float32)
        xi_rel, _, n_inl = pnp_ransac(
            ppts, uv, good, intr, frame_scores(gen, 0, i, kpts, x.device))
        bump = n_inl + torch.round(xi_rel.abs().sum() * 1e4).to(torch.int64)
        return (x ^ (bump.to(torch.uint8) & 1),
                (xy, xy_sub, desc, valid, pts, ok), i + 1)
    return fe, step


# -- the rows ---------------------------------------------------------------------

def specs():
    """[(name, n, make, costs)] in the original's order. ``make(pair)``
    takes ``pair(h, w) -> (L, R)`` (device uint8 tensors) and returns
    ``(step, carry0, pixels a step, frames a step)``; ``costs`` is true
    where the step's ``sad_lr`` launches carry the costs (B2s: the
    subpixel row, and the SLAM rows, whose ``sad`` front end is
    ``disparity_subpixel``)."""
    rows = []

    def sad_plain(h, w, b, d):
        def make(pair):
            L, R = pair(h, w)
            return sad_step(R, b, d), L, h * w, 1
        return make

    rows += [
        ("640x480 b7 d64 plain", 50, sad_plain(480, 640, 7, 64), False),
        ("1920x1080 b7 d64 plain", 20, sad_plain(1080, 1920, 7, 64), False),
        ("1920x1080 b16 d64 plain", 20, sad_plain(1080, 1920, 16, 64),
         False),
        ("1920x1080 b31 d256 plain (envelope worst)", 6,
         sad_plain(1080, 1920, 31, 256), False),
        ("3840x2160 b9 d128 plain", 5, sad_plain(2160, 3840, 9, 128), False),
    ]

    def batch(F):
        def make(pair):
            # the original's draws: the lefts of F pairs, then the rights
            # of F more
            Ls = torch.stack([pair(480, 640)[0] for _ in range(F)])
            Rs = torch.stack([pair(480, 640)[1] for _ in range(F)])
            return batch_step(Rs, 7, 64), Ls, 480 * 640 * F, F
        return make

    rows += [(f"640x480 b7 d64 batch B={F} (per frame)", 30, batch(F), False)
             for F in (1, 2, 4, 8)]

    def lr(subpixel):
        def make(pair):
            L, R = pair(480, 640)
            return (subpixel_step if subpixel else lr_step)(R), L, 480 * 640, 1
        return make

    rows += [("640x480 b7 d64 fused LEFT+RIGHT (one sweep)", 30, lr(False),
              False),
             ("640x480 b7 d64 fused LR + SUBPIXEL", 30, lr(True), True)]

    def sgm(h, w, d, lr=False):
        def make(pair):
            L, R = pair(h, w)
            return sgm_step(R, d, lr), L, h * w, 1
        return make

    rows += [
        ("640x480 SGM d64 subpixel", 20, sgm(480, 640, 64), False),
        ("640x480 SGM d64 fused LR", 16, sgm(480, 640, 64, lr=True), False),
        ("640x480 SGM d128 subpixel", 12, sgm(480, 640, 128), False),
        ("1920x1080 SGM d64 subpixel", 8, sgm(1080, 1920, 64), False),
        ("1920x1080 SGM d128 subpixel", 5, sgm(1080, 1920, 128), False),
        ("640x480 SGM d256 subpixel", 8, sgm(480, 640, 256), False),
        ("1920x1080 SGM d256 subpixel", 3, sgm(1080, 1920, 256), False),
    ]

    def slam(h, w, d, frontend, track=True):
        def make(pair):
            L, R = pair(h, w)
            if not track:
                return frontend_step(R, h, w, d, frontend), L, h * w, 1
            fe, step = track_step(R, h, w, d, frontend)
            return step, (L, fe(L), 0), h * w, 1
        return make

    rows += [
        ("640x480 SLAM frontend SAD d64 (disp+feat+triang)", 16,
         slam(480, 640, 64, "sad", track=False), True),
        ("640x480 SLAM track SAD d64 (frontend+match+PnP)", 16,
         slam(480, 640, 64, "sad"), True),
        ("640x480 SLAM track SGM d64 (frontend+match+PnP)", 10,
         slam(480, 640, 64, "sgm"), True),
        ("1920x1080 SLAM track SAD d64 (frontend+match+PnP)", 8,
         slam(1080, 1920, 64, "sad"), True),
        ("1920x1080 SLAM track SGM d64 (frontend+match+PnP)", 4,
         slam(1080, 1920, 64, "sgm"), True),
        ("1920x1080 SLAM track SGMhalf d64 (pyramid census frontend)", 8,
         slam(1080, 1920, 64, "sgm_half"), True),
        ("640x480 SLAM track SGMhalf d64 (pyramid census frontend)", 12,
         slam(480, 640, 64, "sgm_half"), True),
    ]
    return rows


def names() -> list[str]:
    return [name for name, *_ in specs()]


def seeded_pairs(device, seed: int = 0):
    """``pair(h, w)``: the original's textured pairs
    (``bench.textured_pair``), one seeded stream in call order, on
    ``device``."""
    rng = np.random.default_rng(seed)

    def pair(h, w):
        return tuple(torch.from_numpy(a).to(device)
                     for a in textured_pair(rng, (h, w)))
    return pair


def row_record(name, dt, npix, per=1) -> dict:
    dt = dt / per
    return {"name": name, "ms": dt * 1e3, "mpix_s": npix / per / 1e6 / dt,
            "fps": 1 / dt}


def table(device, *, scale: float = 1.0, filter: str = "",
          profile: bool = False, out=print):
    """Times every row whose name contains ``filter`` (with ``profile``, a
    card only, also its device time); returns the row records (a failed
    row has ``error``) and prints each as it lands."""
    pair = seeded_pairs(device)
    results = []
    for name, n, make, _ in specs():
        if filter and filter not in name:
            continue
        n = max(2, int(n * scale))
        try:
            step, carry0, npix, per = make(pair)
            rec = row_record(name, diff_time_n(step, carry0, n), npix, per)
            rec["n"] = n
            line = (f"{name:55s} {rec['ms']:8.3f} ms  {rec['mpix_s']:7.1f} "
                    f"Mpix/s {rec['fps']:8.1f} fps")
            if profile:
                dev_ms, kernels = device_profile(step, carry0)
                rec.update(device_ms=dev_ms / per, kernels=kernels / per,
                           device_share=dev_ms / per / rec["ms"])
                line += (f"  device {rec['device_ms']:.3f} ms "
                         f"({rec['device_share']:.2f}) in "
                         f"{rec['kernels']:.1f} launches")
            out(line)
        except Exception as e:  # noqa: BLE001 -- keep the table going
            out(f"{name:55s} FAILED {type(e).__name__}: {str(e)[:160]}")
            rec = {"name": name, "n": n, "error": str(e)[:300]}
        results.append(rec)
    return results


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="the kernel table under the differenced chain")
    ap.add_argument("--filter", default="", help="only rows whose name "
                    "contains this substring")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every chain length (at least 2)")
    ap.add_argument("--json", default="", help="dump rows as JSON here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels (fails without a "
                         "usable GPU); cpu: the plain torch versions")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from steroscopic_hardware_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    card = card_name(device)
    print(f"device: {card}", flush=True)
    rows = table(device, scale=args.scale, filter=args.filter,
                 profile=device.type == "cuda",
                 out=lambda s: print(s, flush=True))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": card, "protocol": PROTOCOL, "rows": rows},
                      f, indent=1)
        print(f"wrote {args.json}", flush=True)
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
