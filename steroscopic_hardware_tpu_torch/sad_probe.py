"""SAD probe on one GPU: times B1 (``sad_wta``) and B2 (``sad_lr``, without
and with costs) through their wrappers at 1920x1080, and (``--plans``)
under every launch plan their kernel takes.

    python -m steroscopic_hardware_tpu_torch.sad_probe [--plans] \
        [--blocks 7,16,31] [--maxd 64,128,256] [--frames 1] [--out FILE]

The first line is the card (``nvidia-smi`` name and power limit). Then one
JSON line per measurement; with ``--out`` all of them also go there as a
JSON list. Times are CUDA events, the median of 20 after 3 warm-ups, of one
launch over ``--frames`` frames (default 1) of a seeded random pair (the
right image the left shifted by 5 with noise; the kernels' work does not
depend on the data). Every block size is timed at every max disparity.
``--plans`` calls the kernel library directly under each (columns per
lane, tile height, warps) plan of ``_kernels.SAD_COMPILED`` /
``_kernels.SAD_DS``, checks each output against the wrapper's, and marks
the plan ``sad_plan`` picks. Without ``--plans`` the probe uses nothing but
the wrappers, so it also times a tree whose kernels take no plan.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

H, W = 1080, 1920
SEED = 20261016


def time_ms(fn, warmup=3, reps=20):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def pair(frames=1):
    rng = np.random.default_rng(SEED)
    left = rng.integers(0, 256, (frames, H, W), dtype=np.uint8)
    right = np.clip(np.roll(left, -5, axis=-1).astype(int)
                    + rng.integers(-3, 4, left.shape), 0, 255).astype(np.uint8)
    return (torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda())


def _calls(L, R, block, maxd):
    """(kernel name, wrapper call) of the three SAD kernels."""
    from steroscopic_hardware_tpu_torch.ops import sad

    kw = dict(block_size=block, max_disparity=maxd)
    return [("sad_wta", lambda: (sad.disparity_batch(L, R, **kw),)),
            ("sad_lr", lambda: sad.disparity_lr(L, R, **kw)),
            ("sad_lr_costs",
             lambda: sad.disparity_lr(L, R, with_costs=True, **kw))]


def probe_wrapper(L, R, block, maxd):
    return [{"kernel": name, "block": block, "maxd": maxd,
             "frames": L.shape[0], "ms": time_ms(call)}
            for name, call in _calls(L, R, block, maxd)]


def probe_plans(L, R, block, maxd):
    from steroscopic_hardware_tpu_torch import _kernels

    lib = _kernels._ready(L.device)  # sad_init: the shared-memory opt-in
    F = L.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for name, call in _calls(L, R, block, maxd):
        want = call()
        costs = name == "sad_lr_costs"
        chosen = _kernels.sad_plan(
            F, H, W, block, maxd, costs, sms,
            kernel="sad_wta" if name == "sad_wta" else "sad_lr")
        outs = [torch.empty_like(w) for w in want]
        plans = [(kv, th, ds)
                 for kv, ths in _kernels.SAD_COMPILED[name].items()
                 for th in ths for ds in ((1,) if costs else _kernels.SAD_DS)
                 if ds <= maxd + 1]
        for plan in plans:
            if name == "sad_wta":
                def run(plan=plan):
                    return lib.sad_wta(
                        L.data_ptr(), R.data_ptr(), outs[0].data_ptr(),
                        L.stride(0), R.stride(0), F, H, W, block, maxd, *plan,
                        stream)
            else:
                ptrs = [o.data_ptr() for o in outs] + [None] * (5 - len(outs))

                def run(plan=plan, ptrs=ptrs):
                    return lib.sad_lr(
                        L.data_ptr(), R.data_ptr(), *ptrs, L.stride(0),
                        R.stride(0), F, H, W, block, maxd, int(costs), *plan,
                        stream)
            for o in outs:
                o.zero_()
            err = run()
            torch.cuda.synchronize()
            row = {"kernel": name, "block": block, "maxd": maxd, "frames": F,
                   "kv": plan[0], "th": plan[1], "ds": plan[2],
                   "chosen": plan == (chosen.kv, chosen.th, chosen.ds)}
            if err:
                row["refused"] = err
            else:
                row["equal"] = all(torch.equal(o, w)
                                   for o, w in zip(outs, want))
                row["ms"] = time_ms(run)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--blocks", default="7,16,31",
                    help="comma-separated block sizes (default 7,16,31)")
    ap.add_argument("--maxd", default="64,128,256",
                    help="comma-separated max disparities (default 64,128,256)")
    ap.add_argument("--frames", type=int, default=1,
                    help="frames per launch (default 1)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sad_probe needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    L, R = pair(args.frames)
    rows = []
    for maxd in (int(m) for m in args.maxd.split(",")):
        for block in (int(b) for b in args.blocks.split(",")):
            found = probe_wrapper(L, R, block, maxd)
            if args.plans:
                found += probe_plans(L, R, block, maxd)
            for row in found:
                row["card"] = card
                print(json.dumps(row), flush=True)
            rows += found
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
