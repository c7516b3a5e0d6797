"""SGM probe on one GPU: times B3 (``sgm_aggregate``) through its wrapper at
1920x1080, B3 under every launch plan its kernels take (``--plans``), the
device time of served SGM frames by kernel (``--profile``), B4
(``sgm_transpose_add``) alone (``--transpose``) and B5 (``sgm_epilogue``)
alone (``--epilogue``).

    python -m steroscopic_hardware_tpu_torch.sgm_probe [--plans] \
        [--profile [--fused]] [--transpose | --epilogue] [--maxd 64] \
        [--out FILE]

The first line is the card (``nvidia-smi`` name and power limit). Then one
JSON line per measurement; with ``--out`` all of them also go there as a
JSON list. Times are CUDA events, the median of 20 after 3 warm-ups. B3
runs on a seeded random cost volume in the served chain's storage tiers:
the vertical pass (D, H, W) from bfloat16, the horizontal one (D, W, H)
from uint8, each stored in bfloat16 (the served chain), uint8 (the fused
one) or float32 (the tier of fractional penalties). ``--plans`` times B3
under every plan of the wide kernel (each columns a block and ring depth
whose shared memory fits) and, up to D = 136, of the lane-group kernel,
and checks every plan's output against the wrapper's before timing it.
``--profile`` runs ``models.blockmatch.sgm_one`` (without and with the
LR check; with ``--fused`` also the same frame through
``sgm_disparity(epilogue="fused")``, B5's chain) on a seeded textured
pair, 10 frames after 3 warm-ups, under ``torch.profiler``: per kernel its
device time and launches per frame, and per frame the sum of all kernels'
device time beside the wall time between two CUDA events around the 10
frames, and beside the frame's time without the profiler (the median of
10). ``--transpose`` replaces the B3 rows with B4's three served forms at
1080p on seeded volumes: the cost form uint8 (D, W, H) -> bfloat16 (D, H,
W), and the summed form (D, W, H) + (D, H, W) bfloat16 -> bfloat16 and ->
float32 (the float32 tier), each through the wrapper beside its byte
bound; with ``--plans`` also under launch plans around the one
``_kernels.transpose_add_plan`` picks (each access width the library
takes at that shape, and other d planes per block), each checked against
the wrapper's output. ``--epilogue`` replaces them with B5 at 1080p,
subpixel, on seeded aggregates in each storage tier (uint8, bfloat16,
float32): through the wrapper, and the kernel alone (its device time per
launch under ``torch.profiler``, 20 launches after 3 warm-ups), beside the
byte bound; with ``--plans`` also under launch plans around the one
``_kernels.sgm_epilogue_plan`` picks (each ring depth the library
compiled, each narrower access width), at 1080p and on a 240-column
W-band of the frame, each checked against the wrapper's output. Without
``--plans``, ``--transpose`` and ``--epilogue`` use only the wrappers, so
a copy of this file times a parent commit.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from steroscopic_hardware_tpu_torch.utils.device import card_name

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


def _tiers(maxd):
    from steroscopic_hardware_tpu_torch.ops import sgm

    rng = np.random.default_rng(SEED)
    D = maxd + 1
    cost_t = torch.from_numpy(
        rng.integers(0, 25, (D, W, H), dtype=np.uint8)).cuda()
    cost = sgm.transpose_add(cost_t, out_dtype=torch.bfloat16)
    u8, bf16, f32 = torch.uint8, torch.bfloat16, torch.float32
    return [("vertical bf16->bf16", cost, bf16),
            ("horizontal u8->bf16", cost_t, bf16),
            ("vertical bf16->u8", cost, u8),
            ("horizontal u8->u8", cost_t, u8),
            ("vertical bf16->f32", cost, f32),
            ("horizontal u8->f32", cost_t, f32)]


def probe_wrapper(maxd):
    from steroscopic_hardware_tpu_torch.ops import sgm

    rows = []
    for what, c, outd in _tiers(maxd):
        ms = time_ms(lambda: sgm.aggregate_axis(c, 1.0, 8.0, out_dtype=outd))
        rows.append({"kernel": "sgm_aggregate", "stage": what,
                     "maxd": maxd, "ms": ms})
    return rows


def probe_plans(maxd):
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.ops import sgm

    lib = _kernels.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    D = maxd + 1
    rows = []
    for what, c, outd in _tiers(maxd):
        want = sgm.aggregate_axis(c, 1.0, 8.0, out_dtype=outd)
        out = torch.empty_like(want)
        _, S, K = c.shape
        stream = torch.cuda.current_stream().cuda_stream
        plans = []
        dpt = min(n for n in _kernels.WIDE_DPTS if 32 * n >= D)
        for cols in _kernels.WIDE_COLUMNS:
            for ring in _kernels.WIDE_RINGS:
                if _kernels.wide_smem(dpt, cols, c.element_size(),
                                      want.element_size(),
                                      ring) <= _kernels.SMEM_LIMIT:
                    plans.append(_kernels.AggregatePlan(
                        1, 32, dpt, 32 * cols, -(-K // cols), ring))
        for lanes in (1, 2, 4, 8, 16, 32):
            fits = [n for n in _kernels.AGG_DPTS if lanes * n >= D]
            for block in ((32, 64, 128, 256)
                          if fits and D <= _kernels.AGG_LANES_MAX_D else ()):
                plans.append(_kernels.AggregatePlan(
                    0, lanes, min(fits), block, -(-K // (block // lanes)),
                    0))
        pace = torch.zeros(_kernels.WIDE_PACE_SLOTS, dtype=torch.int32,
                           device=c.device)
        for plan in plans:
            def run(plan=plan):
                # the wrapper's pacing counters, zeroed for each launch
                pace.zero_()
                err = lib.sgm_aggregate(
                    c.data_ptr(), out.data_ptr(), D, S, K,
                    _kernels._TYPE_CODES[c.dtype],
                    _kernels._TYPE_CODES[outd], 1.0, 8.0, *plan,
                    pace.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"plan {plan} refused ({err})")

            out.zero_()
            run()
            torch.cuda.synchronize()
            rows.append({
                "kernel": "sgm_aggregate", "stage": what, "maxd": maxd,
                "plan": plan._asdict(),
                "chosen": plan == _kernels.sgm_aggregate_plan(
                    D, S, K, sms, c.element_size(), want.element_size()),
                "equal": bool(torch.equal(out, want)), "ms": time_ms(run)})
    return rows


MEM_BPS = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet


def _transpose_forms(maxd):
    """(form, aT, b, out dtype) of B4's served forms at 1080p."""
    rng = np.random.default_rng(SEED + 7)
    D = maxd + 1
    bf16 = torch.bfloat16
    cost_t = torch.from_numpy(
        rng.integers(0, 25, (D, W, H), dtype=np.uint8)).cuda()
    agg_ht = torch.from_numpy(
        rng.integers(0, 120, (D, W, H), dtype=np.uint8)).cuda().to(bf16)
    agg_v = torch.from_numpy(
        rng.integers(0, 120, (D, H, W), dtype=np.uint8)).cuda().to(bf16)
    return [("cost u8->bf16", cost_t, None, bf16),
            ("summed bf16+bf16->bf16", agg_ht, agg_v, bf16),
            ("summed bf16+bf16->f32", agg_ht, agg_v, torch.float32)]


def _transpose_bytes(aT, b, out_dtype):
    n = aT.numel()
    return n * (aT.element_size() * (1 if b is None else 2)
                + torch.empty((), dtype=out_dtype).element_size())


def probe_transpose(maxd, plans):
    from steroscopic_hardware_tpu_torch.ops import sgm

    rows = []
    for form, aT, b, outd in _transpose_forms(maxd):
        nbytes = _transpose_bytes(aT, b, outd)
        ms = time_ms(lambda: sgm.transpose_add(aT, b, out_dtype=outd))
        rows.append({"kernel": "sgm_transpose_add", "form": form,
                     "maxd": maxd, "ms": ms, "MB": nbytes / 1e6,
                     "bound_ms": nbytes / MEM_BPS * 1e3})
        if plans:
            rows += _transpose_plans(form, maxd, aT, b, outd)
        torch.cuda.empty_cache()
    return rows


def _transpose_plans(form, maxd, aT, b, outd):
    """B4 under the chosen plan and, one field at a time, every other
    access width the library takes at this shape and other d planes per
    block, called through the library."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.ops import sgm

    lib = _kernels.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    D, B, A = aT.shape
    want = sgm.transpose_add(aT, b, out_dtype=outd)
    out = torch.empty_like(want)
    chosen = _kernels.transpose_add_plan(D, B, A, aT.dtype, outd,
                                         b is not None, sms)
    sa, so = aT.element_size(), out.element_size()

    def widths(elem, cap, pitch):
        return [w for w in _kernels.TRANSPOSE_WIDTHS
                if elem <= w <= cap and pitch % w == 0]

    plans = [chosen]
    plans += [chosen._replace(wa=w) for w in widths(sa, 16, A * sa)]
    if b is not None:
        plans += [chosen._replace(wb=w)
                  for w in widths(sa, min(16, 8 * sa), B * sa)]
    plans += [chosen._replace(wo=w) for w in widths(so, 16, B * so)]
    for dpb in (1, 2, 4, 8, 16, 32, D):
        plans.append(chosen._replace(
            dpb=dpb, grid=chosen.grid[:2] + (-(-D // dpb),)))
    seen, rows = set(), []
    stream = torch.cuda.current_stream().cuda_stream
    for plan in plans:
        if plan in seen:
            continue
        seen.add(plan)

        def run(plan=plan):
            err = lib.sgm_transpose_add(
                aT.data_ptr(), None if b is None else b.data_ptr(),
                out.data_ptr(), D, B, A, _kernels._TYPE_CODES[aT.dtype],
                _kernels._TYPE_CODES[outd], *plan[:4], *plan.grid, stream)
            if err:
                raise RuntimeError(f"plan {plan} refused ({err})")

        out.zero_()
        run()
        torch.cuda.synchronize()
        rows.append({"kernel": "sgm_transpose_add", "form": form,
                     "maxd": maxd, "plan": plan._asdict(),
                     "chosen": plan == chosen,
                     "equal": bool(torch.equal(out, want)),
                     "ms": time_ms(run)})
    return rows


def profile_frames(frame, frames=10, warmup=3):
    """Device time by kernel of ``frame()`` under ``torch.profiler``, after
    ``warmup`` unprofiled calls: ({kernel name: (us, launches)} over the
    ``frames`` calls, wall ms of the profiled calls between two CUDA
    events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        frame()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(frames):
            frame()
        end.record()
        end.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = per.get(e.name, (0.0, 0))
            per[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return per, start.elapsed_time(end)


def sgm_frame(left, right, maxd, lr, fused):
    """One served SGM frame (``models.blockmatch.sgm_one``), or with
    ``fused`` the same frame through ``sgm_disparity(epilogue="fused")``
    (B5 in place of B4's summed form and the plain argmin / parabola)."""
    from steroscopic_hardware_tpu_torch.models.blockmatch import (
        _sgm_u8, sgm_one)
    from steroscopic_hardware_tpu_torch.ops.sgm import sgm_disparity

    if fused:
        return _sgm_u8(sgm_disparity(left, right, max_disparity=maxd, P1=1.0,
                                     P2=8.0, subpixel=True, epilogue="fused"),
                       maxd)
    return sgm_one(left, right, max_disparity=maxd, p1=1.0, p2=8.0,
                   subpixel=True, lr=lr, threshold=1.0)


def probe_profile(maxd, lr, fused=False, frames=10):
    from steroscopic_hardware_tpu_torch.serve_probe import textured_pair

    left, right = (torch.from_numpy(a).cuda()
                   for a in textured_pair(SEED, H, W))

    def frame():
        sgm_frame(left, right, maxd, lr, fused)

    per, wall = profile_frames(frame, frames)
    mode = "sgm-fused" if fused else "sgm-lr-check" if lr else "sgm"
    rows = [{"profile": mode, "maxd": maxd, "kernel": name[:160],
             "ms_per_frame": us / 1e3 / frames, "launches_per_frame": n / frames}
            for name, (us, n) in sorted(per.items(), key=lambda kv: -kv[1][0])]
    rows.append({"profile": mode, "maxd": maxd, "kernel": "all kernels",
                 "ms_per_frame": sum(us for us, _ in per.values()) / 1e3 / frames,
                 "launches_per_frame": sum(n for _, n in per.values()) / frames,
                 "wall_ms_per_frame": wall / frames,
                 "wall_ms_per_frame_unprofiled": time_ms(frame, reps=frames)})
    return rows


EPILOGUE_TIERS = (torch.uint8, torch.bfloat16, torch.float32)


def _epilogue_volumes(maxd):
    """Seeded uint8 agg_v (D, H, W) and agg_ht (D, W, H) at 1080p, values
    0..119 as the uint8 tier's aggregates hold (the other tiers take the
    same values)."""
    rng = np.random.default_rng(SEED + 11)
    D = maxd + 1
    return (torch.from_numpy(
                rng.integers(0, 120, (D, H, W), dtype=np.uint8)).cuda(),
            torch.from_numpy(
                rng.integers(0, 120, (D, W, H), dtype=np.uint8)).cuda())


def kernel_ms(fn, match, reps=20):
    """Device ms of one launch of the kernels whose name holds ``match``
    (``torch.profiler``, ``reps`` calls of ``fn`` after 3 warm-ups)."""
    per, _ = profile_frames(fn, reps)
    us = [t for name, (t, _) in per.items() if match in name]
    if not us:
        raise RuntimeError(f"the profiler saw no kernel named *{match}*")
    return sum(us) / 1e3 / reps


def probe_epilogue(maxd, plans):
    """B5 at 1080p per storage tier, subpixel: through the wrapper (CUDA
    events around one call), the kernel alone (its device time under the
    profiler) and, with ``plans``, under launch plans around the chosen
    one, beside the byte bound."""
    from steroscopic_hardware_tpu_torch.ops import sgm

    rows = []
    v8, ht8 = _epilogue_volumes(maxd)
    for dt in EPILOGUE_TIERS:
        agg_v, agg_ht = v8.to(dt), ht8.to(dt)
        nbytes = 2 * agg_v.numel() * agg_v.element_size() + H * W * 4

        def run():
            return sgm.sgm_epilogue(agg_v, agg_ht, subpixel=True)

        rows.append({"kernel": "sgm_epilogue", "tier": str(dt), "maxd": maxd,
                     "ms": time_ms(run), "kernel_ms": kernel_ms(
                         run, "sgm_epilogue"),
                     "MB": nbytes / 1e6, "bound_ms": nbytes / MEM_BPS * 1e3})
        if plans:
            rows += _epilogue_plans(maxd, agg_v, agg_ht)
            # the 240-column W-band of the 8-way sharded engine
            rows += _epilogue_plans(maxd, agg_v[:, :, :240].contiguous(),
                                    agg_ht[:, :240].contiguous())
        del agg_v, agg_ht
        torch.cuda.empty_cache()
    return rows


def _epilogue_plans(maxd, agg_v, agg_ht):
    """B5 on agg_v (D, h, w) under the chosen plan and, one field at a
    time, each other ring depth the library compiled and each narrower
    access width the shape allows, called through the library, each
    checked against the wrapper's output."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.ops import sgm

    lib = _kernels.load()
    D, H, W = agg_v.shape
    want = sgm.sgm_epilogue(agg_v, agg_ht, subpixel=True)
    dt = agg_v.dtype
    s = agg_v.element_size()
    chosen = _kernels.sgm_epilogue_plan(D, H, W, dt)
    out = torch.empty_like(want)

    def widths(pitch):
        return [w for w in _kernels.TRANSPOSE_WIDTHS
                if s <= w and pitch % w == 0]

    plans = [chosen]
    plans += [chosen._replace(stages=n) for n in _kernels.EPILOGUE_RINGS]
    plans += [chosen._replace(wv=w) for w in widths(W * s)]
    plans += [chosen._replace(wh=w) for w in widths(H * s)]
    seen, rows = set(), []
    stream = torch.cuda.current_stream().cuda_stream
    for plan in plans:
        if plan in seen:
            continue
        seen.add(plan)

        def run(plan=plan):
            err = lib.sgm_epilogue(
                agg_v.data_ptr(), agg_ht.data_ptr(), out.data_ptr(), D, H, W,
                _kernels._TYPE_CODES[dt], 1, *plan[:3], *plan.grid, stream)
            if err:
                raise RuntimeError(f"plan {plan} refused ({err})")

        out.zero_()
        run()
        torch.cuda.synchronize()
        rows.append({"kernel": "sgm_epilogue", "tier": str(dt), "maxd": maxd,
                     "shape": [H, W], "plan": plan._asdict(),
                     "chosen": plan == chosen,
                     "equal": bool(torch.equal(out, want)),
                     "kernel_ms": kernel_ms(run, "sgm_epilogue")})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--transpose", action="store_true",
                    help="time B4 instead of B3")
    ap.add_argument("--epilogue", action="store_true",
                    help="time B5 instead of B3")
    ap.add_argument("--fused", action="store_true",
                    help="with --profile, also profile the fused chain")
    ap.add_argument("--maxd", default="64",
                    help="comma-separated max disparities (default 64)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sgm_probe needs a CUDA GPU")
    card = card_name("cuda")
    print(card, flush=True)
    rows = []
    for maxd in (int(m) for m in args.maxd.split(",")):
        if args.transpose:
            found = probe_transpose(maxd, args.plans)
        elif args.epilogue:
            found = probe_epilogue(maxd, args.plans)
        else:
            found = probe_wrapper(maxd)
            if args.plans:
                found += probe_plans(maxd)
        if args.profile:
            found += (probe_profile(maxd, lr=False)
                      + probe_profile(maxd, lr=True))
            if args.fused:
                found += probe_profile(maxd, lr=False, fused=True)
        for row in found:
            row["card"] = card
            print(json.dumps(row), flush=True)
        rows += found
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
