"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (written for an
H100, sm_90a): builds the SAD and SGM kernels from
``steroscopic_hardware_tpu_torch/csrc``, holds them to their plain torch
versions, drives the live depth server in-process at 1920x1080 with both
engines, runs stereo visual odometry and SLAM at KITTI's frame geometry,
serves live SLAM, rectifies and serves a calibrated rig (``--calib``),
runs the multi-process tier over 2 and 4 ranks on the card, feeds the
server from TCP and serial camera transports, runs the tools (the
parameter sweep, the SLAM stress suite, scaling) and the entry hook, and
the measurement tools (bench, the kernel table, the SGM stages, the golden
vectors, serve_probe's last modes).

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, one line each; the first that fails ends the run with a non-zero
exit code:
  1. the card (nvidia-smi name and power limit), torch / CUDA versions,
     the kernel build time and ptxas's registers and spill bytes per kernel
     (fails if a SAD sweep, sgm_transpose_add or sgm_epilogue
     instantiation spills);
  2. SAD kernel == plain on the card, exact, at 1080p and ragged shapes, a
     4-frame batch, and sad_lr with and without costs; at the sweep's edges
     (W not a multiple of its 128-column strip, W < maxD, b63 d511, right-map
     columns drifting across the right edge, 4 frames of a (4, 2, H, W)
     upload) all three kernels; and every launch plan of each kernel on a
     ragged strided batch;
  2s. SGM kernel == plain on the card: sgm_aggregate in its six storage
     tiers (fractional penalties in float32), sgm_transpose_add with and
     without the addend, sgm_epilogue with and without subpixel, at 1080p
     d64 and d256 and a ragged 37x53 d16, sgm_aggregate at the edges of
     its launch plan (D 1..288, S 1 / 2 / 7, ragged K), and
     sgm_transpose_add at each access width of its plan, at the 1080-byte
     uint8 rows of the served cost volume and at ragged tile edges, in all
     six type combinations, and sgm_epilogue in all three tiers at each
     access width of its plan, at ragged tile edges, at D 1 and 288, on
     the sharded engine's 1080-row W-bands (960 / 480 / 240 columns);
     integers and sgm_epilogue exact, other floats within 1e-5 (max abs
     error printed);
  3. ground truth: a 1080p textured pair with a known piecewise-constant
     shift field; the SAD kernels must recover it on >= 90% of the pixels
     farther than maxD + h from any image or region edge;
  3s. the same for SGM at d64 (margin maxD + 8), and sgm_disparity's fused
     epilogue (the entry point of sgm_epilogue) equal to the unfused one;
  4. the server (``__main__.build_app``) serves the pair: ``/stream/out``
     equals the plain version before and after ``/update-params`` and with
     ``--lr-check``, and the launch counters show every served batch went
     through the kernels;
  4s. the same with ``--backend sgm``, with and without ``--lr-check``,
     each before and after a retune to maxDisparity 128;
  5. kernel and plain times at 1080p (CUDA events; kernels the median of
     20 after 3 warm-ups, plain versions of 5 after 1), SAD (sad_lr also
     with costs; b16 d64, b7 d128, b31 d256) and each SGM stage
     (sgm_epilogue in all three tiers), beside each kernel's bound and,
     for B4, the one PyTorch call that computes the same function;
  5f. the device time of one 1080p d64 SGM frame through the fused chain
     (B5) against the served, unfused one (torch.profiler);
  6v. stereo visual odometry at KITTI odometry's frame geometry (1241x376,
     block 9, maxDisparity 128, 512 keypoints): B2s (sad_lr with costs and
     the parabola) == plain exactly, with its time beside its bound; the
     sgm front end's chain (B4 and B3 at its volumes, D 129) == plain
     exactly, stage by stage and in both maps; one tracking step per front
     end (sad, sgm) on the card against the same step on the CPU (same
     previous features and RANSAC scores: keypoints exact, descriptor bits
     >= 99.9%, points and twist within the CPU tests' tolerances); a
     40-frame synthetic loop through StereoVO.process on the card (ATE,
     tracking drops and median inliers within their bounds, sad_lr
     launched once a frame, device ms per frame by stage under
     torch.profiler); 10 frames with the sgm front end (the same gates and
     profile); and despair.run_sad on the card == plain at 640x480 b7 d64;
  7. the SLAM backend and live SLAM serving: StereoSLAM with BoW loop
     closure (window 4, a keyframe every 2 frames, BA 6 iterations) over
     phase 6v's 40 frames on the card, synchronously (ATE beside phase
     6v's VO-only ATE, BA runs, loops closed, keyframes, stage seconds,
     frame wall ms; gates: a BA run, a closure, no backend error, ATE
     below the VO-only ATE, the newest BA window's error curve and the
     newest closure's pose-graph cost falling, sad_lr once a frame) with
     a checkpoint after 21 frames; the
     backend's operations card against CPU on the same inputs (the
     batched matches and BowIndex.vector exactly at K 512, the BA solve
     of the run's last window and a 64-node pose graph with loop edges,
     with and without n_fixed, within tolerances); the same frames with
     the asynchronous backend (the same gates after finish(), its ATE
     under a fixed bound); the checkpoint loaded on the card (frame index,
     keyframes and edges as the uninterrupted run's) and the rest of the
     frames (the sync run's gates; camera centres within 1 mm of the
     uninterrupted run's),
     then one BA window, one loop check and one pose-graph solve on its
     final state under torch.profiler (device ms and launches, beside the
     sync run's wall ms per stage); and the live server with --slam --loop-closure at 1080p,
     fused and --no-slam-fused, 7 s each once the backend warmup is
     done (/stream/out == plain, /slam
     and /slam/trajectory served, no error or dropped track, sad_lr once
     per tracked frame; served fps, serve latency, device busy, SLAM
     frames per second, backend queue);
  8. rectification (``--calib``) at 1920x1080 on a synthetic distorted,
     rotated rig written with ``io/calib.save_calibration``: the maps on
     the card bit for bit those built on the CPU; remap card against CPU
     (gate: at most 1 grey level on at most 1e-4 of the pixels; the
     identity rig exact); the time of one rectified pair through
     ``StereoRectifier.apply`` (CUDA events, median of 20 after 3
     warm-ups, its taps built) with its launches (the aten operations
     dispatched on the card) beside its byte bound, the SAD serve step
     after it and ``grid_sample``; one host-to-device copy per served
     batch, of the raw (B, 2, H, W) stack (counted where torch dispatches
     it; SAD and --lr-check); the
     server with --calib: /stream/out == the plain path (the CPU
     rectifier's frames, then the plain disparity) for SAD, --lr-check
     and --backend sgm, sad_wta / sad_lr once per batch and sgm_aggregate
     twice per frame, served fps over 3 s windows with and without
     --calib; and live --slam --loop-closure --calib (fused): /slam
     served, no error or dropped track, sad_lr once per tracked frame;
  9. the multi-process tier (``parallel/``) over 2 and 4 gloo ranks on the
     one card (``parallel.dryrun.launch_cases``; each rank a process of its
     own; gloo stages the collectives' CUDA tensors through the host):
     row-band SAD with its halo exchange (b16 d64, b31 d256) and
     scanline-sharded SGM with its
     all_to_all (d64, subpixel on and off) on phase 3's 1080p pair,
     gathered, == one process bit for bit, each rank launching sad_wta
     once, sgm_transpose_add once, sgm_aggregate twice and sgm_epilogue
     once a frame; landmark-sharded BA at the SLAM window's size (4 x 512)
     and an edge-sharded 64-node pose graph with loop edges against one
     process (the JAX tests' gates; the pose graph's twists bit for
     bit); StereoSLAM(pg_mesh=) over 2 ranks on
     phase 7's frames (a loop closed on each rank, the same keyframes,
     camera centres within 1 mm of phase 7's sync run); each case's
     seconds per rank and the bytes each rank sent through the halo and
     the all_to_all (no speed is claimed: the ranks share one card);
  10. live ingest at 1920x1080, each run an in-process ``build_app`` whose
     sources are attached the way users attach them. 10t: two TCP
     ``CameraEmitter``s cycle K = 4 seeded textured pairs (a pair a
     INGEST_HOLD_S slot of the wall clock, so both sides change pairs
     together) at 60 Hz in codec raw, range and lzma, and raw again with
     --lr-check, attached through POST /left/configure and
     /right/configure; 10s: the same frames raw from ``SerialEmitter``s on
     two ptys, attached with --serial left=/dev/pts/N and /right/configure
     device=... (raw 1080p: the range codec would not shrink the
     noise-textured frames, its decode is slower than the line, and 20
     raw frames still cross two ptys in seconds); 10d: one static pair over TCP with
     and without --dedup-uploads; 10r: --rig b, four TCP emitters, a pair
     per rig; 10g: --backend sgm d64 over raw TCP. Gates: every frame the
     sources publish is byte-equal to an emitted one; each /stream/out
     read (every 0.5 s of a window of >= 20 frames and >= 2 s) equals the
     plain map of an emitted left and right, and one read at least a
     pair's own (with --lr-check the plain LR-checked map; the rigs and
     the static runs exactly their own pair's; SGM the plain chain's); the
     launch counters show sad_wta (sad_lr with --lr-check) once per served
     batch and nothing else, sgm_aggregate and sgm_transpose_add twice a
     frame; the native frame parser loaded and parsed every stream; with
     --dedup-uploads one batch and one launch for the one distinct pair
     while dup_skipped grows, without it a launch per batch. Printed: per
     codec the served fps, device busy, wire bytes and host decode ms per
     frame and the parser; both rigs' fps in one window. 10k: ``python -m
     steroscopic_hardware_tpu_torch.soak --minutes 0.5 --interval 5`` (a
     server subprocess with --slam --loop-closure): no backend traceback,
     no error, frames and poses grow at every sample; RSS and device
     memory at the first and last sample;
  11. the tools (``steroscopic_hardware_tpu_torch/tools``) and the entry
     hook, each a phase of its own in the seconds line. 11a: ``run_sweep
     --synthetic --lr-check`` over blocks 3-31 (odd) x maxD 16-256 (step
     16) at 1080p, 240 configurations: each sad_wta map == plain, each LR
     check's map, mask and valid fraction == the plain sweep and
     ``check_from_raw``, exactly 1 + 2n sad_wta and one sad_lr launches a
     configuration; Mpix/s and kernel ms printed per configuration. 11b:
     ``run_sweep --engine sgm --synthetic`` over maxD 16-256, the map ==
     the plain chain at d 16, 128, 144 and 256 (both sides of B3's wide
     kernel at 136), two sgm_aggregate and two sgm_transpose_add a frame.
     11c: ``run_synth_slam`` on the photometric loop (40 frames, noise 2,
     the tool's 320x240 rig), front ends sad and sgm, engines vo and
     vo+ba+loop; gates: sgm drops no frame and no more than sad, every
     ATE finite and below 0.1 m, sad_lr once a frame (sad), sgm_aggregate
     and sgm_transpose_add twice (sgm); each row printed with its frame
     p95 ms. 11d: ``bench_scaling --batch-axis`` at 1080p b16 d64 (F = 1,
     2, 4, 8; each F's first chained output == plain; 4n launches a F),
     then its rank mode at 480x640 over the cards present (NCCL, one card
     a rank: the gathered map == one process, each rank 1 + n sad_wta).
     11e: ``entry()``'s ``fn(*args)`` on the card == plain with one
     sad_wta launch, and ``dryrun_multichip`` over every card passes;
  12. the measurement tools, each a phase of its own in the seconds line.
     12a: ``python -m steroscopic_hardware_tpu_torch.bench --synthetic``
     (in-process): its guard passes and its JSON line names the card;
     12b: ``tools.bench_table`` over every row at n = 2 (``--scale
     0.01``), no row with an error, each row's launches printed, and the
     first chained step of the VGA SAD, SGM d64 and the three VGA tracking
     rows (sad, sgm, sgm_half) == the same step through the plain path;
     12c: the sgm_half front end on one 1080p frame == the plain path;
     12d: ``tools.sgm_bench`` at 1080p d64, every row with no error;
     12e: ``tools.gen_vectors`` on a seeded PNG pair written there, each
     case's vectors == the golden model == sad_wta on the crop;
     12f: ``serve_probe --modes device-colorize-preview-2,slam-sgm-half``
     at 1080p, 3 s windows: frames served, no error;
     12g: ``tools.run_synth_slam``'s clean loop (40 frames, vo) with the
     engine's own RANSAC draws, sad and sgm: ATE < 0.1 m each.
Then one JSON line of per-kernel results and, last, the device line
``{"ok": true, "device": {...}}``. Without a usable GPU it exits 1 before
printing anything; it imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
import zlib

import numpy as np
import torch

H, W = 1080, 1920
SEED = 20261016
CSRC = "steroscopic_hardware_tpu_torch/csrc/"
SOURCE = {"sad_wta": CSRC + "sad.cu", "sad_lr": CSRC + "sad.cu",
          "sgm_aggregate": CSRC + "sgm.cu",
          "sgm_aggregate_wide": CSRC + "sgm.cu",
          "sgm_transpose_add": CSRC + "sgm.cu",
          "sgm_epilogue": CSRC + "sgm.cu"}
REPLACES = {
    "sad_wta": "steroscopic_hardware_tpu/ops/sad_pallas.py:121",
    "sad_lr": "steroscopic_hardware_tpu/ops/sad_pallas.py:427",
    "sgm_aggregate": "steroscopic_hardware_tpu/ops/sgm.py:172",
    "sgm_aggregate_wide": "steroscopic_hardware_tpu/ops/sgm.py:172",
    "sgm_transpose_add": "steroscopic_hardware_tpu/ops/sgm.py:415",
    "sgm_epilogue": "steroscopic_hardware_tpu/ops/sgm.py:550",
}
# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet): device
# memory 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s; int32
# 132 SMs x 64 lanes x 1.98 GHz.
MEM_BPS = 3.35e12
F32_OPS = 67e12
I32_OPS = 132 * 64 * 1.98e9
SGM_TOL = 1e-5  # float maps, kernel vs plain (both round as torch does)
# kernels whose instantiations must not spill (ptxas, phase 1)
SPILL_CHECKED = ("sad_kernel", "sgm_aggregate_wide_kernel",
                 "sgm_transpose_add_kernel", "sgm_epilogue_kernel")


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def random_pair(rng, shape, shift=5):
    left = rng.integers(0, 256, shape, dtype=np.uint8)
    right = np.clip(np.roll(left, -shift, axis=-1).astype(int)
                    + rng.integers(-3, 4, shape), 0, 255).astype(np.uint8)
    return left, right


def to_cuda(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


def phase_build():
    from steroscopic_hardware_tpu_torch import _kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    say(card)
    path, seconds = _kernels.build()
    _kernels.load()
    with open(path[:-3] + ".log") as f:
        usage = ptxas_usage(f.read())
    if not any("sgm_epilogue_kernel" in u[0] for u in usage):
        fail("ptxas reported no sgm_epilogue instantiation")
    spilled = [u for u in usage
               if u[2] and any(k in u[0] for k in SPILL_CHECKED)]
    if spilled:
        fail(f"SAD sweep, B3's wide kernel, B4 or B5 instantiations "
             f"spill: {spilled}")
    say(f"phase 1 ok: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; nvcc build "
        f"{seconds:.2f} s for sm_90a; ptxas: "
        + "; ".join(f"{name}: {regs} registers, {spill} spill bytes"
                    for name, regs, spill in usage))
    return card


def ptxas_usage(log):
    """[(kernel, registers, spill store + load bytes)] from ``-Xptxas -v``
    output, kernel names demangled where ``c++filt`` exists."""
    rows, name, spill = [], None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln and name is not None:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            spill = nums[1] + nums[2]  # stack frame, spill stores, loads
        elif "Used" in ln and "registers" in ln and name is not None:
            regs = int(ln.split("Used")[1].split()[0])
            rows.append([name, regs, spill])
            name, spill = None, 0
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r[0] = n.replace("(anonymous namespace)::", "").split("(")[0]
    except (OSError, subprocess.CalledProcessError):
        pass
    return [tuple(r) for r in rows]


def _compare(name, got, want, errs):
    n = 0
    for g, w in zip(got, want):
        n += int((g != w).sum())
        errs[name] = max(errs[name],
                         int((g.long() - w.long()).abs().max()))
    return n


def phase_exact():
    from steroscopic_hardware_tpu_torch.ops import sad

    rng = np.random.default_rng(SEED)
    errs = {"sad_wta": 0, "sad_lr": 0}
    results = []
    wta_cases = [(1, H, W, 16, 64), (1, H, W, 7, 128), (1, H, W, 31, 256),
                 (1, 37, 130, 7, 64), (1, 33, 31, 31, 16), (1, 48, 64, 5, 256),
                 (4, H, W, 16, 64)]
    for F, h, w, b, d in wta_cases:
        L, R = to_cuda(*random_pair(rng, (F, h, w)))
        got = sad.disparity_batch(L, R, block_size=b, max_disparity=d)
        torch.cuda.synchronize()
        want = sad.disparity_plain(L, R, block_size=b, max_disparity=d)
        n = _compare("sad_wta", [got], [want], errs)
        results.append(f"sad_wta F{F} {h}x{w} b{b} d{d}: {n} mismatches")
    lr_cases = [(1, H, W, 7, 64, False), (1, H, W, 7, 64, True),
                (1, 37, 130, 7, 64, True), (1, 33, 31, 31, 16, True),
                (1, 48, 64, 5, 256, True), (2, H, W, 16, 64, False)]
    for F, h, w, b, d, costs in lr_cases:
        L, R = to_cuda(*random_pair(rng, (F, h, w)))
        got = sad.disparity_lr(L, R, block_size=b, max_disparity=d,
                               with_costs=costs)
        torch.cuda.synchronize()
        want = sad.disparity_raw_lr_plain(L, R, block_size=b,
                                          max_disparity=d, with_costs=costs)
        if len(got) != len(want):
            fail(f"sad_lr returned {len(got)} maps, plain {len(want)}")
        n = _compare("sad_lr", got, want, errs)
        results.append(f"sad_lr F{F} {h}x{w} b{b} d{d} costs={costs}: "
                       f"{n} mismatches")
    # the sweep's edges, all three kernels; F = 4 from a (4, 2, H, W) upload
    # (frame stride 2 H W)
    for F, h, w, b, d in [(1, 64, 300, 16, 64), (1, 40, 50, 7, 128),
                          (1, 70, 700, 63, 511), (1, 50, 200, 9, 100),
                          (4, H, W, 16, 64)]:
        L, R = stacked_pair(rng, F, h, w)
        kw = dict(block_size=b, max_disparity=d)
        got = sad.disparity_batch(L, R, **kw)
        torch.cuda.synchronize()
        n = _compare("sad_wta", [got], [sad.disparity_plain(L, R, **kw)], errs)
        results.append(f"sad_wta edge F{F} {h}x{w} b{b} d{d}: {n} mismatches")
        for costs in (False, True):
            got = sad.disparity_lr(L, R, with_costs=costs, **kw)
            torch.cuda.synchronize()
            want = sad.disparity_raw_lr_plain(L, R, with_costs=costs, **kw)
            n = _compare("sad_lr", got, want, errs)
            results.append(f"sad_lr edge F{F} {h}x{w} b{b} d{d} "
                           f"costs={costs}: {n} mismatches")
        del L, R, got, want
    results += check_every_plan(rng, errs)
    bad = [r for r in results if not r.endswith(": 0 mismatches")]
    if bad:
        fail("kernel != plain: " + "; ".join(bad))
    say(f"phase 2 ok: kernel == plain exactly in {len(results)} cases "
        f"({'; '.join(results)})")
    return errs


def stacked_pair(rng, F, h, w):
    """(L, R) as the two planes of one (F, 2, h, w) upload, as the server
    stacks a batch: frames 2 h w bytes apart."""
    left, right = random_pair(rng, (F, h, w))
    both = to_cuda(np.stack([left, right], axis=1))[0]
    return both[:, 0], both[:, 1]


def check_every_plan(rng, errs):
    """Each kernel under every launch plan it takes (called through the
    library, not the wrappers) on a ragged strided batch, against plain."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.ops import sad

    F, h, w, b, d = 2, 37, 300, 9, 100
    L, R = stacked_pair(rng, F, h, w)
    lib = _kernels._ready(L.device)  # sad_init: the shared-memory opt-in
    stream = torch.cuda.current_stream().cuda_stream
    kw = dict(block_size=b, max_disparity=d)
    results = []
    for name in ("sad_wta", "sad_lr", "sad_lr_costs"):
        costs = name == "sad_lr_costs"
        if name == "sad_wta":
            want = [sad.disparity_plain(L, R, **kw)]
        else:
            want = sad.disparity_raw_lr_plain(L, R, with_costs=costs, **kw)
        plans = [(kv, th, ds)
                 for kv, ths in _kernels.SAD_COMPILED[name].items()
                 for th in ths for ds in ((1,) if costs else _kernels.SAD_DS)]
        for kv, th, ds in plans:
            outs = [torch.empty_like(x) for x in want]
            ptrs = [o.data_ptr() for o in outs]
            args = (L.stride(0), R.stride(0), F, h, w, b, d)
            if name == "sad_wta":
                err = lib.sad_wta(L.data_ptr(), R.data_ptr(), *ptrs, *args,
                                  kv, th, ds, stream)
            else:
                err = lib.sad_lr(L.data_ptr(), R.data_ptr(), *ptrs,
                                 *[None] * (5 - len(ptrs)), *args,
                                 int(costs), kv, th, ds, stream)
            torch.cuda.synchronize()
            if err:
                fail(f"{name} plan kv {kv} th {th} ds {ds} refused ({err})")
            n = _compare("sad_wta" if name == "sad_wta" else "sad_lr",
                         outs, want, errs)
            results.append(f"{name} plan kv{kv} th{th} ds{ds} F{F} {h}x{w} "
                           f"b{b} d{d}: {n} mismatches")
    return results


def truth_pair(rng):
    """Textured pair whose left pixel (y, x) matches right pixel
    (y, x - d(y)), d = 8 / 24 / 40 in three horizontal bands."""
    left = rng.integers(0, 256, (H, W), dtype=np.uint8)
    right = rng.integers(0, 256, (H, W), dtype=np.uint8)
    edges = np.array([0, H // 3, 2 * H // 3, H])
    bands = [(edges[i], edges[i + 1], d) for i, d in enumerate((8, 24, 40))]
    truth = np.zeros((H, W), np.int32)
    for y0, y1, d in bands:
        right[y0:y1, : W - d] = left[y0:y1, d:]
        truth[y0:y1] = d
    right = np.clip(right.astype(int) + rng.integers(-2, 3, (H, W)), 0,
                    255).astype(np.uint8)
    return left, right, truth, edges


def phase_truth(left, right, truth, edges, block, maxd):
    from steroscopic_hardware_tpu_torch.ops import sad

    h = block // 2
    margin = maxd + h
    ys = np.arange(H)[:, None]
    xs = np.arange(W)[None, :]
    row_far = np.min(np.abs(ys - edges[None, :]), axis=1,
                     keepdims=True) > margin
    col_far = (xs > margin) & (W - 1 - xs > margin)
    mask = row_far & col_far
    if not mask.any():
        fail("no pixel lies far enough from the edges to check")
    L, R = to_cuda(left, right)
    u8 = sad.disparity(L, R, block_size=block,
                       max_disparity=maxd).cpu().numpy()
    dL, _ = sad.disparity_lr(L, R, block_size=block, max_disparity=maxd)
    dL = dL.cpu().numpy()
    want_u8 = (truth * 255 // maxd).astype(np.uint8)
    rate_wta = float((u8 == want_u8)[mask].mean())
    rate_lr = float((dL == truth)[mask].mean())
    if min(rate_wta, rate_lr) < 0.90:
        fail(f"ground truth recovered on {rate_wta:.4f} (sad_wta) / "
             f"{rate_lr:.4f} (sad_lr) of {int(mask.sum())} pixels, < 0.90")
    say(f"phase 3 ok: b{block} d{maxd} recovers the known shift field on "
        f"{rate_wta:.6f} (sad_wta) and {rate_lr:.6f} (sad_lr) of "
        f"{int(mask.sum())} pixels away from edges")


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _metrics(base):
    return json.loads(_get(base + "/metrics"))["pipeline"]


def _wait_frames(base, n, timeout=120.0):
    t0 = time.time()
    while True:
        m = _metrics(base)
        if m["frames"] >= n:
            return m
        if m.get("errors"):
            fail(f"pipeline errors: {m}")
        if time.time() - t0 > timeout:
            fail(f"served {m['frames']} frames of {n} in {timeout:.0f} s: {m}")
        time.sleep(0.05)


def _served_out(base):
    from steroscopic_hardware_tpu_torch.io.png import read_png

    return read_png(_get(base + "/stream/out"))


def _serve(argv, checks):
    """Build and start the app, wait for 30 frames, run ``checks(base)``,
    shut down. Returns the last /metrics pipeline dict."""
    from steroscopic_hardware_tpu_torch.__main__ import build_app

    app = build_app(argv).start()
    try:
        base = app.url
        t0 = time.time()
        while _get(base + "/checkhealth") != b"OK":
            if time.time() - t0 > 30:
                fail("/checkhealth never answered OK")
            time.sleep(0.05)
        _wait_frames(base, 30)
        checks(base)
        m = _metrics(base)
    finally:
        app.shutdown()
    return m


def phase_serve(left, right):
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.io.png import write_png
    from steroscopic_hardware_tpu_torch.ops import sad
    from steroscopic_hardware_tpu_torch.ops.lr_check import check_from_raw

    L, R = to_cuda(left, right)

    def plain(block, maxd, lr=False):
        if lr:
            dL, dR = sad.disparity_raw_lr_plain(
                L, R, block_size=block, max_disparity=maxd)
            return check_from_raw(dL, dR, W, maxd)[0].cpu().numpy()
        return sad.disparity_plain(L, R, block_size=block,
                                   max_disparity=maxd).cpu().numpy()

    def expect(base, want, what):
        got = _served_out(base)
        if got.shape != want.shape or not np.array_equal(got, want):
            n = int((got != want).sum()) if got.shape == want.shape else -1
            fail(f"/stream/out {what}: {n} pixels differ from plain")

    lines = []

    def plain_run(base):
        expect(base, plain(16, 64), "at b16 d64")
        req = urllib.request.Request(
            base + "/update-params", data=b"blockSize=7&maxDisparity=128",
            method="POST",
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        with urllib.request.urlopen(req, timeout=10) as r:
            if json.load(r) != {"blockSize": 7, "maxDisparity": 128}:
                fail("/update-params did not echo the new parameters")
        # frames of batches that started after the update (a batch <= 8)
        _wait_frames(base, _metrics(base)["frames"] + 17)
        expect(base, plain(7, 128), "after /update-params b7 d128")
        lines.append("== plain at b16 d64 and after /update-params b7 d128")

    def lr_run(base):
        expect(base, plain(16, 64, lr=True), "--lr-check at b16 d64")
        lines.append("== plain LR-checked at b16 d64 with --lr-check")

    with tempfile.TemporaryDirectory() as tmp:
        lp, rp = os.path.join(tmp, "left.png"), os.path.join(tmp, "right.png")
        write_png(lp, left)
        write_png(rp, right)
        argv = ["--left", lp, "--right", rp, "--fps", "60", "--no-open",
                "--device", "cuda", "--port", "0"]
        _kernels.reset_launches()
        m1 = _serve(argv, plain_run)
        m2 = _serve(argv + ["--lr-check"], lr_run)
        launches = dict(_kernels.launches)
    if not (launches["sad_wta"] >= m1["batches"] > 0
            and launches["sad_lr"] >= m2["batches"] > 0):
        fail(f"launch counters {launches} below served batches "
             f"{m1['batches']} / {m2['batches']}")
    for tag, m in (("plain", m1), ("lr-check", m2)):
        lines.append(
            f"{tag}: {m['frames']} frames in {m['batches']} batches, fps "
            f"{m['fps']}, lat_serve_p50 {m.get('lat_serve_p50')} ms, "
            f"lat_serve_p95 {m.get('lat_serve_p95')} ms")
    say(f"phase 4 ok: served 1080p /stream/out {'; '.join(lines)}; "
        f"launches {launches}")
    return launches


# the plain versions take 25-550 ms a call at 1080p: 1 warm-up and the
# median of 5 (the kernels: 3 and 20), to keep the script well inside its
# time limit
PLAIN_REPS = dict(warmup=1, reps=5)


def _time_ms(fn, warmup=3, reps=20):
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


def phase_times(card):
    from steroscopic_hardware_tpu_torch.ops import sad

    rng = np.random.default_rng(SEED + 1)
    L, R = to_cuda(*random_pair(rng, (1, H, W)))
    out = {}
    # sad_lr with costs is the kernel under the subpixel SAD path (B2s)
    cases = [(name, b, d) for b, d in ((16, 64), (7, 128), (31, 256))
             for name in ("sad_wta", "sad_lr", "sad_lr_costs")]
    for name, b, d in cases:
        kw = dict(block_size=b, max_disparity=d)
        if name == "sad_wta":
            kernel = lambda: sad.disparity_batch(L, R, **kw)  # noqa: E731
            plain = lambda: sad.disparity_plain(L, R, **kw)  # noqa: E731
        else:
            kw["with_costs"] = name == "sad_lr_costs"
            kernel = lambda: sad.disparity_lr(L, R, **kw)  # noqa: E731
            plain = lambda: sad.disparity_raw_lr_plain(L, R, **kw)  # noqa: E731
        ms, plain_ms = _time_ms(kernel), _time_ms(plain, **PLAIN_REPS)
        out[(name, b, d)] = (ms, plain_ms)
        bound_ms, bound_by = sad_bound(name, d)
        say(f"phase 5: {name} 1080p b{b} d{d}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
            f"({card})")
    say("phase 5 ok")
    return out


def _free():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _err(got, want):
    """Max abs difference; shapes and dtypes must agree."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"kernel gave {tuple(got.shape)} {got.dtype}, plain "
             f"{tuple(want.shape)} {want.dtype}")
    return float((got.float() - want.float()).abs().max())


def phase_sgm_exact():
    """SGM kernels against their plain versions on the card."""
    from steroscopic_hardware_tpu_torch.ops import sgm

    rng = np.random.default_rng(SEED + 3)
    errs = {"sgm_aggregate": 0.0, "sgm_aggregate_wide": 0.0,
            "sgm_transpose_add": 0.0, "sgm_epilogue": 0.0}
    results = []

    def check(name, what, got, want, is_float):
        torch.cuda.synchronize()
        e = _err(got, want)
        errs[name] = max(errs[name], e)
        if e > (SGM_TOL if is_float else 0.0):
            fail(f"{name} {what}: max abs error {e} against plain")
        results.append(f"{name} {what}: {e}")

    def vol(shape, high):
        return torch.from_numpy(
            rng.integers(0, high, shape, dtype=np.uint8)).cuda()

    u8, bf16, f32 = torch.uint8, torch.bfloat16, torch.float32
    tiers = [(u8, u8, (1.0, 8.0)), (bf16, u8, (1.0, 8.0)),
             (bf16, bf16, (1.0, 8.0)), (u8, bf16, (1.0, 8.0)),
             (u8, f32, (0.7, 5.3)), (bf16, f32, (0.7, 5.3))]
    for D, h, w in ((65, H, W), (257, H, W), (17, 37, 53)):
        tag = f"{h}x{w} d{D - 1}"
        # B3 on both frames: vertical (D, H, W) and horizontal (D, W, H)
        for shape in ((D, h, w), (D, w, h)):
            cost = vol(shape, 25)
            for ind, outd, P in tiers:
                c = cost.to(ind)
                got = sgm.aggregate_axis(c, *P, out_dtype=outd)
                want = sgm.aggregate_axis_plain(c, *P, out_dtype=outd)
                check(_agg_name(D), f"{tuple(shape)} {ind}->{outd} P{P}",
                      got, want, outd == f32 and D <= WIDE_FROM - 1)
                del c, got, want
            del cost
            _free()
        aT = vol((D, w, h), 25)
        check("sgm_transpose_add", f"{tag} u8->bf16",
              sgm.transpose_add(aT, out_dtype=bf16),
              sgm.transpose_add_plain(aT, out_dtype=bf16), False)
        for dt in (bf16, f32):
            a = vol((D, w, h), 120).to(dt)
            b = vol((D, h, w), 120).to(dt)
            check("sgm_transpose_add", f"{tag} {dt}+b->f32",
                  sgm.transpose_add(a, b, out_dtype=f32),
                  sgm.transpose_add_plain(a, b, out_dtype=f32), False)
            del a, b
        del aT
        _free()
        for dt in (u8, bf16, f32):
            agg_v = vol((D, h, w), 120).to(dt)
            agg_ht = vol((D, w, h), 120).to(dt)
            for sub in (False, True):
                check("sgm_epilogue", f"{tag} {dt} subpixel={sub}",
                      sgm.sgm_epilogue(agg_v, agg_ht, subpixel=sub),
                      sgm.sgm_epilogue_plain(agg_v, agg_ht, subpixel=sub),
                      False)
            del agg_v, agg_ht
            _free()
    # sgm_aggregate at its launch plan's edges, in all six tiers: D at each
    # boundary of the lanes per column, of the compiled chunk sizes and of
    # the two kernels (136 / 137), S of 1, 2 and odd (the middle row), K
    # ragged against a warp's columns
    n_edges = len(results)
    for D in (1, 2, 20, 21, 33, 36, 37, 40, 41, 65, 72, 73, 129, 136, 137,
              144, 145, 257, 272, 273, 288):
        for S, K in ((1, 37), (2, 45), (7, 33)):
            cost = vol((D, S, K), 25)
            for ind, outd, P in tiers:
                c = cost.to(ind)
                check(_agg_name(D), f"edge ({D}, {S}, {K}) {ind}->{outd}",
                      sgm.aggregate_axis(c, *P, out_dtype=outd),
                      sgm.aggregate_axis_plain(c, *P, out_dtype=outd),
                      outd == f32 and D < WIDE_FROM)
    check_wide_edges(rng, tiers, check)
    edges = results[n_edges:]
    del results[n_edges:]
    wide = [r for r in edges if r.startswith("sgm_aggregate_wide")]
    results.append(f"sgm_aggregate at {len(edges)} plan edges (D 1..288, S "
                   f"1 / 2 / 7, K 37 / 45 / 33, six tiers; the wide kernel "
                   f"also S 3 / 4 / 9 at K 38 / 1 / 1081 and at unaligned "
                   f"bases): {max(float(r.rsplit(': ', 1)[1]) for r in edges)}"
                   f", D > 136 ({len(wide)} cases): "
                   f"{max(float(r.rsplit(': ', 1)[1]) for r in wide)}")
    n_b4 = len(results)
    check_transpose_widths(rng, check)
    b4 = results[n_b4:]
    del results[n_b4:]
    results.append(f"sgm_transpose_add at {len(b4)} access-width, row-phase "
                   f"and ragged cases: "
                   f"{max(float(r.rsplit(': ', 1)[1]) for r in b4)}")
    n_edges += len(b4)
    n_b5 = len(results)
    check_epilogue_edges(rng, check)
    b5 = results[n_b5:]
    del results[n_b5:]
    results.append(f"sgm_epilogue at {len(b5)} access-width, ragged, "
                   f"D 1 / 288 and W-band cases: "
                   f"{max(float(r.rsplit(': ', 1)[1]) for r in b5)}")
    n_edges += len(b5)
    say(f"phase 2s ok: SGM kernel vs plain, max abs error per case "
        f"({n_edges + len(edges)} cases; {'; '.join(results)})")
    return errs


WIDE_FROM = 137  # the first D of B3's wide kernel
WIDE_EDGE_D = (137, 144, 145, 160, 161, 192, 193, 224, 225, 256, 257, 272,
               273, 288)


def _agg_name(D):
    """The errors' key of B3's kernel at D: exact for the wide kernel."""
    return "sgm_aggregate_wide" if D >= WIDE_FROM else "sgm_aggregate"


def check_wide_edges(rng, tiers, check):
    """B3's wide kernel at the edges of its plan, every tier, exactly: D at
    each chunk boundary (5 / 7 / 9 d values a lane); S 3, 4 and 9 (the
    raw halves read back the step after they are stored, copied at the
    crossing, and loaded ahead); K of 38 (a uint8 row pitch of 2 mod 4
    bytes: element copies), 1 and 1081 (ragged against blocks of 4, 8
    and 16 columns); and a cost and out one element off their alignment
    (element copies of both)."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.ops import sgm

    for D in WIDE_EDGE_D:
        for S, K in ((3, 38), (4, 1), (9, 1081)):
            cost = torch.from_numpy(
                rng.integers(0, 25, (D, S, K), dtype=np.uint8)).cuda()
            for ind, outd, P in tiers:
                c = cost.to(ind)
                check("sgm_aggregate_wide",
                      f"edge ({D}, {S}, {K}) {ind}->{outd}",
                      sgm.aggregate_axis(c, *P, out_dtype=outd),
                      sgm.aggregate_axis_plain(c, *P, out_dtype=outd), False)
    D, S, K = 257, 7, 40
    flat = torch.from_numpy(
        rng.integers(0, 25, (D * S * K + 8,), dtype=np.uint8)).cuda()
    for ind, outd, P in tiers:
        c = flat.to(ind)[1:1 + D * S * K].view(D, S, K)
        out = torch.empty(D * S * K + 1, dtype=outd, device="cuda")[1:]
        got = out.view(D, S, K)
        plan = _kernels.sgm_aggregate_plan(D, S, K, _kernels._sms(c.device),
                                           c.element_size(),
                                           got.element_size())
        lib = _kernels.load()
        err = lib.sgm_aggregate(
            c.data_ptr(), got.data_ptr(), D, S, K, _kernels._TYPE_CODES[ind],
            _kernels._TYPE_CODES[outd], *P, *plan, None,
            torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"sgm_aggregate_wide refused unaligned bases ({err})")
        check("sgm_aggregate_wide", f"unaligned ({D}, {S}, {K}) {ind}->{outd}",
              got, sgm.aggregate_axis_plain(c, *P, out_dtype=outd), False)


def check_transpose_widths(rng, check):
    """B4 at each access width of aT, b and out (base pointers 16, 8, 4,
    2 and 1 bytes aligned; out rows of B odd, 2 and 4 mod 8 and a multiple
    of 8), at the served cost volume's 1080-byte uint8 rows (8 mod 16),
    and at ragged tile edges, in all six type combinations, exactly."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.ops import sgm

    u8, bf16, f32 = torch.uint8, torch.bfloat16, torch.float32
    forms = [(u8, bf16, False), (bf16, bf16, True), (bf16, f32, True),
             (f32, f32, True), (u8, f32, True), (f32, bf16, False)]

    def vol(shape, dtype, offset=0, high=120):
        n = int(np.prod(shape))
        size = torch.empty((), dtype=dtype).element_size()
        flat = torch.from_numpy(rng.integers(0, high, n + 16, dtype=np.uint8)
                                ).cuda().to(dtype)
        return flat[offset // size:offset // size + n].view(shape)

    def one(tag, aT, b, outd):
        D, B, A = aT.shape
        plan = _kernels.transpose_add_plan(
            D, B, A, aT.dtype, outd, b is not None, 132,
            _kernels.pointer_alignment(aT.data_ptr()),
            16 if b is None else _kernels.pointer_alignment(b.data_ptr()))
        check("sgm_transpose_add",
              f"{tag} {aT.dtype}{'+b' if b is not None else ''}->{outd} "
              f"wa{plan.wa} wb{plan.wb} wo{plan.wo}",
              sgm.transpose_add(aT, b, out_dtype=outd),
              sgm.transpose_add_plain(aT, b, out_dtype=outd), False)

    for ind, outd, has_b in forms:
        size = torch.empty((), dtype=ind).element_size()
        for off in (0, 8, 4, 2, 1):
            if off % size == 0:
                D, B, A = 3, 72, 1920
                one(f"(3, 72, 1920) +{off} B", vol((D, B, A), ind, off),
                    vol((D, A, B), ind, off) if has_b else None, outd)
        for D, B, A in ((1, 53, 37), (2, 38, 130), (5, 36, 257),
                        (7, 130, 66), (1, 1, 1)):
            one(f"ragged ({D}, {B}, {A})", vol((D, B, A), ind),
                vol((D, A, B), ind) if has_b else None, outd)
    for off in (0, 8):
        one(f"1080-byte rows (65, {W}, {H}) +{off} B",
            vol((65, W, H), u8, off, high=25), None, bf16)
    _free()


def check_epilogue_edges(rng, check):
    """B5 against its plain version, integer and subpixel, exactly (max abs
    error 0), in all three tiers: at each access width of agg_v and agg_ht
    (views at base pointers 16, 8, 4, 2 and 1 bytes aligned, on rows whose
    pitch allows 16), at ragged tile edges, at D 1 and 288, and on the
    W-bands of the 2-, 4- and 8-way sharded engine at 1080p (960, 480 and
    240 columns)."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.ops import sgm

    def vol(shape, dtype, offset=0):
        n = int(np.prod(shape))
        size = torch.empty((), dtype=dtype).element_size()
        flat = torch.from_numpy(rng.integers(0, 120, n + 16, dtype=np.uint8)
                                ).cuda().to(dtype)
        return flat[offset // size:offset // size + n].view(shape)

    def one(tag, agg_v, agg_ht):
        D, h, w = agg_v.shape
        plan = _kernels.sgm_epilogue_plan(
            D, h, w, agg_v.dtype,
            _kernels.pointer_alignment(agg_v.data_ptr()),
            _kernels.pointer_alignment(agg_ht.data_ptr()))
        for sub in (False, True):
            check("sgm_epilogue",
                  f"{tag} {agg_v.dtype} wv{plan.wv} wh{plan.wh} "
                  f"ring{plan.stages} subpixel={sub}",
                  sgm.sgm_epilogue(agg_v, agg_ht, subpixel=sub),
                  sgm.sgm_epilogue_plain(agg_v, agg_ht, subpixel=sub), False)

    for dt in (torch.uint8, torch.bfloat16, torch.float32):
        size = torch.empty((), dtype=dt).element_size()
        for off in (0, 8, 4, 2, 1):
            if off % size == 0:
                one(f"(5, 80, 208) +{off} B", vol((5, 80, 208), dt, off),
                    vol((5, 208, 80), dt, off))
        for D, h, w in ((1, 1, 1), (1, 37, 53), (2, 64, 64), (3, 65, 129),
                        (7, 130, 66), (288, 70, 45), (288, 200, 300)):
            one(f"ragged ({D}, {h}, {w})", vol((D, h, w), dt),
                vol((D, w, h), dt))
        for w in (960, 480, 240):
            one(f"W-band (65, {H}, {w})", vol((65, H, w), dt),
                vol((65, w, H), dt))
        _free()


def phase_sgm_truth(left, right, truth, edges, maxd=64):
    """SGM recovers the shift field; the fused epilogue (sgm_epilogue's
    entry point) equals the unfused chain. Returns the launch counts of
    the fused run."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.ops import sgm

    margin = maxd + 8
    ys = np.arange(H)[:, None]
    xs = np.arange(W)[None, :]
    mask = ((np.min(np.abs(ys - edges[None, :]), axis=1, keepdims=True)
             > margin) & (xs > margin) & (W - 1 - xs > margin))
    L, R = to_cuda(left, right)
    unfused = sgm.sgm_disparity(L, R, max_disparity=maxd)
    _kernels.reset_launches()
    fused = sgm.sgm_disparity(L, R, max_disparity=maxd, epilogue="fused")
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    if launches["sgm_epilogue"] < 1:
        fail(f"sgm_disparity(epilogue='fused') launched {launches}")
    err = _err(fused, unfused)
    if err != 0.0:
        fail(f"fused != unfused at 1080p d{maxd}: max abs error {err}")
    disp = unfused.cpu().numpy()
    rate = float((np.abs(disp - truth) < 0.5)[mask].mean())
    if rate < 0.90:
        fail(f"SGM recovers the shift field on {rate:.4f} of "
             f"{int(mask.sum())} pixels, < 0.90")
    say(f"phase 3s ok: SGM d{maxd} within 0.5 px of the known shift field "
        f"on {rate:.6f} of {int(mask.sum())} pixels away from edges; fused "
        f"== unfused exactly; fused run launches {launches}")
    return launches


@contextlib.contextmanager
def _plain_chain():
    """Points the SGM wrappers and the SAD launchers at their plain
    versions, so the serving chain (and the VO front ends) run without any
    kernel (the reference maps)."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.ops import sad, sgm

    saved = sgm.aggregate_axis, sgm.transpose_add, sgm.sgm_epilogue
    saved_sad = _kernels.sad_wta, _kernels.sad_lr
    sgm.aggregate_axis = (
        lambda c, P1, P2, *, out_dtype: sgm.aggregate_axis_plain(
            c, P1, P2, out_dtype=out_dtype))
    sgm.transpose_add = sgm.transpose_add_plain
    sgm.sgm_epilogue = sgm.sgm_epilogue_plain
    _kernels.sad_wta = lambda l, r, b, d: sad.disparity_plain(
        l, r, block_size=b, max_disparity=d)
    _kernels.sad_lr = lambda l, r, b, d, costs=False: (
        sad.disparity_raw_lr_plain(l, r, block_size=b, max_disparity=d,
                                   with_costs=costs))
    try:
        yield
    finally:
        sgm.aggregate_axis, sgm.transpose_add, sgm.sgm_epilogue = saved
        _kernels.sad_wta, _kernels.sad_lr = saved_sad


def phase_sgm_serve(left, right):
    """``--backend sgm`` serves /stream/out equal to the plain chain, before
    and after /update-params, with and without --lr-check."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.io.png import write_png
    from steroscopic_hardware_tpu_torch.models.blockmatch import sgm_one

    L, R = to_cuda(left, right)
    want = {}
    with _plain_chain():
        for maxd, lr in ((64, False), (128, False), (64, True), (128, True)):
            want[maxd, lr] = sgm_one(L, R, max_disparity=maxd, p1=1.0,
                                     p2=8.0, subpixel=True, lr=lr,
                                     threshold=1.0).cpu().numpy()
    _free()

    def expect(base, key, what):
        got = _served_out(base)
        if got.shape != want[key].shape or not np.array_equal(got, want[key]):
            n = (int((got != want[key]).sum())
                 if got.shape == want[key].shape else -1)
            fail(f"--backend sgm /stream/out {what}: {n} pixels differ "
                 "from the plain chain")

    lines = []

    def retune(base, lr):
        req = urllib.request.Request(
            base + "/update-params", data=b"blockSize=7&maxDisparity=128",
            method="POST",
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        with urllib.request.urlopen(req, timeout=10) as r:
            if json.load(r) != {"blockSize": 7, "maxDisparity": 128}:
                fail("/update-params did not echo the new parameters")
        _wait_frames(base, _metrics(base)["frames"] + 17)
        expect(base, (128, lr), f"after /update-params d128, lr={lr}")

    def run(base):
        expect(base, (64, False), "at d64")
        retune(base, False)
        lines.append("== plain chain at d64 and after /update-params d128")

    def lr_run(base):
        expect(base, (64, True), "--lr-check at d64")
        retune(base, True)
        lines.append("== plain LR-checked chain with --lr-check at d64 and "
                     "after /update-params d128")

    with tempfile.TemporaryDirectory() as tmp:
        lp, rp = os.path.join(tmp, "left.png"), os.path.join(tmp, "right.png")
        write_png(lp, left)
        write_png(rp, right)
        argv = ["--left", lp, "--right", rp, "--fps", "60", "--no-open",
                "--device", "cuda", "--port", "0", "--backend", "sgm"]
        _kernels.reset_launches()
        m1 = _serve(argv, run)
        m2 = _serve(argv + ["--lr-check"], lr_run)
        launches = dict(_kernels.launches)
    frames = m1["frames"] + m2["frames"]
    # per served frame: two aggregations and two transpose-adds
    if not (launches["sgm_aggregate"] >= 2 * frames > 0
            and launches["sgm_transpose_add"] >= 2 * frames):
        fail(f"launch counters {launches} below 2 x {frames} served frames")
    for tag, m in (("sgm", m1), ("sgm lr-check", m2)):
        lines.append(
            f"{tag}: {m['frames']} frames in {m['batches']} batches, fps "
            f"{m['fps']}, lat_serve_p50 {m.get('lat_serve_p50')} ms, "
            f"lat_serve_p95 {m.get('lat_serve_p95')} ms")
    say(f"phase 4s ok: served 1080p /stream/out {'; '.join(lines)}; "
        f"launches {launches}")
    return launches


def _bound(bytes_moved, ops, op_rate):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = bytes_moved / MEM_BPS * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_sgm_times(card, maxd=64):
    """Kernel, plain and bound per SGM stage of the 1080p d64 chain."""
    from steroscopic_hardware_tpu_torch.ops import sgm

    rng = np.random.default_rng(SEED + 4)
    D = maxd + 1
    V = D * H * W
    u8, bf16, f32 = torch.uint8, torch.bfloat16, torch.float32
    size = {u8: 1, bf16: 2, f32: 4}
    cost_t = torch.from_numpy(
        rng.integers(0, 25, (D, W, H), dtype=np.uint8)).cuda()
    cost = sgm.transpose_add(cost_t, out_dtype=bf16)
    agg_v = sgm.aggregate_axis(cost, 1.0, 8.0, out_dtype=bf16)
    agg_ht = sgm.aggregate_axis(cost_t, 1.0, 8.0, out_dtype=bf16)
    agg_v8 = sgm.aggregate_axis(cost, 1.0, 8.0, out_dtype=u8)
    agg_ht8 = sgm.aggregate_axis(cost_t, 1.0, 8.0, out_dtype=u8)
    # per element and direction: min, min, add, min, add, min, add, sub
    agg_ops = 2 * 8 * V
    stages = [
        ("sgm_transpose_add", "cost u8->bf16",
         lambda: sgm.transpose_add(cost_t, out_dtype=bf16),
         lambda: sgm.transpose_add_plain(cost_t, out_dtype=bf16),
         V * (1 + 2), 0,
         lambda: torch.empty((D, H, W), dtype=bf16, device="cuda").copy_(
             cost_t.transpose(1, 2))),
        ("sgm_aggregate", "vertical bf16->bf16",
         lambda: sgm.aggregate_axis(cost, 1.0, 8.0, out_dtype=bf16),
         lambda: sgm.aggregate_axis_plain(cost, 1.0, 8.0, out_dtype=bf16),
         V * (2 + 2), agg_ops, None),
        ("sgm_aggregate", "horizontal u8->bf16",
         lambda: sgm.aggregate_axis(cost_t, 1.0, 8.0, out_dtype=bf16),
         lambda: sgm.aggregate_axis_plain(cost_t, 1.0, 8.0, out_dtype=bf16),
         V * (1 + 2), agg_ops, None),
        ("sgm_transpose_add", "summed volume bf16+bf16->bf16",
         lambda: sgm.transpose_add(agg_ht, agg_v, out_dtype=bf16),
         lambda: sgm.transpose_add_plain(agg_ht, agg_v, out_dtype=bf16),
         V * (2 + 2 + 2), V,
         lambda: torch.add(agg_v, agg_ht.transpose(1, 2))),
        ("sgm_aggregate", "fused path, vertical bf16->u8",
         lambda: sgm.aggregate_axis(cost, 1.0, 8.0, out_dtype=u8),
         lambda: sgm.aggregate_axis_plain(cost, 1.0, 8.0, out_dtype=u8),
         V * (2 + 1), agg_ops, None),
        ("sgm_aggregate", "fused path, horizontal u8->u8",
         lambda: sgm.aggregate_axis(cost_t, 1.0, 8.0, out_dtype=u8),
         lambda: sgm.aggregate_axis_plain(cost_t, 1.0, 8.0, out_dtype=u8),
         V * (1 + 1), agg_ops, None),
    ]
    agg_v32, agg_ht32 = agg_v.float(), agg_ht.float()
    # per element: add, compare, and the running-state selects
    for tier, v, ht in (("u8", agg_v8, agg_ht8), ("bf16", agg_v, agg_ht),
                        ("f32", agg_v32, agg_ht32)):
        stages.append((
            "sgm_epilogue", f"{tier} x2 -> f32 subpixel",
            lambda v=v, ht=ht: sgm.sgm_epilogue(v, ht, subpixel=True),
            lambda v=v, ht=ht: sgm.sgm_epilogue_plain(v, ht, subpixel=True),
            V * 2 * v.element_size() + H * W * size[f32], 3 * V, None))
    out = []
    for name, what, kernel, plain, nbytes, ops, library in stages:
        ms, plain_ms = _time_ms(kernel), _time_ms(plain, **PLAIN_REPS)
        library_ms = _time_ms(library) if library is not None else None
        bound_ms, bound_by = _bound(nbytes, ops, F32_OPS)
        out.append({"name": name, "stage": what, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms})
        say(f"phase 5s: {name} {what} 1080p d{maxd}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {nbytes / 1e6:.1f} MB), library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'} "
            f"({card})")
        _free()
    del cost_t, cost, agg_v, agg_ht, agg_v8, agg_ht8, agg_v32, agg_ht32
    _free()
    out += wide_times(card)
    say("phase 5s ok")
    return out


WIDE_MAXD = 256
# the SGM kernels whose launches the main path's phases add up (B3 counts
# both its kernels, sgm_aggregate_wide the wide kernel's share)
SGM_COUNTED = ("sgm_aggregate", "sgm_aggregate_wide", "sgm_transpose_add")
WIDE_PLAIN_REPS = dict(warmup=0, reps=1)  # the plain scan at d256: ~1 s


def wide_times(card, maxd=WIDE_MAXD):
    """B3's wide kernel at 1080p d256 on the served chain's two passes,
    beside its plain version (one run) and the byte bound."""
    from steroscopic_hardware_tpu_torch.ops import sgm

    rng = np.random.default_rng(SEED + 5)
    D = maxd + 1
    V = D * H * W
    bf16 = torch.bfloat16
    cost_t = torch.from_numpy(
        rng.integers(0, 25, (D, W, H), dtype=np.uint8)).cuda()
    cost = sgm.transpose_add(cost_t, out_dtype=bf16)
    out = []
    for what, c, nbytes in (("vertical bf16->bf16", cost, V * (2 + 2)),
                            ("horizontal u8->bf16", cost_t, V * (1 + 2))):
        ms = _time_ms(lambda: sgm.aggregate_axis(c, 1.0, 8.0, out_dtype=bf16))
        plain_ms = _time_ms(lambda: sgm.aggregate_axis_plain(
            c, 1.0, 8.0, out_dtype=bf16), **WIDE_PLAIN_REPS)
        bound_ms, bound_by = _bound(nbytes, 2 * 8 * V, F32_OPS)
        out.append({"name": "sgm_aggregate_wide", "stage": what, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})
        say(f"phase 5s: sgm_aggregate_wide {what} 1080p d{maxd}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {nbytes / 1e6:.1f} MB), library none ({card})")
        _free()
    return out


def phase_fused_frame(card, left, right, maxd=64, frames=5):
    """Device time of one 1080p SGM frame through the fused chain
    (sgm_disparity(epilogue="fused"): B5) against the served, unfused one
    (B4's summed form, plain argmin and parabola), by torch.profiler over
    ``frames`` frames of each after 3 warm-ups; both give the same map."""
    from steroscopic_hardware_tpu_torch.sgm_probe import (
        profile_frames, sgm_frame)

    L, R = to_cuda(left, right)
    row = {}
    for chain in ("unfused", "fused"):
        per, _ = profile_frames(
            lambda: sgm_frame(L, R, maxd, False, chain == "fused"), frames)
        if not per:
            fail(f"the profiler saw no kernel of the {chain} chain")
        b5 = sum(us for n, (us, _) in per.items() if "sgm_epilogue" in n)
        row[chain] = (sum(us for us, _ in per.values()) / 1e3 / frames,
                      sum(n for _, n in per.values()) / frames,
                      b5 / 1e3 / frames)
    if row["fused"][2] <= 0.0:
        fail("the fused chain's profile holds no sgm_epilogue kernel")
    say(f"phase 5f: one 1080p d{maxd} SGM frame, device time of all "
        f"kernels (torch.profiler, {frames} frames): fused chain "
        f"{row['fused'][0]:.4f} ms in {row['fused'][1]:.1f} launches "
        f"(B5 {row['fused'][2]:.4f} ms), unfused (served) chain "
        f"{row['unfused'][0]:.4f} ms in {row['unfused'][1]:.1f} launches "
        f"({card})")


# -- phase 6v: stereo visual odometry at KITTI odometry's frame geometry ------

VO_FRAMES = 40       # the synthetic loop through StereoVO, frontend sad
VO_SGM_FRAMES = 10   # the shorter run with frontend sgm
VO_PROFILED = 5      # frames under torch.profiler (after the first)
VO = dict(block_size=9, max_disparity=128, max_keypoints=512,
          fast_threshold=20)  # examples/run_kitti_vo.py's settings
# ATE bounds, m: about 3x the first chip run's (PERF.md section 6)
VO_ATE_BOUND = 0.05      # the 40-frame loop, sad (first run 0.018)
VO_SGM_ATE_BOUND = 0.15  # the 10-frame sgm run (first run 0.055)
# Tracking gates, about 2x the first chip run's drops (sad 6 of 39, sgm 2
# of 9). A frame drops where none of RANSAC's 32 minimal sets is all
# inliers (tests/test_torch_vo_drops.py); at this field's inlier share
# among the matches (0.37-0.59) that is expected of ~1 frame in 5. A
# tracked frame finds the ground-truth motion's inliers, 48-93 a frame
# (median 69), so the median over the frames stays above 50.
VO_DROPS_BOUND = {"sad": 12, "sgm": 4}
VO_INLIERS_MEDIAN_MIN = 50
# the tolerances of tests/test_torch_features.py, test_torch_slam.py
ORB_BIT_SHARE = 0.999
XI_TOL = 1e-4
STAGES = ("vo.disparity", "vo.features", "vo.triangulate", "vo.match",
          "vo.pnp")


def _check_track(got, want):
    """One _track_step on the card against the same step on the CPU:
    (descriptor bit share, max point error, max twist error)."""
    xy, xy_sub, desc, valid, pts, ok, xi, n_inl = (
        g.cpu().numpy() for g in got)
    wxy, wsub, wdesc, wvalid, wpts, wok, wxi, wn = (
        w.numpy() for w in want)
    if not (np.array_equal(xy, wxy) and np.array_equal(valid, wvalid)):
        fail("the track step's keypoints differ between card and CPU")
    if np.abs(xy_sub - wsub).max() > 1e-6:
        fail("the track step's subpixel keypoints differ beyond 1e-6 px")
    share = float((desc == wdesc).mean())
    if share < ORB_BIT_SHARE:
        fail(f"descriptor bits equal in {share} < {ORB_BIT_SHARE}")
    both = ok & wok
    pts_err = float(np.abs(pts[both] - wpts[both]).max() /
                    np.abs(wpts[both]).max())
    if (ok != wok).sum() > 0 or pts_err > 1e-5:
        fail(f"triangulation differs: {(ok != wok).sum()} validity flips, "
             f"relative point error {pts_err}")
    xi_err = float(np.abs(xi - wxi).max())
    if int(n_inl) != int(wn) or xi_err > XI_TOL:
        fail(f"PnP differs: inliers {int(n_inl)} / {int(wn)}, twist error "
             f"{xi_err}")
    return share, pts_err, xi_err, int(n_inl), int(valid.sum())


def _check_sgm_chain(L, R, maxd):
    """The sgm front end's chain (``ops.sgm.sgm_disparity_lr``) on the card
    against the same chain of plain versions on the same pair, stage by
    stage (B4 on the cost volume, B3 along both axes, B4 summing the
    aggregates) and in both output maps. All exact: returns the largest
    error of each kernel (0.0)."""
    from steroscopic_hardware_tpu_torch.ops import sgm
    from steroscopic_hardware_tpu_torch.ops.census import (
        census_cost_volume_T,
    )

    P1, P2 = 1.0, 8.0  # sgm_disparity_lr's defaults: bfloat16 storage
    bf16 = torch.bfloat16
    cost_t = census_cost_volume_T(L, R, max_disparity=maxd)
    cost_p = sgm.transpose_add_plain(cost_t, out_dtype=bf16)
    v_p = sgm.aggregate_axis_plain(cost_p, P1, P2, axis=1, out_dtype=bf16)
    ht_p = sgm.aggregate_axis_plain(cost_t, P1, P2, axis=1, out_dtype=bf16)
    agg_p = sgm.transpose_add_plain(ht_p, v_p, out_dtype=bf16)
    dL_p, dR_p = sgm.epilogue(agg_p, True), sgm.diagonal_argmin_right(agg_p)
    stages = {}
    cost = sgm.transpose_add(cost_t, out_dtype=bf16)
    stages[f"B4 cost {tuple(cost_t.shape)}"] = _err(cost, cost_p)
    v = sgm.aggregate_axis(cost, P1, P2, out_dtype=bf16)
    stages[f"B3 {tuple(cost.shape)}"] = _err(v, v_p)
    ht = sgm.aggregate_axis(cost_t, P1, P2, out_dtype=bf16)
    stages[f"B3 {tuple(cost_t.shape)}"] = _err(ht, ht_p)
    agg = sgm.transpose_add(ht, v, out_dtype=bf16)
    stages[f"B4 summed {tuple(ht.shape)}"] = _err(agg, agg_p)
    dL, dR = sgm.sgm_disparity_lr(L, R, max_disparity=maxd)
    stages["dL"], stages["dR"] = _err(dL, dL_p), _err(dR, dR_p)
    bad = {k: e for k, e in stages.items() if e != 0.0}
    if bad:
        fail(f"the sgm front end's chain differs from plain: {bad}")
    return stages


def profile_vo(vo, pairs):
    """Device ms per frame by stage (the torch.profiler labels of
    models/slam.py) and of all kernels, kernel launches per frame and the
    wall ms per frame, over ``pairs`` after the first (unprofiled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    vo.process(*pairs[0])
    torch.cuda.synchronize()
    n = len(pairs) - 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for left, right in pairs[1:]:
            vo.process(left, right)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    # a stage's device time is that of the kernels that ran inside its
    # label's span on the device timeline (the profiler's device-side
    # event of the label); the kernels of csrc/ are launched outside any
    # torch op, so the host-side label does not see them
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in STAGES:
            spans.append((e.time_range.start, e.time_range.end, e.name))
        else:
            kernels.append(e)
    if {name for _, _, name in spans} != set(STAGES):
        fail(f"the profiler gave device spans for {sorted(spans)} only")
    stages = dict.fromkeys(STAGES, 0.0)
    total_us = 0.0
    for k in kernels:
        us = k.time_range.elapsed_us()
        total_us += us
        for start, end, name in spans:
            if start <= k.time_range.start < end:
                stages[name] += us
                break
    launches = len(kernels)
    return ({k: us / 1e3 / n for k, us in stages.items()},
            total_us / 1e3 / n, launches / n, wall)


def _check_vo(frontend, vo, stats, ate_bound):
    """The gates of a StereoVO run: finite trajectory, ATE, tracking drops
    and median inliers within their bounds."""
    if not np.isfinite(np.stack(vo.trajectory)).all():
        fail(f"VO {frontend}: trajectory not finite")
    if not (stats["ate"] <= ate_bound
            and stats["tracking_drops"] <= VO_DROPS_BOUND[frontend]
            and stats["inliers_median"] >= VO_INLIERS_MEDIAN_MIN):
        fail(f"VO {frontend}: ATE (bound {ate_bound} m), tracking drops "
             f"(bound {VO_DROPS_BOUND[frontend]}) or median inliers (at "
             f"least {VO_INLIERS_MEDIAN_MIN}) out of bounds: {stats}")


def _say_profile(frontend, cam, pairs, stats, card):
    """Profile a fresh StereoVO of ``frontend`` over ``pairs`` and print its
    device ms per frame by stage beside the unprofiled run's wall time."""
    from steroscopic_hardware_tpu_torch.models import slam

    stage, total, n_launch, wall = profile_vo(
        slam.StereoVO(cam, device="cuda", seed=SEED, frontend=frontend,
                      **VO), pairs)
    if total <= 0.0 or min(stage.values()) <= 0.0:
        fail(f"the profiler saw no kernel of a VO stage: {stage}")
    say(f"phase 6v: {frontend}: device ms per frame by stage "
        f"(torch.profiler, {len(pairs) - 1} frames): "
        + ", ".join(f"{k[3:]} {stage[k]:.4f}" for k in STAGES)
        + ", outside the stages (RANSAC draws, copies) "
        f"{total - sum(stage.values()):.4f}; all kernels {total:.4f} ms in "
        f"{n_launch:.1f} launches, "
        f"profiled wall {wall:.4f} ms per frame; device busy "
        f"{total / stats['frame_ms_median']:.4f} of the unprofiled wall "
        f"({card})")


def phase_vo(card):
    """Phase 6v: B2s and the sgm front end's chain at KITTI geometry, one
    track step per front end card against CPU, a 40-frame synthetic loop
    through StereoVO.process on the card (sad), a shorter sgm run, and
    despair.run_sad."""
    from steroscopic_hardware_tpu_torch import _kernels, despair
    from steroscopic_hardware_tpu_torch.models import slam
    from steroscopic_hardware_tpu_torch.models.vo import gumbel_scores
    from steroscopic_hardware_tpu_torch.ops import sad
    from steroscopic_hardware_tpu_torch.vo import run, synthetic_sequence

    t0 = time.perf_counter()
    cam, pairs, gt = synthetic_sequence(VO_FRAMES, trajectory="loop",
                                        seed=SEED)
    render_s = time.perf_counter() - t0
    h, w = pairs[0][0].shape
    b, d = VO["block_size"], VO["max_disparity"]
    kw = dict(block_size=b, max_disparity=d)

    # 1. B2s: sad_lr with costs and the parabola, card against plain
    L, R = to_cuda(*pairs[0])
    got = sad.disparity_lr(L, R, with_costs=True, **kw)
    want = sad.disparity_raw_lr_plain(L, R, with_costs=True, **kw)
    err = max(_err(g, x) for g, x in zip(got, want))
    sub = sad.disparity_subpixel(L, R, **kw)
    sub_plain = sad.disparity_subpixel_plain(L, R, **kw)
    err = max(err, _err(sub[0], sub_plain[0]), _err(sub[1], sub_plain[1]))
    if err != 0.0:
        fail(f"B2s at {h}x{w} b{b} d{d}: max abs error {err}")
    ms = _time_ms(lambda: sad.disparity_lr(L, R, with_costs=True, **kw))
    plain_ms = _time_ms(lambda: sad.disparity_raw_lr_plain(
        L, R, with_costs=True, **kw), warmup=1, reps=5)
    sub_ms = _time_ms(lambda: sad.disparity_subpixel(L, R, **kw))
    bound_ms, bound_by = sad_bound("sad_lr_costs", d, h * w)
    say(f"phase 6v: B2s {w}x{h} b{b} d{d}: kernel == plain (5 maps and the "
        f"subpixel map, max abs error 0); sad_lr with costs {ms:.4f} ms, "
        f"with the parabola {sub_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}) ({card})")
    b2s = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    del L, R, got, want, sub, sub_plain

    # 2. the sgm front end's kernels at its shapes (D 129 over 376 x 1241)
    stages = _check_sgm_chain(*to_cuda(*pairs[0]), d)
    say(f"phase 6v: sgm front end {w}x{h} d{d}, card == plain (max abs "
        f"error): " + ", ".join(f"{k} {e}" for k, e in stages.items()))
    _free()

    # 3. one _track_step per front end on the card against the same step on
    # the CPU, with the same previous features and RANSAC scores
    cpu = [torch.from_numpy(a) for a in (*pairs[0], *pairs[1])]
    scores = gumbel_scores(slam.N_HYPOTHESES, VO["max_keypoints"],
                           torch.Generator().manual_seed(SEED), "cpu")
    for frontend in ("sad", "sgm"):
        static = dict(VO, intr=cam.intr, baseline=cam.baseline,
                      frontend=frontend)
        prev = slam._frame_frontend(cpu[0], cpu[1], **static)
        want = slam._track_step(cpu[2], cpu[3], *prev[2:], scores, **static)
        got = slam._track_step(*to_cuda(*pairs[1]),
                               *(t.cuda() for t in prev[2:]), scores.cuda(),
                               **static)
        share, pts_err, xi_err, n_inl, n_valid = _check_track(got, want)
        say(f"phase 6v: one track step ({frontend}), card == CPU: keypoints "
            f"exact ({n_valid} of {VO['max_keypoints']} slots valid), "
            f"descriptor bits equal {share:.6f}, relative point error "
            f"{pts_err:.3g}, twist error {xi_err:.3g}, inliers {n_inl} on "
            f"both")

    # 4. the main path: the loop through StereoVO.process on the card
    vo = slam.StereoVO(cam, device="cuda", seed=SEED, **VO)
    _kernels.reset_launches()
    stats = run(vo, pairs, gt)
    launches = dict(_kernels.launches)
    if launches["sad_lr"] != VO_FRAMES:
        fail(f"sad_lr launched {launches['sad_lr']} times in "
             f"{VO_FRAMES} VO frames")
    _check_vo("sad", vo, stats, VO_ATE_BOUND)
    say(f"phase 6v: {VO_FRAMES}-frame synthetic loop {w}x{h} "
        f"({render_s:.1f} s to render), StereoVO sad on the card: ATE "
        f"{stats['ate']:.6f} m (bound {VO_ATE_BOUND}), inliers min "
        f"{stats['inliers_min']} median {stats['inliers_median']}, tracking "
        f"drops {stats['tracking_drops']}, valid keypoint slots median "
        f"{stats['valid_keypoints_median']:.4f} min "
        f"{stats['valid_keypoints_min']:.4f}, wall ms per frame median "
        f"{stats['frame_ms_median']:.4f} (first {stats['first_frame_ms']:.1f})"
        f", launches {launches} ({card})")
    _say_profile("sad", cam, pairs[:VO_PROFILED + 1], stats, card)

    # 5. a shorter run through the SGM front end (B3, B4)
    vo = slam.StereoVO(cam, device="cuda", seed=SEED, frontend="sgm", **VO)
    _kernels.reset_launches()
    sgm = run(vo, pairs[:VO_SGM_FRAMES], gt)
    sgm_launches = dict(_kernels.launches)
    if sgm_launches["sgm_aggregate"] != 2 * VO_SGM_FRAMES:
        fail(f"VO sgm: {sgm}, launches {sgm_launches}")
    _check_vo("sgm", vo, sgm, VO_SGM_ATE_BOUND)
    say(f"phase 6v: {VO_SGM_FRAMES} frames StereoVO sgm on the card: ATE "
        f"{sgm['ate']:.6f} m (bound {VO_SGM_ATE_BOUND}), inliers min "
        f"{sgm['inliers_min']} median {sgm['inliers_median']}, tracking "
        f"drops {sgm['tracking_drops']}, wall ms per "
        f"frame median {sgm['frame_ms_median']:.4f}, launches "
        f"{sgm_launches} ({card})")
    _say_profile("sgm", cam, pairs[:VO_SGM_FRAMES], sgm, card)

    # 6. the despair facade on the card, b7 d64 at 640x480
    rng = np.random.default_rng(SEED + 6)
    left, right = random_pair(rng, (480, 640))
    _kernels.reset_launches()
    out = despair.run_sad(left, right, 7, 64)
    Lc, Rc = to_cuda(left, right)
    want = sad.disparity_plain(Lc, Rc, block_size=7,
                               max_disparity=64).cpu().numpy()
    if _kernels.launches["sad_wta"] != 1 or not np.array_equal(out, want):
        fail("despair.run_sad on the card != the plain map")
    say("phase 6v ok: despair.run_sad 640x480 b7 d64 on the card == plain")
    _free()
    return b2s, launches["sad_lr"], (cam, pairs, gt, stats)


# -- phase 7: the SLAM backend and live SLAM serving ---------------------------

SLAM = dict(VO, window=4, kf_every=2, ba_iters=6, loop_closure=True)
# frames before the checkpoint of the sync run: a checkpoint holds only the
# keyframes' features and a resumed engine tracks its first frame against
# the newest keyframe, so the save follows a keyframe (frame 20), and the
# resumed run tracks frame 21 against frame 20 as the uninterrupted one does
SLAM_SAVE_AT = 21
# ATE gates of the SLAM runs: the sync run and the resumed one (which
# repeats it) must beat phase 6v's VO-only ATE on the same frames (first
# chip runs: 0.010184 against 0.018058); the async run, whose BA windows
# coalesce as the backend lags, keeps the VO runs' bound, m
SLAM_ATE_BOUND = 0.05  # first chip runs: async 0.015847
# the resumed run's camera centres against the uninterrupted run's, m: it
# draws as that run does and the card repeats a run bit for bit (0 m
# measured); resumed without the fallback motion they moved 0.052 m
SLAM_RESUME_TOL = 1e-3
# card against CPU on the same inputs, each limit between the spread of
# sound readings and a lower-precision control (slam_probe.py, NVIDIA
# H100, PERF.md section 6): BA over the 19 windows of a 40-frame run,
# twists 1.5e-7..4.7e-6 (observations rounded to float16: 2.2e-4..8.8e-4)
# and error curves 5.9e-6..1.3e-4 relative (0.19..2.1); the 64-node pose
# graph over 16 seeds x 2 horizons, twists 4.3e-6..1.2e-4 (measurements
# rounded to bfloat16: 9.9e-3..3.7e-2) and the final cost 0..2.9e-7 of the
# initial one (2.3e-5..3.9e-4). Its middle iterations' costs are not
# compared: on one graph one of them differed by 4.3% of the initial cost
# on the card and in the control alike, the twists within 1e-4.
BA_XI_TOL = 3e-5
BA_ERR_RTOL = 1e-3
PG_XI_TOL = 1e-3
PG_FINAL_COST_TOL = 3e-6
SLAM_STAGES = ("slam.ba", "slam.loop", "slam.graph")
SERVE_SLAM_SECONDS = 7.0


def _descriptor_sets(rng, B, K):
    """One (K, 256) set and B noisy permuted copies, with duplicated rows
    and invalid slots (tests/test_torch_bow.py's construction)."""
    a = rng.integers(0, 2, (K, 256), dtype=np.uint8)
    a[K // 2: K // 2 + 4] = a[0]
    bs = np.stack([a[rng.permutation(K)]
                   ^ (rng.random((K, 256)) < 0.1).astype(np.uint8)
                   for _ in range(B)])
    return a, bs, rng.random(K) < 0.9, rng.random((B, K)) < 0.9


def check_backend_ops(card, cam, window, K=512):
    """Phase 7.1: the backend's operations on the card against the CPU on
    the same inputs: the batched matches and BowIndex.vector exactly, the
    BA window solve of ``window`` (real keyframes of the sync run) and a
    64-node pose graph, with and without n_fixed, within tolerances."""
    from steroscopic_hardware_tpu_torch.models import slam
    from steroscopic_hardware_tpu_torch.ops import bow, matching
    from steroscopic_hardware_tpu_torch.slam_probe import loop_graph

    rng = np.random.default_rng(SEED + 7)
    t = torch.from_numpy
    dev = "cuda"
    errs = {}
    a, bs, va, vbs = _descriptor_sets(rng, 4, K)
    kw = dict(ratio=0.85, max_distance=60.0)
    for name, fn, args in (
            ("match_batch", matching.match_batch, (bs, a, vbs, va)),
            ("match_one_to_many", matching.match_one_to_many,
             (a, bs, va, vbs))):
        want = fn(*(t(x) for x in args), **kw)
        got = fn(*(t(x).to(dev) for x in args), **kw)
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            fail(f"{name} at K {K}: card != CPU")
        errs[name] = 0.0
    vec_cpu = bow.BowIndex().vector(a, va)
    vec_dev = bow.BowIndex(device=dev).vector(a, va)
    if not np.array_equal(vec_cpu, vec_dev):
        fail(f"BowIndex.vector: card != CPU, max abs error "
             f"{np.abs(vec_cpu - vec_dev).max()}")
    errs["bow_vector"] = 0.0
    # the BA window of real keyframes, solved by a card and a CPU engine
    xi0 = np.stack([kf.xi_world for kf in window]).astype(np.float32)
    solved = {}
    for d in (dev, "cpu"):
        engine = slam.StereoSLAM(cam, device=d, seed=SEED, **SLAM)
        solved[d] = (engine._solve_window(window, xi0), engine.last_ba_errs)
    xi_err = float(np.abs(solved[dev][0] - solved["cpu"][0]).max())
    err_rel = float(np.max(np.abs(solved[dev][1] - solved["cpu"][1])
                           / np.abs(solved["cpu"][1])))
    if xi_err > BA_XI_TOL or err_rel > BA_ERR_RTOL:
        fail(f"ba_solve window of {len(window)} at K {K}: card vs CPU twist "
             f"error {xi_err} (tolerance {BA_XI_TOL}), error curve "
             f"{err_rel} relative (tolerance {BA_ERR_RTOL})")
    errs["ba_solve"] = xi_err
    graph = loop_graph(rng)
    for n_fixed in (None, 16):
        outs = {}
        for d in (dev, "cpu"):
            xi, costs = slam.pose_graph_optimize(
                *(t(x).to(d) for x in graph), iters=10, n_fixed=n_fixed)
            outs[d] = (xi.cpu().numpy(), costs.cpu().numpy())
        pg_err = float(np.abs(outs[dev][0] - outs["cpu"][0]).max())
        costs, costs_cpu = outs[dev][1], outs["cpu"][1]
        cost_rel = float(abs(costs[-1] - costs_cpu[-1]) / costs_cpu[0])
        frozen = n_fixed or 1
        if (pg_err > PG_XI_TOL or cost_rel > PG_FINAL_COST_TOL
                or not np.array_equal(outs[dev][0][:frozen],
                                      graph[0][:frozen])
                or not costs[-1] < costs[0]):
            fail(f"pose_graph_optimize (n_fixed {n_fixed}): card vs CPU "
                 f"twist error {pg_err} (tolerance {PG_XI_TOL}), final "
                 f"cost {cost_rel} of the initial (tolerance "
                 f"{PG_FINAL_COST_TOL}), costs {costs}, CPU {costs_cpu}")
        errs[f"pose_graph n_fixed={n_fixed}"] = pg_err
        errs[f"pose_graph n_fixed={n_fixed} final cost (of the initial)"] = (
            cost_rel)
    say(f"phase 7: backend ops at K {K}, card vs CPU (max abs error): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; BA window of {len(window)} keyframes error curve "
        f"{err_rel:.3g} relative; 64-node pose graph with loop edges, frozen "
        f"nodes bit for bit ({card})")


def _slam_gates(tag, engine, gt, bound):
    """A run's gates: finite poses, a BA run and a closure, no backend
    error, ATE below ``bound`` (m), and the newest BA window's error curve
    and the newest closure's pose-graph cost falling."""
    from steroscopic_hardware_tpu_torch.models.slam import ate_rmse

    ate = ate_rmse(engine.vo.positions(), gt)
    ba, pg = engine.last_ba_errs, engine.last_pg_costs
    if not (np.isfinite(np.stack(engine.vo.trajectory)).all()
            and engine.ba_runs >= 1 and engine.loops_closed >= 1
            and engine.backend_errors == 0 and ate < bound
            and ba[-1] < ba[0] and pg[-1] < pg[0]):
        fail(f"StereoSLAM {tag}: ba_runs {engine.ba_runs}, loops_closed "
             f"{engine.loops_closed}, backend_errors "
             f"{engine.backend_errors}, ATE {ate} (bound {bound}), newest "
             f"BA error curve {ba}, pose-graph costs {pg}")
    return ate


def profile_stages(engine):
    """Device ms and launches of one BA window, one loop check and one
    pose-graph solve (``engine``'s final state; torch.profiler, kernels
    attributed to the labels slam.ba, slam.loop, slam.graph by their span
    on the device timeline). The frames themselves run unprofiled: the
    profiler's events of a 19-frame run took minutes to process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in (("slam.ba", engine._refine_window),
                     ("slam.loop", engine._try_loop_closure),
                     ("slam.graph", engine._optimize_pose_graph)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        spans = [(e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and e.name == name]
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name not in SLAM_STAGES
                   and any(a <= e.time_range.start < b for a, b in spans)]
        if not kernels:
            fail(f"the profiler saw no kernel of {name}")
        out[name] = (sum(k.time_range.elapsed_us() for k in kernels) / 1e3,
                     len(kernels))
    return out


def phase_slam(card, cam, pairs, gt, vo_stats):
    """Phase 7.2-7.4: StereoSLAM with BoW loop closure on the card, sync
    and async, and a checkpoint resume, over phase 6v's 40-frame loop."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.models import slam
    from steroscopic_hardware_tpu_torch.vo import run_slam

    n = len(pairs)
    _kernels.reset_launches()
    engine = slam.StereoSLAM(cam, device="cuda", seed=SEED, **SLAM)
    ckpt = os.path.join(tempfile.mkdtemp(), "slam-sync.ckpt")
    first = run_slam(engine, pairs[:SLAM_SAVE_AT])
    engine.save_checkpoint(ckpt)
    saved = dict(frame_idx=engine.frame_idx, hist=len(engine.kf_history),
                 keyframes=len(engine.keyframes),
                 edges=[(i, j) for i, j, _ in engine.graph_edges])
    rest = run_slam(engine, pairs[SLAM_SAVE_AT:])
    launches = dict(_kernels.launches)
    if launches["sad_lr"] != n:
        fail(f"StereoSLAM sync: sad_lr launched {launches['sad_lr']} times "
             f"in {n} frames")
    ate = _slam_gates("sync", engine, gt, vo_stats["ate"])
    wall = float(np.median([first["frame_ms_median"],
                            rest["frame_ms_median"]]))
    say(f"phase 7: StereoSLAM sync {n} frames ({SLAM}) on the card: ATE "
        f"{ate:.6f} m (below VO only, phase 6v, {vo_stats['ate']:.6f}), "
        f"newest BA error curve {engine.last_ba_errs[0]:.6g} -> "
        f"{engine.last_ba_errs[-1]:.6g}, pose-graph cost "
        f"{engine.last_pg_costs[0]:.6g} -> {engine.last_pg_costs[-1]:.6g}, "
        f"ba_runs {engine.ba_runs}, loops_closed "
        f"{engine.loops_closed}, keyframes {len(engine.kf_history)}, "
        f"backend_errors {engine.backend_errors}, stage_s "
        + json.dumps({k: round(v, 4) for k, v in engine.stage_s.items()})
        + f", frame wall ms median {wall:.4f} (VO only {vo_stats['frame_ms_median']:.4f}), "
        f"launches {launches} ({card})")
    check_backend_ops(card, cam, list(engine.keyframes),
                      K=VO["max_keypoints"])

    asyn = slam.StereoSLAM(cam, device="cuda", seed=SEED,
                           async_backend=True, **SLAM)
    try:
        stats = run_slam(asyn, pairs, gt)
    finally:
        asyn.close()
    ate_async = _slam_gates("async", asyn, gt, SLAM_ATE_BOUND)
    say(f"phase 7: StereoSLAM async on the card after finish(): ATE "
        f"{ate_async:.6f} m (bound {SLAM_ATE_BOUND}), ba_runs "
        f"{asyn.ba_runs}, loops_closed "
        f"{asyn.loops_closed}, backend_coalesced {asyn.backend_coalesced}, "
        f"backend_errors {asyn.backend_errors}, frame wall ms median "
        f"{stats['frame_ms_median']:.4f} (sync {wall:.4f}) ({card})")

    resumed = slam.StereoSLAM.load_checkpoint(
        ckpt, device="cuda", seed=SEED,
        **{k: v for k, v in SLAM.items() if k not in ("window", "kf_every")})
    got = dict(frame_idx=resumed.frame_idx, hist=len(resumed.kf_history),
               keyframes=len(resumed.keyframes),
               edges=[(i, j) for i, j, _ in resumed.graph_edges])
    if got != saved:
        fail(f"checkpoint resume: {got} != the uninterrupted run's {saved}")
    run_slam(resumed, pairs[SLAM_SAVE_AT:])
    ate_resumed = _slam_gates("resumed", resumed, gt, vo_stats["ate"])
    # the resumed run draws as the uninterrupted one and so repeats it
    resume_dev = float(np.abs(resumed.vo.positions()
                              - engine.vo.positions()).max())
    if resume_dev > SLAM_RESUME_TOL:
        fail(f"checkpoint resume: camera centres {resume_dev} m from the "
             f"uninterrupted run's (tolerance {SLAM_RESUME_TOL})")
    stages = profile_stages(resumed)
    ref = {"positions": engine.vo.positions(),
           "keyframes": [ti for _, ti in engine.kf_history]}
    st = engine.stage_s
    wall = {"slam.ba": st["ba"] / engine.ba_runs,
            "slam.loop": (st["loop"] - st["graph"]) / len(engine.kf_history),
            "slam.graph": st["graph"] / engine.loops_closed}
    say(f"phase 7: checkpoint after {SLAM_SAVE_AT} frames loaded on the "
        f"card (frame_idx {got['frame_idx']}, {got['hist']} keyframes, "
        f"{len(got['edges'])} edges, as the uninterrupted run), then "
        f"{n - SLAM_SAVE_AT} frames: ATE {ate_resumed:.6f} m (below VO "
        f"only), camera centres within {resume_dev:.3g} m of the "
        f"uninterrupted run's; device ms "
        f"and launches (torch.profiler, on the resumed run's final state) "
        f"beside the sync run's wall ms per "
        + ", ".join(f"{name[5:]}: {ms:.4f} ms in {k} launches, wall "
                    f"{1e3 * wall[name]:.1f} ms"
                    for name, (ms, k) in stages.items())
        + f" ({card})")
    _free()
    return launches, ref


def phase_serve_slam(card, left, right):
    """Phase 7.5: the live server with --slam --loop-closure at 1080p,
    fused and then --no-slam-fused, each over a 7 s window that opens
    once the backend warmup is done."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.__main__ import build_app
    from steroscopic_hardware_tpu_torch.io.png import write_png
    from steroscopic_hardware_tpu_torch.ops import sad

    L, R = (torch.from_numpy(a).to("cuda") for a in (left, right))
    want = sad.disparity_plain(L, R, block_size=16,
                               max_disparity=64).cpu().numpy()
    del L, R
    total = {"sad_wta": 0, "sad_lr": 0}
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        lp, rp = os.path.join(tmp, "left.png"), os.path.join(tmp, "right.png")
        write_png(lp, left)
        write_png(rp, right)
        h, w = left.shape
        argv = ["--left", lp, "--right", rp, "--fps", "60", "--no-open",
                "--device", "cuda", "--port", "0", "--slam",
                "--loop-closure", "--cx", str(w / 2), "--cy", str(h / 2)]
        for fused in (True, False):
            tag = "fused" if fused else "no-slam-fused"
            _kernels.reset_launches()
            app = build_app(argv + ([] if fused else ["--no-slam-fused"]))
            app.start()
            try:
                base = app.url
                _wait_frames(base, 20)
                # the window opens once the backend warmup (a boot thread
                # that competes for the GIL) is done
                t_warm = time.time()
                while not json.loads(_get(base + "/slam")).get("warm"):
                    if time.time() - t_warm > 120:
                        fail(f"--slam {tag}: the backend warmup did not "
                             f"finish in 120 s")
                    time.sleep(0.1)
                m0, s0 = _metrics(base), json.loads(_get(base + "/slam"))
                t0 = time.time()
                time.sleep(SERVE_SLAM_SECONDS)
                m1, s1 = _metrics(base), json.loads(_get(base + "/slam"))
                window = time.time() - t0
                got = _served_out(base)
                tum = _get(base + "/slam/trajectory").decode().split("\n")
                js = json.loads(_get(base + "/slam/trajectory?format=json"))
            finally:
                app.shutdown()
            launches = dict(_kernels.launches)
            tracked = (app.server.ctx.pipeline.frames if fused
                       else app.slam_pipeline.frames)
            rows = [r.split() for r in tum if r]
            if got.shape != want.shape or not np.array_equal(got, want):
                fail(f"--slam {tag}: /stream/out differs from plain")
            backend_errors = app.slam_pipeline.slam.backend_errors
            if not (s1["enabled"] and s1["fused"] == fused
                    and s1["frames"] > 0 and s1["keyframes"] > 0
                    and s1["errors"] == 0 and s1["fused_dropped"] == 0
                    and m1["errors"] == 0 and backend_errors == 0):
                fail(f"--slam {tag}: backend_errors {backend_errors}, /slam "
                     f"{json.dumps(s1)[:600]}")
            if not (rows and all(len(r) == 8 for r in rows)
                    and len(js["xi"]) >= len(rows)
                    and np.isfinite(np.array(js["xi"])).all()):
                fail(f"--slam {tag}: /slam/trajectory does not parse")
            if launches["sad_lr"] != tracked or launches["sad_wta"] < 1:
                fail(f"--slam {tag}: sad_lr launched {launches['sad_lr']} "
                     f"times for {tracked} tracked frames; {launches}")
            for k in total:
                total[k] += launches[k]
            busy = ((m1["device_s"] - m0["device_s"]) / window
                    if m1["device_s"] is not None else float("nan"))
            slam_fps = (s1["positions_total"] - s0["positions_total"]) / window
            lines.append(
                f"{tag}: served fps {m1['fps']}, lat_serve_p50 "
                f"{m1.get('lat_serve_p50')} ms p95 {m1.get('lat_serve_p95')} "
                f"ms, device busy {busy:.4f}, SLAM frames per second "
                f"{slam_fps:.4f}, keyframes {s1['keyframes']}, ba_runs "
                f"{s1['ba_runs']}, loops_closed {s1['loops_closed']}, "
                f"backend_pending {s1['backend_pending']}, warm {s1['warm']}, "
                f"frames tracked {tracked}, launches {launches}")
    say(f"phase 7 ok: live --slam --loop-closure {w}x{h} SAD b16 d64, "
        f"{SERVE_SLAM_SECONDS:.0f} s windows, /stream/out == plain, /slam "
        f"and /slam/trajectory (TUM, JSON) served; " + "; ".join(lines)
        + f" ({card})")
    return total


# -- phase 8: rectification and calibrated serving at 1080p -------------------

# a synthetic calibrated rig at the reference cameras' size: both cameras
# fx = fy = 1400 px, principal point off centre, barrel distortion, a small
# rotation between them and a 12 cm baseline
RIG_K = [[1400.0, 0.0, 963.0], [0.0, 1400.0, 538.0], [0.0, 0.0, 1.0]]
RIG_DIST1 = [-0.12, 0.03, 5e-4, -3e-4, 0.0]
RIG_DIST2 = [-0.10, 0.02, 0.0, 0.0, 0.0]
RIG_PHI = [0.01, -0.02, 0.005]
RIG_T = [-0.12, 0.002, 0.001]
# remap, card against CPU: at most one grey level apart, on at most this
# share of the pixels (tests/test_torch_rectify.py holds the port's CPU
# remap to the JAX one by the same rule)
REMAP_SHARE = 1e-4
# float32 operations per output pixel and camera of remap: two floors, the
# clamps and subtractions of the taps and weights (8), the blend's two
# complements, eight products and three sums, the inside test (4) and the
# select
REMAP_OPS = 28
RECT_SECONDS = 3.0  # served-fps windows, with and without --calib
SETTLE_FRAMES = 10  # frames served before /stream/out is checked


def _write_rig(path, distorted=True):
    from steroscopic_hardware_tpu_torch.io.calib import save_calibration
    from steroscopic_hardware_tpu_torch.ops.se3_np import so3_exp

    if distorted:
        save_calibration(path, K1=RIG_K, K2=RIG_K,
                         R=so3_exp(np.array(RIG_PHI)), T=RIG_T, size=(H, W),
                         dist1=RIG_DIST1, dist2=RIG_DIST2)
    else:  # the identity rig: rectification is a no-op
        K = [[1400.0, 0.0, W / 2], [0.0, 1400.0, H / 2], [0.0, 0.0, 1.0]]
        save_calibration(path, K1=K, K2=K, R=np.eye(3), T=[-0.12, 0.0, 0.0],
                         size=(H, W))


def _dispatched(fn):
    """(ops, uploads) of one call of ``fn``, counted where torch dispatches
    them in this thread, so no profiler session is needed: ``ops`` names
    the aten operations that write a tensor on the card, views apart (each
    one launches a kernel); ``uploads`` gives, of those, each that reads a
    host tensor of one dimension or more (a copy to the card by any route:
    ``.to``, ``.cuda``, ``copy_``), its host tensors' shapes."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    ops, uploads = [], []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns)
            if not view and any(isinstance(t, torch.Tensor) and t.is_cuda
                                for t in tree_leaves(out)):
                ops.append(func.__name__)
                host = [tuple(t.shape) for t in tree_leaves((args, kwargs))
                        if isinstance(t, torch.Tensor)
                        and t.device.type == "cpu" and t.dim() > 0]
                if host:
                    uploads.append(host)
            return out

    with Log():
        fn()
    torch.cuda.synchronize()
    return ops, uploads


def _serve_window(argv, want):
    """Serve with ``argv`` from zeroed launch counters: after SETTLE_FRAMES
    frames check /stream/out against ``want`` (None: no check), then count
    the frames of a RECT_SECONDS window. Returns (window fps, /metrics
    pipeline dict, the pipeline after shutdown, launches)."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.__main__ import build_app

    _kernels.reset_launches()
    app = build_app(argv).start()
    try:
        base = app.url
        _wait_frames(base, SETTLE_FRAMES)
        if want is not None:
            got = _served_out(base)
            if got.shape != want.shape or not np.array_equal(got, want):
                n = int((got != want).sum()) if got.shape == want.shape else -1
                fail(f"{argv[-3:]}: /stream/out differs from the plain path "
                     f"in {n} pixels")
        m0, t0 = _metrics(base), time.time()
        time.sleep(RECT_SECONDS)
        m1 = _metrics(base)
        fps = (m1["frames"] - m0["frames"]) / (time.time() - t0)
    finally:
        app.shutdown()
    if m1["errors"]:
        fail(f"{argv[-3:]}: pipeline errors {m1}")
    return fps, m1, app.server.ctx.pipeline, dict(_kernels.launches)


def phase_rectify(card, left, right):
    """Phase 8: ``--calib`` at 1080p. The maps card == CPU; remap card
    against CPU; its time beside its bound; the calibrated server's
    /stream/out == the plain path (CPU rectifier, then plain disparity) for
    SAD, --lr-check and --backend sgm; one host-to-device copy per served
    batch; served fps with and without --calib; live --slam --calib."""
    from steroscopic_hardware_tpu_torch.io.calib import load_calibration
    from steroscopic_hardware_tpu_torch.io.png import write_png
    from steroscopic_hardware_tpu_torch.models.blockmatch import (
        BlockMatcher,
        sgm_one,
    )
    from steroscopic_hardware_tpu_torch.ops import sad
    from steroscopic_hardware_tpu_torch.ops.lr_check import check_from_raw
    from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
    from steroscopic_hardware_tpu_torch.runtime.pipeline import DepthPipeline
    from steroscopic_hardware_tpu_torch.utils.params import Parameters

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rig, ident = (os.path.join(tmp, f) for f in ("rig.json", "id.json"))
        _write_rig(rig)
        _write_rig(ident, distorted=False)
        rect, rect_cpu = (load_calibration(rig, device=d)
                          for d in ("cuda", "cpu"))
        # 1. the maps, built on the host, reach the card unchanged
        for a, b in zip(rect._maps, rect_cpu._maps):
            if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
                fail("rectification maps on the card differ from the CPU's")
        # 2. remap, card against CPU, on phase 4's pair as raw frames
        raw = torch.from_numpy(np.stack([left, right])[None])
        stacked = raw.to("cuda")
        rectified = rect.apply(stacked)
        want = rect_cpu.apply(raw)
        diff = (rectified.cpu().to(torch.int32) - want.to(torch.int32)).abs()
        max_diff, share = int(diff.max()), float((diff != 0).double().mean())
        if max_diff > 1 or share > REMAP_SHARE:
            fail(f"remap card vs CPU: max {max_diff} levels on {share} of "
                 f"the pixels (gate 1 on {REMAP_SHARE})")
        ident_rect = load_calibration(ident, device="cuda")
        if not torch.equal(ident_rect.apply(stacked), stacked):
            fail("the identity rig's rectification is not exact")
        # 3. time of one rectified pair, its launches, its bound, the serve
        # step it precedes, and grid_sample (a near function: it zeroes
        # each tap outside the source, remap the whole sample)
        rect.apply(stacked)  # its taps, built once per source size
        ms = _time_ms(lambda: rect.apply(stacked))
        kernels, _ = _dispatched(lambda: rect.apply(stacked))
        px = H * W
        bound_ms, bound_by = _bound(2 * px + 2 * 2 * 4 * px + 2 * px,
                                    2 * REMAP_OPS * px, F32_OPS)
        serve = BlockMatcher(device="cuda").serve_fn(
            Parameters(16, 64), False, 1, True, False)
        serve_ms = _time_ms(lambda: serve(rectified))
        grid = torch.stack([rect.map_x / (W - 1) * 2 - 1,
                            rect.map_y / (H - 1) * 2 - 1], dim=-1)
        grid_ms = _time_ms(lambda: torch.nn.functional.grid_sample(
            stacked[0, :, None].float(), grid, mode="bilinear",
            padding_mode="zeros", align_corners=True).to(torch.uint8))
        out["remap"] = dict(ms=ms, launches=len(kernels), bound_ms=bound_ms,
                            bound_by=bound_by, max_diff=max_diff, share=share,
                            serve_ms=serve_ms, grid_sample_ms=grid_ms)
        say(f"phase 8: remap 1080p pair (2, 1080, 1920) u8: card == CPU maps "
            f"bit for bit; card vs CPU max {max_diff} levels on {share} of "
            f"the pixels; identity rig exact; {ms:.4f} ms in {len(kernels)} "
            f"launches ({' '.join(kernels)}), bound {bound_ms:.4f} ms ({bound_by}); the SAD b16 "
            f"d64 serve step after it {serve_ms:.4f} ms; grid_sample "
            f"{grid_ms:.4f} ms ({card})")
        del grid, diff
        # 4. one host-to-device copy per served batch (SAD, --lr-check)
        bus = FrameBus()
        bus.publish("left", left)
        bus.publish("right", right)
        pairs = [(time.time(), (left, right))] * 4
        for lr in (False, True):
            pipe = DepthPipeline(bus, BlockMatcher(device="cuda"),
                                 lr_check=lr, rectifier=rect)
            pipe._step_batch(pairs)
            _, htod = _dispatched(lambda: [pipe._step_batch(pairs)
                                           for _ in range(3)])
            if htod != [[(len(pairs), 2, H, W)]] * 3:
                fail(f"rectified serve, lr={lr}: {len(htod)} host-to-device "
                     f"copies in 3 batches, of host tensors {htod}")
        # 5. the calibrated server against the plain path: the CPU
        # rectifier's frames, then the plain disparity
        L, R = (t.to("cuda") for t in want[0])
        plain = {"sad": sad.disparity_plain(L, R, block_size=16,
                                            max_disparity=64),
                 "lr": check_from_raw(*sad.disparity_raw_lr_plain(
                     L, R, block_size=16, max_disparity=64), W, 64)[0]}
        with _plain_chain():
            plain["sgm"] = sgm_one(L, R, max_disparity=64, p1=1.0, p2=8.0,
                                   subpixel=True, lr=False, threshold=1.0)
        plain = {k: v.cpu().numpy() for k, v in plain.items()}
        del L, R, stacked, rectified, want
        _free()
        lp, rp = os.path.join(tmp, "left.png"), os.path.join(tmp, "right.png")
        write_png(lp, left)
        write_png(rp, right)
        argv = ["--left", lp, "--right", rp, "--fps", "60", "--no-open",
                "--device", "cuda", "--port", "0"]
        cal = ["--calib", rig]
        launches = {}
        fps = {}
        for key, flags, check in (
                ("sad", [], "sad_wta"), ("lr", ["--lr-check"], "sad_lr"),
                ("sgm", ["--backend", "sgm"], "sgm_aggregate")):
            fps[key], m, pipe, n = _serve_window(argv + flags + cal,
                                                 plain[key])
            launches[key] = n
            # SAD: one launch per batch; SGM: two aggregations a frame
            want_n = 2 * pipe.frames if key == "sgm" else pipe.batches
            if n[check] != want_n or want_n == 0:
                fail(f"--calib {key}: {check} launched {n[check]} times for "
                     f"{pipe.batches} batches / {pipe.frames} frames")
        fps["raw"], _, _, _ = _serve_window(argv, None)
        out["fps"] = fps
        # 6. live SLAM on the rectified rig (fused)
        from steroscopic_hardware_tpu_torch.__main__ import build_app
        from steroscopic_hardware_tpu_torch import _kernels

        _kernels.reset_launches()
        app = build_app(argv + cal + ["--slam", "--loop-closure"]).start()
        try:
            base, t0 = app.url, time.time()
            while True:
                s = json.loads(_get(base + "/slam"))
                if s["frames"] >= 3 and s["keyframes"] >= 1:
                    break
                if time.time() - t0 > 180:
                    fail(f"--slam --calib: {json.dumps(s)[:400]}")
                time.sleep(0.1)
            m = _metrics(base)
        finally:
            app.shutdown()
        tracked = app.server.ctx.pipeline.frames
        slam = dict(_kernels.launches)
        backend_errors = app.slam_pipeline.slam.backend_errors
        # the boot warmup (stopped by the shutdown if still running) must
        # not have failed: in a fresh process it races the frame thread's
        # first linear-algebra call
        warm = app.slam_pipeline._warm_done
        if not (s["fused"] and s["errors"] == 0 and s["fused_dropped"] == 0
                and m["errors"] == 0 and backend_errors == 0 and warm
                and slam["sad_lr"] == tracked > 0):
            fail(f"--slam --calib: sad_lr {slam['sad_lr']} for {tracked} "
                 f"tracked frames, backend_errors {backend_errors}, warmup "
                 f"done {warm}, /slam {json.dumps(s)[:400]}")
        cam = app.slam_pipeline.slam.cam
        launches["slam"] = slam
    nonzero = {k: {n: v for n, v in d.items() if v}
               for k, d in launches.items()}
    say(f"phase 8 ok: --calib 1080p /stream/out == CPU rectifier + plain for "
        f"SAD b16 d64, --lr-check and --backend sgm d64; one host-to-device "
        f"copy per served batch; served fps over "
        f"{RECT_SECONDS:.0f} s: --calib {fps['sad']:.2f}, --calib --lr-check "
        f"{fps['lr']:.2f}, --calib --backend sgm {fps['sgm']:.2f}, without "
        f"--calib {fps['raw']:.2f}; --slam --loop-closure --calib fused: "
        f"{s['frames']} SLAM frames, {s['keyframes']} keyframes, camera fx "
        f"{cam.fx} cx {cam.cx} cy {cam.cy} baseline {cam.baseline:.6f}, "
        f"sad_lr {slam['sad_lr']} for {tracked} tracked frames; launches "
        f"{nonzero} ({card})")
    out["launches"] = launches
    return out


PAR_WORLDS = (2, 4)        # ranks on the one card
PAR_SAD = ((16, 64), (31, 256))  # h 15 < 270 rows a band at 4 ranks
PAR_SGM_MAXD = 64
PAR_BA = (4, 512)          # the SLAM window: keyframes x landmarks
PAR_PG_NODES = 64
PAR_ITERS = 10
PAR_SLAM_WORLD = 2
PAR_SLAM_TOL = 1e-3        # m, camera centres against phase 7's sync run
# each rank's launches per frame: the no-fallback gate
PAR_LAUNCHES = {"sad": {"sad_wta": 1},
                "sgm": {"sgm_transpose_add": 1, "sgm_aggregate": 2,
                        "sgm_epilogue": 1}}


def parallel_cases(left, right, with_slam):
    """Phase 9's cases (``parallel.dryrun.run_cases``) and the BA truth:
    SAD and SGM on the 1080p pair, BA at the SLAM window's size, a 64-node
    pose graph with loop edges, and StereoSLAM(pg_mesh=) over phase 7's
    frames."""
    from steroscopic_hardware_tpu_torch.parallel import dryrun
    from steroscopic_hardware_tpu_torch.vo import KITTI_SIZE

    rng = np.random.default_rng(SEED + 9)
    xi, pts, uv, mask, xi_true = dryrun.ba_problem(rng, *PAR_BA)
    nodes, edges, meas, w = dryrun.loop_graph(rng, PAR_PG_NODES)
    cases = [(f"sad b{b} d{d}", dict(kind="sad", left=left, right=right,
                                     block_size=b, max_disparity=d))
             for b, d in PAR_SAD]
    cases += [(f"sgm d{PAR_SGM_MAXD} subpixel {int(sub)}",
               dict(kind="sgm", left=left, right=right, subpixel=sub,
                    max_disparity=PAR_SGM_MAXD)) for sub in (True, False)]
    cases += [("ba", dict(kind="ba", xi=xi, points=pts, uv=uv, mask=mask,
                          intr=dryrun.BA_INTR, iters=PAR_ITERS)),
              ("pg", dict(kind="pg", nodes=nodes, edges=edges, meas=meas,
                          w=w, iters=PAR_ITERS))]
    if with_slam:
        cases.append(("slam", dict(kind="slam", frames=VO_FRAMES,
                                   size=KITTI_SIZE, seed=SEED, kwargs=SLAM)))
    return cases, xi_true


def _check_parallel(n, name, case, got, want, xi_true, slam_ref):
    """Phase 9's gates of one case over n ranks; a summary for the line."""
    kind = case["kind"]
    tag = f"phase 9: {name} over {n} ranks"
    if kind in PAR_LAUNCHES:
        if not np.array_equal(got["disp"], want["disp"]):
            fail(f"{tag}: the gathered map differs from one process's on "
                 f"{int((got['disp'] != want['disp']).sum())} pixels")
        for j, r in enumerate(got["ranks"]):
            nz = {k: v for k, v in r["launches"].items() if v}
            if nz != PAR_LAUNCHES[kind]:
                fail(f"{tag}: rank {j} launched {nz}, not "
                     f"{PAR_LAUNCHES[kind]}")
        return "== one process"
    if kind == "ba":
        e, e1 = got["errs"], want["errs"]
        d_single = float(np.abs(got["xi"] - want["xi"]).max())
        d_truth = float(np.abs(got["xi"] - xi_true).max())
        if not (np.allclose(e[0], e1[0], rtol=1e-5) and e[-1] < 1e-3
                and d_single <= 5e-3 and d_truth <= 5e-3):
            fail(f"{tag}: errors {e[0]} -> {e[-1]} (one process "
                 f"{e1[0]}), poses {d_single} from one process's, "
                 f"{d_truth} from the truth")
        return (f"error {e[0]:.6g} -> {e[-1]:.3g} px, poses {d_single:.3g} "
                f"from one process's")
    if kind == "pg":
        c, c1 = got["costs"], want["costs"]
        # the float64 node sums are all-reduced before rounding, so the
        # twists are one process's bit for bit
        d = float(np.abs(got["xi"] - want["xi"]).max())
        if not (np.allclose(c[0], c1[0], rtol=1e-5) and c[-1] < 1e-3 * c[0]
                and np.array_equal(got["xi"], want["xi"])):
            fail(f"{tag}: cost {c[0]} -> {c[-1]} (one process {c1[0]}), "
                 f"twists {d} from one process's (must be equal)")
        return f"cost {c[0]:.6g} -> {c[-1]:.3g}, twists equal to one " \
            "process's"
    ranks = got["per_rank"]
    devs = []
    for j, r in enumerate(ranks):
        dev = float(np.abs(r["positions"] - slam_ref["positions"]).max())
        devs.append(dev)
        if (r["loops_closed"] < 1 or r["backend_errors"]
                or r["keyframes"] != ranks[0]["keyframes"]
                or dev > PAR_SLAM_TOL):
            fail(f"{tag}: rank {j} closed {r['loops_closed']} loops, "
                 f"{r['backend_errors']} backend errors, keyframes "
                 f"{r['keyframes']} (rank 0 {ranks[0]['keyframes']}), camera "
                 f"centres {dev} m from phase 7's sync run")
    return (f"{ranks[0]['loops_closed']} loops closed on each rank, "
            f"{len(ranks[0]['keyframes'])} keyframes the same on both "
            f"(phase 7: {len(slam_ref['keyframes'])}), camera centres "
            f"within {max(devs):.3g} m of phase 7's sync run, frame wall ms "
            f"median {ranks[0]['frame_ms_median']:.1f}")


def phase_parallel(card, left, right, slam_ref):
    """Phase 9: the multi-process tier (``parallel/``) on the card, 2 and 4
    gloo ranks through ``parallel.dryrun.launch_cases``: sharded SAD and
    SGM at 1080p against one process bit for bit with each rank's
    launches, BA, the pose graph and StereoSLAM(pg_mesh=)."""
    from steroscopic_hardware_tpu_torch.parallel import dryrun

    launches = {name: 0 for name in SOURCE}
    want = None
    for n in PAR_WORLDS:
        cases, xi_true = parallel_cases(left, right, n == PAR_SLAM_WORLD)
        t0 = time.perf_counter()
        got = dryrun.launch_cases(cases, n, backend="gloo", device="cuda")
        wall = time.perf_counter() - t0
        if want is None:
            want = dryrun.single_rank(
                [c for c in cases if c[1]["kind"] != "slam"],
                torch.device("cuda", 0))
        parts = []
        for name, case in cases:
            r = got[name]
            summary = _check_parallel(n, name, case, r, want.get(name),
                                      xi_true, slam_ref)
            for rank in r["ranks"]:
                for k, v in rank["launches"].items():
                    launches[k] += v
            secs = [round(rank["seconds"], 4) for rank in r["ranks"]]
            sent = [rank["sent_bytes"] for rank in r["ranks"]]
            parts.append(f"{name}: {summary}; seconds by rank {secs}"
                         + (f", bytes sent by rank (halo, all_to_all) "
                            f"{[(b['halo'], b['all_to_all']) for b in sent]}"
                            if case["kind"] in PAR_LAUNCHES else ""))
        say(f"phase 9: {n} gloo ranks on the one card, launch and all cases "
            f"{wall:.1f} s; " + "; ".join(parts) + f" ({card})")
    say(f"phase 9 ok: sharded SAD and SGM == one process bit for bit over "
        f"{PAR_WORLDS} ranks, each rank sad_wta 1 and sgm_transpose_add 1, "
        f"sgm_aggregate 2, sgm_epilogue 1 a frame; BA, pose graph and "
        f"StereoSLAM(pg_mesh=) gates; launches {launches} ({card})")
    return launches


# -- phase 10: live ingest over TCP and serial --------------------------------

INGEST_SHIFTS = (8, 16, 24, 32)  # the K = 4 seeded pairs, one shift each
INGEST_HOLD_S = 3.0     # each pair holds this long on the emitters' shared
#                         clock (an lzma frame takes ~0.7 s to encode)
INGEST_FRAMES = 20      # served frames per run (N)
INGEST_MIN_S = 2.0      # and at least this long a window
INGEST_FPS = 60.0       # the emitters' rate
INGEST_SAMPLE_S = 0.5   # /stream/out is read this often in a window
INGEST_TIMEOUT = 120.0
SOAK_SMOKE = ("--minutes", "0.25", "--interval", "5")


def ingest_pairs():
    """The K seeded 1080p textured pairs (``serve_probe.textured_pair``),
    each with its own shift."""
    from steroscopic_hardware_tpu_torch.serve_probe import textured_pair

    return [textured_pair(SEED + 10 + k, H, W, shift=s)
            for k, s in enumerate(INGEST_SHIFTS)]


def _cycled(pairs, side):
    """An emitter's frame function: pair k is the slot of the shared wall
    clock, so the two sides change pairs at the same moments."""
    return lambda n: pairs[int(time.time() / INGEST_HOLD_S) % len(pairs)][side]


def _check_published(bus, emitted):
    """Wrap ``bus.publish``: each frame published to a slot of ``emitted``
    (slot -> the frames its camera sends) is counted as byte-equal to one
    of them, or not. Returns {slot: [equal, not equal]}."""
    index = {slot: {zlib.crc32(f): f for f in frames}
             for slot, frames in emitted.items()}
    counts = {slot: [0, 0] for slot in emitted}
    publish = bus.publish

    def checked(name, data, source=""):
        if name in index:
            f = index[name].get(zlib.crc32(np.ascontiguousarray(data)))
            ok = f is not None and np.array_equal(f, data)
            counts[name][0 if ok else 1] += 1
        return publish(name, data, source=source)

    bus.publish = checked
    return counts


def _plain_maps(pairs, lr):
    """{(i, j): the plain b16 d64 map of left i and right j} on the card:
    while the two sides change pairs, a served pair may mix them."""
    from steroscopic_hardware_tpu_torch.ops import sad
    from steroscopic_hardware_tpu_torch.ops.lr_check import check_from_raw

    out = {}
    for i, (left, _) in enumerate(pairs):
        for j, (_, right) in enumerate(pairs):
            L, R = to_cuda(left, right)
            if lr:
                dL, dR = sad.disparity_raw_lr_plain(L, R, block_size=16,
                                                    max_disparity=64)
                m = check_from_raw(dL, dR, W, 64)[0]
            else:
                m = sad.disparity_plain(L, R, block_size=16, max_disparity=64)
            out[i, j] = m.cpu().numpy()
    return out


def _ingest_run(tag, argv, feed, emitted, n=INGEST_FRAMES, rig=None):
    """Build the app from zeroed launch counters, check every frame the
    sources publish against ``emitted``, attach them with ``feed(base)``
    (which returns what to close), serve ``n`` frames over at least
    INGEST_MIN_S, read /stream/out (and the rig's) every INGEST_SAMPLE_S.
    Returns a dict of the run's numbers, samples and launches."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.__main__ import build_app
    from steroscopic_hardware_tpu_torch.io.png import read_png

    outs = ["out"] + ([f"{rig}.out"] if rig else [])
    _kernels.reset_launches()
    app = build_app(argv)
    counts = _check_published(app.manager.bus, emitted)
    app.start()
    closers, samples = [], {o: [] for o in outs}
    try:
        base = app.url
        closers = feed(base)
        _wait_frames(base, 1, timeout=INGEST_TIMEOUT)
        m0, t0 = json.loads(_get(base + "/metrics")), time.time()
        t_sample = 0.0
        while True:
            m = json.loads(_get(base + "/metrics"))
            p = m["pipeline"]
            if p["errors"] or (rig and m["rigs"][rig]["errors"]):
                fail(f"{tag}: pipeline errors {m}")
            elapsed = time.time() - t0
            if time.time() - t_sample >= INGEST_SAMPLE_S:
                t_sample = time.time()
                for o in outs:
                    samples[o].append(read_png(_get(f"{base}/stream/{o}")))
            if (p["frames"] - m0["pipeline"]["frames"] >= n
                    and elapsed >= INGEST_MIN_S):
                break
            if elapsed > INGEST_TIMEOUT:
                fail(f"{tag}: {p['frames'] - m0['pipeline']['frames']} "
                     f"frames of {n} in {INGEST_TIMEOUT:.0f} s: {m}")
            time.sleep(0.05)
        parsers = {slot: type(app.manager.get_source(slot).parser).__name__
                   for slot in emitted}
    finally:
        app.shutdown()
        for c in closers:
            c.close()
    pipes = {"out": app.server.ctx.pipeline}
    if rig:
        pipes[f"{rig}.out"] = app.server.ctx.rigs[rig]
    for pp in pipes.values():
        # shutdown waits 5 s for a pipeline thread; an SGM batch from
        # live cameras can take longer, and its launches and frames must
        # both be counted before they are compared
        pp.close(timeout=INGEST_TIMEOUT)
        if pp._thread.is_alive():
            fail(f"{tag}: the pipeline thread did not stop")
    launches = dict(_kernels.launches)
    if any(bad or not good for good, bad in counts.values()):
        fail(f"{tag}: published frames [equal, not] to an emitted one: "
             f"{counts}")
    fps = {"out": (p["frames"] - m0["pipeline"]["frames"]) / elapsed}
    # the rate each source published at in the window
    src_fps = {slot: (m["sources"][slot]["frames"]
                      - m0["sources"][slot]["frames"]) / elapsed
               for slot in emitted}
    busy = {"out": (p["device_s"] - m0["pipeline"]["device_s"]) / elapsed}
    if rig:
        r0, r1 = m0["rigs"][rig], m["rigs"][rig]
        fps[f"{rig}.out"] = (r1["frames"] - r0["frames"]) / elapsed
        busy[f"{rig}.out"] = (r1["device_s"] - r0["device_s"]) / elapsed
    return dict(fps=fps, busy=busy, samples=samples, parsers=parsers, m0=m0,
                src_fps=src_fps,
                launches=launches, pipes=pipes, counts=counts,
                batches=sum(pp.batches for pp in pipes.values()),
                frames=sum(pp.frames for pp in pipes.values()))


def _match_samples(tag, samples, maps, want=None):
    """Every sample equals some (i, j) plain map; one at least a pair's
    own (i == j), or ``want`` when given. Returns the pairs seen."""
    seen = []
    for got in samples:
        hit = next((k for k, v in maps.items()
                    if got.shape == v.shape and np.array_equal(got, v)), None)
        if hit is None:
            fail(f"{tag}: /stream/out equals the plain map of no pair of the "
                 f"emitted frames")
        seen.append(hit)
    if want is not None:
        if any(s != want for s in seen):
            fail(f"{tag}: /stream/out served pairs {seen}, not {want}")
    elif not any(i == j for i, j in seen):
        fail(f"{tag}: no /stream/out read served one pair's own frames: "
             f"{seen}")
    return seen


def _rates(run):
    return ", ".join(f"{k} {v:.2f} fps" for k, v in run["src_fps"].items())


def _decode_ms(frame, codec):
    """Host ms to parse and decode one encoded frame fed in 64 KiB reads
    (the sources' recv size), the median of 3, and its wire bytes."""
    from steroscopic_hardware_tpu_torch.runtime import wire

    blob = wire.encode_frame(frame, codec=codec)
    ts = []
    for _ in range(3):
        parser = wire.make_parser()
        t0 = time.perf_counter()
        got = []
        for i in range(0, len(blob), 65536):
            got += parser.feed(blob[i:i + 65536])
        ts.append((time.perf_counter() - t0) * 1e3)
        if len(got) != 1 or not np.array_equal(got[0], frame):
            fail(f"codec {codec}: the parser did not return the frame")
    return float(np.median(ts)), len(blob)


def _tcp_feed(frames, codec):
    """feed(base): one CameraEmitter per slot of ``frames`` (slot -> a
    frame or a frame function), attached through /<slot>/configure."""
    from steroscopic_hardware_tpu_torch.serve_probe import attach_emitters

    return lambda base: attach_emitters(base, frames, codec, INGEST_FPS)


def phase_ingest(card):
    """Phase 10: the ingest path at 1080p. 10t: TCP CameraEmitters in codec
    raw, range and lzma (and raw with --lr-check) attached through
    /left/configure and /right/configure; 10s: SerialEmitters on two ptys,
    --serial left=... and /right/configure device=...; 10d: a static TCP
    pair with and without --dedup-uploads; 10r: two rigs (--rig b) on four
    TCP emitters; 10g: --backend sgm over raw TCP; 10k: the soak tool for
    a quarter minute on --slam --loop-closure."""
    from steroscopic_hardware_tpu_torch._native import get_lib
    from steroscopic_hardware_tpu_torch.models.blockmatch import sgm_one
    from steroscopic_hardware_tpu_torch.runtime import wire
    from steroscopic_hardware_tpu_torch.runtime.emitter import SerialEmitter

    if get_lib() is None:
        fail("phase 10: the native library (native/, make and g++) did not "
             "build: the sources would parse in Python")
    pairs = ingest_pairs()
    maps = {lr: _plain_maps(pairs, lr) for lr in (False, True)}
    lefts, rights = [p[0] for p in pairs], [p[1] for p in pairs]
    cycled = {"left": _cycled(pairs, 0), "right": _cycled(pairs, 1)}
    base_argv = ["--no-open", "--device", "cuda", "--port", "0"]
    totals = {name: 0 for name in SOURCE}

    def note(msg):
        say(f"phase 10: {msg}")

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    def gate_launches(tag, run, kernel):
        """``kernel`` launched once per served batch, no other kernel."""
        nz = {k: v for k, v in run["launches"].items() if v}
        want = {kernel: run["batches"]}
        if nz != want:
            fail(f"{tag}: launches {nz}, not {want} ({run['batches']} "
                 f"batches, {run['frames']} frames)")

    # 10t: TCP, each codec; raw again with --lr-check
    for codec, lr in ((wire.CODEC_RAW, False), (wire.CODEC_RANGE, False),
                      (wire.CODEC_LZMA, False), (wire.CODEC_RAW, True)):
        tag = f"phase 10t codec {codec}" + (" --lr-check" if lr else "")
        run = _ingest_run(tag, base_argv + (["--lr-check"] if lr else []),
                          _tcp_feed(cycled, codec),
                          {"left": lefts, "right": rights})
        seen = _match_samples(tag, run["samples"]["out"], maps[lr])
        gate_launches(tag, run, "sad_lr" if lr else "sad_wta")
        if set(run["parsers"].values()) != {"NativeFrameParser"}:
            fail(f"{tag}: the sources parsed with {run['parsers']}")
        add(run["launches"])
        dec = [_decode_ms(f, codec) for f in (lefts[0], rights[0])]
        note(
            f"10t codec {codec}{' --lr-check' if lr else ''}: served fps "
            f"{run['fps']['out']:.2f} (sources {_rates(run)}), device busy "
            f"{run['busy']['out']:.4f}, {run['frames']} frames in "
            f"{run['batches']} batches, wire bytes per frame "
            f"{np.mean([d[1] for d in dec]):.0f}, parser "
            f"{run['parsers']['left']}, decode ms per frame "
            f"{np.mean([d[0] for d in dec]):.2f}, published frames "
            f"{sum(c[0] for c in run['counts'].values())} all emitted ones, "
            f"/stream/out reads {len(seen)} (pairs {sorted(set(seen))})")

    # 10s: serial over two ptys, raw 1080p
    ptys = [os.openpty() for _ in range(2)]
    paths = [os.ttyname(slave) for _, slave in ptys]
    ems = []

    def serial_feed(base):
        for (master, _), side in zip(ptys, ("left", "right")):
            ems.append(SerialEmitter(cycled[side], master,
                                     fps=INGEST_FPS).start())
        from steroscopic_hardware_tpu_torch.serve_probe import configure

        configure(base, "right", {"device": paths[1], "baud": 921600})
        return []

    try:
        run = _ingest_run("phase 10s", base_argv + [
            "--serial", f"left={paths[0]}@921600"], serial_feed,
            {"left": lefts, "right": rights})
    finally:
        for em in ems:
            em.close()
        for _, slave in ptys:
            os.close(slave)
    seen = _match_samples("phase 10s", run["samples"]["out"], maps[False])
    gate_launches("phase 10s", run, "sad_wta")
    if set(run["parsers"].values()) != {"NativeFrameParser"}:
        fail(f"phase 10s: the sources parsed with {run['parsers']}")
    add(run["launches"])
    note(
        f"10s serial (two ptys, raw 1080p): served fps "
        f"{run['fps']['out']:.2f} (sources {_rates(run)}), {run['frames']} "
        f"frames in {run['batches']} batches, parser "
        f"{run['parsers']['left']}, "
        f"published frames {sum(c[0] for c in run['counts'].values())} all "
        f"emitted ones, /stream/out reads {len(seen)}")

    # 10d: one static pair over TCP, with and without --dedup-uploads
    static = {"left": lefts[0], "right": rights[0]}
    emitted0 = {"left": [lefts[0]], "right": [rights[0]]}
    for dedup in (True, False):
        tag = f"phase 10d dedup {dedup}"
        run = _ingest_run(tag, base_argv + (["--dedup-uploads"] if dedup
                                            else []),
                          _tcp_feed(static, wire.CODEC_RAW), emitted0,
                          n=0 if dedup else INGEST_FRAMES)
        _match_samples(tag, run["samples"]["out"], maps[False], want=(0, 0))
        pipe = run["pipes"]["out"]
        if dedup and not (pipe.dup_skipped
                          > run["m0"]["pipeline"]["dup_skipped"]
                          and pipe.dup_skipped >= INGEST_FRAMES
                          and run["launches"]["sad_wta"] == 1
                          and pipe.batches == 1):
            fail(f"{tag}: dup_skipped {pipe.dup_skipped}, batches "
                 f"{pipe.batches}, launches {run['launches']} (one distinct "
                 f"pair: 1 launch)")
        gate_launches(tag, run, "sad_wta")
        if not dedup and run["batches"] < 2:
            fail(f"{tag}: {run['batches']} batches")
        add(run["launches"])
        note(f"10d --dedup-uploads {dedup}: batches {pipe.batches}, "
             f"dup_skipped {pipe.dup_skipped}, sad_wta "
             f"{run['launches']['sad_wta']}")

    # 10r: two rigs on four TCP emitters
    rig_frames = {"left": lefts[0], "right": rights[0],
                  "b.left": lefts[1], "b.right": rights[1]}
    run = _ingest_run("phase 10r", base_argv + ["--rig", "b"],
                      _tcp_feed(rig_frames, wire.CODEC_RAW),
                      {k: [v] for k, v in rig_frames.items()}, rig="b")
    _match_samples("phase 10r rig ''", run["samples"]["out"], maps[False],
                   want=(0, 0))
    _match_samples("phase 10r rig b", run["samples"]["b.out"], maps[False],
                   want=(1, 1))
    gate_launches("phase 10r", run, "sad_wta")
    add(run["launches"])
    note(
        f"10r two rigs (four raw TCP emitters): fps out "
        f"{run['fps']['out']:.2f} and b.out {run['fps']['b.out']:.2f} in one "
        f"window, device busy {run['busy']['out']:.4f} and "
        f"{run['busy']['b.out']:.4f} (one stream: each spans the other's "
        f"work), batches {[p.batches for p in run['pipes'].values()]}, "
        f"sad_wta {run['launches']['sad_wta']}")

    # 10g: --backend sgm over raw TCP, one static pair
    L, R = to_cuda(lefts[0], rights[0])
    with _plain_chain():
        want = sgm_one(L, R, max_disparity=64, p1=1.0, p2=8.0, subpixel=True,
                       lr=False, threshold=1.0).cpu().numpy()
    del L, R
    run = _ingest_run("phase 10g", base_argv + ["--backend", "sgm"],
                      _tcp_feed(static, wire.CODEC_RAW), emitted0)
    _match_samples("phase 10g", run["samples"]["out"], {(0, 0): want},
                   want=(0, 0))
    nz = {k: v for k, v in run["launches"].items() if v}
    if nz != {"sgm_aggregate": 2 * run["frames"],
              "sgm_transpose_add": 2 * run["frames"]}:
        fail(f"phase 10g: launches {nz} for {run['frames']} frames (2 and 2 "
             f"a frame)")
    add(run["launches"])
    note(f"10g --backend sgm d64 over raw TCP: served fps "
         f"{run['fps']['out']:.2f} (sources {_rates(run)}), device busy "
         f"{run['busy']['out']:.4f}, {run['frames']} frames in "
         f"{run['batches']} batches, == plain chain, launches {nz}")

    # 10k: the soak tool, a quarter minute on --slam --loop-closure
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "soak.json")
        proc = subprocess.run(
            [sys.executable, "-m", "steroscopic_hardware_tpu_torch.soak",
             *SOAK_SMOKE, "--json", out], capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0 or not os.path.exists(out):
            fail(f"phase 10k: soak exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        with open(out) as f:
            soak = json.load(f)
    summ, series = soak["summary"], soak["series"]
    grow = all(b["depth_frames"] > a["depth_frames"]
               and b["slam_poses"] > a["slam_poses"]
               for a, b in zip(series, series[1:]))
    if not (series and summ["sample_errors"] == 0 and grow
            and summ["server_tracebacks"] == 0
            and all(s["slam_errors"] == 0 and s["pipeline_errors"] == 0
                    for s in series)):
        fail(f"phase 10k: soak summary {json.dumps(summ)[:1500]}")
    first, last = summ["first"], summ["last"]
    note(
        f"10k soak {SOAK_SMOKE[1]} min {summ['size']}: {len(series)} samples, "
        f"frames and poses grew at each, RSS {first['rss_mb']} -> "
        f"{last['rss_mb']} MB, device memory {first['gpu_mem_mb']} -> "
        f"{last['gpu_mem_mb']} MiB (card used {first['card_mem_used_mb']} "
        f"-> {last['card_mem_used_mb']}), pose fps "
        f"{[s['slam_pose_fps_window'] for s in series]}, loops closed "
        f"{last['loops_closed']}, backend_pending max "
        f"{summ['backend_pending_max']}")
    say(f"phase 10 ok: ingest over TCP (raw, range, lzma), serial, dedup, two "
        f"rigs and SGM == plain, every served batch through the kernels; "
        f"launches {totals} ({card})")
    return totals


# -- phase 11: the tools (sweep, SLAM stress suite, scaling, entry hook) -----

SWEEP_N = 2            # timed computes (and kernel steps) a configuration
SGM_PLAIN_AT = (16, 128, 144, 256)  # both sides of B3's wide kernel at 136
SUITE_CONDITION = "photometric loop"
SUITE_FRAMES = 40
SUITE_ENGINES = ("vo", "vo+ba+loop")
SUITE_ATE_BOUND = 0.1  # m, every row
SCALING = ["--height", str(H), "--width", str(W), "--block", "16",
           "--disp", "64"]
RANKS_SIZE = ["--height", "480", "--width", "640"]  # the tool's default


def _launch_gate(tag, want):
    """The kernels launched since the last reset must be exactly ``want``
    (others 0); returns them and resets the counters."""
    from steroscopic_hardware_tpu_torch import _kernels

    got = dict(_kernels.launches)
    if any(got[k] != want.get(k, 0) for k in got):
        fail(f"{tag}: launches {got}, want exactly {want}")
    _kernels.reset_launches()
    return got


def _add(totals, got):
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v


def phase_sweep(card, totals):
    """11a: ``tools.run_sweep --synthetic --lr-check`` over the full grid
    (blocks 3-31 odd x maxD 16-256 step 16) at 1080p: each B1 map ==
    ``disparity_plain``, each B2 check's map and mask == the plain sweep
    and ``check_from_raw``, and its ``lr_valid_frac`` their fraction; per
    configuration exactly 1 + 2n sad_wta launches (n computes after the
    first and n kernel steps) and one sad_lr."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.ops import lr_check, sad
    from steroscopic_hardware_tpu_torch.tools import run_sweep

    pairs = run_sweep.load_pairs([], synthetic=True)
    L, R = to_cuda(*pairs["synthetic"])
    want = {"sad_wta": 1 + 2 * SWEEP_N, "sad_lr": 1}
    rows = []
    _kernels.reset_launches()
    for rec, out, (cmap, cvalid) in run_sweep.sweep(
            pairs, n=SWEEP_N, lr_check=True, device="cuda"):
        b, d = rec["block"], rec["disp"]
        _add(totals, _launch_gate(f"11a b{b} d{d}", want))
        dL, dR = sad.disparity_raw_lr_plain(L, R, block_size=b,
                                            max_disparity=d)
        pmap, pvalid = lr_check.check_from_raw(dL, dR, W, d)
        pvalid = pvalid.cpu().numpy()
        if not np.array_equal(out, sad.normalize(dL, d).cpu().numpy()):
            fail(f"11a b{b} d{d}: the sad_wta map differs from plain")
        if not (np.array_equal(cmap, pmap.cpu().numpy())
                and np.array_equal(cvalid, pvalid)
                and rec["lr_valid_frac"] == float(pvalid.mean())):
            fail(f"11a b{b} d{d}: the LR check differs from plain")
        rows.append(rec)
    if len(rows) != 240:
        fail(f"11a: {len(rows)} configurations, want 240")
    for b in sorted({r["block"] for r in rows}):
        say(f"phase 11a b{b} (d: Mpix/s, kernel ms, lr_valid): " + ", ".join(
            f"{r['disp']}: {r['mpix_s']:.1f}, {r['kernel_ms']:.4f}, "
            f"{r['lr_valid_frac']:.3f}" for r in rows if r["block"] == b))
    mpix = [r["mpix_s"] for r in rows]
    kms = [r["kernel_ms"] for r in rows]
    at = {(r["block"], r["disp"]): r for r in rows}
    say(f"phase 11a ok: 240 SAD configurations at 1080p == plain with and "
        f"without the LR check, 1 + 2n sad_wta and one sad_lr each; Mpix/s "
        f"{min(mpix)}..{max(mpix)} (b7 d64 {at[7, 64]['mpix_s']}, b31 d256 "
        f"{at[31, 256]['mpix_s']}), kernel ms {min(kms)}..{max(kms)} (b7 "
        f"d64 {at[7, 64]['kernel_ms']}, b31 d256 {at[31, 256]['kernel_ms']})"
        f" ({card})")


def phase_sgm_sweep(card, totals):
    """11b: ``tools.run_sweep --engine sgm --synthetic`` over maxD 16-256
    at 1080p: per configuration 2 (1 + 2n) launches each of sgm_aggregate
    and sgm_transpose_add, and the map == the plain chain on the card at
    ``SGM_PLAIN_AT``."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.models.blockmatch import sgm_one
    from steroscopic_hardware_tpu_torch.tools import run_sweep

    pairs = run_sweep.load_pairs([], synthetic=True)
    L, R = to_cuda(*pairs["synthetic"])
    frames = 1 + 2 * SWEEP_N
    want = {"sgm_aggregate": 2 * frames, "sgm_transpose_add": 2 * frames}
    rows = []
    _kernels.reset_launches()
    for rec, out, _ in run_sweep.sweep(pairs, engine="sgm", n=SWEEP_N,
                                       device="cuda"):
        d = rec["disp"]
        wide = {"sgm_aggregate_wide": 2 * frames} if d + 1 >= WIDE_FROM else {}
        _add(totals, _launch_gate(f"11b d{d}", {**want, **wide}))
        if d in SGM_PLAIN_AT:
            with _plain_chain():
                plain = sgm_one(L, R, max_disparity=d, p1=1.0, p2=8.0,
                                subpixel=True, lr=False,
                                threshold=1.0).cpu().numpy()
            _launch_gate(f"11b d{d} plain chain", {})
            if not np.array_equal(out, plain):
                fail(f"11b d{d}: {int((out != plain).sum())} pixels differ "
                     "from the plain chain")
            _free()
        rows.append(rec)
    say("phase 11b (d: ms, Mpix/s, kernel ms): " + ", ".join(
        f"{r['disp']}: {r['ms']:.2f}, {r['mpix_s']:.2f}, "
        f"{r['kernel_ms']:.4f}" for r in rows))
    say(f"phase 11b ok: SGM sweep maxD 16..256 at 1080p, == plain chain at "
        f"{SGM_PLAIN_AT}, 2 sgm_aggregate (the wide kernel's from maxD 144) "
        f"and 2 sgm_transpose_add a frame ({card})")


def phase_suite(card, totals):
    """11c: ``tools.run_synth_slam`` on the photometric loop (40 frames,
    noise 2, the tool's 320x240 rig): the ``sad`` and ``sgm`` front ends
    with the ``vo`` and ``vo+ba+loop`` engines. Gates: sgm drops 0 frames
    and no more than sad; every ATE finite and below SUITE_ATE_BOUND; B2s
    once a frame (sad), sgm_aggregate and sgm_transpose_add twice (sgm)."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.tools import run_synth_slam as tool

    from steroscopic_hardware_tpu_torch.utils.device import resolve_device

    args = tool.parse_args(["--frames", str(SUITE_FRAMES)])
    args.device = resolve_device("cuda")
    cond = dict(tool.CONDITIONS)[SUITE_CONDITION]
    n = SUITE_FRAMES * len(SUITE_ENGINES)
    want = {"sad": {"sad_lr": n},
            "sgm": {"sgm_aggregate": 2 * n, "sgm_transpose_add": 2 * n}}
    rows = []
    for fe in ("sad", "sgm"):
        a = tool.condition_args(args, cond, fe)
        cam, frames, gt = tool.render_sequence(a)
        _kernels.reset_launches()
        recs = tool.run_engines(a, cam, frames, gt, SUITE_ENGINES)
        got = _launch_gate(f"11c {fe}", want[fe])
        # the sad front end's sad_lr launches are B2s's (with costs)
        if "sad_lr" in got:
            got["sad_lr_costs"] = got.pop("sad_lr")
        _add(totals, got)
        rows += recs
    drops = {fe: max(r["tracking_drops"] for r in rows
                     if r["frontend"] == fe) for fe in ("sad", "sgm")}
    bad = [r for r in rows if not (np.isfinite(r["ate_rmse_m"])
                                   and r["ate_rmse_m"] < SUITE_ATE_BOUND)]
    for r in rows:
        say(f"phase 11c {SUITE_CONDITION} {r['frontend']} {r['engine']}: "
            f"ATE {r['ate_rmse_m']} m, drops {r['tracking_drops']}, min "
            f"inliers {r['min_inliers']}, loops {r['loops_closed']}, fps "
            f"{r['fps']}, frame p95 {r['frame_p95_ms']} ms, max "
            f"{r['frame_max_ms']} ms" + (f", stages {r['stage_s']}"
                                         if "stage_s" in r else ""))
    if drops["sgm"] != 0 or drops["sgm"] > drops["sad"] or bad:
        fail(f"11c: drops {drops} (sgm must drop 0, no more than sad); "
             f"ATE at or above {SUITE_ATE_BOUND} m or not finite: {bad}")
    say(f"phase 11c ok: {SUITE_CONDITION}, {SUITE_FRAMES} frames: drops "
        f"{drops}, every ATE < {SUITE_ATE_BOUND} m ({card})")


def phase_scaling(card, totals):
    """11d: ``tools.bench_scaling --batch-axis`` at 1080p b16 d64: each F's
    first chained output == ``disparity_plain`` on the same frames, n
    launches a chain (one untimed, 3 timed); then the rank mode at 480x640
    over the cards present (NCCL, one card a rank): the gathered map == the
    one-process map, each rank 1 + n sad_wta launches."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.ops import sad
    from steroscopic_hardware_tpu_torch.tools import bench_scaling as tool
    from steroscopic_hardware_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    args = tool.parse_args(SCALING + ["--batch-axis"])
    _kernels.reset_launches()
    for row in tool.bench_batch_axis(args, dev):
        _add(totals, _launch_gate(f"11d batch={row['batch']}",
                                  {"sad_wta": 4 * args.n}))
        want = sad.disparity_plain(row["lefts"], row["rights"],
                                   block_size=args.block,
                                   max_disparity=args.disp)
        if not torch.equal(row["first"], want):
            fail(f"11d batch={row['batch']}: the first chained output "
                 "differs from plain")
        say(f"phase 11d {tool.batch_line(row, dev)}")
    args = tool.parse_args(RANKS_SIZE)
    counts = []
    for row in tool.bench_ranks(args, dev):
        L, R = to_cuda(row["left"], row["right"])
        want = sad.disparity(L, R, block_size=args.block,
                             max_disparity=args.disp).cpu().numpy()
        _launch_gate("11d one-process map", {"sad_wta": 1})
        if not np.array_equal(row["disp"], want):
            fail(f"11d ranks={row['ranks']}: the gathered map differs from "
                 "one process")
        if any(c["sad_wta"] != 1 + args.n or sum(c.values()) != 1 + args.n
               for c in row["launches"]):
            fail(f"11d ranks={row['ranks']}: launches by rank "
                 f"{row['launches']}, want sad_wta {1 + args.n} each")
        for c in row["launches"]:
            _add(totals, c)
        say(f"phase 11d {tool.rank_line(row, dev)}")
        counts.append(row["ranks"])
    say(f"phase 11d ok: batch axis F = 1..8 == plain, ranks {counts} == one "
        f"process ({card})")


def phase_entry(card, totals):
    """11e: ``entry()`` on the card == ``disparity_plain`` (one sad_wta
    launch), and ``dryrun_multichip`` over every card present."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.entry import dryrun_multichip, entry
    from steroscopic_hardware_tpu_torch.ops import sad

    _kernels.reset_launches()
    fn, (left, right) = entry()
    got = fn(left, right)
    _add(totals, _launch_gate("11e entry", {"sad_wta": 1}))
    want = sad.disparity_plain(left, right, block_size=7, max_disparity=64)
    if not (left.is_cuda and torch.equal(got, want)):
        fail("11e: entry()'s fn(*args) differs from plain")
    n = torch.cuda.device_count()
    stages = dryrun_multichip(n)
    say(f"phase 11e ok: entry() on the card == plain; dryrun_multichip({n}) "
        f"matches one rank: " + json.dumps(stages) + f" ({card})")


def phase_tools(card, timed):
    """Phase 11: 11a-11e, each timed as a phase of its own. Returns the
    launches of the paths they drive (B2s's as ``sad_lr_costs``)."""
    totals = {}
    for name, phase in (("11a", phase_sweep), ("11b", phase_sgm_sweep),
                        ("11c", phase_suite), ("11d", phase_scaling),
                        ("11e", phase_entry)):
        timed(name, phase, card, totals)
        _free()
    return totals

# -- phase 12: the measurement tools and the card's own RANSAC draws ---------

TABLE_SCALE = 0.01     # every bench_table row at its least chain, n = 2
# rows whose first chained step is held to the plain path: one SAD, one SGM
# and the three VGA tracking rows (sad, sgm, sgm_half front ends)
CHAIN_CHECKED = (
    "640x480 b7 d64 plain",
    "640x480 SGM d64 subpixel",
    "640x480 SLAM track SAD d64 (frontend+match+PnP)",
    "640x480 SLAM track SGM d64 (frontend+match+PnP)",
    "640x480 SLAM track SGMhalf d64 (pyramid census frontend)",
)
SGM_BENCH_FRAMES = 2   # sgm_bench's --frames: chains of 1 and 4
# serve_probe's window per mode, s: slam-sgm-half serves batches of 8
# frames that take 4.5-7.6 s each at 1080p (PERF.md section 5), so its
# window must hold more than one batch
PROBE_SECONDS = {"device-colorize-preview-2": 3.0, "slam-sgm-half": 15.0}
VECTORS_SIZE = (480, 640)  # the seeded PNG pair gen_vectors reads
CLEAN_FRONTENDS = ("sad", "sgm")
CLEAN_ATE_BOUND = 0.1  # m: the JAX tool's clean loop reads 0.0436 / 0.0548


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _with_costs(got):
    """Launches with sad_lr's counted as sad_lr_costs: the caller's sweeps
    carry the costs (B2s)."""
    got = dict(got)
    got["sad_lr_costs"] = got.pop("sad_lr")
    return got


def phase_bench(card, totals, dev):
    """12a: ``python -m steroscopic_hardware_tpu_torch.bench --synthetic``
    in-process: exit 0 (the guard passed), one JSON line with the
    original's fields and the card's name; sad_wta only."""
    import io

    from steroscopic_hardware_tpu_torch import _kernels, bench

    _kernels.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--synthetic", "--device", dev.type])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    got = dict(_kernels.launches)
    if rc != 0 or "error" in line or line["detail"]["card"] != card:
        fail(f"12a: bench exited {rc}: {line}")
    if got["sad_wta"] == 0 or sum(got.values()) != got["sad_wta"]:
        fail(f"12a: launches {got}, want sad_wta only")
    _add(totals, got)
    say(f"phase 12a ok: bench --synthetic {json.dumps(line)}")


def phase_table(card, totals, dev):
    """12b: ``tools.bench_table --scale TABLE_SCALE`` over every row, each
    at n = 2 and none with an error; then the first chained step of each
    row of CHAIN_CHECKED == the same step through the plain path on the
    same carry (every output, exactly; no kernel launched by the plain
    step)."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.tools import bench_table

    costs = {name: c for name, _, _, c in bench_table.specs()}
    rows = []
    for name in bench_table.names():
        _kernels.reset_launches()
        got = bench_table.table(dev, scale=TABLE_SCALE, filter=name,
                                out=lambda line: None)
        if len(got) != 1 or got[0]["name"] != name:
            fail(f"12b: filter {name!r} ran {[r['name'] for r in got]}")
        rec = got[0]
        if "error" in rec or rec["n"] != 2:
            fail(f"12b: {name}: {rec}")
        rec["launches"] = (_with_costs if costs[name] else dict)(
            _kernels.launches)
        if not any(rec["launches"].values()):
            fail(f"12b: {name} launched no kernel")
        _add(totals, rec["launches"])
        rows.append(rec)
    for r in rows:
        say(f"phase 12b {r['name']}: {r['ms']:.4f} ms a frame, "
            f"{r['mpix_s']:.1f} Mpix/s, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }")
    specs = {name: make for name, _, make, _ in bench_table.specs()}
    for name in CHAIN_CHECKED:
        step, carry0, _, _ = specs[name](bench_table.seeded_pairs(dev, SEED))
        _kernels.reset_launches()
        got = step(carry0)
        _add(totals, (_with_costs if costs[name] else dict)(
            _kernels.launches))
        _kernels.reset_launches()
        with _plain_chain():
            want = step(carry0)
        _launch_gate(f"12b {name} plain path", {})
        pairs = list(zip(_leaves(got), _leaves(want)))
        if not all(torch.equal(g, w) if torch.is_tensor(g) else g == w
                   for g, w in pairs):
            fail(f"12b {name}: the first chained step differs from the "
                 "plain path")
    say(f"phase 12b ok: {len(rows)} bench_table rows at n = 2 with no error;"
        f" the first chained step of {len(CHAIN_CHECKED)} rows == plain "
        f"({card})")
    return rows


def phase_sgm_half(card, totals, left, right):
    """12c: the sgm_half front end (``_frame_frontend``) on one 1080p frame,
    kernels against the plain path: every output equal."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.models.slam import _frame_frontend

    L, R = to_cuda(left, right)
    kw = dict(block_size=7, max_disparity=64, fast_threshold=20,
              max_keypoints=512, intr=(1400.0, 1400.0, W / 2, H / 2),
              baseline=0.12, frontend="sgm_half")
    _kernels.reset_launches()
    got = _frame_frontend(L, R, **kw)
    got_launches = _launch_gate("12c sgm_half", {"sgm_aggregate": 2,
                                                 "sgm_transpose_add": 2})
    _add(totals, got_launches)
    with _plain_chain():
        want = _frame_frontend(L, R, **kw)
    _launch_gate("12c sgm_half plain path", {})
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail("12c: the sgm_half front end differs from the plain path")
    say(f"phase 12c ok: sgm_half front end at {W}x{H} d64 == plain path "
        f"({int(got[5].sum())} of 512 keypoints triangulated) ({card})")


def phase_sgm_bench(card, totals, dev):
    """12d: ``tools.sgm_bench --size 1920x1080 --maxd 64`` at
    SGM_BENCH_FRAMES: every row timed, none with an error."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.tools import sgm_bench

    _kernels.reset_launches()
    rows = sgm_bench.bench(dev, size=(W, H), maxd=64,
                           frames=SGM_BENCH_FRAMES, out=lambda line: None)
    _add(totals, _kernels.launches)
    bad = [r for r in rows if "error" in r]
    if bad or len(rows) != len(sgm_bench.names()):
        fail(f"12d: sgm_bench rows {len(rows)}, errors {bad}")
    say(f"phase 12d ok: sgm_bench {W}x{H} d64 (ms a frame): " + ", ".join(
        f"{r['name']} {r['ms']:.4f}" for r in rows) + f" ({card})")


def phase_vectors(card, totals, dev):
    """12e: ``tools.gen_vectors`` on a seeded PNG pair written here: each
    case's .mem lines are the golden disparities of its crop, and the
    kernel's map of the crop (sad_wta) equals them."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.io.png import write_png
    from steroscopic_hardware_tpu_torch.ops import sad
    from steroscopic_hardware_tpu_torch.ops.sad_golden import disparity_numpy
    from steroscopic_hardware_tpu_torch.tools import gen_vectors

    n, size, block, disp = 4, 128, 15, 64
    left, right = random_pair(np.random.default_rng(SEED + 12), VECTORS_SIZE)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{s}.png") for s in ("L", "R")]
        write_png(paths[0], left)
        write_png(paths[1], right)
        out = os.path.join(tmp, "vectors")
        with contextlib.redirect_stdout(sys.stderr):
            gen_vectors.main([out, "--left", paths[0], "--right", paths[1],
                              "--n", str(n), "--size", str(size)])
        _kernels.reset_launches()
        for i in range(n):
            base = os.path.join(out, f"case{i}")
            lp = np.fromfile(base + "_L.raw", np.uint8).reshape(size, size)
            rp = np.fromfile(base + "_R.raw", np.uint8).reshape(size, size)
            with open(base + "_exp_disp.mem") as f:
                mem = np.array([int(v, 16) for v in f.read().split()],
                               np.uint8).reshape(size, size)
            L, R = (torch.from_numpy(a).to(dev) for a in (lp, rp))
            kernel = sad.disparity(L, R, block_size=block,
                                   max_disparity=disp).cpu().numpy()
            if not (np.array_equal(mem, disparity_numpy(lp, rp, block, disp))
                    and np.array_equal(mem, kernel)):
                fail(f"12e: case{i}'s vectors differ from the golden model "
                     "or the kernel")
        _add(totals, _launch_gate("12e", {"sad_wta": n}))
    say(f"phase 12e ok: gen_vectors, {n} cases of {size}x{size} b{block} "
        f"d{disp} == golden == sad_wta ({card})")


def phase_probe(card, totals, dev):
    """12f: ``serve_probe --modes MODE --seconds S`` at 1080p for each
    MODE, S of PROBE_SECONDS: frames served, no error (and no SLAM
    error)."""
    from steroscopic_hardware_tpu_torch import _kernels, serve_probe

    rows = []
    _kernels.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "probe.json")
        for mode, seconds in PROBE_SECONDS.items():
            serve_probe.main(["--device", dev.type, "--height", str(H),
                              "--width", str(W), "--modes", mode,
                              "--seconds", str(seconds), "--out", out])
            with open(out) as f:
                rows += json.load(f)
    got = dict(_kernels.launches)
    if got["sad_lr"] or got["sgm_aggregate"] == 0 or got["sad_wta"] == 0:
        fail(f"12f: launches {got}: want sad_wta (the serve) and the SGM "
             "kernels (the sgm_half front end), no sad_lr")
    _add(totals, got)
    for r in rows:
        if r["frames"] <= 0 or r["errors"] or r.get("slam_errors"):
            fail(f"12f: {r['mode']}: {json.dumps(r)}")
        say(f"phase 12f {r['mode']}: fps {r['fps']}, frames {r['frames']}, "
            f"serve p50 {r['lat_serve_p50']} ms, device busy "
            f"{r.get('device_busy')}" + (
                f", SLAM poses/s {r['slam_pose_fps']}" if "slam_pose_fps" in r
                else ""))
    say(f"phase 12f ok: {', '.join(PROBE_SECONDS)} served with no error "
        f"({card})")


def phase_clean_loop(card, totals, dev):
    """12g: ``tools.run_synth_slam``'s clean loop (40 frames), engine vo,
    with the engine's own RANSAC draws: ATE below CLEAN_ATE_BOUND for each
    front end of CLEAN_FRONTENDS; B2s once a frame (sad), sgm_aggregate and
    sgm_transpose_add twice (sgm)."""
    from steroscopic_hardware_tpu_torch import _kernels
    from steroscopic_hardware_tpu_torch.tools import run_synth_slam as tool

    args = tool.parse_args(["--frames", str(SUITE_FRAMES)])
    args.device = dev
    cond = dict(tool.CONDITIONS)["clean loop"]
    want = {"sad": {"sad_lr": SUITE_FRAMES},
            "sgm": {"sgm_aggregate": 2 * SUITE_FRAMES,
                    "sgm_transpose_add": 2 * SUITE_FRAMES}}
    for fe in CLEAN_FRONTENDS:
        a = tool.condition_args(args, cond, fe)
        cam, frames, gt = tool.render_sequence(a)
        _kernels.reset_launches()
        (rec,) = tool.run_engines(a, cam, frames, gt, ("vo",))
        _add(totals, _with_costs(_launch_gate(f"12g {fe}", want[fe])))
        say(f"phase 12g clean loop {fe} vo: ATE {rec['ate_rmse_m']} m, drops "
            f"{rec['tracking_drops']}, min inliers {rec['min_inliers']}, "
            f"frame p95 {rec['frame_p95_ms']} ms")
        if not (np.isfinite(rec["ate_rmse_m"])
                and rec["ate_rmse_m"] < CLEAN_ATE_BOUND):
            fail(f"12g: clean loop {fe}: ATE {rec['ate_rmse_m']} m, want < "
                 f"{CLEAN_ATE_BOUND}")
    say(f"phase 12g ok: the clean loop on the card's own draws, every ATE < "
        f"{CLEAN_ATE_BOUND} m ({card})")


def phase_measure(card, timed, left, right, dev):
    """Phase 12: 12a-12g, each timed as a phase of its own. Returns the
    launches of the paths they drive (B2s's as ``sad_lr_costs``)."""
    totals = {}
    for name, phase, args in (
            ("12a", phase_bench, (dev,)), ("12b", phase_table, (dev,)),
            ("12c", phase_sgm_half, (left, right)),
            ("12d", phase_sgm_bench, (dev,)), ("12e", phase_vectors, (dev,)),
            ("12f", phase_probe, (dev,)),
            ("12g", phase_clean_loop, (dev,))):
        timed(name, phase, card, totals, *args)
        _free()
    return totals


def sad_bound(name, maxd=64, px=H * W):
    """(bound_ms, bound_by) of one frame of ``px`` pixels (1080p unless
    given): two uint8 images in, the uint8 map (sad_wta), two int32 maps
    (sad_lr) or five (sad_lr_costs) out. The function's int32 operations
    per pixel and disparity: one cost evaluation with sliding window sums,
    6 (the vertical window's |a - b| in and out and their add and
    subtract, the horizontal window's difference, and the minimum of the
    packed key cost * 512 + d, counted as one); sad_lr adds the right
    map's minimum over the shifted diagonal, 2; with costs the neighbour
    tracking adds 4 (the d - 1 test and the selects of c_left, c_right
    and the previous cost). So 6, 8 and 12.
    Counted once per pixel and d: the kernel's extra work (halo columns,
    window rows rebuilt per tile) is not the function's."""
    if name == "sad_wta":
        return _bound(3 * px, 6 * px * (maxd + 1), I32_OPS)
    maps, ops = (5, 12) if name == "sad_lr_costs" else (2, 8)
    return _bound(2 * px + 4 * maps * px, ops * px * (maxd + 1), I32_OPS)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    card = timed("1", phase_build)
    errs = timed("2", phase_exact)
    sgm_errs = timed("2s", phase_sgm_exact)
    rng = np.random.default_rng(SEED + 2)
    left, right, truth, edges = truth_pair(rng)
    timed("3", phase_truth, left, right, truth, edges, block=7, maxd=64)
    fused_launches = timed("3s", phase_sgm_truth, left, right, truth, edges)
    launches = timed("4", phase_serve, left, right)
    sgm_launches = timed("4s", phase_sgm_serve, left, right)
    _free()
    times = timed("5", phase_times, card)
    sgm_times = timed("5s", phase_sgm_times, card)
    timed("5f", phase_fused_frame, card, left, right)
    b2s, b2s_launches, vo_run = timed("6v", phase_vo, card)
    slam_launches, slam_ref = timed("7 slam", phase_slam, card, *vo_run)
    serve_slam = timed("7 serve", phase_serve_slam, card, left, right)
    _free()
    rectify = timed("8", phase_rectify, card, left, right)
    _free()
    par = timed("9", phase_parallel, card, left, right, slam_ref)
    _free()
    ingest = timed("10", phase_ingest, card)
    # phase 7's launches on the SLAM main path: the sync run, the server;
    # phase 8's on the calibrated one: the served SAD, LR and SGM runs and
    # live SLAM
    cal = rectify["launches"]
    launches["sad_wta"] += serve_slam["sad_wta"] + cal["sad"]["sad_wta"]
    launches["sad_lr"] += cal["lr"]["sad_lr"]
    b2s_launches += (slam_launches["sad_lr"] + serve_slam["sad_lr"]
                     + cal["slam"]["sad_lr"])
    for name in SGM_COUNTED:
        sgm_launches[name] += cal["sgm"][name]
    # phase 9's: every rank's sharded SAD, SGM and StereoSLAM(pg_mesh=)
    launches["sad_wta"] += par["sad_wta"]
    b2s_launches += par["sad_lr"]
    for name in SGM_COUNTED:
        sgm_launches[name] += par[name]
    fused_launches["sgm_epilogue"] += par["sgm_epilogue"]
    # phase 10's: the batches served from TCP and serial ingest
    launches["sad_wta"] += ingest["sad_wta"]
    launches["sad_lr"] += ingest["sad_lr"]
    for name in SGM_COUNTED:
        sgm_launches[name] += ingest[name]
    _free()
    tools = phase_tools(card, timed)
    # phase 11's: the sweeps, the suite's front ends, scaling and entry()
    for name in ("sad_wta", "sad_lr"):
        launches[name] += tools.get(name, 0)
    b2s_launches += tools.get("sad_lr_costs", 0)
    for name in SGM_COUNTED:
        sgm_launches[name] += tools.get(name, 0)
    from steroscopic_hardware_tpu_torch.utils.device import resolve_device

    measure = phase_measure(card, timed, left, right, resolve_device("cuda"))
    # phase 12's: bench, the kernel table, the sgm_half front end, the SGM
    # stages, the golden vectors, the two serve_probe modes, the clean loop
    for name in ("sad_wta", "sad_lr"):
        launches[name] += measure.get(name, 0)
    b2s_launches += measure.get("sad_lr_costs", 0)
    for name in SGM_COUNTED:
        sgm_launches[name] += measure.get(name, 0)
    fused_launches["sgm_epilogue"] += measure.get("sgm_epilogue", 0)
    say(f"phase seconds: {json.dumps(seconds)}")
    kernels = []
    for name in ("sad_wta", "sad_lr"):
        ms, plain_ms = times[(name, 16, 64)]
        bound_ms, bound_by = sad_bound(name)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    # B2s: sad_lr with costs, launched on the VO path (phase 6v)
    kernels.append({
        "name": "sad_lr_costs", "route": "cuda", "source": SOURCE["sad_lr"],
        "replaces": "steroscopic_hardware_tpu/ops/sad_pallas.py:622",
        "launches": b2s_launches, **b2s, "library_ms": None})
    # the row of each SGM kernel: its stage on the served (unfused) chain
    # (B3's lane-group kernel at d64, its wide kernel at d256, each with
    # its own launches), and the fused epilogue for sgm_epilogue
    rows = {"sgm_aggregate": "vertical bf16->bf16",
            "sgm_aggregate_wide": "vertical bf16->bf16",
            "sgm_transpose_add": "summed volume bf16+bf16->bf16",
            "sgm_epilogue": "u8 x2 -> f32 subpixel"}
    sgm_launches["sgm_aggregate"] -= sgm_launches["sgm_aggregate_wide"]
    for name, stage in rows.items():
        t = next(r for r in sgm_times
                 if r["stage"] == stage and r["name"] == name)
        n = (fused_launches if name == "sgm_epilogue" else sgm_launches)[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": n,
            "max_abs_err": sgm_errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
