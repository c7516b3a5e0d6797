"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (written for an
H100, sm_90a): builds the SAD and SGM kernels from
``steroscopic_hardware_tpu_torch/csrc``, holds them to their plain torch
versions, drives the live depth server in-process at 1920x1080 with both
engines, runs stereo visual odometry and SLAM at KITTI's frame geometry,
serves live SLAM, rectifies and serves a calibrated rig (``--calib``), and
runs the multi-process tier over 2 and 4 ranks on the card.

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
     the all_to_all (no speed is claimed: the ranks share one card).
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

import numpy as np
import torch

H, W = 1080, 1920
SEED = 20261016
CSRC = "steroscopic_hardware_tpu_torch/csrc/"
SOURCE = {"sad_wta": CSRC + "sad.cu", "sad_lr": CSRC + "sad.cu",
          "sgm_aggregate": CSRC + "sgm.cu",
          "sgm_transpose_add": CSRC + "sgm.cu",
          "sgm_epilogue": CSRC + "sgm.cu"}
REPLACES = {
    "sad_wta": "steroscopic_hardware_tpu/ops/sad_pallas.py:121",
    "sad_lr": "steroscopic_hardware_tpu/ops/sad_pallas.py:427",
    "sgm_aggregate": "steroscopic_hardware_tpu/ops/sgm.py:172",
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
SPILL_CHECKED = ("sad_kernel", "sgm_transpose_add_kernel",
                 "sgm_epilogue_kernel")


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
        fail(f"SAD sweep, B4 or B5 instantiations spill: {spilled}")
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
    errs = {"sgm_aggregate": 0.0, "sgm_transpose_add": 0.0,
            "sgm_epilogue": 0.0}
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
                check("sgm_aggregate",
                      f"{tuple(shape)} {ind}->{outd} P{P}", got, want,
                      outd == f32)
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
                check("sgm_aggregate", f"edge ({D}, {S}, {K}) {ind}->{outd}",
                      sgm.aggregate_axis(c, *P, out_dtype=outd),
                      sgm.aggregate_axis_plain(c, *P, out_dtype=outd),
                      outd == f32)
    edges = results[n_edges:]
    del results[n_edges:]
    results.append(f"sgm_aggregate at {len(edges)} plan edges (D 1..288, S "
                   f"1 / 2 / 7, K 37 / 45 / 33, six tiers): "
                   f"{max(float(r.rsplit(': ', 1)[1]) for r in edges)}")
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
    """Points the SGM wrappers at their plain versions, so the serving
    chain runs without any kernel (the reference maps)."""
    from steroscopic_hardware_tpu_torch.ops import sgm

    saved = sgm.aggregate_axis, sgm.transpose_add, sgm.sgm_epilogue
    sgm.aggregate_axis = (
        lambda c, P1, P2, *, out_dtype: sgm.aggregate_axis_plain(
            c, P1, P2, out_dtype=out_dtype))
    sgm.transpose_add = sgm.transpose_add_plain
    sgm.sgm_epilogue = sgm.sgm_epilogue_plain
    try:
        yield
    finally:
        sgm.aggregate_axis, sgm.transpose_add, sgm.sgm_epilogue = saved


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
    say("phase 5s ok")
    return out


def phase_fused_frame(card, left, right, maxd=64, frames=10):
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
VO_PROFILED = 10     # frames under torch.profiler (after the first)
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
    # phase 7's launches on the SLAM main path: the sync run, the server;
    # phase 8's on the calibrated one: the served SAD, LR and SGM runs and
    # live SLAM
    cal = rectify["launches"]
    launches["sad_wta"] += serve_slam["sad_wta"] + cal["sad"]["sad_wta"]
    launches["sad_lr"] += cal["lr"]["sad_lr"]
    b2s_launches += (slam_launches["sad_lr"] + serve_slam["sad_lr"]
                     + cal["slam"]["sad_lr"])
    for name in ("sgm_aggregate", "sgm_transpose_add"):
        sgm_launches[name] += cal["sgm"][name]
    # phase 9's: every rank's sharded SAD, SGM and StereoSLAM(pg_mesh=)
    launches["sad_wta"] += par["sad_wta"]
    b2s_launches += par["sad_lr"]
    for name in ("sgm_aggregate", "sgm_transpose_add"):
        sgm_launches[name] += par[name]
    fused_launches["sgm_epilogue"] += par["sgm_epilogue"]
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
    # the row of each SGM kernel: its stage on the served (unfused) chain,
    # and the fused epilogue for sgm_epilogue
    rows = {"sgm_aggregate": "vertical bf16->bf16",
            "sgm_transpose_add": "summed volume bf16+bf16->bf16",
            "sgm_epilogue": "u8 x2 -> f32 subpixel"}
    for name, stage in rows.items():
        t = next(r for r in sgm_times if r["stage"] == stage)
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
