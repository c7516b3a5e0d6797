"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (written for an
H100, sm_90a): builds the SAD and SGM kernels from
``steroscopic_hardware_tpu_torch/csrc``, holds them to their plain torch
versions, and drives the live depth server in-process at 1920x1080 with
both engines.

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
  5. kernel and plain times at 1080p (CUDA events, median of 20 after 3
     warm-ups), SAD (sad_lr also with costs; b16 d64, b7 d128, b31 d256) and
     each SGM stage (sgm_epilogue in all three tiers), beside each
     kernel's bound and, for B4, the one PyTorch call that computes the
     same function;
  5f. the device time of one 1080p d64 SGM frame through the fused chain
     (B5) against the served, unfused one (torch.profiler).
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
        ms, plain_ms = _time_ms(kernel), _time_ms(plain)
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
        ms, plain_ms = _time_ms(kernel), _time_ms(plain)
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


def sad_bound(name, maxd=64):
    """(bound_ms, bound_by) of one 1080p frame: two uint8 images in, the
    uint8 map (sad_wta), two int32 maps (sad_lr) or five (sad_lr_costs)
    out. The function's int32 operations per pixel and disparity: one cost
    evaluation with sliding window sums, 6 (the vertical window's |a - b|
    in and out and their add and subtract, the horizontal window's
    difference, and the minimum of the packed key cost * 512 + d, counted
    as one); sad_lr adds the right map's minimum over the shifted diagonal,
    2; with costs the neighbour tracking adds 4 (the d - 1 test and the
    selects of c_left, c_right and the previous cost). So 6, 8 and 12.
    Counted once per pixel and d: the kernel's extra work (halo columns,
    window rows rebuilt per tile) is not the function's."""
    px = H * W
    if name == "sad_wta":
        return _bound(3 * px, 6 * px * (maxd + 1), I32_OPS)
    maps, ops = (5, 12) if name == "sad_lr_costs" else (2, 8)
    return _bound(2 * px + 4 * maps * px, ops * px * (maxd + 1), I32_OPS)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    card = phase_build()
    errs = phase_exact()
    sgm_errs = phase_sgm_exact()
    rng = np.random.default_rng(SEED + 2)
    left, right, truth, edges = truth_pair(rng)
    phase_truth(left, right, truth, edges, block=7, maxd=64)
    fused_launches = phase_sgm_truth(left, right, truth, edges)
    launches = phase_serve(left, right)
    sgm_launches = phase_sgm_serve(left, right)
    _free()
    times = phase_times(card)
    sgm_times = phase_sgm_times(card)
    phase_fused_frame(card, left, right)
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
