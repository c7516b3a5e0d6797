"""SLAM backend probe: the pose graph's agreement between the card and the
CPU over many seeds, and where the asynchronous backend's frame-loop
slowdown comes from.

    python -m steroscopic_hardware_tpu_torch.slam_probe          # cuda
    python -m steroscopic_hardware_tpu_torch.slam_probe --device cpu \
        --pg-seeds 2 --frames 6 --size 120 400 --variants sync,async \
        --live-seconds 0

The first line names the device (on CUDA: ``nvidia-smi`` name and power
limit). Then one JSON line per row, in three parts:

* ``pg``: per seed and ``n_fixed`` (None, 16), the 64-node loop graph of
  ``chip_smoke.py`` phase 7 (``loop_graph``) solved by
  ``pose_graph_optimize`` (10 iterations) on ``--device`` twice and on the
  CPU: the largest twist difference card against CPU, the largest
  difference of the per-iteration costs and that of the final cost,
  both relative to the initial cost, whether the two card solves are bit
  for bit equal, and a bfloat16 control: the same
  graph with its edge measurements rounded to bfloat16 on ``--device``,
  against the CPU's full-precision solve (what a solver that lost the
  measurements' precision would read). On ``--device cpu`` both sides are
  the CPU.
* ``ba``: every BA window of the first ``sync`` run below (its keyframes
  and starting poses, recorded as the run solved them) solved again by a
  fresh engine on ``--device`` and on the CPU: the largest twist
  difference and the largest relative difference of the LM error curve,
  and a float16 control: the window's observations (``xy_sub``) rounded
  to float16 on ``--device`` against the CPU's full-precision solve.
* ``backend``: the seeded 40-frame synthetic loop at KITTI geometry
  (``vo.synthetic_sequence``) through a ``StereoVO`` and ``StereoSLAM``
  variants with ``chip_smoke.py`` phase 7's settings: ``sync``; ``async``;
  ``async-sleep`` and ``async-spin``, whose BA window and loop check take
  the sync run's wall time per call in ``time.sleep`` (the GIL released,
  no device work) or in a pure Python loop (the GIL wanted, no device
  work); ``async-switch-0.5ms`` and ``async-switch-50ms``, the real
  backend under ``sys.setswitchinterval``. Each row: frame wall ms
  median (``vo.run``: each ``process`` call, the first frame excluded),
  ATE, BA runs, closures, windows coalesced. ``sync`` and ``async`` run
  again last, so their spread inside the call shows (``--variants``
  picks a subset, in order; the stubs need a ``sync`` run before them).
* ``live``: the live server (``--slam --loop-closure --no-slam-fused``,
  SAD b16 d64, ``--live-size``) with the asynchronous backend (the
  default) and with a synchronous one, each read over ``--live-seconds``
  once the backend warmup is done: SLAM frames per second (``/slam``
  ``positions_total``), served fps, BA runs, closures.

With ``--out`` the rows are also written there as a JSON list.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

# chip_smoke.py phase 7's StereoSLAM settings (examples/run_kitti_vo.py's VO)
SLAM = dict(block_size=9, max_disparity=128, max_keypoints=512,
            fast_threshold=20, window=4, kf_every=2, ba_iters=6,
            loop_closure=True)
VARIANTS = ("vo", "sync", "async", "async-sleep", "async-spin",
            "async-switch-0.5ms", "async-switch-50ms", "sync", "async")
SWITCH = {"async-switch-0.5ms": 5e-4, "async-switch-50ms": 5e-2}


def loop_graph(rng, M=64):
    """A 64-node circle with odometry edges drifted by noise, loop edges
    every 8 nodes back to node 0 and across, padded to a 128-edge bucket:
    (nodes, edges, meas, weights) as numpy arrays."""
    from steroscopic_hardware_tpu_torch.ops import se3_np

    step = np.array([0.2, 0, 0, 0, 2 * np.pi / M, 0], np.float32)
    truth = np.zeros((M, 6), np.float32)
    for i in range(1, M):
        truth[i] = se3_np.accum(step, truth[i - 1])
    pairs = [(i, i + 1) for i in range(M - 1)]
    pairs += [(j, 0) for j in range(8, M, 8)] + [(j, j + M // 2)
                                                 for j in range(0, M // 2, 8)]
    meas = np.stack([se3_np.relative(truth[i], truth[j]) for i, j in pairs])
    meas += rng.normal(0, 0.01, meas.shape).astype(np.float32)
    nodes = truth + rng.normal(0, 0.05, truth.shape).astype(np.float32)
    nodes[0] = truth[0]
    E = len(pairs)
    edges = np.zeros((128, 2), np.int64)
    edges[:E] = pairs
    w = np.zeros(128, np.float32)
    w[:E] = 1.0
    return nodes, edges, np.pad(meas, ((0, 128 - E), (0, 0))), w


def probe_pose_graph(device, seeds):
    from steroscopic_hardware_tpu_torch.models.slam import (
        pose_graph_optimize,
    )

    def solve(graph, dev, bf16=False):
        nodes, edges, meas, w = (torch.from_numpy(a).to(dev) for a in graph)
        if bf16:
            meas = meas.to(torch.bfloat16).to(torch.float32)
        xi, costs = pose_graph_optimize(nodes, edges, meas, w, iters=10,
                                        n_fixed=n_fixed)
        return xi.cpu().numpy(), costs.cpu().numpy()

    def rel0(a, b):
        """Per-iteration costs apart, relative to the initial cost (the
        converged costs sit at float32's floor, where a relative
        difference of each says nothing)."""
        return float(np.max(np.abs(a - b)) / abs(b[0]))

    def final_rel0(a, b):
        return float(abs(a[-1] - b[-1]) / abs(b[0]))

    rows = []
    for seed in range(seeds):
        graph = loop_graph(np.random.default_rng(seed))
        for n_fixed in (None, 16):
            cpu, cpu_c = solve(graph, "cpu")
            (a, a_c), (b, b_c) = solve(graph, device), solve(graph, device)
            control, control_c = solve(graph, device, bf16=True)
            rows.append({
                "part": "pg", "seed": seed, "n_fixed": n_fixed,
                "card_vs_cpu": float(np.abs(a - cpu).max()),
                "card_costs_rel0": rel0(a_c, cpu_c),
                "card_final_cost_rel0": final_rel0(a_c, cpu_c),
                "card_repeat_equal": bool(np.array_equal(a, b)
                                          and np.array_equal(a_c, b_c)),
                "bf16_control_vs_cpu": float(np.abs(control - cpu).max()),
                "bf16_control_costs_rel0": rel0(control_c, cpu_c),
                "bf16_control_final_cost_rel0": final_rel0(control_c,
                                                           cpu_c)})
    return rows


def _spin(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def _stub_backend(engine, wait, t_ba, t_loop):
    """Replace the BA window's solve and the loop check by ``wait`` of the
    sync run's wall time per call; the locks, queue and pose write-back
    stay as they are."""
    def solve(kfs, xi0):
        wait(t_ba)
        engine.ba_runs += 1
        return xi0

    engine._solve_window = solve
    engine._try_loop_closure = lambda hist_idx=None: wait(t_loop)


def probe_backend(device, frames, size, seed, variants=VARIANTS):
    from steroscopic_hardware_tpu_torch.models.slam import StereoSLAM, StereoVO
    from steroscopic_hardware_tpu_torch.vo import run, run_slam
    from steroscopic_hardware_tpu_torch.vo import synthetic_sequence

    cam, pairs, gt = synthetic_sequence(frames, trajectory="loop",
                                        size=tuple(size), seed=seed)
    vo_kw = {k: v for k, v in SLAM.items()
             if k not in ("window", "kf_every", "ba_iters", "loop_closure")}
    rows, per_call, windows = [], None, []
    for name in variants:
        if name == "vo":
            stats = run(StereoVO(cam, device=device, seed=seed, **vo_kw),
                        pairs, gt)
            rows.append({"part": "backend", "variant": name,
                         "frame_ms_median": stats["frame_ms_median"],
                         "ate": stats["ate"]})
            print(json.dumps(rows[-1]), flush=True)
            continue
        engine = StereoSLAM(cam, device=device, seed=seed,
                            async_backend=name != "sync", **SLAM)
        if name == "sync" and per_call is None:
            solve = engine._solve_window

            def recording(kfs, xi0, solve=solve):
                windows.append(([copy.copy(kf) for kf in kfs], xi0.copy()))
                return solve(kfs, xi0)

            engine._solve_window = recording
        if name in ("async-sleep", "async-spin"):
            _stub_backend(engine, time.sleep if name == "async-sleep"
                          else _spin, *per_call)
        old = sys.getswitchinterval()
        sys.setswitchinterval(SWITCH.get(name, old))
        try:
            stats = run_slam(engine, pairs, gt)
        finally:
            sys.setswitchinterval(old)
            engine.close()
        st = stats["stage_s"]
        if name == "sync" and per_call is None:
            per_call = (st["ba"] / max(1, stats["ba_runs"]),
                        st["loop"] / max(1, stats["keyframes"]))
        rows.append({
            "part": "backend", "variant": name,
            "frame_ms_median": stats["frame_ms_median"],
            "ate": stats["ate"], "ba_runs": stats["ba_runs"],
            "loops_closed": stats["loops_closed"],
            "backend_coalesced": stats["backend_coalesced"],
            "ba_ms_per_window": 1e3 * st["ba"] / max(1, stats["ba_runs"]),
            "loop_ms_per_check": 1e3 * st["loop"] / max(1, stats["keyframes"]),
            "stub_ms": None if name not in ("async-sleep", "async-spin")
            else [1e3 * t for t in per_call],
            "switch_interval_s": SWITCH.get(name, old)})
        print(json.dumps(rows[-1]), flush=True)
    for i, (kfs, xi0) in enumerate(windows):
        rounded = [copy.copy(kf) for kf in kfs]
        for kf in rounded:
            kf.xy_sub = kf.xy_sub.astype(np.float16).astype(kf.xy_sub.dtype)
        out = {}
        for tag, d, window in (("card", device, kfs), ("cpu", "cpu", kfs),
                               ("control", device, rounded)):
            engine = StereoSLAM(cam, device=d, seed=seed, **SLAM)
            out[tag] = engine._solve_window(window, xi0), engine.last_ba_errs
        xi_c, errs_c = out["cpu"]
        row = {"part": "ba", "window": i, "keyframes": len(kfs)}
        for tag, name in (("card", "card"), ("control", "f16_control")):
            xi, errs = out[tag]
            row[f"{name}_vs_cpu"] = float(np.abs(xi - xi_c).max())
            row[f"{name}_errs_rel"] = float(
                np.max(np.abs(errs - errs_c) / np.abs(errs_c)))
        rows.append(row)
        print(json.dumps(rows[-1]), flush=True)
    return rows


def _get_json(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.load(r)


def probe_live(device, size, seconds, seed, warm_timeout=180.0):
    from steroscopic_hardware_tpu_torch.__main__ import build_app
    from steroscopic_hardware_tpu_torch.io.png import write_png
    from steroscopic_hardware_tpu_torch.runtime import pipeline
    from steroscopic_hardware_tpu_torch.serve_probe import textured_pair

    h, w = size
    init = pipeline.SlamPipeline.__init__
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        lp, rp = os.path.join(tmp, "l.png"), os.path.join(tmp, "r.png")
        left, right = textured_pair(seed, h, w)
        write_png(lp, left)
        write_png(rp, right)
        argv = ["--left", lp, "--right", rp, "--fps", "60", "--no-open",
                "--device", device, "--port", "0", "--slam",
                "--loop-closure", "--no-slam-fused", "--cx", str(w / 2),
                "--cy", str(h / 2)]
        for backend in ("async", "sync"):
            def patched(self, *args, slam_kwargs=None, **kwargs):
                kw = dict(slam_kwargs or {}, async_backend=backend == "async")
                init(self, *args, slam_kwargs=kw, **kwargs)

            pipeline.SlamPipeline.__init__ = patched
            try:
                app = build_app(argv).start()
            finally:
                pipeline.SlamPipeline.__init__ = init
            try:
                base, t0 = app.url, time.time()
                while not _get_json(base + "/slam").get("warm"):
                    if time.time() - t0 > warm_timeout:
                        raise RuntimeError("backend warmup did not finish")
                    time.sleep(0.1)
                warm_s = time.time() - t0
                s0, m0, t0 = (_get_json(base + "/slam"),
                              _get_json(base + "/metrics")["pipeline"],
                              time.time())
                time.sleep(seconds)
                s1, m1, t1 = (_get_json(base + "/slam"),
                              _get_json(base + "/metrics")["pipeline"],
                              time.time())
            finally:
                app.shutdown()
            wall = t1 - t0
            rows.append({
                "part": "live", "backend": backend, "shape": [h, w],
                "window_s": wall, "warm_wait_s": warm_s,
                "slam_fps": (s1["positions_total"] - s0["positions_total"])
                / wall,
                "served_fps": (m1["frames"] - m0["frames"]) / wall,
                "ba_runs": s1["ba_runs"] - s0["ba_runs"],
                "loops_closed": s1["loops_closed"] - s0["loops_closed"],
                "errors": s1["errors"] + m1["errors"]})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--pg-seeds", type=int, default=16)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--size", type=int, nargs=2, default=[376, 1241],
                    metavar=("H", "W"))
    ap.add_argument("--live-size", type=int, nargs=2, default=[1080, 1920],
                    metavar=("H", "W"))
    ap.add_argument("--live-seconds", type=float, default=7.0,
                    help="0 skips the live part")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated backend variants, in order")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("slam_probe: no usable CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.splitlines()[0]
    else:
        card = "cpu"
    print(f"device: {card}", flush=True)
    rows = probe_pose_graph(args.device, args.pg_seeds)
    for row in rows:
        print(json.dumps(row), flush=True)
    rows += probe_backend(args.device, args.frames, args.size, args.seed,
                          args.variants.split(","))
    if args.live_seconds > 0:
        rows += probe_live(args.device, args.live_size, args.live_seconds,
                           args.seed)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump([dict(r, device=card) for r in rows], f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
