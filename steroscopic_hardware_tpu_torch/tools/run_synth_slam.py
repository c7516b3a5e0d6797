"""SLAM quality on synthetic ground-truth sequences, the counterpart of the
repository's ``tools/run_synth_slam.py``: trajectory ATE RMSE of pure VO
against keyframed BA and BA + loop closure on rendered sequences with
exact ground truth, on the tool's own 320x240 rig.

The stress content is the original's: opaque near-field occluders, per-eye
photometric gain / offset jitter (an auto-exposure model: census / SGM
front ends shrug it off, SAD degrades), the non-planar ``helix``
trajectory, ``--circuits`` for multi-loop sequences, and ``--frontend
sgm`` for the census + SGM front end. ``--suite`` runs five conditions x
{sad, sgm} front ends x the three engines and prints the table.

    python -m steroscopic_hardware_tpu_torch.tools.run_synth_slam \\
        --frames 120 --trajectory loop --noise 2
    python -m steroscopic_hardware_tpu_torch.tools.run_synth_slam --suite
    python -m steroscopic_hardware_tpu_torch.tools.run_synth_slam \\
        --device cpu --frames 6 --trajectory loop --noise 2

The flags are the original's, plus ``--device``. The rig (fx = fy = 240,
principal point (160, 120), baseline 0.4 m, 320x240), the engines' settings
(block 7, maxDisparity 32, 128 keypoints, FAST 15; a BA window of 3
keyframes, a keyframe every 2 frames, 5 BA iterations; loop closure with
15 matches at least 10 keyframes apart) and the suite's conditions are the
original's. The rows keep the original's keys but ``graph_compiles``,
which counts the JAX pose-graph solver's compiled variants and has no
counterpart here. On the card the ``sad`` front end runs B2s (``sad_lr``
with costs) once a frame, the ``sgm`` one B4 (``sgm_transpose_add``) and
B3 (``sgm_aggregate``).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np

CAMERA = dict(fx=240.0, fy=240.0, cx=160.0, cy=120.0, baseline=0.4)
ENGINE_NAMES = ("vo", "vo+ba", "vo+ba+loop")
CONDITIONS = [
    ("clean loop", dict(trajectory="loop", noise=2.0, occluders=0,
                        gain_jitter=0.0, offset_jitter=0.0)),
    ("occluded loop", dict(trajectory="loop", noise=2.0, occluders=6,
                           gain_jitter=0.0, offset_jitter=0.0)),
    ("photometric loop", dict(trajectory="loop", noise=2.0, occluders=0,
                              gain_jitter=0.12, offset_jitter=14.0)),
    ("helix (non-planar)", dict(trajectory="helix", noise=2.0, occluders=0,
                                gain_jitter=0.0, offset_jitter=0.0)),
    ("full stress helix", dict(trajectory="helix", noise=2.0, occluders=6,
                               gain_jitter=0.12, offset_jitter=14.0)),
]


def render_sequence(args, seed=None):
    """(camera, [(left, right)], ground-truth positions) of the sequence
    ``args`` describes, rendered as the original renders it."""
    from steroscopic_hardware_tpu_torch.models.slam import StereoCamera
    from steroscopic_hardware_tpu_torch.utils.synth import (
        SyntheticScene,
        gt_positions,
        helix_trajectory,
        loop_trajectory,
        straight_trajectory,
    )

    seed = args.seed if seed is None else seed
    cam = StereoCamera(**CAMERA)
    scene = SyntheticScene(cam, n_landmarks=args.landmarks, seed=seed,
                           n_occluders=args.occluders)
    if args.trajectory == "straight":
        xis = straight_trajectory(args.frames)
    else:
        fn = {"loop": loop_trajectory, "helix": helix_trajectory}[
            args.trajectory]
        xis = fn(args.frames, circuits=args.circuits)
    nrng = np.random.default_rng(seed + 7)
    frames = []
    for xi in xis:
        # per-eye auto-exposure: independent gain/offset draws each frame
        g = 1.0 + nrng.normal(0.0, args.gain_jitter, 2)
        o = nrng.normal(0.0, args.offset_jitter, 2)
        frames.append(scene.render_pair(
            xi, noise=args.noise, noise_rng=nrng, gain=tuple(g),
            offset=tuple(o)))
    return cam, frames, gt_positions(xis)


def make_engine(name: str, args, cam):
    """The engine ``name`` (one of ``ENGINE_NAMES``) with the original's
    settings, on ``args.device``."""
    from steroscopic_hardware_tpu_torch.models.slam import (
        StereoSLAM,
        StereoVO,
    )

    kwargs = dict(block_size=7, max_disparity=32, max_keypoints=128,
                  fast_threshold=15, frontend=args.frontend,
                  device=args.device)
    if name == "vo":
        return StereoVO(cam, **kwargs)
    slam = dict(window=3, kf_every=2, ba_iters=5,
                async_backend=args.async_backend)
    if name == "vo+ba+loop":
        slam.update(loop_closure=True, loop_min_matches=15, loop_gap=10)
    return StereoSLAM(cam, **slam, **kwargs)


def row_line(rec) -> str:
    """The original's text line for a row."""
    extra = ""
    if "stage_s" in rec:
        st = rec["stage_s"]
        extra = (f"  stages vo {st['vo']:.1f}s ba {st['ba']:.1f}s "
                 f"loop {st['loop']:.1f}s graph {st['graph']:.1f}s")
    return (f"{rec['engine']:12s} [{rec['frontend']}] ATE "
            f"{rec['ate_rmse_m']:.4f} m  {rec['fps']:6.1f} fps  "
            f"min_inliers {rec['min_inliers']}  drops "
            f"{rec['tracking_drops']}  loops {rec['loops_closed']}" + extra)


def run_engines(args, cam, frames, gt, engines=None):
    """Each engine over ``frames``: a row per engine. ``engines`` is a
    list of ``ENGINE_NAMES`` (all three by default), each built just
    before its run and closed after it."""
    from steroscopic_hardware_tpu_torch.models.slam import ate_rmse

    out = []
    for name in engines or ENGINE_NAMES:
        eng = make_engine(name, args, cam)
        try:
            t0 = time.time()
            frame_ts = []
            for left, right in frames:
                tf = time.time()
                eng.process(left, right)
                frame_ts.append(time.time() - tf)
            frame_dt = time.time() - t0
            if hasattr(eng, "finish"):
                eng.finish()
            dt = time.time() - t0
            vo = getattr(eng, "vo", eng)
            rec = {
                "engine": name,
                "frontend": args.frontend,
                "ate_rmse_m": ate_rmse(vo.positions(), gt),
                "fps": len(frames) / dt,
                "frame_loop_fps": len(frames) / frame_dt,
                "frame_p95_ms": 1e3 * float(np.percentile(frame_ts, 95)),
                "frame_max_ms": 1e3 * max(frame_ts),
                "min_inliers": int(min(vo.n_inliers[1:])),
                "tracking_drops": vo.tracking_drops,
                "loops_closed": getattr(eng, "loops_closed", 0),
            }
            if hasattr(eng, "stage_s"):
                s = dict(eng.stage_s)
                s["loop"] -= s["graph"]  # loop = retrieval/verify only
                rec["stage_s"] = s
        finally:
            if hasattr(eng, "close"):
                eng.close()
        out.append(rec)
        print(json.dumps(rec) if args.json else row_line(rec), flush=True)
    return out


def condition_args(args, cond: dict, frontend: str):
    """A copy of ``args`` with a suite condition and a front end."""
    a = copy.copy(args)
    for k, v in cond.items():
        setattr(a, k, v)
    a.frontend = frontend
    return a


def table(rows) -> str:
    """The suite's markdown table, as the original prints it."""
    lines = ["| condition | frontend | engine | ATE (m) | drops | loops |",
             "|---|---|---|---|---|---|"]
    lines += [f"| {r['condition']} | {r['frontend']} | {r['engine']} | "
              f"{r['ate_rmse_m']:.4f} | {r['tracking_drops']} | "
              f"{r['loops_closed']} |" for r in rows]
    return "\n".join(lines)


def run_suite(args):
    """Multi-sequence stress table: every condition x {sad, sgm} front
    end, the three engines (the original's 'SLAM stress suite')."""
    rows = []
    for label, cond in CONDITIONS:
        for fe in ("sad", "sgm"):
            a = condition_args(args, cond, fe)
            print(f"--- {label} / {fe} ---", flush=True)
            cam, frames, gt = render_sequence(a)
            recs = run_engines(a, cam, frames, gt)
            for r in recs:
                r["condition"] = label
            rows.extend(recs)
    print("\n" + table(rows), flush=True)
    return rows


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="SLAM quality on synthetic sequences (PyTorch + CUDA)")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--landmarks", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trajectory", default="straight",
                    choices=["straight", "loop", "helix"])
    ap.add_argument("--noise", type=float, default=0.0,
                    help="Gaussian pixel-noise sigma (sensor model)")
    ap.add_argument("--circuits", type=int, default=1,
                    help="loop/helix circuits (multi-loop sequences)")
    ap.add_argument("--occluders", type=int, default=0,
                    help="number of opaque near-field occluder objects")
    ap.add_argument("--gain-jitter", type=float, default=0.0,
                    dest="gain_jitter",
                    help="per-eye per-frame gain sigma (AE model)")
    ap.add_argument("--offset-jitter", type=float, default=0.0,
                    dest="offset_jitter",
                    help="per-eye per-frame offset sigma (gray levels)")
    ap.add_argument("--frontend", default="sad", choices=["sad", "sgm"])
    ap.add_argument("--async-backend", action="store_true",
                    dest="async_backend",
                    help="run BA/loop-closure in the backend worker "
                         "(the live-serving mode); finish() drains it "
                         "before ATE is computed")
    ap.add_argument("--suite", action="store_true",
                    help="run the multi-sequence stress table")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels (fails without a "
                         "usable GPU); cpu: the plain torch versions")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from steroscopic_hardware_tpu_torch.utils.device import resolve_device

    args.device = resolve_device(args.device)
    if args.suite:
        run_suite(args)
        return 0
    cam, frames, gt = render_sequence(args)
    run_engines(args, cam, frames, gt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
