"""Stereo visual odometry and SLAM from the command line: ``StereoVO`` (or,
with ``--slam``, ``StereoSLAM``) over a seeded synthetic sequence or a
KITTI odometry sequence, one JSON line out (the counterpart of the
engines of ``tools/run_synth_slam.py``, ``vo`` / ``vo+ba`` /
``vo+ba+loop``, and of ``examples/run_kitti_vo.py``).

    python -m steroscopic_hardware_tpu_torch.vo --synthetic \\
        --trajectory loop --frames 40            # on the GPU
    python -m steroscopic_hardware_tpu_torch.vo --synthetic --slam \\
        --loop-closure [--async-backend]         # windowed BA (+ loops)
    python -m steroscopic_hardware_tpu_torch.vo --kitti ROOT 00 --frames 200
    python -m steroscopic_hardware_tpu_torch.vo --synthetic --device cpu \\
        --size 120 320 --frames 4 --max-disparity 32

``--device cuda`` (the default) needs a usable GPU and raises without one.
The synthetic sequence renders ``utils.synth`` landmarks at KITTI odometry's
frame geometry by default: 1241 x 376, fx = fy = 718.856, (cx, cy) =
(607.1928, 185.2157), baseline 0.5372 m (the published calibration of
sequences 00-02); another ``--size`` scales the intrinsics with it. The
landmark field spans the camera's view at 5-11 m, one landmark per 1000
pixels. The settings are ``examples/run_kitti_vo.py``'s: block 9 and
maxDisparity 128 by default, 512 keypoints, FAST threshold 20.

The line: frames, fps and the median per-frame wall ms (frames after the
first, which builds the kernels), ATE RMSE against ground truth where
there is one, the minimum and median PnP inliers, tracking drops, and the
share of valid keypoint slots. ``--slam`` runs a keyframe every
``--kf-every`` frames, windowed BA over ``--window`` keyframes and, with
``--loop-closure``, BoW loop closure and the pose graph (``--async-backend``:
on a backend thread, drained before the line); its line adds ``ba_runs``,
``loops_closed``, ``keyframes``, ``backend_errors``, the per-stage seconds
``stage_s`` and ``ate_vo_only``, the ATE of a plain ``StereoVO`` over the
same frames (run first).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

KITTI_SIZE = (376, 1241)
KITTI_CAMERA = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                    baseline=0.5372)
DEPTH = (5.0, 11.0)


def synthetic_camera(size=KITTI_SIZE):
    """KITTI's calibration, its focal length and principal point scaled
    with the frame width and height."""
    from steroscopic_hardware_tpu_torch.models.slam import StereoCamera

    H, W = size
    sx, sy = W / KITTI_SIZE[1], H / KITTI_SIZE[0]
    c = KITTI_CAMERA
    return StereoCamera(fx=c["fx"] * sx, fy=c["fy"] * sx, cx=c["cx"] * sx,
                        cy=c["cy"] * sy, baseline=c["baseline"])


def synthetic_sequence(frames, *, trajectory="loop", size=KITTI_SIZE,
                       noise=0.0, seed=0):
    """(camera, [(left, right)], ground-truth positions) of a seeded
    ``utils.synth`` sequence. The landmark field fills the view at the
    middle depth, one landmark per 1000 pixels."""
    from steroscopic_hardware_tpu_torch.utils.synth import (
        SyntheticScene,
        gt_positions,
        helix_trajectory,
        loop_trajectory,
        straight_trajectory,
    )

    cam = synthetic_camera(size)
    H, W = size
    z = sum(DEPTH) / 2
    spread = (0.5 * W / cam.fx * z, 0.5 * H / cam.fy * z)
    scene = SyntheticScene(cam, size=size, n_landmarks=H * W // 1000,
                           depth=DEPTH,
                           spread=spread, seed=seed)
    if trajectory == "straight":
        xis = straight_trajectory(frames)
    else:
        xis = {"loop": loop_trajectory, "helix": helix_trajectory}[
            trajectory](frames)
    nrng = np.random.default_rng(seed + 7)
    pairs = [scene.render_pair(xi, noise=noise, noise_rng=nrng) for xi in xis]
    return cam, pairs, gt_positions(xis)


def run(engine, pairs, gt=None) -> dict:
    """Drive ``engine`` (a ``StereoVO`` or a ``StereoSLAM``) over an
    iterable of pairs; the summary of the JSON line."""
    vo = getattr(engine, "vo", engine)
    ms = []
    valid = []
    t_all = time.perf_counter()
    for left, right in pairs:
        t0 = time.perf_counter()
        engine.process(left, right)
        ms.append((time.perf_counter() - t0) * 1e3)
        valid.append(float(vo.prev.valid.mean()))
    if hasattr(engine, "finish"):
        engine.finish()  # an asynchronous backend's queue, drained
    seconds = time.perf_counter() - t_all
    inl = vo.n_inliers[1:]
    out = {
        "frames": len(ms),
        "fps": len(ms) / seconds,
        "frame_ms_median": float(np.median(ms[1:])) if len(ms) > 1 else None,
        "first_frame_ms": ms[0],
        "ate": None,
        "inliers_min": int(min(inl)) if inl else None,
        "inliers_median": float(np.median(inl)) if inl else None,
        "tracking_drops": vo.tracking_drops,
        "valid_keypoints_min": min(valid),
        "valid_keypoints_median": float(np.median(valid)),
    }
    if gt is not None:
        from steroscopic_hardware_tpu_torch.models.slam import ate_rmse

        out["ate"] = ate_rmse(vo.positions(), gt[:len(ms)])
    return out


def run_slam(slam, pairs, gt=None) -> dict:
    """:func:`run` for a ``StereoSLAM``, with its backend's counters."""
    out = run(slam, pairs, gt)
    out.update(ba_runs=slam.ba_runs, loops_closed=slam.loops_closed,
               keyframes=len(slam.kf_history),
               backend_errors=slam.backend_errors,
               backend_coalesced=slam.backend_coalesced,
               stage_s=dict(slam.stage_s))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="stereo visual odometry (PyTorch + CUDA)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--synthetic", action="store_true",
                     help="a seeded utils.synth sequence")
    src.add_argument("--kitti", nargs=2, metavar=("ROOT", "SEQ"),
                     help="a KITTI odometry sequence (sequences/, poses/)")
    ap.add_argument("--trajectory", default="loop",
                    choices=["straight", "loop", "helix"])
    ap.add_argument("--frames", type=int, default=40,
                    help="frames to run (KITTI: 0 = all)")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="Gaussian pixel noise of the synthetic frames")
    ap.add_argument("--size", type=int, nargs=2, metavar=("H", "W"),
                    default=list(KITTI_SIZE))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frontend", default="sad",
                    choices=["sad", "sgm", "sgm_half"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels (fails without a "
                         "usable GPU); cpu: the plain torch versions")
    ap.add_argument("--block", type=int, default=9)
    ap.add_argument("--max-disparity", type=int, default=128)
    ap.add_argument("--slam", action="store_true",
                    help="StereoSLAM: keyframes and windowed BA")
    ap.add_argument("--loop-closure", action="store_true",
                    help="with --slam: BoW loop closure and the pose graph")
    ap.add_argument("--async-backend", action="store_true",
                    help="with --slam: BA and loop closure on a backend "
                         "thread")
    ap.add_argument("--window", type=int, default=4,
                    help="with --slam: keyframes in the BA window")
    ap.add_argument("--kf-every", type=int, default=2,
                    help="with --slam: a keyframe every N frames")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from steroscopic_hardware_tpu_torch.models.slam import StereoVO

    if args.synthetic:
        cam, pairs, gt = synthetic_sequence(
            args.frames, trajectory=args.trajectory, size=tuple(args.size),
            noise=args.noise, seed=args.seed)
        source = {"synthetic": args.trajectory, "size": list(args.size)}
    else:
        from steroscopic_hardware_tpu_torch.io.kitti import KittiOdometry

        seq = KittiOdometry(*args.kitti)
        cam = seq.stereo_camera()
        n = len(seq) if args.frames == 0 else min(args.frames, len(seq))
        pairs = (seq.pair(i) for i in range(n))
        gt = seq.gt_positions()
        source = {"kitti": args.kitti}
    kw = dict(block_size=args.block, max_disparity=args.max_disparity,
              max_keypoints=512, fast_threshold=20, seed=args.seed,
              frontend=args.frontend, device=args.device)
    vo = StereoVO(cam, **kw)
    if not args.slam:
        out = {**source, "frontend": args.frontend, "device": str(vo.device),
               **run(vo, pairs, gt)}
        print(json.dumps(out), flush=True)
        return 0
    from steroscopic_hardware_tpu_torch.models.slam import StereoSLAM

    pairs = list(pairs)
    vo_only = run(vo, pairs, gt)["ate"]
    slam = StereoSLAM(cam, window=args.window, kf_every=args.kf_every,
                      loop_closure=args.loop_closure,
                      async_backend=args.async_backend, **kw)
    try:
        stats = run_slam(slam, pairs, gt)
    finally:
        slam.close()
    out = {**source, "frontend": args.frontend, "device": str(vo.device),
           "engine": "vo+ba+loop" if args.loop_closure else "vo+ba",
           "async_backend": args.async_backend, **stats,
           "ate_vo_only": vo_only}
    print(json.dumps(out), flush=True)
    return 0 if slam.backend_errors == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
