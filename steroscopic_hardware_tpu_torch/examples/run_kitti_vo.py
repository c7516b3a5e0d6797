"""Stereo visual odometry on a KITTI odometry sequence (the counterpart of
``examples/run_kitti_vo.py``, BASELINE config #4). It needs a KITTI
odometry dataset on disk (``io/kitti.py`` reads the standard layout).

    python -m steroscopic_hardware_tpu_torch.examples.run_kitti_vo \\
        /data/kitti 04 --frames 200 [--slam] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="KITTI odometry root (sequences/, poses/)")
    ap.add_argument("sequence", help="sequence id, e.g. 04")
    ap.add_argument("--frames", type=int, default=0,
                    help="limit frame count (0 = all)")
    ap.add_argument("--slam", action="store_true",
                    help="keyframe BA + loop closure (default: pure VO)")
    ap.add_argument("--max-disparity", type=int, default=128)
    ap.add_argument("--block", type=int, default=9)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from steroscopic_hardware_tpu_torch.io.kitti import KittiOdometry
    from steroscopic_hardware_tpu_torch.models.slam import (
        StereoSLAM,
        StereoVO,
        ate_rmse,
    )

    seq = KittiOdometry(args.root, args.sequence)
    cam = seq.stereo_camera()
    print(f"sequence {args.sequence}: {len(seq)} frames, "
          f"fx={cam.fx:.1f} baseline={cam.baseline:.3f}m")

    kwargs = dict(block_size=args.block, max_disparity=args.max_disparity,
                  max_keypoints=512, fast_threshold=20, device=args.device)
    engine = (StereoSLAM(cam, loop_closure=True, **kwargs)
              if args.slam else StereoVO(cam, **kwargs))

    n = len(seq) if args.frames == 0 else min(args.frames, len(seq))
    t0 = time.time()
    try:
        for i in range(n):
            left, right = seq.pair(i)
            engine.process(left, right)
            if i % 50 == 0:
                print(f"frame {i}/{n}  {(i + 1) / (time.time() - t0):.1f} "
                      f"fps")
    finally:
        if args.slam:
            engine.close()

    vo = engine.vo if args.slam else engine
    est = vo.positions()
    gt = seq.gt_positions()
    if gt is not None:
        ate = ate_rmse(est, gt[:n])
        print(f"ATE RMSE vs ground truth: {ate:.3f} m over {n} frames")
    else:
        print("no ground-truth poses; trajectory length:",
              np.linalg.norm(np.diff(est, axis=0), axis=1).sum())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
