"""Streaming benchmark: repeated disparity over stereo pairs (the
counterpart of ``examples/run_stream.py`` and the reference's
``examples/run.stream.go``: a 10-iteration loop printing each frame's
time, then throughput).

    python -m steroscopic_hardware_tpu_torch.examples.run_stream \\
        --left L.png --right R.png [-n 10] [--block N] [--disp N]
    python -m steroscopic_hardware_tpu_torch.examples.run_stream \\
        --synthetic [--size H W] [--device cpu]

``--synthetic`` cycles four seeded textured pairs (the JAX script cycles
four test pairs). Each frame's time is host wall time around
``BlockMatcher.compute``, which returns the map on the host, so it covers
the upload, the kernel and the copy back; the first call (the kernel
build) is made before the loop.
"""

from __future__ import annotations

import argparse
import time

N_SYNTHETIC = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=10)
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--disp", type=int, default=64)
    ap.add_argument("--left", default=None, help="left image (PNG)")
    ap.add_argument("--right", default=None, help="right image (PNG)")
    ap.add_argument("--synthetic", action="store_true",
                    help="four seeded textured pairs instead of --left/"
                         "--right")
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640),
                    metavar=("H", "W"), help="size of the synthetic pairs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.synthetic == (args.left is not None and args.right is not None):
        ap.error("give --left and --right, or --synthetic")

    from steroscopic_hardware_tpu_torch.models.blockmatch import BlockMatcher
    from steroscopic_hardware_tpu_torch.utils.params import Parameters
    from steroscopic_hardware_tpu_torch.utils.timing import RollingTimer

    if args.synthetic:
        from steroscopic_hardware_tpu_torch.serve_probe import textured_pair

        frames = [textured_pair(seed, *args.size, shift=8 + 4 * seed)
                  for seed in range(N_SYNTHETIC)]
    else:
        from steroscopic_hardware_tpu_torch.ops.gray import load_gray

        frames = [(load_gray(args.left), load_gray(args.right))]
    m = BlockMatcher(params=Parameters(args.block, args.disp),
                     device=args.device)
    m.compute(*frames[0])  # the kernel build and first launch

    timer = RollingTimer(window=max(args.n, 1))
    for i in range(args.n):
        left, right = frames[i % len(frames)]
        t0 = time.perf_counter()
        m.compute(left, right)
        dt = time.perf_counter() - t0
        timer.add(dt)
        print(f"frame {i}: {dt * 1000:.2f} ms")
    s = timer.stats(pixels=frames[0][0].size)
    if s:
        print(f"mean {s['ms_mean']:.2f} ms  p50 {s['ms_p50']:.2f} ms  "
              f"{s['fps']:.1f} fps  {s['mpix_per_s']:.1f} Mpix/s "
              f"on {m.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
