"""One-shot SAD disparity of a stereo pair (the counterpart of
``examples/run_once.py``; block 16, maxDisparity 64 by default, as the
reference's ``examples/run.go``).

    python -m steroscopic_hardware_tpu_torch.examples.run_once \\
        LEFT.png RIGHT.png [OUT.png] [--block N] [--disp N]
    python -m steroscopic_hardware_tpu_torch.examples.run_once \\
        --synthetic [OUT.png] [--size H W] [--device cpu]

The first call on the card builds the kernels, so its time includes the
build, as the JAX script's includes the compile.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*", metavar="LEFT RIGHT [OUT]",
                    help="the pair and the output PNG (default "
                         "disparity.png); with --synthetic only [OUT]")
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--disp", type=int, default=64)
    ap.add_argument("--synthetic", action="store_true",
                    help="a seeded textured pair instead of LEFT RIGHT")
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640),
                    metavar=("H", "W"), help="size of the synthetic pair")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if len(args.paths) not in ((0, 1) if args.synthetic else (2, 3)):
        ap.error("give LEFT RIGHT [OUT], or --synthetic [OUT]")
    out_path = (args.paths[0 if args.synthetic else 2:] or
                ["disparity.png"])[0]

    from steroscopic_hardware_tpu_torch.io.png import write_png
    from steroscopic_hardware_tpu_torch.models.blockmatch import BlockMatcher
    from steroscopic_hardware_tpu_torch.utils.params import Parameters

    if args.synthetic:
        from steroscopic_hardware_tpu_torch.serve_probe import textured_pair

        left, right = textured_pair(args.seed, *args.size)
    else:
        from steroscopic_hardware_tpu_torch.ops.gray import load_gray

        left, right = load_gray(args.paths[0]), load_gray(args.paths[1])
    m = BlockMatcher(params=Parameters(args.block, args.disp),
                     device=args.device)
    t0 = time.time()
    out = m.compute(left, right)
    print(f"computed {out.shape[1]}x{out.shape[0]} disparity "
          f"(block={args.block}, maxDisp={args.disp}) on {m.device} "
          f"in {time.time() - t0:.3f}s (includes the kernel build)")
    write_png(out_path, out)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
