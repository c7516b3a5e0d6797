"""Golden-vector generator, the counterpart of the repository's
``tools/gen_vectors.py`` (host numpy; no device).

The reference generates HDL test vectors by cropping random patches from
a stereo pair and computing the integral-image SAD golden disparities
(``hardware/test.py``, read by ``hardware/ez_tb.v`` through $readmemh).
For each of ``--n`` crops this writes ``caseI_L.raw`` / ``caseI_R.raw``
(the uint8 patches), ``caseI_exp_disp.mem`` (the golden disparities in
hex, one byte a line) and ``caseI_disp.pgm``, from the port's own
``ops/gray.load_gray``, ``ops/sad_golden.disparity_numpy`` and
``io/pgm.write_pgm``: the same files, byte for byte, as the original's
for the same pair and flags.

    python -m steroscopic_hardware_tpu_torch.tools.gen_vectors OUTDIR \\
        [--n 4] [--size 128] [--block 15] [--disp 64] [--seed 0] \\
        [--left L.png] [--right R.png]

``--left`` / ``--right`` take any PNG pair (the reference's
``L_00001.png`` / ``R_00001.png`` under ``TESTDATA`` by default).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from steroscopic_hardware_tpu_torch.io.pgm import write_pgm
from steroscopic_hardware_tpu_torch.ops.gray import load_gray
from steroscopic_hardware_tpu_torch.ops.sad_golden import disparity_numpy
from steroscopic_hardware_tpu_torch.tools.run_sweep import TESTDATA


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="HDL golden vectors")
    ap.add_argument("outdir")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--block", type=int, default=15)
    ap.add_argument("--disp", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--left", default=f"{TESTDATA}/L_00001.png")
    ap.add_argument("--right", default=f"{TESTDATA}/R_00001.png")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    left = load_gray(args.left)
    right = load_gray(args.right)
    rng = np.random.default_rng(args.seed)
    H, W = left.shape
    s = args.size

    for i in range(args.n):
        y = int(rng.integers(0, H - s))
        x = int(rng.integers(0, W - s))
        lp, rp = left[y: y + s, x: x + s], right[y: y + s, x: x + s]
        gold = disparity_numpy(lp, rp, args.block, args.disp)

        base = os.path.join(args.outdir, f"case{i}")
        lp.tofile(base + "_L.raw")
        rp.tofile(base + "_R.raw")
        with open(base + "_exp_disp.mem", "w") as f:
            for v in gold.reshape(-1):
                f.write(f"{v:02x}\n")
        write_pgm(base + "_disp.pgm", gold)
        print(f"case{i}: crop ({y},{x}) {s}x{s} "
              f"block={args.block} disp={args.disp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
