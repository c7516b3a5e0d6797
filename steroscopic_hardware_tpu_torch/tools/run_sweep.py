"""Full parameter sweep (BASELINE config #2), the counterpart of the
repository's ``tools/run_sweep.py``: every block size 3-31 (odd) x maximum
disparity 16-256 (step 16) through the port's ``BlockMatcher``, or the
disparity grid alone through ``SGMMatcher`` (SGM has no block size), with
the optional left-right check, one line per configuration and pair.

    python -m steroscopic_hardware_tpu_torch.tools.run_sweep --synthetic
    python -m steroscopic_hardware_tpu_torch.tools.run_sweep \\
        --pairs 00001 --blocks 7,15 --disps 64,128 --lr-check --json
    python -m steroscopic_hardware_tpu_torch.tools.run_sweep --synthetic \\
        --engine sgm --device cpu --disps 16 -n 1

The flags are the original's, plus ``--device`` and ``--synthetic``. The
original reads the reference's test pairs under ``TESTDATA``, which a
checkout does not carry; ``--synthetic`` sweeps one seeded textured pair
of the reference cameras' size (1920x1080) instead, whose right image is
the left shifted by 8, 24 and 40 pixels in three horizontal bands
(:func:`synthetic_pair`), so the sweep runs wherever the port does.

A line has the original's keys: ``pair``, ``engine``, ``block`` (0 for
SGM), ``disp``, ``ms`` (the mean of ``-n`` ``compute`` calls, each an
upload of the host pair, the disparity and the copy back), ``mpix_s``,
``compile_s`` (the first call's seconds, which include building or
loading the kernel library) and, with ``--lr-check``,
``lr_valid_frac``; and one more, ``kernel_ms``: the mean of ``-n``
disparity steps on a pair already on the card, between CUDA events (the
SAD kernel's launch alone; SGM's chain), null on the CPU.

On the card a SAD ``compute`` is one launch of B1 (``sad_wta``), the LR
check one of B2 (``sad_lr``); an SGM frame runs the census costs, B4
(``sgm_transpose_add``), B3 (``sgm_aggregate``) twice, its wide kernel
above D 136, and the argmin.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

TESTDATA = "/root/reference/testdata"
ALL_PAIRS = ["00001", "00002", "00335", "01000"]
SYNTHETIC_SIZE = (1080, 1920)
SYNTHETIC_SHIFTS = (8, 24, 40)


def synthetic_pair(seed: int = 0, size=SYNTHETIC_SIZE):
    """(left, right, truth): a seeded uint8 noise texture whose left pixel
    (y, x) is right pixel (y, x - d) up to +-2 grey levels, with d = 8, 24
    and 40 in three horizontal bands (``truth``, int32)."""
    H, W = size
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (H, W), dtype=np.uint8)
    right = rng.integers(0, 256, (H, W), dtype=np.uint8)
    truth = np.zeros((H, W), np.int32)
    edges = np.linspace(0, H, len(SYNTHETIC_SHIFTS) + 1).astype(int)
    for y0, y1, d in zip(edges[:-1], edges[1:], SYNTHETIC_SHIFTS):
        right[y0:y1, : W - d] = left[y0:y1, d:]
        truth[y0:y1] = d
    right = np.clip(right.astype(int) + rng.integers(-2, 3, (H, W)), 0,
                    255).astype(np.uint8)
    return left, right, truth


def load_pairs(names, synthetic: bool) -> dict:
    """{name: (left, right)} uint8 host arrays: the synthetic pair, or the
    reference's ``L_<name>.png`` / ``R_<name>.png`` under ``TESTDATA``."""
    if synthetic:
        left, right, _ = synthetic_pair(0, SYNTHETIC_SIZE)
        return {"synthetic": (left, right)}
    from steroscopic_hardware_tpu_torch.ops.gray import load_gray

    return {p: (load_gray(f"{TESTDATA}/L_{p}.png"),
                load_gray(f"{TESTDATA}/R_{p}.png")) for p in names}


def _step(matcher, engine, L, R, block, disp):
    """The disparity step of one configuration on device tensors."""
    if engine == "sgm":
        from steroscopic_hardware_tpu_torch.models.blockmatch import sgm_one

        return sgm_one(L, R, max_disparity=disp, p1=matcher.p1,
                       p2=matcher.p2, subpixel=matcher.subpixel, lr=False,
                       threshold=1.0)
    from steroscopic_hardware_tpu_torch.ops.sad import disparity_batch

    return disparity_batch(L[None], R[None], block_size=block,
                           max_disparity=disp)


def kernel_ms(matcher, engine, L, R, block, disp, n) -> float | None:
    """Mean ms of ``n`` disparity steps on the card between CUDA events;
    None on the CPU, which has no device clock."""
    if L.device.type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        _step(matcher, engine, L, R, block, disp)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def run_config(matcher, name, left, right, *, engine, block, disp, n,
               lr_check):
    """One configuration on one pair: ``(rec, out, checked)``, the line's
    record, the first call's uint8 map and, with ``lr_check``, the
    checked ``(map, valid)`` (else None)."""
    from steroscopic_hardware_tpu_torch.utils.params import Parameters

    matcher.set_params(Parameters(block or 7, disp))
    t0 = time.perf_counter()
    out = matcher.compute(left, right)  # builds or loads the kernels
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        matcher.compute(left, right)
    dt = (time.perf_counter() - t0) / n
    L = torch.from_numpy(np.ascontiguousarray(left)).to(matcher.device)
    R = torch.from_numpy(np.ascontiguousarray(right)).to(matcher.device)
    rec = {"pair": name, "engine": engine, "block": block, "disp": disp,
           "ms": dt * 1e3, "mpix_s": out.size / 1e6 / dt,
           "compile_s": compile_s,
           "kernel_ms": kernel_ms(matcher, engine, L, R, block, disp, n)}
    checked = None
    if lr_check:
        if engine == "sgm":
            checked = matcher.compute_checked(left, right)
        else:
            from steroscopic_hardware_tpu_torch.ops.lr_check import (
                disparity_lr_checked,
            )

            disp_u8, valid = disparity_lr_checked(
                L, R, block_size=block, max_disparity=disp)
            checked = disp_u8.cpu().numpy(), valid.cpu().numpy()
        rec["lr_valid_frac"] = float(checked[1].mean())
    return rec, out, checked


def sweep(pairs: dict, *, engine="sad", blocks=None, disps=None, n=5,
          lr_check=False, device="cuda"):
    """Yields ``run_config``'s ``(rec, out, checked)`` over the grid in
    the original's order: block, then disparity, then pair. SGM runs one
    row per disparity (block 0)."""
    from steroscopic_hardware_tpu_torch.utils.params import (
        VALID_BLOCK_SIZES,
        VALID_MAX_DISPARITIES,
    )

    from steroscopic_hardware_tpu_torch.models.blockmatch import (
        BlockMatcher,
        SGMMatcher,
    )

    matcher = (SGMMatcher if engine == "sgm" else BlockMatcher)(
        device=device)
    blocks = [0] if engine == "sgm" else list(blocks or VALID_BLOCK_SIZES)
    for b in blocks:
        for d in disps or VALID_MAX_DISPARITIES:
            for name, (left, right) in pairs.items():
                yield run_config(matcher, name, left, right, engine=engine,
                                 block=b, disp=d, n=n, lr_check=lr_check)


def line(rec) -> str:
    """The original's text line, with ``kernel_ms`` where there is one."""
    s = (f"pair {rec['pair']} {rec['engine']} b={rec['block']:2d} "
         f"D={rec['disp']:3d}: {rec['ms']:8.2f} ms {rec['mpix_s']:7.1f} "
         f"Mpix/s")
    if rec["kernel_ms"] is not None:
        s += f"  kernel {rec['kernel_ms']:.4f} ms"
    if "lr_valid_frac" in rec:
        s += f"  lr_valid={rec['lr_valid_frac']:.3f}"
    return s


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="block size x maximum disparity sweep (PyTorch + CUDA)")
    ap.add_argument("--pairs", default=",".join(ALL_PAIRS))
    ap.add_argument("--blocks",
                    default=",".join(str(b) for b in range(3, 32, 2)))
    ap.add_argument("--disps",
                    default=",".join(str(d) for d in range(16, 257, 16)))
    ap.add_argument("--lr-check", action="store_true")
    ap.add_argument("--engine", default="sad", choices=["sad", "sgm"],
                    help="sad = block matching (block x disp grid); "
                         "sgm = semi-global matching (disp grid; block "
                         "sizes are ignored: SGM has none)")
    ap.add_argument("-n", type=int, default=5, help="timed reps per config")
    ap.add_argument("--json", action="store_true", help="JSON-lines output")
    ap.add_argument("--synthetic", action="store_true",
                    help="sweep the seeded 1920x1080 textured pair, not "
                         "the reference's test pairs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels (fails without a "
                         "usable GPU); cpu: the plain torch versions")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from steroscopic_hardware_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    pairs = load_pairs(args.pairs.split(","), args.synthetic)
    for rec, _, _ in sweep(
            pairs, engine=args.engine,
            blocks=[int(b) for b in args.blocks.split(",")],
            disps=[int(d) for d in args.disps.split(",")], n=args.n,
            lr_check=args.lr_check, device=device):
        print(json.dumps(rec) if args.json else line(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
