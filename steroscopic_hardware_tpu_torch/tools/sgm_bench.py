"""SGM stage-level benchmark on one card, the counterpart of the
repository's ``tools/sgm_bench.py``: the SGM variants end to end and each
stage alone, under the two-point differenced chain of
``steroscopic_hardware_tpu_torch/bench.py`` (n // 2 and 2n steps, best of
3), so a change in one stage shows in its own row.

    python -m steroscopic_hardware_tpu_torch.tools.sgm_bench \\
        [--size 640x480] [--maxd 64] [--frames 12] [--filter prefix]

Each chain feeds a stage's output back into its input (uint8 wraparound,
bfloat16 accumulation: the values drift, the shapes and the operations do
not), as the original's do. The chains are eager launches from Python, so
a row whose launches outlast its kernels (the plain-torch census costs
and argmin, ~1650 launches a d64 SGM frame) reads the host's rate.

Rows, under the original's names (its TPU terms stand for the port's
kernels: "MXU transpose-add" is B4, ``sgm_transpose_add``; "aggregation
kernel" B3, ``sgm_aggregate``; "fused Pallas epilogue" B5,
``sgm_epilogue``; "XLA epilogue" the plain-torch argmin and parabola):

* end to end: ``sgm_disparity`` raw and subpixel (unfused epilogue),
  subpixel with the fused epilogue (B5), ``sgm_disparity_lr`` (fused LR),
  and the plain disparity through the summed volume (B4 twice, B3 twice,
  float32 sum, plain epilogue);
* stages: the census volume (plain torch), B4 building the (D, H, W)
  cost, B3 on the vertical (bfloat16 in) and horizontal (uint8 in)
  families, B5 subpixel and raw on uint8 aggregates;
* ``prefix: through <stage>`` for census, ta, agg_v, agg_ht, full: the
  fused chain cut after each stage (uint8 aggregates, B5 at the end);
* ``uprefix: through <stage>`` for census, ta, agg_v, agg_ht, sum, full:
  the served (unfused) chain cut after each stage.

Not ported (listed by the original, not timed here):

* ``sgm plain raw (s_unfused scan-major)``, ``sgm plain subpixel
  (s_unfused scan-major)`` and every ``sprefix:`` row: the scan-major
  chain is a TPU layout variant the port does not have;
* ``prefix: through pads``: the padding of the aggregates to 128-lane
  tiles before the TPU epilogue; the port's B5 reads them unpadded.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from steroscopic_hardware_tpu_torch.bench import textured_pair
from steroscopic_hardware_tpu_torch.tools.bench_table import diff_time_n
from steroscopic_hardware_tpu_torch.utils.device import card_name

P1, P2 = 1.0, 8.0
PREFIXES = ("census", "ta", "agg_v", "agg_ht", "full")
UPREFIXES = ("census", "ta", "agg_v", "agg_ht", "sum", "full")
NOT_PORTED = (
    "sgm plain raw (s_unfused scan-major)",
    "sgm plain subpixel (s_unfused scan-major)",
    "prefix: through pads",
    *(f"sprefix: through {s}"
      for s in ("census", "ta", "agg_v", "agg_h", "sum", "full")),
)


def _u8(x):
    return x.to(torch.uint8)


def specs(L, R, D: int, rng):
    """[(name, step, carry0)] in the original's order (less the rows of
    ``NOT_PORTED``) for the (H, W) uint8 device pair ``L``, ``R`` at
    maxDisparity ``D``; ``rng`` makes the epilogue rows' aggregates."""
    from steroscopic_hardware_tpu_torch.ops import sgm
    from steroscopic_hardware_tpu_torch.ops.census import (
        census_cost_volume_T,
    )

    bf16 = torch.bfloat16
    rows = []

    def e2e(subpixel, epilogue="unfused"):
        def step(x):
            d = sgm.sgm_disparity(x, R, max_disparity=D, subpixel=subpixel,
                                  epilogue=epilogue)
            return (d * 4.0).clamp(0, 255).to(torch.uint8)
        return step

    def lr_step(x):
        dl, _ = sgm.sgm_disparity_lr(x, R, max_disparity=D, subpixel=True)
        return (dl * 4.0).clamp(0, 255).to(torch.uint8)

    def plain_unfused_step(x):
        ct = census_cost_volume_T(x, R, max_disparity=D)
        cost = sgm.transpose_add(ct, out_dtype=bf16)
        agg_dtype = bf16 if sgm._bf16_exact(P1, P2) else torch.float32
        agg_v = sgm.aggregate_axis(cost, P1, P2, out_dtype=agg_dtype)
        agg_ht = sgm.aggregate_axis(ct, P1, P2, out_dtype=agg_dtype)
        agg = sgm.transpose_add(agg_ht, agg_v, out_dtype=torch.float32)
        disp = sgm.epilogue(agg, True)
        return (disp * 4.0).clamp(0, 255).to(torch.uint8)

    rows += [
        ("sgm plain raw (default unfused epilogue)", e2e(False), L),
        ("sgm plain subpixel (default unfused)", e2e(True), L),
        ("sgm plain subpixel (fused epilogue)", e2e(True, "fused"), L),
        ("sgm fused LR (summed vol + XLA epilogue)", lr_step, L),
        ("sgm plain via summed vol + XLA epilogue", plain_unfused_step, L),
    ]

    # ---- stages --------------------------------------------------------
    def census_step(x):
        ct = census_cost_volume_T(x, R, max_disparity=D)
        return x + ct[0].T

    ct0 = census_cost_volume_T(L, R, max_disparity=D)

    def ta_step(c):
        out = sgm.transpose_add(c, out_dtype=bf16)
        return c + _u8(out).transpose(1, 2)

    cost_bf16 = sgm.transpose_add(ct0, out_dtype=bf16)

    def agg_step(c):
        agg = sgm.aggregate_axis(c, P1, P2, out_dtype=torch.uint8)
        return c + agg.to(bf16)

    def agg_t_step(c):
        return c + sgm.aggregate_axis(c, P1, P2, out_dtype=torch.uint8)

    Dp, H, W = cost_bf16.shape
    dev = L.device
    av0 = torch.from_numpy(rng.integers(0, 96, (Dp, H, W),
                                        dtype=np.uint8)).to(dev)
    ah0 = torch.from_numpy(rng.integers(0, 96, (Dp, W, H),
                                        dtype=np.uint8)).to(dev)

    def epi(subpixel):
        def step(c):
            av, ah = c
            disp = sgm.sgm_epilogue(av, ah, subpixel=subpixel)
            return (av + _u8(disp)[None], ah)
        return step

    rows += [
        ("stage: census_cost_volume_T", census_step, L),
        ("stage: MXU transpose-add (build std frame)", ta_step, ct0),
        ("stage: aggregation kernel (vertical fam)", agg_step, cost_bf16),
        ("stage: aggregation kernel (u8 in, horiz fam)", agg_t_step, ct0),
        ("stage: fused Pallas epilogue", epi(True), (av0, ah0)),
        ("stage: fused Pallas epilogue (raw)", epi(False), (av0, ah0)),
    ]

    # ---- cumulative prefixes of the fused chain (uint8 aggregates) -------
    def prefix(upto):
        def step(x):
            ct = census_cost_volume_T(x, R, max_disparity=D)
            if upto == "census":
                return x + ct[0].T
            cost = sgm.transpose_add(ct, out_dtype=bf16)
            if upto == "ta":
                return x + _u8(cost[0])
            agg_v = sgm.aggregate_axis(cost, P1, P2, out_dtype=torch.uint8)
            if upto == "agg_v":
                return x + agg_v[0]
            agg_ht = sgm.aggregate_axis(ct, P1, P2, out_dtype=torch.uint8)
            if upto == "agg_ht":
                # a scalar reduction consumes agg_ht, as the original's
                return x + agg_v[0] + _u8(agg_ht.sum() % 7)
            disp = sgm.sgm_epilogue(agg_v, agg_ht, subpixel=True)
            return (disp * 4.0).clamp(0, 255).to(torch.uint8)
        return step

    rows += [(f"prefix: through {u}", prefix(u), L) for u in PREFIXES]

    # ---- the served (d-major unfused) chain, cut after each stage --------
    def uprefix(upto):
        sum_dtype = bf16 if sgm._bf16_sum_exact(P1, P2) else torch.float32

        def step(x):
            ct = census_cost_volume_T(x, R, max_disparity=D)
            if upto == "census":
                return x + ct[0].T
            cost = sgm.transpose_add(ct, out_dtype=bf16)
            if upto == "ta":
                return x + _u8(cost[0])
            agg_v = sgm.aggregate_axis(cost, P1, P2, out_dtype=bf16)
            if upto == "agg_v":
                return x + _u8(agg_v[0])
            agg_ht = sgm.aggregate_axis(ct, P1, P2, out_dtype=bf16)
            if upto == "agg_ht":
                return x + _u8(agg_v[0]) + _u8(agg_ht.sum() % 7)
            agg = sgm.transpose_add(agg_ht, agg_v, out_dtype=sum_dtype)
            if upto == "sum":
                return x + _u8(agg[0])
            disp = sgm.epilogue(agg, True)
            return (disp * 4.0).clamp(0, 255).to(torch.uint8)
        return step

    rows += [(f"uprefix: through {u}", uprefix(u), L) for u in UPREFIXES]
    return rows


def names() -> list[str]:
    """The rows' names, in order (built on a tiny CPU pair)."""
    z = torch.zeros((8, 8), dtype=torch.uint8)
    return [name for name, _, _ in specs(z, z, 4, np.random.default_rng(0))]


def bench(device, *, size=(640, 480), maxd: int = 64, frames: int = 12,
          filter: str = "", out=print) -> list[dict]:
    """Times each row whose name contains ``filter``; returns ``{"name",
    "ms"}`` records (``error`` for a row that raised; the rest go on)."""
    W, H = size
    rng = np.random.default_rng(0)   # the pair, then the epilogue rows'
    L, R = (torch.from_numpy(a).to(device)
            for a in textured_pair(rng, (H, W)))
    out(f"device={card_name(device)} {W}x{H} d{maxd}")
    results = []
    for name, step, carry in specs(L, R, maxd, rng):
        if filter and filter not in name:
            continue
        try:
            dt = diff_time_n(step, carry, frames)
            out(f"  {name:42s} {dt * 1e3:8.3f} ms")
            results.append({"name": name, "ms": dt * 1e3})
        except Exception as e:  # noqa: BLE001 -- keep the rows going
            out(f"  {name:42s} FAILED {type(e).__name__}: {str(e)[:120]}")
            results.append({"name": name, "error": str(e)[:300]})
    return results


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="SGM stage timings")
    ap.add_argument("--size", default="640x480")
    ap.add_argument("--maxd", type=int, default=64)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--filter", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels (fails without a "
                         "usable GPU); cpu: the plain torch versions")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from steroscopic_hardware_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    W, H = map(int, args.size.split("x"))
    rows = bench(device, size=(W, H), maxd=args.maxd, frames=args.frames,
                 filter=args.filter, out=lambda s: print(s, flush=True))
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
