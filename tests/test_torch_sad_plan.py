"""The SAD sweep's launch plan (``_kernels.sad_plan``) over the kernels'
envelope: block 1-63, maxD 1-511, frames from 1x1 to 4096 wide, 1-4
frames, sad_wta and sad_lr with and without costs, on a card of 132 SMs and
on a small one. Pure Python: the plan is what the CUDA kernels are launched
with (``csrc/sad.cu`` checks the same limits and refuses a plan outside
them), and the coverage it promises is checked here without a card.
"""

import numpy as np
import pytest

from steroscopic_hardware_tpu_torch import _kernels as k

BLOCKS = (1, 2, 3, 7, 16, 31, 32, 33, 63)
MAXDS = (1, 7, 15, 16, 64, 100, 128, 256, 511)
SHAPES = ((1, 1), (1, 200), (7, 3), (37, 130), (64, 300), (40, 50),
          (70, 700), (50, 200), (2, 4096), (1080, 1920), (17, 129),
          (33, 31))
# block, maxD and shape taken in step from lists of coprime-ish lengths:
# every block meets several maxD and shapes, ragged and exact widths alike
CASES = [(BLOCKS[i % len(BLOCKS)], MAXDS[(i * 5) % len(MAXDS)],
          SHAPES[i % len(SHAPES)], 1 + i % 4) for i in range(36)]
KERNELS = (("sad_wta", False), ("sad_lr", False), ("sad_lr", True))


def _chunks(maxd, ds):
    """The d range [da, db) of each of a block's ds warps (csrc/sad.cu)."""
    n = maxd + 1
    return [(w * n // ds, (w + 1) * n // ds) for w in range(ds)]


def _name(kernel, costs):
    return "sad_lr_costs" if costs else kernel


@pytest.mark.parametrize("sms", (132, 4))
@pytest.mark.parametrize("block,maxd,shape,frames", CASES)
def test_plan_within_limits_and_covers(block, maxd, shape, frames, sms):
    H, W = shape
    for kernel, costs in KERNELS:
        p = k.sad_plan(frames, H, W, block, maxd, costs, sms, kernel=kernel)
        name = _name(kernel, costs)
        # a compiled kernel, within the card's limits
        h = block // 2
        assert p.th in k.SAD_COMPILED[name][p.kv]
        assert p.ds in k.SAD_DS and p.ds <= maxd + 1
        assert p.ds == 1 or not costs
        assert p.strip == 32 * p.kv - 2 * h >= 32 * p.kv // 2
        assert p.smem <= k.SMEM_LIMIT
        assert p.smem == k.sad_smem(name, p.kv, p.th, h, maxd, p.ds, W)
        gx, gy, gz = p.grid
        assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535 and 1 <= gz <= 65535
        assert 32 * p.ds <= 128
        assert gz == frames
        # every output pixel in exactly one tile, and no tile without one
        cover = np.zeros((H, W), np.int32)
        for by in range(gy):
            for bx in range(gx):
                tile = cover[by * p.th:(by + 1) * p.th,
                             bx * p.strip:(bx + 1) * p.strip]
                assert tile.size > 0
                tile += 1
        assert (cover == 1).all()
        # the d chunks of a block's warps partition [0, maxD]
        chunks = _chunks(maxd, p.ds)
        assert chunks[0][0] == 0 and chunks[-1][1] == maxd + 1
        assert all(a < b for a, b in chunks)
        assert all(chunks[i][1] == chunks[i + 1][0]
                   for i in range(len(chunks) - 1))
        if kernel == "sad_lr":
            # the right map: every (xr, d) with xr + d < W reached by exactly
            # one (strip, warp), the one whose output columns hold x = xr + d
            # and whose chunk holds d; pairs with xr + d >= W by none
            reach = np.zeros((W, maxd + 1), np.int32)
            xr = np.arange(W)[:, None]
            d = np.arange(maxd + 1)[None, :]
            x = xr + d
            for bx in range(gx):
                in_strip = ((x >= bx * p.strip)
                            & (x < (bx + 1) * p.strip) & (x < W))
                for a, b in chunks:
                    reach += in_strip & (d >= a) & (d < b)
            assert (reach == (x < W)).all()


def test_plan_at_1080p():
    """1080p, 132 SMs: 240 output columns a block at b16 (KV 8, h 8);
    sad_wta 8-row tiles of 4 warps, sad_lr 4 rows of 4, with costs 2 rows
    of 1 warp at b16 and KV 4, 4 rows at b31; a batch of 8 frames of
    sad_lr fills the card with 2 warps a block."""
    def plan(costs, kernel, block=16, frames=1):
        return k.sad_plan(frames, 1080, 1920, block, 64, costs, 132,
                          kernel=kernel)
    assert plan(False, "sad_wta")[:3] == (8, 8, 4)
    assert plan(False, "sad_lr")[:3] == (8, 4, 4)
    assert plan(True, "sad_lr")[:3] == (8, 2, 1)
    assert plan(True, "sad_lr", block=31)[:3] == (4, 4, 1)
    assert plan(False, "sad_wta").grid == (8, 135, 1)
    assert plan(False, "sad_wta", frames=8).ds == 4
    assert plan(False, "sad_lr", frames=8).ds == 2
    assert plan(False, "sad_wta", block=63).strip == 256 - 62


def test_plan_keeps_eight_d_values_a_warp():
    for maxd in (1, 7, 15, 16, 31, 63):
        p = k.sad_plan(1, 8, 8, 5, maxd, False, 132, kernel="sad_lr")
        assert (maxd + 1) // p.ds >= 8 or p.ds == 1


@pytest.mark.parametrize("args,match", [
    ((1, 8, 8, 0, 16, False, 132), "block_size"),
    ((1, 8, 8, 64, 16, False, 132), "block_size"),
    ((1, 8, 8, 5, 0, False, 132), "max_disparity"),
    ((1, 8, 8, 5, 512, False, 132), "max_disparity"),
    ((0, 8, 8, 5, 16, False, 132), "empty"),
    ((1, 8 * 65536, 8, 5, 16, False, 132), "grid"),
    ((65536, 8, 8, 5, 16, False, 132), "grid"),
])
def test_plan_refuses_outside_the_envelope(args, match):
    with pytest.raises(ValueError, match=match):
        k.sad_plan(*args)


def test_plan_refuses_wta_with_costs_and_unknown_kernels():
    with pytest.raises(ValueError, match="no costs"):
        k.sad_plan(1, 8, 8, 5, 16, True, 132, kernel="sad_wta")
    with pytest.raises(ValueError, match="unknown"):
        k.sad_plan(1, 8, 8, 5, 16, False, 132, kernel="sad_sgm")


def test_smem_of_the_largest_launch_fits():
    """The envelope's largest block (h 31, maxD 511, the most warps its
    kernel takes) fits the card's shared memory for every tile height."""
    for name, compiled in k.SAD_COMPILED.items():
        ds = 1 if name == "sad_lr_costs" else k.SAD_DS[-1]
        for kv, ths in compiled.items():
            for th in ths:
                assert k.sad_smem(name, kv, th, 31, 511, ds, 15) <= k.SMEM_LIMIT
