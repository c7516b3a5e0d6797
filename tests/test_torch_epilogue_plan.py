"""B5's launch plan (``_kernels.sgm_epilogue_plan``) over the kernel's
envelope: D 1 / 2 / 3 / 31 / 64 / 65 / 257 / 288; H x W at 1080p, ragged
and the sharded engine's W-bands of a 1080p frame (960, 480 and 240
columns); uint8, bfloat16 and float32 aggregates; base pointers 0, 1, 2,
4 and 8 bytes past a 16-byte boundary. Pure Python: the plan is what the
CUDA kernel is launched with (``csrc/sgm.cu`` checks the same rules and
refuses a plan outside them), so its promises are checked here without a
card: each access width is the widest that divides the row pitch and the
base pointer it is used on, the grid covers the (H, W) plane exactly
once, the ring depth is the type's (one the library compiled), and the
kernel's thread mapping, swizzle and d loop cover every pixel, byte and
plane once.
"""

import itertools

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu_torch import _kernels as k

DS = (1, 2, 3, 31, 64, 65, 257, 288)
SHAPES = [(1080, 1920), (1080, 960), (1080, 480), (1080, 240), (1, 1),
          (37, 53), (64, 64), (65, 129), (1079, 1921), (7, 2000),
          (2000, 3)]
TYPES = (torch.uint8, torch.bfloat16, torch.float32)
OFFSETS = (0, 1, 2, 4, 8)
T = k.EPILOGUE_TILE


def _widest(itemsize, pitch, align):
    return max(w for w in (1, 2, 4, 8, 16)
               if itemsize <= w and pitch % w == 0 and align % w == 0)


def _covered_once(n, tile, tiles):
    """Every index of range(n) in exactly one of ``tiles`` tiles of
    ``tile``, and no tile without one."""
    cover = np.zeros(n, np.int32)
    for t in range(tiles):
        seg = cover[t * tile:(t + 1) * tile]
        assert seg.size > 0
        seg += 1
    return bool((cover == 1).all())


@pytest.mark.parametrize("H,W", SHAPES)
def test_plan_widths_grid_and_ring(H, W):
    for dt, off, D in itertools.product(TYPES, OFFSETS, DS):
        s = dt.itemsize
        align = k.pointer_alignment(4096 + off)
        if align < s:  # a torch tensor's base is a multiple of its itemsize
            with pytest.raises(ValueError, match="no access width"):
                k.sgm_epilogue_plan(D, H, W, dt, align, align)
            continue
        p = k.sgm_epilogue_plan(D, H, W, dt, align, 16)
        assert p.wv == _widest(s, W * s, align)
        assert p.wh == _widest(s, H * s, 16)
        assert (W * s) % p.wv == 0 and align % p.wv == 0
        assert (H * s) % p.wh == 0
        gx, gy = p.grid
        assert _covered_once(W, T, gx) and _covered_once(H, T, gy)
        assert 1 <= gy <= k.GRID_YZ_MAX
        assert p.stages == k.EPILOGUE_RING[dt]
        assert p.stages in k.EPILOGUE_RINGS
        # a ring slot holds both tiles of a plane; every compiled ring fits
        # a block's shared memory
        assert max(k.EPILOGUE_RINGS) * 2 * T * T * s <= k.SMEM_LIMIT


def test_plan_at_1080p_and_on_the_w_bands():
    """1080p: 16-byte loads on agg_v's 1920-byte uint8 rows, 8 bytes on
    agg_ht's 1080-byte rows, 30 x 17 tiles, the 4-slot ring for uint8 and
    3 slots for the others; the W-bands of the 2-, 4- and 8-way sharded
    engine (960, 480, 240 columns of 1080 rows) the same widths on fewer
    tiles."""
    u8, bf16, f32 = TYPES
    for D in (65, 129, 257):
        p = k.sgm_epilogue_plan(D, 1080, 1920, u8)
        assert p == k.EpiloguePlan(16, 8, 4, (30, 17))
        assert k.sgm_epilogue_plan(D, 1080, 1920, bf16) == \
            k.EpiloguePlan(16, 16, 3, (30, 17))
        assert k.sgm_epilogue_plan(D, 1080, 1920, f32) == \
            k.EpiloguePlan(16, 16, 3, (30, 17))
    for w, gx in ((960, 15), (480, 8), (240, 4)):
        assert k.sgm_epilogue_plan(65, 1080, w, u8) == \
            k.EpiloguePlan(16, 8, 4, (gx, 17))


def test_threads_partition_a_tile():
    """csrc/sgm.cu: 256 threads, warp w lane l owning the 4 x 4 pixels
    from (4 tx, 4 ty) with tx = l % 8 + 8 (w % 2), ty = 4 (w // 2) + l // 8,
    cover the 64 x 64 tile exactly once."""
    cover = np.zeros((T, T), np.int32)
    for t in range(256):
        w, lane = t // 32, t % 32
        tx, ty = lane % 8 + 8 * (w % 2), 4 * (w // 2) + lane // 8
        cover[4 * ty:4 * ty + 4, 4 * tx:4 * tx + 4] += 1
    assert (cover == 1).all()


def _swizzle(r, x, row, shift):
    """csrc/sgm.cu tile_swizzle."""
    return r * row + ((((x >> 4) ^ (r >> shift)) & (row // 16 - 1)) << 4) \
        + (x & 15)


@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_swizzle_is_a_permutation_keeping_vectors_whole(itemsize):
    """The staged tile's layout (64 rows of 64 values; SHIFT 2) puts each
    byte in its own place, keeps every aligned piece of up to 16 bytes (a
    staged copy, a thread's 4-value read) contiguous, and a thread's
    4-value read inside one 16-byte chunk."""
    row = T * itemsize
    where = np.array([[_swizzle(r, x, row, 2) for x in range(row)]
                      for r in range(T)])
    assert sorted(where.ravel()) == list(range(T * row))
    for w in (1, 2, 4, 8, 16, 4 * itemsize):
        for r in range(T):
            for x in range(0, row, w):
                piece = where[r, x:x + w]
                assert (np.diff(piece) == 1).all()
                assert piece[0] % w == 0
    assert _swizzle(9, 40, 128, 3) == 9 * 128 + (((40 >> 4) ^ 1) << 4) + 8


@pytest.mark.parametrize("D", DS)
def test_ring_visits_each_plane_once(D):
    """The d loop of csrc/sgm.cu, replayed: plane s staged before the loop
    for s < stages - 1, plane d + stages - 1 at step d; the plane read at
    step d sits in slot d % stages and is not overwritten before it is
    read (the slot staged at step d held plane d - 1, read at step d - 1,
    before the barrier of step d)."""
    for stages in k.EPILOGUE_RINGS:
        slot = {}
        staged = []
        for s in range(stages - 1):
            if s < D:
                slot[s % stages] = s
                staged.append(s)
        for d in range(D):
            if d + stages - 1 < D:
                n = d + stages - 1
                # overwrites the plane of step d - 1, already read
                assert slot.get(n % stages, -1) in (-1, d - 1)
                slot[n % stages] = n
                staged.append(n)
            assert slot[d % stages] == d
        assert staged == list(range(D))


def test_pointer_alignment_of_views():
    assert [k.pointer_alignment(4096 + o) for o in OFFSETS] == [16, 1, 2, 4, 8]


@pytest.mark.parametrize("args,match", [
    ((4, 8, 8, torch.int32), "uint8, bfloat16 or float32"),
    ((0, 8, 8, torch.uint8), "empty"),
    ((4, 0, 8, torch.uint8), "empty"),
    ((4, 8, 0, torch.uint8), "empty"),
    ((4, 2 ** 15, 2 ** 15 + 1, torch.uint8), "plane"),
    ((4, 65 * 2 ** 16, 1, torch.uint8), "grid"),
    ((4, 8, 8, torch.float32, 2, 16), "no access width"),
    ((4, 8, 8, torch.bfloat16, 16, 1), "no access width"),
])
def test_plan_refuses_outside_the_envelope(args, match):
    with pytest.raises(ValueError, match=match):
        k.sgm_epilogue_plan(*args)
