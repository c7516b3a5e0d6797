"""B4's launch plan (``_kernels.transpose_add_plan``) over the kernel's
envelope: D 1-257; A and B from 1 to 1920, odd, ragged and the served
1080 / 1920; every type combination the library takes (aT uint8 /
bfloat16 / float32, out bfloat16 / float32, with and without b); base
pointers 0, 2, 4 and 8 bytes past a 16-byte boundary. Pure Python: the plan
is what the CUDA kernel is launched with (``csrc/sgm.cu`` checks the same
rules and refuses a plan outside them), so its promises are checked here
without a card: every access width divides the row pitch and the base
pointer it is used on and is the widest that does, and the grid covers the
volume exactly once.
"""

import itertools

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu_torch import _kernels as k

SIDES = (1, 7, 37, 53, 480, 640, 1080, 1920)
DS = (1, 2, 17, 65, 129, 257)
OFFSETS = (0, 2, 4, 8)
COMBOS = [(i, o, b) for i in k.TRANSPOSE_IN for o in k.TRANSPOSE_OUT
          for b in (False, True)]


def _widest(itemsize, cap, pitch, align):
    return max(w for w in (1, 2, 4, 8, 16)
               if itemsize <= w <= cap and pitch % w == 0 and align % w == 0)


def _covered_once(n, tile, tiles):
    """Every index of range(n) in exactly one of ``tiles`` tiles of
    ``tile``, and no tile without one."""
    cover = np.zeros(n, np.int32)
    for t in range(tiles):
        seg = cover[t * tile:(t + 1) * tile]
        assert seg.size > 0
        seg += 1
    return bool((cover == 1).all())


@pytest.mark.parametrize("A,B", list(itertools.product(SIDES, SIDES)))
def test_plan_widths_and_cover(A, B):
    for (ind, outd, has_b), off, D in itertools.product(COMBOS, OFFSETS, DS):
        sa, so = ind.itemsize, outd.itemsize
        # a base pointer `off` bytes past a 16-byte boundary; one that is
        # not a multiple of the element size does not occur in torch
        align = k.pointer_alignment(4096 + off)
        if align < sa:
            with pytest.raises(ValueError, match="no access width"):
                k.transpose_add_plan(D, B, A, ind, outd, has_b, 132,
                                     align, align, 16)
            continue
        p = k.transpose_add_plan(D, B, A, ind, outd, has_b, 132, align,
                                 align, 16)
        assert p.wa == _widest(sa, 16, A * sa, align)
        assert (A * sa) % p.wa == 0 and align % p.wa == 0
        if has_b:
            assert p.wb == _widest(sa, min(16, 8 * sa), B * sa, align)
            assert (B * sa) % p.wb == 0 and align % p.wb == 0
            assert p.wb <= 8 * sa
        else:
            assert p.wb == 0
        assert p.wo == _widest(so, 16, B * so, 16)
        assert (B * so) % p.wo == 0
        gx, gy, gz = p.grid
        assert _covered_once(A, k.TRANSPOSE_ROW_BYTES // sa, gx)
        assert _covered_once(B, k.TRANSPOSE_ROWS, gy)
        assert _covered_once(D, p.dpb, gz)
        assert 1 <= gy <= k.GRID_YZ_MAX and 1 <= gz <= k.GRID_YZ_MAX


def test_plan_at_1080p():
    """The served forms at 1080p on 132 SMs: the cost volume's 1080-byte
    uint8 rows take 8-byte loads, everything else 16 bytes; a block walks
    2 planes, and the grid holds several waves of blocks."""
    u8, bf16, f32 = torch.uint8, torch.bfloat16, torch.float32
    cost = k.transpose_add_plan(65, 1920, 1080, u8, bf16, False, 132)
    assert cost[:3] == (8, 0, 16)
    assert cost.grid == (9, 30, 33) and cost.dpb == 2
    for outd in (bf16, f32):
        summed = k.transpose_add_plan(65, 1920, 1080, bf16, outd, True, 132)
        assert summed[:3] == (16, 16, 16)
        assert summed.grid == (17, 30, 33) and summed.dpb == 2
    for D in (65, 129, 257):
        for args in ((u8, bf16, False), (bf16, bf16, True)):
            p = k.transpose_add_plan(D, 1920, 1080, *args, 132)
            assert p.dpb == k.TRANSPOSE_PLANES
            assert p.grid[0] * p.grid[1] * p.grid[2] >= 4 * 132


def test_threads_partition_a_tile():
    """csrc/sgm.cu: 256 threads, thread t writing the 8 values of b from
    8 (t % 8) in the 4 / itemsize rows a from (t // 8) (4 / itemsize),
    write every element of a tile exactly once."""
    for dt in k.TRANSPOSE_IN:
        ae = 4 // dt.itemsize
        ta = k.TRANSPOSE_ROW_BYTES // dt.itemsize
        cover = np.zeros((ta, k.TRANSPOSE_ROWS), np.int32)
        for t in range(256):
            j, ai = t % 8, t // 8
            cover[ai * ae:(ai + 1) * ae, 8 * j:8 * j + 8] += 1
        assert (cover == 1).all()


def test_plan_takes_few_planes_a_block_for_small_volumes():
    p = k.transpose_add_plan(257, 53, 37, torch.uint8, torch.bfloat16,
                             False, 132)
    assert p.dpb == 1 and p.grid == (1, 1, 257)
    p = k.transpose_add_plan(9, 40, 300, torch.bfloat16, torch.bfloat16,
                             True, 132)
    assert p.dpb == 1 and p.grid == (5, 1, 9)
    p = k.transpose_add_plan(17, 1920, 1080, torch.float32, torch.float32,
                             True, 132)
    assert p.dpb == 2 and p.grid == (34, 30, 9)


def test_pointer_alignment():
    assert [k.pointer_alignment(4096 + o) for o in (0, 1, 2, 4, 8, 24)] == [
        16, 1, 2, 4, 8, 8]
    assert k.pointer_alignment(0) == 16


@pytest.mark.parametrize("args,match", [
    ((4, 8, 8, torch.int32, torch.float32, False, 132), "aT must be"),
    ((4, 8, 8, torch.uint8, torch.uint8, False, 132), "out_dtype"),
    ((0, 8, 8, torch.uint8, torch.float32, False, 132), "empty"),
    ((4, 0, 8, torch.uint8, torch.float32, False, 132), "empty"),
    ((4, 2 ** 15, 2 ** 15 + 1, torch.uint8, torch.float32, False, 132),
     "plane"),
    ((4, 65 * 2 ** 16, 1, torch.uint8, torch.float32, False, 132), "grid"),
    ((4, 8, 8, torch.float32, torch.float32, True, 132, 16, 2, 16),
     "no access width"),
    ((4, 8, 8, torch.uint8, torch.float32, False, 132, 16, 16, 2),
     "no access width"),
])
def test_plan_refuses_outside_the_envelope(args, match):
    with pytest.raises(ValueError, match=match):
        k.transpose_add_plan(*args)
