"""Parity of the port's subpixel SAD path (B2 with costs, then the parabola)
with the JAX package on the CPU.

The port's ``disparity_lr(with_costs=True)`` on CPU tensors (its plain
sweep) must equal ``disparity_pallas_lr(with_costs=True, interpret=True)``
in all five outputs (dL, dR, c_left, c_best, c_right) exactly, and
``disparity_subpixel`` must equal the JAX ``parabola_refine`` of those
costs and ``disparity_subpixel_lr_xla`` (float32 maps of the same
operations, held to 1e-6 px). The CUDA kernel is held to the plain sweep
on the card (``tests/test_torch_guard.py``, marker ``gpu``, and
``chip_smoke.py`` phase 6v).
"""

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.ops.sad_pallas import (
    disparity_pallas_lr,
    disparity_pallas_subpixel,
)
from steroscopic_hardware_tpu.ops.sad_xla import (
    disparity_subpixel_lr_xla,
    parabola_refine,
)
from steroscopic_hardware_tpu_torch.ops import sad

SUBPIXEL_TOL = 1e-6  # px, float32 maps of the same operations

# (h, w, block, maxd): the three shapes of the JAX-parity check of this
# path, and a ragged one (odd sizes, W < maxD + block)
SHAPES = [(40, 64, 7, 16), (33, 80, 5, 32), (24, 50, 9, 48),
          (17, 45, 3, 48)]


def _pair(seed, h, w, shift=5):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (h, w), dtype=np.uint8)
    right = np.clip(np.roll(left, -shift, axis=1).astype(int)
                    + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.uint8)
    return left, right


@pytest.mark.parametrize("h,w,block,maxd", SHAPES)
def test_costs_equal_pallas_interpret(h, w, block, maxd):
    left, right = _pair(h * w, h, w)
    want = disparity_pallas_lr(left, right, block_size=block,
                               max_disparity=maxd, with_costs=True,
                               interpret=True)
    got = sad.disparity_lr(torch.from_numpy(left), torch.from_numpy(right),
                           block_size=block, max_disparity=maxd,
                           with_costs=True)
    assert len(got) == len(want) == 5
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(wnt))


@pytest.mark.parametrize("h,w,block,maxd", SHAPES)
def test_subpixel_equals_parabola_and_xla(h, w, block, maxd):
    left, right = _pair(h + w, h, w)
    L, R = torch.from_numpy(left), torch.from_numpy(right)
    dL, dR = sad.disparity_subpixel(L, R, block_size=block,
                                    max_disparity=maxd)
    assert dL.dtype == torch.float32 and dR.dtype == torch.int32
    _, _, c0, c1, c2 = disparity_pallas_lr(
        left, right, block_size=block, max_disparity=maxd, with_costs=True,
        interpret=True)
    raw = sad.disparity_lr(L, R, block_size=block, max_disparity=maxd)[0]
    want = np.asarray(parabola_refine(c0, c1, c2, raw.numpy()))
    assert np.abs(dL.numpy() - want).max() <= SUBPIXEL_TOL
    xL, xR = disparity_subpixel_lr_xla(left, right, block_size=block,
                                       max_disparity=maxd)
    assert np.abs(dL.numpy() - np.asarray(xL)).max() <= SUBPIXEL_TOL
    assert np.array_equal(dR.numpy(), np.asarray(xR))
    # the subpixel refinement moved some pixels off the integer grid
    assert (dL.numpy() != raw.numpy()).any()


def test_subpixel_plain_equals_wrapper_and_pallas_subpixel():
    left, right = _pair(3, 30, 70)
    L, R = torch.from_numpy(left), torch.from_numpy(right)
    kw = dict(block_size=7, max_disparity=32)
    got = sad.disparity_subpixel(L, R, **kw)
    plain = sad.disparity_subpixel_plain(L, R, **kw)
    assert all(torch.equal(g, p) for g, p in zip(got, plain))
    pL, pR = disparity_pallas_subpixel(left, right, interpret=True, **kw)
    assert np.abs(got[0].numpy() - np.asarray(pL)).max() <= SUBPIXEL_TOL
    assert np.array_equal(got[1].numpy(), np.asarray(pR))


def test_parabola_refine_edge_cases():
    """Invalid neighbours (BIG) keep the integer position; a flat
    neighbourhood (zero denominator) adds nothing; offsets clip to
    +-0.5."""
    big = sad.BIG
    c0 = np.array([big, 10, 5, 0, 100], np.int32)
    c1 = np.array([3, 4, 5, 0, 0], np.int32)
    c2 = np.array([7, big, 5, 0, 1], np.int32)
    d = np.array([2, 3, 4, 5, 6], np.int32)
    got = sad.parabola_refine(*(torch.from_numpy(a) for a in (c0, c1, c2, d)))
    want = np.asarray(parabola_refine(c0, c1, c2, d))
    assert np.array_equal(got.numpy(), want)
    assert got[0] == 2 and got[1] == 3 and got[2] == 4 and got[3] == 5
