"""SAD block-matching disparity: the plain torch versions and the kernel
wrappers (counterpart of ``ops/sad_xla.py`` and ``ops/sad_pallas.py``).

Bit contract (``ops/sad_golden.py``): cost_d(y, x) is the zero-padded
(2h+1)^2 box sum of |L(y, x') - R(y, x' - d)|, h = block_size // 2, a term
adding 0 unless both pixels lie in the image; the disparity is the
first-occurrence argmin over d in [0, maxD] with candidates d > x - h
invalid (a pixel with none gets 0); the uint8 map is ``d * 255 // maxD``.

* ``disparity_raw_plain``, ``disparity_plain``, ``disparity_raw_lr_plain``:
  plain torch, an int32 cost sweep over d with cumsum window sums, like
  ``sad_xla.disparity_raw_xla``. They run on any device; the CPU path and
  the reference the CUDA kernels are held to.
* ``disparity``, ``disparity_batch``, ``disparity_lr``: the wrappers. A CPU
  tensor goes to the plain version; a CUDA tensor launches the kernel of
  ``csrc/sad.cu`` (``_kernels.sad_wta`` / ``_kernels.sad_lr``) or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from steroscopic_hardware_tpu_torch import _kernels

BIG = 2**30


def _box_sum(ad: torch.Tensor, h: int) -> torch.Tensor:
    """Zero-padded (2h+1)^2 box sum over the last two axes (exact int32)."""
    B = 2 * h + 1
    cs = F.pad(ad, (h + 1, h)).cumsum(-1, dtype=torch.int32)
    col = cs[..., B:] - cs[..., :-B]
    cs = F.pad(col, (0, 0, h + 1, h)).cumsum(-2, dtype=torch.int32)
    return cs[..., B:, :] - cs[..., :-B, :]


def _sweep(left, right, block_size, max_disparity, *, lr=False,
           with_costs=False):
    """One sweep over d = 0..maxD of (..., H, W) uint8 pairs. Returns the
    left argmin, plus the right-referenced argmin when ``lr``, plus
    (c_left, c_best, c_right) when ``with_costs`` (the neighbour tracking
    of ``sad_xla.disparity_subpixel_xla``)."""
    h = block_size // 2
    L = left.to(torch.int32)
    R = right.to(torch.int32)
    W = L.shape[-1]
    xs = torch.arange(W, device=L.device)
    bcL = torch.full_like(L, BIG)
    bdL = torch.zeros_like(L)
    if with_costs:
        c_left = torch.full_like(L, BIG)
        c_right = torch.full_like(L, BIG)
        prev = torch.full_like(L, BIG)
    if lr:
        bcR = torch.full_like(L, BIG)
        bdR = torch.zeros_like(L)
    for d in range(max_disparity + 1):
        ad = torch.zeros_like(L)
        if d < W:
            ad[..., d:] = (L[..., d:] - R[..., : W - d]).abs()
        costL = torch.where(xs >= d + h, _box_sum(ad, h), BIG)
        better = costL < bcL
        if with_costs:
            c_left = torch.where(better, prev, c_left)
            c_right = torch.where(better, BIG, c_right)
        bcL = torch.where(better, costL, bcL)
        bdL = torch.where(better, d, bdL)
        if with_costs:
            c_right = torch.where(bdL == d - 1, costL, c_right)
            prev = costL
        if lr:
            # right-referenced diagonal: costR[xr] = costL[xr + d], invalid
            # where xr + d >= W (costL's mask already says xr >= h)
            costR = torch.full_like(costL, BIG)
            if d < W:
                costR[..., : W - d] = costL[..., d:]
            betterR = costR < bcR
            bcR = torch.where(betterR, costR, bcR)
            bdR = torch.where(betterR, d, bdR)
    out = (bdL,)
    if lr:
        out += (bdR,)
    if with_costs:
        out += (c_left, bcL, c_right)
    return out


def disparity_raw_plain(left, right, *, block_size: int,
                        max_disparity: int) -> torch.Tensor:
    """Raw int32 winner-take-all disparity of (..., H, W) uint8 pairs."""
    return _sweep(left, right, block_size, max_disparity)[0]


def normalize(raw: torch.Tensor, max_disparity: int) -> torch.Tensor:
    """uint8(d * 255 // maxD), the reference's normalization."""
    return ((raw * 255) // max_disparity).to(torch.uint8)


def disparity_plain(left, right, *, block_size: int,
                    max_disparity: int) -> torch.Tensor:
    """uint8 disparity map of (..., H, W) uint8 pairs."""
    return normalize(
        disparity_raw_plain(left, right, block_size=block_size,
                            max_disparity=max_disparity),
        max_disparity)


def disparity_raw_lr_plain(left, right, *, block_size: int,
                           max_disparity: int, with_costs: bool = False):
    """(dL, dR) int32 from one sweep; with ``with_costs`` also the left
    map's (c_left, c_best, c_right), like ``disparity_pallas_lr``."""
    return _sweep(left, right, block_size, max_disparity, lr=True,
                  with_costs=with_costs)


def _uses_plain(*tensors) -> bool:
    """True for CPU tensors, False for CUDA ones; raises otherwise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("left/right must be on the same device")
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {dev}")


def _check_pair(left, right, ndims):
    if left.shape != right.shape or left.ndim not in ndims:
        raise ValueError(
            f"left/right must be identical-shape images, got "
            f"{tuple(left.shape)} and {tuple(right.shape)}")


def disparity(left, right, *, block_size: int,
              max_disparity: int) -> torch.Tensor:
    """uint8 (H, W) disparity map (``disparity_pallas`` counterpart)."""
    _check_pair(left, right, (2,))
    return disparity_batch(left[None], right[None], block_size=block_size,
                           max_disparity=max_disparity)[0]


def disparity_batch(lefts, rights, *, block_size: int,
                    max_disparity: int) -> torch.Tensor:
    """uint8 (F, H, W) disparity maps of a frame batch in one launch
    (``disparity_pallas_batch`` counterpart)."""
    _check_pair(lefts, rights, (3,))
    if _uses_plain(lefts, rights):
        return disparity_plain(lefts, rights, block_size=block_size,
                               max_disparity=max_disparity)
    return _kernels.sad_wta(lefts, rights, block_size, max_disparity)


def disparity_lr(left, right, *, block_size: int, max_disparity: int,
                 with_costs: bool = False):
    """Left- and right-referenced int32 disparities of (H, W) or (F, H, W)
    pairs in one launch (``disparity_pallas_lr`` counterpart): (dL, dR),
    with ``with_costs`` also (c_left, c_best, c_right)."""
    _check_pair(left, right, (2, 3))
    if _uses_plain(left, right):
        return disparity_raw_lr_plain(left, right, block_size=block_size,
                                      max_disparity=max_disparity,
                                      with_costs=with_costs)
    if left.ndim == 2:
        outs = _kernels.sad_lr(left[None], right[None], block_size,
                               max_disparity, with_costs)
        return tuple(o[0] for o in outs)
    return _kernels.sad_lr(left, right, block_size, max_disparity,
                           with_costs)
