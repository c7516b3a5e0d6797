"""Census transform and Hamming cost volume in plain torch (counterpart of
``ops/census.py``, which computes them in XLA, not Pallas).

Each pixel is described by the sign pattern of its 5x5 neighbourhood (24
bits, centre excluded, edges replicated); the matching cost at disparity d
is the Hamming distance between the left code at x and the right code at
x - d, or the maximum 24 where x < d.

Codes are int32 tensors holding the 24-bit values that the JAX package
holds as uint32 (torch's uint32 lacks the shift and bitwise kernels on
every device); only the d-major layouts are ported.
"""

from __future__ import annotations

import torch

# 5x5 neighbourhood, centre excluded -> 24-bit codes, bit order of the JAX
# package
_OFFS = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
         if (dy, dx) != (0, 0)]


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Static shift of the last two axes with edge replication."""
    H, W = img.shape[-2], img.shape[-1]
    ys = (torch.arange(H, device=img.device) + dy).clamp(0, H - 1)
    xs = (torch.arange(W, device=img.device) + dx).clamp(0, W - 1)
    return img.index_select(-2, ys).index_select(-1, xs)


def census5x5(img: torch.Tensor) -> torch.Tensor:
    """(H, W) uint8 -> (H, W) int32 census codes (24 bits used)."""
    I = img.to(torch.int32)
    code = torch.zeros_like(I)
    for bit, (dy, dx) in enumerate(_OFFS):
        code |= (_shift2d(I, dy, dx) < I).to(torch.int32) << bit
    return code


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit population count (SWAR) of non-negative int32 values below
    2^24; the final multiply may wrap, but only its top byte is kept."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0x3F


def _cost_volume(cl: torch.Tensor, cr: torch.Tensor, max_disparity: int,
                 axis: int) -> torch.Tensor:
    """(D, *codes.shape) uint8 Hamming costs of codes whose disparity
    shift runs along ``axis`` (of the codes): out[d] at position x along
    ``axis`` compares cl[x] with cr[x - d], 24 where x < d."""
    n = cl.shape[axis]
    out = torch.empty((max_disparity + 1, *cl.shape), dtype=torch.uint8,
                      device=cl.device)
    for d in range(max_disparity + 1):
        o = out[d]
        if d >= n:
            o.fill_(24)
            continue
        valid = o.narrow(axis, d, n - d)
        valid.copy_(popcount32(cl.narrow(axis, d, n - d)
                               ^ cr.narrow(axis, 0, n - d)))
        o.narrow(axis, 0, d).fill_(24)
    return out


def census_cost_volume(left: torch.Tensor, right: torch.Tensor, *,
                       max_disparity: int) -> torch.Tensor:
    """(D, H, W) uint8 Hamming cost volume over d in [0, maxD] (invalid
    x < d filled with the max cost 24)."""
    return _cost_volume(census5x5(left), census5x5(right), max_disparity,
                        axis=1)


def census_cost_volume_T(left: torch.Tensor, right: torch.Tensor, *,
                         max_disparity: int) -> torch.Tensor:
    """Transposed-frame cost volume: (D, W, H) uint8 with
    ``out[d, x, y] == census_cost_volume(...)[d, y, x]``, built from the
    transposed images as the JAX package builds it (the census codes of a
    transposed image are the transposed codes up to one bit permutation
    shared by both images, so the Hamming costs are unchanged)."""
    return _cost_volume(census5x5(left.T), census5x5(right.T), max_disparity,
                        axis=0)
