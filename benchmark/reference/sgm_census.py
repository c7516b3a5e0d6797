"""Plain reference of served census + SGM depth: what a map on a rig's
``out`` slot and its colorized form on the ``depth`` slot should hold.

Written from the method, not from the program: the 5x5 census (24 bits,
the centre left out, edges replicated, a bit set where the neighbour is
darker than the centre), Hamming costs over d in [0, maxD] with the largest
cost, 24, where x < d, Hirschmueller's recursion along the four scanline
directions

  L_r(p, d) = C(p, d) + min(L_r(p-r, d), L_r(p-r, d+-1) + P1,
                            min_k L_r(p-r, k) + P2) - min_k L_r(p-r, k)

each starting from L = C, summed over the four, the first minimum over d,
the parabola through its two neighbours (offset clamped to half a pixel,
only where both neighbours exist), the uint8 quantisation
``clip(d * 255 / maxD + 0.5, 0, 255)`` and the Turbo palette (its published
polynomial fit, tabulated at the 256 levels).

``dtype`` is the arithmetic of the whole chain: float32 is the reference,
bfloat16 the lower-precision control that must come out wrong. Plain torch
and numpy only; it imports nothing of the program.

The judge finds a reference by the path in a configuration's
``"reference"`` and calls only :func:`depth_u8` and :func:`colorize`.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_COST = 24
_OFFSETS = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
            if (dy, dx) != (0, 0)]
_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)],
                          dtype=torch.int32)


def census(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 -> (B, H, W) int32 codes of the 5x5 census."""
    H, W = img.shape[-2:]
    x = img.to(torch.int32)
    padded = torch.nn.functional.pad(
        img.to(torch.float32)[:, None], (2, 2, 2, 2),
        mode="replicate")[:, 0].to(torch.int32)
    code = torch.zeros_like(x)
    for bit, (dy, dx) in enumerate(_OFFSETS):
        nb = padded[:, 2 + dy:2 + dy + H, 2 + dx:2 + dx + W]
        code |= (nb < x).to(torch.int32) << bit
    return code


def _popcount(v: torch.Tensor) -> torch.Tensor:
    table = _POPCOUNT8.to(v.device)
    return (table[v & 255] + table[(v >> 8) & 255]
            + table[(v >> 16) & 255])


def cost_volume(left: torch.Tensor, right: torch.Tensor, max_disparity: int,
                dtype: torch.dtype) -> torch.Tensor:
    """(B, maxD + 1, H, W) Hamming costs of (B, H, W) pairs: left code at
    x against right code at x - d, 24 where x < d."""
    cl, cr = census(left), census(right)
    B, H, W = cl.shape
    cost = torch.full((B, max_disparity + 1, H, W), MAX_COST, dtype=dtype,
                      device=left.device)
    for d in range(min(max_disparity + 1, W)):
        cost[:, d, :, d:] = _popcount(cl[..., d:] ^ cr[..., :W - d]).to(
            dtype)
    return cost


def _paths_along(vol: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Sum of the forward and backward path costs of an (S, B, D, K)
    volume along S."""
    S = vol.shape[0]
    total = torch.zeros_like(vol)
    prev = torch.stack([vol[0], vol[S - 1]])       # forward, backward
    total[0] += prev[0]
    total[S - 1] += prev[1]
    inf = torch.full_like(prev[:, :, :1], float("inf"))
    for s in range(1, S):
        low = prev.amin(dim=2, keepdim=True)
        shifted = torch.minimum(torch.cat([prev[:, :, 1:], inf], 2),
                                torch.cat([inf, prev[:, :, :-1]], 2))
        best = torch.minimum(torch.minimum(prev, shifted + p1), low + p2)
        prev = torch.stack([vol[s], vol[S - 1 - s]]) + best - low
        total[s] += prev[0]
        total[S - 1 - s] += prev[1]
    return total


def aggregate(cost: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """(B, D, H, W) sum over the four scanline directions."""
    vertical = _paths_along(cost.permute(2, 0, 1, 3).contiguous(), p1, p2)
    total = vertical.permute(1, 2, 0, 3).contiguous()
    del vertical
    horizontal = _paths_along(cost.permute(3, 0, 1, 2).contiguous(), p1,
                              p2)
    total += horizontal.permute(1, 2, 3, 0)
    return total


def disparity(total: torch.Tensor, subpixel: bool) -> torch.Tensor:
    """First minimum over d (dimension 1 of (B, D, H, W)), then the
    clamped parabola where both neighbours exist."""
    D = total.shape[1]
    best = total.argmin(dim=1)
    if not subpixel or D < 3:
        return best.to(total.dtype)
    centre = best.clamp(1, D - 2)
    c0, c1, c2 = (total.gather(1, (centre + k)[:, None])[:, 0]
                  for k in (-1, 0, 1))
    denom = (c0 - 2 * c1 + c2).clamp(min=1e-6)
    delta = (0.5 * (c0 - c2) / denom).clamp(-0.5, 0.5)
    inside = (best >= 1) & (best <= D - 2)
    return torch.where(inside, centre.to(total.dtype) + delta,
                       best.to(total.dtype))


def quantise(disp: torch.Tensor, max_disparity: int) -> torch.Tensor:
    return (disp * (255.0 / max_disparity) + 0.5).clamp(0, 255).to(
        torch.uint8)


# bytes of device memory a pair takes at its peak, per cost element: the
# cost volume, the two permuted copies, the two path totals and the sum
_BYTES_PER_ELEMENT = 6 * 4
_CPU_BUDGET = 1 << 31


def _block(shape: tuple, maxd: int, device: torch.device) -> int:
    """Pairs computed together, so that a block fits the free memory."""
    per_pair = _BYTES_PER_ELEMENT * (maxd + 1) * shape[0] * shape[1]
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = free // 2
    else:
        budget = _CPU_BUDGET
    return max(1, int(budget // per_pair))


def depth_u8(pairs: list, config: dict, device: torch.device,
             dtype: torch.dtype = torch.float32) -> list:
    """The served uint8 map of each (left, right) pair of (H, W) uint8
    images, under the configuration's ``params.max_disparity``, ``p1``,
    ``p2`` and ``subpixel``; pairs are computed in blocks that fit."""
    maxd = int(config["params"]["max_disparity"])
    p1, p2 = float(config["p1"]), float(config["p2"])
    out = []
    if not pairs:
        return out
    block = _block(pairs[0][0].shape, maxd, device)
    for i in range(0, len(pairs), block):
        part = pairs[i:i + block]
        L = torch.from_numpy(np.stack([p[0] for p in part])).to(device)
        R = torch.from_numpy(np.stack([p[1] for p in part])).to(device)
        cost = cost_volume(L, R, maxd, dtype)
        total = aggregate(cost, p1, p2)
        del cost
        maps = quantise(disparity(total, bool(config["subpixel"])), maxd)
        del total
        out += list(maps.cpu().numpy())
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


# The Turbo colormap's published degree-5 polynomial fit (Google AI blog,
# 2019), one row per channel, evaluated by Horner's rule.
_TURBO = (
    np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
              -152.94239396, 59.28637943]),
    np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
              4.27729857, 2.82956604]),
    np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
              -89.90310912, 27.34824973]),
)


def turbo_lut() -> np.ndarray:
    """(256, 3) uint8 palette at the levels 0..255."""
    x = np.arange(256, dtype=np.float32) / 255.0
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    channels = []
    for coeffs in _TURBO:
        y = np.zeros_like(x)
        for c in coeffs[::-1]:
            y = y * x + c
        channels.append(y)
    rgb = np.stack(channels, -1)
    return (np.clip(rgb, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)


_LUT = turbo_lut()


def colorize(disp_u8: np.ndarray) -> np.ndarray:
    """(H, W) uint8 -> (H, W, 3) uint8 RGB."""
    return _LUT[disp_u8]
