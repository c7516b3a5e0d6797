"""FAST corner detection and oriented BRIEF (ORB-style) descriptors on
torch tensors (counterpart of ``ops/features.py``).

Static shapes as in the JAX module: detection returns a fixed-K keypoint
set with a validity mask (invalid slots score 0). The FAST ring and the
seeded BRIEF-256 pattern (``_CIRCLE``, ``_PAIRS``) are the JAX module's.

The JAX module selects the K best corners with ``jax.lax.top_k``, which
orders equal scores by the lower flat index. FAST scores are sums of
integers, so ties are common (every zero slot ties), and ``torch.topk``
promises no order among them; ``fast_detect`` therefore ranks by one
int64 key, score * H*W + (H*W - 1 - index), whose order is (score
descending, index ascending) with no ties, and gets the same keypoints.
"""

from __future__ import annotations

import numpy as np
import torch

# 16 Bresenham circle offsets (radius 3), clockwise from 12 o'clock, the
# standard FAST-16 ring: (dy, dx)
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
        (-3, -1),
    ],
    dtype=np.int32,
)

# BRIEF-256 sampling pattern: pairs ~ N(0, (patch/5)^2) clipped to the
# 31x31 patch, deterministic seed: (bit, endpoint, (dy, dx))
_PATCH = 31
_rng = np.random.default_rng(20240516)
_PAIRS = np.clip(
    _rng.normal(0.0, _PATCH / 5.0, size=(256, 2, 2)), -15, 15
).astype(np.float32)


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Static shift with edge clamping (replicate border)."""
    H, W = img.shape[-2], img.shape[-1]
    ys = (torch.arange(H, device=img.device) + dy).clamp(0, H - 1)
    xs = (torch.arange(W, device=img.device) + dx).clamp(0, W - 1)
    return img[..., ys, :][..., :, xs]


def _has_arc(mask: torch.Tensor, arc_len: int) -> torch.Tensor:
    """OR over the 16 cyclic AND-windows of length ``arc_len`` of a
    (16, H, W) ring mask."""
    acc = torch.zeros_like(mask[0])
    for s in range(16):
        win = mask[s]
        for k in range(1, arc_len):
            win = win & mask[(s + k) % 16]
        acc = acc | win
    return acc


def fast_detect(img: torch.Tensor, *, threshold: int = 20, arc_len: int = 9,
                max_keypoints: int = 512):
    """FAST-9/16 corners of a uint8 (H, W) image with 3x3 non-max
    suppression, top-K selection and parabola subpixel refinement.

    Returns (xy (K, 2) int32 [x, y], xy_sub (K, 2) float32 subpixel
    positions, score (K,) float32, valid (K,) bool).
    """
    H, W = img.shape
    I = img.to(torch.int32)
    ring = torch.stack([_shift2d(I, int(dy), int(dx)) for dy, dx in _CIRCLE])
    diff = ring - I[None]
    is_corner = (_has_arc(diff > threshold, arc_len)
                 | _has_arc(diff < -threshold, arc_len))
    # score: sum of |diff| beyond threshold over the ring, 0 off corners
    excess = (diff.abs() - threshold).clamp_min(0)
    score = torch.where(is_corner, excess.sum(0), 0).to(torch.float32)

    # border suppression (ring and descriptor patch must fit)
    m = _PATCH // 2 + 1
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inb = (ys >= m) & (ys < H - m) & (xs >= m) & (xs < W - m)
    score = torch.where(inb, score, 0.0)

    # 3x3 non-max suppression
    score_raw = score
    neigh = torch.stack([_shift2d(score, dy, dx)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                         if (dy, dx) != (0, 0)])
    score = torch.where(score >= neigh.amax(0), score, 0.0)

    # top K by (score descending, flat index ascending), as lax.top_k
    flat = score.reshape(-1)
    n = flat.numel()
    key = (flat.to(torch.int64) * n
           + (n - 1 - torch.arange(n, device=img.device)))
    idx = n - 1 - torch.topk(key, max_keypoints).values % n
    top = flat[idx]
    xy = torch.stack([idx % W, idx // W], -1).to(torch.int32)

    # subpixel: 1D parabola fits on the pre-NMS score map around each kept
    # maximum (keypoints sit >= the patch border from the image edge, so
    # the +-1 reads are in bounds; an empty slot's reads are wrapped and
    # clamped as a JAX gather does)
    flat_raw = score_raw.reshape(-1)
    s0 = flat_raw[idx]

    def nb(dy, dx):
        j = idx + dy * W + dx
        return flat_raw[torch.where(j < 0, j + n, j).clamp(0, n - 1)]

    def vertex(sm, sp):
        denom = sm + sp - 2.0 * s0
        off = torch.where(denom.abs() > 1e-6, (sm - sp) / (2.0 * denom), 0.0)
        return off.clamp(-0.5, 0.5)

    offx = vertex(nb(0, -1), nb(0, 1))
    offy = vertex(nb(-1, 0), nb(1, 0))
    xy_sub = xy.to(torch.float32) + torch.stack([offx, offy], -1)
    return xy, xy_sub, top, top > 0


def _moment_orientation(img: torch.Tensor, xy: torch.Tensor,
                        radius: int = 15) -> torch.Tensor:
    """Intensity-centroid angle of each keypoint."""
    I = img.to(torch.float32)
    H, W = img.shape
    d = torch.arange(-radius, radius + 1, device=img.device)
    DY, DX = torch.meshgrid(d, d, indexing="ij")
    circ = (DY**2 + DX**2) <= radius**2
    ys = (xy[:, 1, None, None] + DY).clamp(0, H - 1)
    xs = (xy[:, 0, None, None] + DX).clamp(0, W - 1)
    patch = I[ys, xs] * circ
    m01 = (patch * DY).sum((-2, -1))
    m10 = (patch * DX).sum((-2, -1))
    return torch.atan2(m01, m10)


def orb_describe(img: torch.Tensor, xy: torch.Tensor):
    """Steered BRIEF-256 descriptors of a uint8 (H, W) image at (K, 2)
    int32 [x, y] keypoints. Returns (desc (K, 256) uint8 in {0, 1},
    angle (K,) float32)."""
    # 5x5 box smoothing for sampling stability
    I = img.to(torch.float32)
    s = I
    for d in (-2, -1, 1, 2):
        s = s + _shift2d(I, d, 0)
    s2 = s
    for d in (-2, -1, 1, 2):
        s2 = s2 + _shift2d(s, 0, d)
    smooth = s2 / 25.0

    H, W = img.shape
    angle = _moment_orientation(img, xy)
    ca, sa = torch.cos(angle), torch.sin(angle)
    pairs = torch.from_numpy(_PAIRS).to(img.device)
    dy, dx = pairs[..., 0], pairs[..., 1]                       # (256, 2)
    # rotate the offsets by the keypoint angle
    ry = sa[:, None, None] * dx + ca[:, None, None] * dy        # (K, 256, 2)
    rx = ca[:, None, None] * dx - sa[:, None, None] * dy
    ys = torch.round(xy[:, 1, None, None] + ry).to(torch.int32).clamp(0, H - 1)
    xs = torch.round(xy[:, 0, None, None] + rx).to(torch.int32).clamp(0, W - 1)
    samples = smooth.reshape(-1)[(ys * W + xs).reshape(-1).long()].reshape(
        ys.shape)
    desc = (samples[..., 0] < samples[..., 1]).to(torch.uint8)
    return desc, angle


def detect_and_describe(img: torch.Tensor, *, threshold: int = 20,
                        max_keypoints: int = 512) -> dict:
    """The full front end: FAST and oriented BRIEF."""
    xy, xy_sub, score, valid = fast_detect(img, threshold=threshold,
                                           max_keypoints=max_keypoints)
    desc, angle = orb_describe(img, xy)
    return {"xy": xy, "xy_sub": xy_sub, "score": score, "valid": valid,
            "desc": desc, "angle": angle}
