"""Golden-model SAD disparity (numpy, literal reference semantics); a copy
of ``steroscopic_hardware_tpu/ops/sad_golden.py``.

This module is the trusted spec against which the vectorized XLA and Pallas
implementations are bit-validated, replicating the per-pixel algorithm of
``pkg/despair/sad.go`` exactly:

* ``sad_window_golden``  — SumAbsoluteDifferences (``sad.go:205-244``):
  B x B window centred on (x, y), ``half = B // 2`` (integer); left rows
  ``[y-half, y+half+1)`` and cols ``[x-half, x+half+1)`` clamped to the
  image; the right window starts at ``(max(ry-half,0), max(rx-half,0))``
  and each row/col *breaks* when the right coordinate exits the image —
  left and right windows can have different shapes at borders.
* ``disparity_golden``   — the worker loop (``sad.go:55-94``): disparity
  sweep ``d in [0, maxDisparity]`` inclusive, candidates with ``x-d < 0``
  skipped (not terminated), argmin with strict ``<`` (ties -> smallest d),
  early exit on SAD == 0 (WTA-equivalent), output
  ``uint8(bestD * 255 / maxDisparity)`` with integer division
  (``sad.go:91-93``).

Deliberately NOT replicated (artifacts, per SURVEY.md section 6):
the last-chunk drop race (``sad.go:180-183``), the even default block size,
and the Verilog ``-(WIN-1)`` offset (``hardware/compute_SAD.v:219``).

``disparity_golden`` vectorizes only the *window sum* (provably identical to
the scalar loops: the Go row/col break conditions are row-independent, so
truncation is rectangular); ``disparity_golden_scalar`` keeps every loop in
Python for tiny exhaustive spec tests.
"""

from __future__ import annotations

import numpy as np


def sad_window_golden_scalar(
    left: np.ndarray,
    right: np.ndarray,
    lx: int,
    ly: int,
    rx: int,
    ry: int,
    block_size: int,
) -> int:
    """Fully scalar SumAbsoluteDifferences — the literal spec."""
    half = block_size // 2
    lh, lw = left.shape
    rh, rw = right.shape
    lminy, lmaxy = max(ly - half, 0), min(ly + half + 1, lh)
    lminx, lmaxx = max(lx - half, 0), min(lx + half + 1, lw)
    rminy, rminx = max(ry - half, 0), max(rx - half, 0)
    sad = 0
    for yy in range(lminy, lmaxy):
        r_y = rminy + (yy - lminy)
        if r_y >= rh:
            break
        for xx in range(lminx, lmaxx):
            r_x = rminx + (xx - lminx)
            if r_x >= rw:
                break
            sad += abs(int(left[yy, xx]) - int(right[r_y, r_x]))
    return sad


def sad_window_golden(
    left: np.ndarray,
    right: np.ndarray,
    lx: int,
    ly: int,
    rx: int,
    ry: int,
    block_size: int,
) -> int:
    """Window-vectorized SumAbsoluteDifferences (same result, faster).

    The Go break conditions depend only on the row/col offset, never on the
    other axis, so the effective windows are rectangles of identical shape.
    """
    half = block_size // 2
    lh, lw = left.shape
    rh, rw = right.shape
    lminy, lmaxy = max(ly - half, 0), min(ly + half + 1, lh)
    lminx, lmaxx = max(lx - half, 0), min(lx + half + 1, lw)
    rminy, rminx = max(ry - half, 0), max(rx - half, 0)
    ny = min(lmaxy - lminy, rh - rminy)
    nx = min(lmaxx - lminx, rw - rminx)
    if ny <= 0 or nx <= 0:
        return 0
    lwin = left[lminy : lminy + ny, lminx : lminx + nx].astype(np.int64)
    rwin = right[rminy : rminy + ny, rminx : rminx + nx].astype(np.int64)
    return int(np.abs(lwin - rwin).sum())


def _disparity_loop(left, right, block_size, max_disparity, window_fn):
    h, w = left.shape
    out = np.zeros((h, w), dtype=np.uint8)
    for y in range(h):
        for x in range(w):
            best = None
            best_d = 0
            for d in range(0, max_disparity + 1):
                if x - d < 0:
                    continue  # skip, don't terminate (sad.go:64-67)
                s = window_fn(left, right, x, y, x - d, y, block_size)
                if best is None or s < best:
                    best = s
                    best_d = d
                    if s == 0:
                        break  # early exit on perfect match (sad.go:84-86)
            out[y, x] = (best_d * 255) // max_disparity
    return out


def disparity_golden_scalar(
    left: np.ndarray, right: np.ndarray, block_size: int, max_disparity: int
) -> np.ndarray:
    """All-Python-loop golden disparity. Use only on tiny images."""
    return _disparity_loop(
        left, right, block_size, max_disparity, sad_window_golden_scalar
    )


def disparity_golden(
    left: np.ndarray, right: np.ndarray, block_size: int, max_disparity: int
) -> np.ndarray:
    """Window-vectorized golden disparity. Exact; usable up to ~128x128."""
    return _disparity_loop(
        left, right, block_size, max_disparity, sad_window_golden
    )


def disparity_numpy(
    left: np.ndarray, right: np.ndarray, block_size: int, max_disparity: int
) -> np.ndarray:
    """Fast full-frame exact disparity in numpy, via the cost-volume
    reformulation (derived from the reference semantics; validated against
    ``disparity_golden`` in tests):

    For the actual call pattern (``ry == ly``, ``rx = lx - d <= lx``) the Go
    window clipping reduces to: for ``x < h`` the output is always 0; for
    ``x >= h`` the effective shift is ``min(d, x-h)``, so the argmin over
    ``d`` equals a first-occurrence argmin over aligned shifts
    ``s in [0, min(x-h, maxD)]`` of a zero-padded (2h+1)^2 box sum of
    ``|L[y, x] - R[y, x-s]|``.
    """
    h = block_size // 2
    H, W = left.shape
    L = left.astype(np.int32)
    R = right.astype(np.int32)
    D = max_disparity
    xs = np.arange(W)

    best_cost = np.full((H, W), np.iinfo(np.int32).max, dtype=np.int64)
    best_d = np.zeros((H, W), dtype=np.int32)
    B = 2 * h + 1
    for d in range(0, D + 1):
        ad = np.zeros((H, W), dtype=np.int64)
        if d < W:
            ad[:, d:] = np.abs(L[:, d:] - R[:, : W - d])
        # zero-padded box sum, window B x B centred
        pad = np.zeros((H + B - 1, W + B - 1), dtype=np.int64)
        pad[h : h + H, h : h + W] = ad
        cs = pad.cumsum(axis=0).cumsum(axis=1)
        cs = np.pad(cs, ((1, 0), (1, 0)))
        cost = (
            cs[B:, B:] - cs[:-B, B:] - cs[B:, :-B] + cs[:-B, :-B]
        )
        valid = xs >= d + h  # d <= x - h
        cost = np.where(valid[None, :], cost, np.iinfo(np.int32).max)
        better = cost < best_cost
        best_cost = np.where(better, cost, best_cost)
        best_d = np.where(better, d, best_d)
    return ((best_d * 255) // max_disparity).astype(np.uint8)
