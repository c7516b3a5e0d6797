"""Stereo rectification and undistortion (counterpart of
``steroscopic_hardware_tpu/ops/rectify.py``).

* ``distort_points`` / ``undistort_points`` — the Brown-Conrady radial
  (k1, k2, k3) + tangential (p1, p2) model, numpy float64 as in the JAX
  module;
* ``stereo_rectify`` — Bouguet-style rectifying rotations from a calibrated
  extrinsic (R, T);
* ``rectify_maps`` — inverse sampling maps (rectified pixel -> source
  pixel), built once on the host in float64 and rounded to float32, so they
  are bit for bit the JAX module's;
* ``bilinear_sample`` / ``remap`` — the image warp in plain torch, the JAX
  arithmetic operation for operation (four clamped taps, weights clamped to
  [0, 1], the same blend order, zero outside the source, integer images
  truncated back to their dtype), over any leading batch dimensions;
* ``StereoRectifier`` — the four maps on an explicit device: ``apply``
  warps a (B, 2, H, W) device batch (the serving paths, after the batch's
  one upload) with the taps, weights and mask built once per source size,
  ``__call__`` a numpy pair (one round trip).

The JAX ``remap`` is XLA, not a Pallas kernel, so it is plain torch here.
"""

from __future__ import annotations

import numpy as np
import torch

from steroscopic_hardware_tpu_torch.utils.device import resolve_device


def _tap_index(coord, n):
    """``clip(floor(coord).astype(int32), 0, n - 1)`` of the JAX module,
    clamped while still float so no conversion overflows (equal for every
    finite coordinate; a non-finite one lies outside and is zeroed)."""
    return torch.floor(coord).nan_to_num(0.0).clamp(0, n - 1).to(torch.int64)


def _plan(map_y: torch.Tensor, map_x: torch.Tensor, H: int, W: int):
    """What warping an (..., H, W) image by the maps needs that does not
    depend on the image: the flat source indices of the four taps
    (..., 4 * H' * W', in the order 00, 01, 10, 11), the blend's weights
    (1 - wy, wy, 1 - wx, wx) and the mask of samples outside the source."""
    y0 = _tap_index(map_y, H)
    x0 = _tap_index(map_x, W)
    y1 = (y0 + 1).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    wy = (map_y - y0.to(torch.float32)).clamp(0.0, 1.0)
    wx = (map_x - x0.to(torch.float32)).clamp(0.0, 1.0)
    idx = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1],
                      dim=-3).flatten(-3)
    inside = (
        (map_y >= 0) & (map_y <= H - 1) & (map_x >= 0) & (map_x <= W - 1)
    )
    return idx, (1 - wy, wy, 1 - wx, wx), ~inside


def _blend(img: torch.Tensor, idx: torch.Tensor, weights) -> torch.Tensor:
    """The four taps of ``img`` at ``idx`` blended in float32, in the JAX
    order: ``v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) +
    v11*wy*wx``."""
    uy, wy, ux, wx = weights
    lead = torch.broadcast_shapes(img.shape[:-2], wy.shape[:-2])
    flat = img.reshape(*img.shape[:-2], -1).expand(*lead, -1)
    v = torch.gather(flat, -1, idx.expand(*lead, -1)).to(torch.float32)
    v00, v01, v10, v11 = v.unflatten(-1, (4, *wy.shape[-2:])).unbind(-3)
    return v00 * uy * ux + v01 * uy * wx + v10 * wy * ux + v11 * wy * wx


def _warp(img: torch.Tensor, plan) -> torch.Tensor:
    idx, weights, outside = plan
    out = _blend(img, idx, weights).masked_fill_(outside, 0.0)
    return out if img.dtype.is_floating_point else out.to(img.dtype)


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (..., H, W) at float coordinates ``ys``, ``xs``
    (..., H', W', their leading dimensions broadcast against the image's)
    with border clamping; float32 (..., H', W')."""
    idx, weights, _ = _plan(ys, xs, *img.shape[-2:])
    return _blend(img, idx, weights)


def remap(img: torch.Tensor, map_y: torch.Tensor,
          map_x: torch.Tensor) -> torch.Tensor:
    """Warp: ``out[..., y, x] = img[..., map_y[y, x], map_x[y, x]]``
    (bilinear); samples falling outside the source are zeroed. Integer
    images come back in their dtype (truncated), float ones as float32.
    The maps' leading dimensions broadcast against the image's: a
    (B, 2, H, W) stereo batch takes (2, H', W') maps, one per camera."""
    return _warp(img, _plan(map_y, map_x, *img.shape[-2:]))


def distort_points(xn, yn, dist):
    """Apply Brown-Conrady distortion to normalized coords."""
    k1, k2, p1, p2, k3 = dist
    r2 = xn * xn + yn * yn
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return xd, yd


def undistort_points(xd, yd, dist, iters: int = 8):
    """Invert the distortion by fixed-point iteration."""
    xn, yn = xd, yd
    for _ in range(iters):
        xe, ye = distort_points(xn, yn, dist)
        xn = xn + (xd - xe)
        yn = yn + (yd - ye)
    return xn, yn


def stereo_rectify(R: np.ndarray, T: np.ndarray):
    """Bouguet rectifying rotations.

    Args: R (3,3), T (3,) mapping left-camera coords to right-camera
    coords (x_r = R x_l + T). Returns (R1, R2): rotations applied to
    left/right camera frames so that epipolar lines become rows.
    """
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64)
    # right camera center in the left frame; the new x-axis points along
    # the baseline so disparity becomes purely horizontal
    b = -R.T @ T
    e1 = b / np.linalg.norm(b)
    # new y-axis orthogonal to the baseline and to the old optical axis
    e2 = np.cross(np.array([0.0, 0.0, 1.0]), e1)
    n = np.linalg.norm(e2)
    e2 = np.array([0.0, 1.0, 0.0]) if n < 1e-9 else e2 / n
    e3 = np.cross(e1, e2)
    R_rect = np.stack([e1, e2, e3])
    R1 = R_rect
    R2 = R_rect @ R.T
    return R1, R2


def rectify_maps(K, dist, R_rect, K_new, size):
    """Inverse sampling maps for one camera.

    For each rectified pixel: unproject with K_new, rotate back by
    R_rect^T, apply lens distortion, project with K. Returns
    (map_y, map_x) float32 (H, W) numpy arrays.
    """
    H, W = size
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    fxn, fyn, cxn, cyn = (
        K_new[0, 0], K_new[1, 1], K_new[0, 2], K_new[1, 2]
    )
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    xn = (xs - cxn) / fxn
    yn = (ys - cyn) / fyn
    pts = np.stack([xn, yn, np.ones_like(xn)], axis=-1)  # (H, W, 3)
    rays = pts @ R_rect  # == (R_rect^T @ p) per pixel
    xr = rays[..., 0] / rays[..., 2]
    yr = rays[..., 1] / rays[..., 2]
    if dist is not None and np.any(np.asarray(dist) != 0):
        xr, yr = distort_points(xr, yr, tuple(np.asarray(dist)))
    map_x = (fx * xr + cx).astype(np.float32)
    map_y = (fy * yr + cy).astype(np.float32)
    return map_y, map_x


class StereoRectifier:
    """Precomputed rectification for the streaming path, its maps on an
    explicit device.

    Args:
      K1, K2: (3,3) intrinsics; dist1, dist2: (k1,k2,p1,p2,k3) or None;
      R, T: extrinsics (x_right = R @ x_left + T);
      size: output (H, W), which may differ from the cameras' own size;
      K_new: shared rectified intrinsics (defaults to K1 with principal
        point centered);
      device: where the maps live and the warp runs: "cuda" (raises without
        a usable GPU) or "cpu".
    """

    def __init__(self, K1, dist1, K2, dist2, R, T, size, K_new=None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        H, W = size
        self.size = (int(H), int(W))
        if K_new is None:
            K_new = np.array(K1, np.float64).copy()
            K_new[0, 2] = W / 2.0
            K_new[1, 2] = H / 2.0
        R1, R2 = stereo_rectify(R, T)
        self.K_new = K_new
        self.baseline = float(np.linalg.norm(T))
        my1, mx1 = rectify_maps(np.asarray(K1), dist1, R1, K_new, size)
        my2, mx2 = rectify_maps(np.asarray(K2), dist2, R2, K_new, size)
        # (2, H, W) each: camera 0 (left) and camera 1 (right)
        self.map_y = torch.from_numpy(np.stack([my1, my2])).to(self.device)
        self.map_x = torch.from_numpy(np.stack([mx1, mx2])).to(self.device)
        self._maps = (self.map_y[0], self.map_x[0],
                      self.map_y[1], self.map_x[1])
        self._plan = (None, None)  # (source size, the remap plan for it)

    def check_device(self, device) -> None:
        """Raise unless the maps live on ``device`` (an engine's)."""
        if torch.device(device) != self.device:
            raise ValueError(f"the rectifier's maps are on {self.device}, "
                             f"not on {device}")

    def apply(self, stacked: torch.Tensor) -> torch.Tensor:
        """Rectify a (B, 2, Hin, Win) batch of (left, right) frames on the
        rectifier's device: (B, 2, H, W) in the input's dtype (float32 for
        float input). The taps, weights and mask of ``remap`` depend only
        on the maps and the source size, so they are built once per source
        size: a batch costs the gather and the blend."""
        self.check_device(stacked.device)
        shape, plan = tuple(stacked.shape[-2:]), self._plan
        if plan[0] != shape:
            plan = self._plan = (shape,
                                 _plan(self.map_y, self.map_x, *shape))
        return _warp(stacked, plan[1])

    def __call__(self, left, right):
        """Rectify one numpy (left, right) pair of one shape: one copy to
        the device, one back."""
        pair = torch.from_numpy(np.stack([left, right])[None])
        out = self.apply(pair.to(self.device))[0].cpu().numpy()
        return out[0], out[1]
