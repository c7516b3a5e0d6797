"""Stereo visual odometry on torch tensors (counterpart of ``models/vo.py``):
triangulation, Gauss-Newton PnP on SE(3) and batched RANSAC.

Fixed-K keypoint sets with validity masks, as in the JAX module; every
RANSAC hypothesis is solved in one batch, with no data-dependent control
flow. Conventions: pose ``(R, t)`` maps world -> camera; intrinsics
``(fx, fy, cx, cy)``; stereo baseline ``b`` with rectified horizontal
disparity ``d = fx * b / z``.

The JAX ``pnp_gn`` takes its Jacobian with ``jax.jacfwd`` of the
left-perturbed residual at zero; here it is the same derivative written
out: d cam / d [rho, phi] = [I, -hat(cam)], chained with the pinhole's.
``pnp_ransac`` takes the (hypotheses, K) Gumbel scores that choose each
hypothesis's minimal set as an argument, so a run is reproducible from
the caller's CPU ``torch.Generator`` (``gumbel_scores`` draws on the host
and copies the scores to the device, so a card draws what the CPU draws)
and a test can feed it the JAX package's own draws.
"""

from __future__ import annotations

import torch

from steroscopic_hardware_tpu_torch.ops import se3


def triangulate_stereo(xy, disparity, fx, fy, cx, cy, baseline,
                       min_disparity=0.5):
    """Back-project (K, 2) [u, v] left-camera keypoints with their (K,)
    disparities in pixels. Returns (pts (K, 3) camera frame, valid (K,))."""
    d = disparity.to(torch.float32)
    valid = d > min_disparity
    z = fx * baseline / d.clamp_min(min_disparity)
    u, v = xy[..., 0].to(torch.float32), xy[..., 1].to(torch.float32)
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    return torch.stack([x, y, z], -1), valid


def _camera_points(xi, pts_w):
    """World points (K, 3) in the camera of each pose (..., 6)."""
    R, t = se3.se3_exp(xi)
    return pts_w @ R.transpose(-1, -2) + t[..., None, :]


def _reproj_residual(xi, pts_w, uv, intr):
    """Residuals (..., K, 2) of projecting world points with pose exp(xi)."""
    return se3.project(_camera_points(xi, pts_w), *intr) - uv


def _jacobian(cam, intr):
    """(..., K, 2, 6) derivative of the projection of exp(delta) * cam at
    delta = 0, where cam (..., K, 3) are the camera-frame points."""
    fx, fy, _, _ = intr
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    live = z > 1e-6  # the projection clamps z there
    zc = z.clamp_min(1e-6)
    zero = torch.zeros_like(x)
    dz = torch.where(live, 1.0, 0.0)
    # d (u, v) / d cam
    Jp = torch.stack([
        torch.stack([fx / zc, zero, -fx * x / zc**2 * dz], -1),
        torch.stack([zero, fy / zc, -fy * y / zc**2 * dz], -1),
    ], -2)
    # d cam / d delta = [I, -hat(cam)]
    eye = torch.eye(3, dtype=cam.dtype, device=cam.device).expand(
        cam.shape[:-1] + (3, 3))
    Jc = torch.cat([eye, -se3.hat(cam)], -1)
    return Jp @ Jc


def pnp_gn(pts_w, uv, weights, intr, xi0=None, *, iters: int = 10,
           damping: float = 1e-4):
    """Weighted Gauss-Newton PnP on SE(3).

    Args:
      pts_w: (K, 3) world points; uv: (K, 2) observations;
      weights: (..., K) observation weights (0 disables a point); leading
        axes solve that many problems at once.
      intr: (fx, fy, cx, cy); xi0: initial twist (..., 6) or None.
    Returns (xi (..., 6), final mean squared residual over weighted points).
    """
    if xi0 is None:
        xi0 = torch.zeros(weights.shape[:-1] + (6,), dtype=torch.float32,
                          device=weights.device)
    eye6 = damping * torch.eye(6, dtype=torch.float32, device=weights.device)
    w = weights[..., None]
    xi = xi0
    for _ in range(iters):
        cam = _camera_points(xi, pts_w)
        r = se3.project(cam, *intr) - uv                      # (..., K, 2)
        J = _jacobian(cam, intr)                              # (..., K, 2, 6)
        Jw = J * w[..., None]
        H = torch.einsum("...kri,...krj->...ij", Jw, J)
        g = torch.einsum("...kri,...kr->...i", Jw, r)
        delta, _ = torch.linalg.solve_ex(H + eye6, -g)
        xi = se3.se3_log(*se3.compose(*se3.se3_exp(delta), *se3.se3_exp(xi)))
    r = _reproj_residual(xi, pts_w, uv, intr)
    wsum = weights.sum(-1).clamp_min(1e-6)
    mse = (weights * (r**2).sum(-1)).sum(-1) / wsum
    return xi, mse


def gumbel_scores(n_hypotheses: int, K: int, generator: torch.Generator,
                  device) -> torch.Tensor:
    """(n_hypotheses, K) standard Gumbel draws from the CPU ``generator``,
    on ``device``. They are drawn and transformed on the host and copied
    over (on a GPU one pinned, asynchronous copy), so every device gets
    the CPU's bits: a device's own generator would draw other minimal
    sets."""
    u = torch.rand((n_hypotheses, K), generator=generator)
    tiny = torch.finfo(torch.float32).tiny
    scores = -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2**-24)))
    device = torch.device(device)
    if device.type == "cuda":
        return scores.pin_memory().to(device, non_blocking=True)
    return scores.to(device)


def pnp_ransac(pts_w, uv, valid, intr, scores, *, min_set: int = 4,
               inlier_px: float = 3.0, gn_iters: int = 5,
               refine_iters: int = 10):
    """Batched RANSAC and Gauss-Newton refinement.

    Hypothesis h solves GN PnP on the ``min_set`` valid points of highest
    ``scores[h]`` (Gumbel-top-k sampling, biased to valid points); the
    hypothesis with the most inliers (the first among equals) is refined
    on its inliers with Huber-style reweighting.
    Returns (xi (6,), inlier_mask (K,), n_inliers).
    """
    validf = valid.to(torch.float32)
    ranked = torch.where(valid, scores, float("-inf"))
    idx = torch.topk(ranked, min_set, dim=-1).indices
    w = torch.zeros_like(ranked).scatter_(-1, idx, 1.0) * validf
    xis, _ = pnp_gn(pts_w, uv, w, intr, iters=gn_iters)
    r = _reproj_residual(xis, pts_w, uv, intr)
    inls = ((r**2).sum(-1).sqrt() < inlier_px) & valid
    best = torch.argmax(inls.sum(-1))
    xi = xis[best]
    inlier0 = inls[best].to(torch.float32)
    for _ in range(refine_iters):
        r = _reproj_residual(xi, pts_w, uv, intr)
        err = (r**2).sum(-1).sqrt()
        w_huber = torch.where(err < inlier_px, 1.0,
                              inlier_px / err.clamp_min(1e-6))
        xi, _ = pnp_gn(pts_w, uv, w_huber * inlier0, intr, xi0=xi, iters=1)
    r = _reproj_residual(xi, pts_w, uv, intr)
    inlier = ((r**2).sum(-1).sqrt() < inlier_px) & valid
    return xi, inlier, inlier.sum()
