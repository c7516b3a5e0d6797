"""SE(3) / SO(3) utilities on torch tensors (counterpart of ``ops/se3.py``).

Conventions as in the JAX module: a pose ``T = (R, t)`` maps points from
world to camera, ``x_cam = R @ x + t``; twists are ``[rho (3), phi (3)]``
(translation first, rotation last). Every function takes leading batch
axes and runs on the device of its inputs.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def _eye(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def hat(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)[..., None]
    K = hat(phi / theta[..., 0].clamp_min(_EPS))
    s, c = torch.sin(theta), torch.cos(theta)
    I = _eye(phi, K.shape)
    R = I + s * K + (1 - c) * (K @ K)
    # small angle: R ~ I + hat(phi)
    return torch.where(theta > _EPS, R, I + hat(phi))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) axis-angle."""
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]).clamp(-1.0, 3.0)
    theta = torch.arccos(((trace - 1) / 2).clamp(-1.0, 1.0))
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    s = torch.sin(theta)[..., None]
    factor = torch.where(s.abs() > 1e-6,
                         theta[..., None] / (2 * s.clamp_min(_EPS)), 0.5)
    return factor * w


def se3_exp(xi: torch.Tensor):
    """Twist (..., 6) [rho, phi] -> (R (..., 3, 3), t (..., 3))."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)[..., None]
    K = hat(phi / theta[..., 0].clamp_min(_EPS))
    I = _eye(xi, K.shape)
    s, c = torch.sin(theta), torch.cos(theta)
    V = (I
         + ((1 - c) / (theta**2).clamp_min(_EPS)) * K * theta
         + ((theta - s) / (theta**3).clamp_min(_EPS)) * (K @ K) * theta**2)
    V = torch.where(theta > _EPS, V, I + 0.5 * hat(phi))
    t = (V @ rho[..., None])[..., 0]
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Inverse of se3_exp: -> twist (..., 6)."""
    phi = so3_log(R)
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)[..., None]
    K = hat(phi / theta[..., 0].clamp_min(_EPS))
    I = _eye(R, K.shape)
    half = 0.5 * theta
    cot = torch.where(theta > _EPS,
                      half * torch.cos(half) / torch.sin(half).clamp_min(_EPS),
                      torch.ones_like(theta))
    Vinv = I - 0.5 * K * theta + (1 - cot) * (K @ K)
    Vinv = torch.where(theta > _EPS, Vinv, I - 0.5 * hat(phi))
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def compose(Ra, ta, Rb, tb):
    """T_a * T_b."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform(R, t, pts):
    """Apply pose to points (..., N, 3)."""
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def project(pts_cam, fx, fy, cx, cy):
    """Pinhole projection of camera-frame points (..., N, 3) -> (..., N, 2)."""
    z = pts_cam[..., 2:3].clamp_min(1e-6)
    return torch.cat([fx * pts_cam[..., 0:1] / z + cx,
                      fy * pts_cam[..., 1:2] / z + cy], -1)
