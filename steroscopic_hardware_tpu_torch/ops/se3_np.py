"""Numpy SE(3) / SO(3) algebra for host-side pose bookkeeping; a copy of
``steroscopic_hardware_tpu/ops/se3_np.py``.

The original re-executes the JAX ``ops/se3.py`` source with numpy bound in
place of ``jax.numpy``; this copy spells the same formulas out in numpy,
so the port needs neither. Pose accumulation, relative motion, camera
centres and quaternions are microseconds of 6-vector math a frame: they
stay on the host, where a device round trip would cost more than the
math. Conventions are those of ``ops/se3.py``.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-9


def hat(v):
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = np.zeros_like(x)
    return np.stack([
        np.stack([zero, -z, y], -1),
        np.stack([z, zero, -x], -1),
        np.stack([-y, x, zero], -1),
    ], -2)


def so3_exp(phi):
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta = np.linalg.norm(phi, axis=-1, keepdims=True)[..., None]
    K = hat(phi / np.maximum(theta[..., 0], _EPS))
    s, c = np.sin(theta), np.cos(theta)
    I = np.broadcast_to(np.eye(3), K.shape)
    R = I + s * K + (1 - c) * (K @ K)
    return np.where(theta > _EPS, R, I + hat(phi))


def so3_log(R):
    """(..., 3, 3) -> (..., 3) axis-angle."""
    trace = np.clip(R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], -1.0, 3.0)
    theta = np.arccos(np.clip((trace - 1) / 2, -1.0, 1.0))
    w = np.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    s = np.sin(theta)[..., None]
    factor = np.where(np.abs(s) > 1e-6,
                      theta[..., None] / (2 * np.maximum(s, _EPS)), 0.5)
    return factor * w


def se3_exp(xi):
    """Twist (..., 6) [rho, phi] -> (R (..., 3, 3), t (..., 3))."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta = np.linalg.norm(phi, axis=-1, keepdims=True)[..., None]
    K = hat(phi / np.maximum(theta[..., 0], _EPS))
    I = np.broadcast_to(np.eye(3), K.shape)
    s, c = np.sin(theta), np.cos(theta)
    V = (I
         + ((1 - c) / np.maximum(theta**2, _EPS)) * K * theta
         + ((theta - s) / np.maximum(theta**3, _EPS)) * (K @ K) * theta**2)
    V = np.where(theta > _EPS, V, I + 0.5 * hat(phi))
    t = (V @ rho[..., None])[..., 0]
    return R, t


def se3_log(R, t):
    """Inverse of se3_exp: -> twist (..., 6)."""
    phi = so3_log(R)
    theta = np.linalg.norm(phi, axis=-1, keepdims=True)[..., None]
    K = hat(phi / np.maximum(theta[..., 0], _EPS))
    I = np.broadcast_to(np.eye(3), K.shape)
    half = 0.5 * theta
    cot = np.where(theta > _EPS,
                   half * np.cos(half) / np.maximum(np.sin(half), _EPS),
                   np.ones_like(theta))
    Vinv = I - 0.5 * K * theta + (1 - cot) * (K @ K)
    Vinv = np.where(theta > _EPS, Vinv, I - 0.5 * hat(phi))
    rho = (Vinv @ t[..., None])[..., 0]
    return np.concatenate([rho, phi], -1)


def compose(Ra, ta, Rb, tb):
    """T_a * T_b."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = np.swapaxes(R, -1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform(R, t, pts):
    """Apply pose to points (..., N, 3)."""
    return pts @ np.swapaxes(R, -1, -2) + t[..., None, :]


def project(pts_cam, fx, fy, cx, cy):
    """Pinhole projection of camera-frame points (..., N, 3) -> (..., N, 2)."""
    z = np.maximum(pts_cam[..., 2:3], 1e-6)
    return np.concatenate([fx * pts_cam[..., 0:1] / z + cx,
                           fy * pts_cam[..., 1:2] / z + cy], -1)


def accum(xi_rel: np.ndarray, xi_prev: np.ndarray) -> np.ndarray:
    """T_new = exp(xi_rel) * exp(xi_prev) as a twist."""
    Rr, tr = se3_exp(np.asarray(xi_rel, np.float32))
    Rp, tp = se3_exp(np.asarray(xi_prev, np.float32))
    return np.asarray(se3_log(*compose(Rr, tr, Rp, tp)), np.float32)


def relative(xi_i: np.ndarray, xi_j: np.ndarray) -> np.ndarray:
    """log(T_j * T_i^-1): measured relative motion i -> j."""
    Ri, ti = se3_exp(np.asarray(xi_i, np.float32))
    Rj, tj = se3_exp(np.asarray(xi_j, np.float32))
    Rii, tii = inverse(Ri, ti)
    return np.asarray(se3_log(*compose(Rj, tj, Rii, tii)), np.float32)


def positions(xis: np.ndarray) -> np.ndarray:
    """Camera centers (world frame) for a batch of world->camera twists."""
    R, t = se3_exp(np.asarray(xis, np.float32))
    _, ti = inverse(R, t)
    return np.asarray(ti)


def quaternions(xis: np.ndarray) -> np.ndarray:
    """(N, 4) [qx, qy, qz, qw] unit quaternions of the CAMERA-to-world
    rotations for a batch of world->camera twists, the orientation
    convention of the TUM trajectory format. Shepperd's method
    (max-component selection) for numerical safety."""
    R, t = se3_exp(np.asarray(xis, np.float32))
    Rcw, _ = inverse(R, t)
    m = np.asarray(Rcw, np.float64)
    N = m.shape[0]
    q = np.empty((N, 4))
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    for i in range(N):
        M = m[i]
        if tr[i] > 0:
            s = np.sqrt(tr[i] + 1.0) * 2
            q[i] = [(M[2, 1] - M[1, 2]) / s, (M[0, 2] - M[2, 0]) / s,
                    (M[1, 0] - M[0, 1]) / s, 0.25 * s]
        else:
            k = int(np.argmax([M[0, 0], M[1, 1], M[2, 2]]))
            a, b, c = k, (k + 1) % 3, (k + 2) % 3
            s = np.sqrt(M[a, a] - M[b, b] - M[c, c] + 1.0) * 2
            v = np.empty(4)
            v[a] = 0.25 * s
            v[b] = (M[b, a] + M[a, b]) / s
            v[c] = (M[c, a] + M[a, c]) / s
            v[3] = (M[c, b] - M[b, c]) / s
            q[i] = v
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
