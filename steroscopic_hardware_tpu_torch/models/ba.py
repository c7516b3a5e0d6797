"""Sliding-window bundle adjustment on torch tensors (counterpart of
``models/ba.py``): Levenberg-Marquardt with Schur complement reduction.

Dense windowed BA over M keyframe poses and N landmarks with a (M, N)
visibility mask, as in the JAX module. The normal equations are reduced by
the Schur complement over the block-diagonal landmark system:

    H = [ Hpp  Hpl ]    S  = Hpp - Hpl Hll^-1 Hpl^T   (reduced camera system)
        [ Hpl' Hll ]    dl = Hll^-1 (bl - Hpl^T dp)   (landmark back-subst.)

Hpp is (M, 6, 6) block-diagonal, Hll (N, 3, 3) block-diagonal. The 3 x 3
landmark inverses and the (6M) x (6M) reduced solve are ``torch.linalg``
(the JAX module leaves them to XLA). The gauge is fixed by freezing the
first pose; Levenberg damping with monotone acceptance; Huber reweighting;
optional stereo (right-camera u) rows and a pose prior.

The JAX module takes the per-observation Jacobians with ``jax.jacfwd``
under ``vmap``; here they are the same derivatives written out (as
``models/vo.py`` does for PnP): d cam / d [rho, phi] = [I, -hat(cam)] and
d cam / d X = R, chained with the pinhole's. Every iteration stays on the
tensors' device: the accept decision is a ``torch.where``, so a solve
never waits for the device until its caller reads the result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from steroscopic_hardware_tpu_torch.ops import se3
from steroscopic_hardware_tpu_torch.utils.collectives import all_reduce


class BAProblem(NamedTuple):
    xi: torch.Tensor        # (M, 6) pose twists (world -> camera)
    points: torch.Tensor    # (N, 3) landmark positions
    uv: torch.Tensor        # (M, N, 2) observed pixels (left camera)
    mask: torch.Tensor      # (M, N) visibility (float 0/1)
    intr: tuple             # (fx, fy, cx, cy)
    # optional STEREO observations: the right camera's horizontal pixel
    # u_R = u_L - disparity; they pin the landmark depths, which a
    # monocular window leaves near-degenerate
    uv_r: torch.Tensor | None = None   # (M, N) observed right-camera u
    mask_r: torch.Tensor | None = None  # (M, N) right-obs visibility
    baseline: float = 0.0


def _camera_points(xi, points):
    """(M, N, 3) landmarks in the camera of each pose."""
    R, t = se3.se3_exp(xi)
    return torch.einsum("mij,nj->mni", R, points) + t[:, None, :]


def reproject(xi, points, intr):
    """(M, N, 2) projected pixels for all pose/landmark combinations."""
    fx, fy, cx, cy = intr
    return se3.project(_camera_points(xi, points), fx, fy, cx, cy)


def residuals(prob: BAProblem):
    return reproject(prob.xi, prob.points, prob.intr) - prob.uv


def residuals_r(prob: BAProblem):
    """(M, N) right-camera horizontal residuals (stereo problems only):
    u_R projected minus u_R observed, with the right camera at the left
    pose translated by +baseline along camera x."""
    fx, fy, cx, cy = prob.intr
    cam = _camera_points(prob.xi, prob.points)
    z = cam[..., 2].clamp_min(1e-6)
    uR = fx * (cam[..., 0] - prob.baseline) / z + cx
    return uR - prob.uv_r


def _per_obs_jacobians(xi, points, intr, baseline=None):
    """Jp (M, N, C, 6) with respect to the left-multiplied pose twist; Jl
    (M, N, C, 3) with respect to the landmark position. C = 2 (left u, v)
    for monocular problems, 3 (+ right-camera u) when ``baseline`` is
    given."""
    fx, fy, _, _ = intr
    R, _ = se3.se3_exp(xi)
    cam = _camera_points(xi, points)                     # (M, N, 3)
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    zc = z.clamp_min(1e-6)
    dz = torch.where(z > 1e-6, 1.0, 0.0)  # the projection clamps z there
    zero = torch.zeros_like(x)
    rows = [torch.stack([fx / zc, zero, -fx * x / zc**2 * dz], -1),
            torch.stack([zero, fy / zc, -fy * y / zc**2 * dz], -1)]
    if baseline is not None:
        rows.append(torch.stack(
            [fx / zc, zero, -fx * (x - baseline) / zc**2 * dz], -1))
    Jproj = torch.stack(rows, -2)                        # (M, N, C, 3)
    eye = torch.eye(3, dtype=cam.dtype, device=cam.device).expand(
        cam.shape[:-1] + (3, 3))
    Jp = Jproj @ torch.cat([eye, -se3.hat(cam)], -1)     # (M, N, C, 6)
    Jl = Jproj @ R[:, None]                              # (M, N, C, 3)
    return Jp, Jl


def _retract(d, x):
    """log(exp(d) * exp(x)), batched over the leading axis."""
    return se3.se3_log(*se3.compose(*se3.se3_exp(d), *se3.se3_exp(x)))


def _twist_from(xi_cur, xi_ref):
    """Left-multiplicative twists taking exp(xi_ref) to exp(xi_cur),
    batched over the leading axis: log(exp(xi_cur) * exp(xi_ref)^-1)."""
    Ra, ta = se3.se3_exp(xi_cur)
    Rbi, tbi = se3.inverse(*se3.se3_exp(xi_ref))
    return se3.se3_log(*se3.compose(Ra, ta, Rbi, tbi))


def _huber(err, huber_px):
    return torch.where(err < huber_px, 1.0, huber_px / err.clamp_min(1e-6))


def ba_solve(prob: BAProblem, *, iters: int = 10, damping: float = 1e-3,
             huber_px: float = 3.0, fix_first_pose: bool = True,
             group=None, pose_prior_weight: float = 0.0):
    """Run Levenberg-Marquardt BA. Returns (BAProblem with updated
    xi / points, the per-iteration masked mean reprojection error (iters,)
    evaluated at each iteration's starting state).

    ``damping`` is the initial LM lambda; each iteration evaluates the
    candidate step and accepts it only if the total cost (squared
    reprojection, right-camera rows and the pose prior) drops (accept ->
    lambda / 2, reject -> lambda * 4). ``pose_prior_weight`` pulls each
    pose toward its initial value (px^2 per squared twist unit).

    ``group`` (a ``torch.distributed`` process group, the counterpart of
    the JAX ``axis_name``): the landmark axis N of ``prob`` is this rank's
    block of the landmarks, and every sum over landmarks (the reduced
    camera system S and b, Hpp, both LM costs and the error) is
    all-reduced over the group, so every rank solves the same pose system,
    takes the same accept decision and updates its own landmarks.
    """
    M = prob.xi.shape[0]
    dev, f32 = prob.xi.device, torch.float32
    stereo = prob.uv_r is not None
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    diag = torch.arange(M, device=dev)

    def at(xi, points):
        return prob._replace(xi=xi, points=points)

    def psum(*xs):
        return xs if group is None else all_reduce(xs, group)

    def data_cost(xi, points):
        """This rank's squared reprojection (left and right-camera rows)."""
        p = at(xi, points)
        c = (prob.mask * (residuals(p) ** 2).sum(-1)).sum()
        if stereo:
            c = c + (prob.mask_r * residuals_r(p) ** 2).sum()
        return c

    def total_cost(c, xi):
        """The LM acceptance cost: the (summed) data cost + the prior."""
        if pose_prior_weight:
            c = c + pose_prior_weight * (_twist_from(xi, prob.xi) ** 2).sum()
        return c

    if fix_first_pose:
        # freeze the gauge: the first pose's rows / columns become identity
        free = torch.ones(6 * M, dtype=f32, device=dev)
        free[:6] = 0.0
        fixed = torch.diag(1 - free)

    xi, points = prob.xi, prob.points
    lam = torch.tensor(damping, dtype=f32, device=dev)
    (wsum,) = psum(prob.mask.sum())
    wsum = wsum.clamp_min(1e-6)
    errs = []
    for _ in range(iters):
        p = at(xi, points)
        r = residuals(p)                                   # (M, N, 2)
        err = torch.sqrt((r**2).sum(-1) + 1e-12)           # (M, N)
        w = prob.mask * _huber(err, huber_px)              # (M, N)
        if stereo:
            rr = residuals_r(p)                            # (M, N)
            w3 = torch.stack(
                [w, w, prob.mask_r * _huber(rr.abs(), huber_px)], -1)
            r = torch.cat([r, rr[..., None]], -1)          # (M, N, 3)
        else:
            w3 = w[..., None].expand(r.shape)
        Jp, Jl = _per_obs_jacobians(
            xi, points, prob.intr, baseline=prob.baseline if stereo else None)

        Jpw, Jlw = Jp * w3[..., None], Jl * w3[..., None]
        Hpp = torch.einsum("mnri,mnrj->mij", Jpw, Jp)      # (M, 6, 6)
        Hll = torch.einsum("mnri,mnrj->nij", Jlw, Jl)      # (N, 3, 3)
        Hpl = torch.einsum("mnri,mnrj->mnij", Jpw, Jl)     # (M, N, 6, 3)
        bp = -torch.einsum("mnri,mnr->mi", Jpw, r)         # (M, 6)
        bl = -torch.einsum("mnri,mnr->ni", Jlw, r)         # (N, 3)

        Hll_inv = torch.linalg.inv(Hll + lam * eye3)       # (N, 3, 3)
        HplW = torch.einsum("mnij,njk->mnik", Hpl, Hll_inv)  # (M, N, 6, 3)
        S = -torch.einsum("mnik,lnjk->mlij", HplW, Hpl)    # (M, M, 6, 6)
        b_red = bp - torch.einsum("mnik,nk->mi", HplW, bl)  # (M, 6)
        err_sum = (prob.mask * err).sum()
        S, b_red, Hpp, err_sum = psum(S, b_red, Hpp, err_sum)
        S[diag, diag] += Hpp + lam * eye6
        if pose_prior_weight:
            # prior residual rp = log(exp(xi) exp(xi0)^-1); its first-order
            # Jacobian with respect to the left update is the identity
            S[diag, diag] += pose_prior_weight * eye6
            b_red = b_red - pose_prior_weight * _twist_from(xi, prob.xi)

        Sm = S.permute(0, 2, 1, 3).reshape(6 * M, 6 * M)
        bm = b_red.reshape(6 * M)
        if fix_first_pose:
            Sm = Sm * free[:, None] * free[None, :] + fixed
            bm = bm * free
        dp = torch.linalg.solve(Sm, bm).reshape(M, 6)
        dl = torch.einsum("nij,nj->ni", Hll_inv,
                          bl - torch.einsum("mnij,mi->nj", Hpl, dp))
        xi_new = _retract(dp, xi)
        points_new = points + dl

        errs.append(err_sum / wsum)
        # LM acceptance: take the step only if the total cost drops
        c_new, c_old = psum(data_cost(xi_new, points_new),
                            data_cost(xi, points))
        accept = total_cost(c_new, xi_new) < total_cost(c_old, xi)
        xi = torch.where(accept, xi_new, xi)
        points = torch.where(accept, points_new, points)
        lam = torch.where(accept, (lam * 0.5).clamp_min(1e-6),
                          (lam * 4.0).clamp_max(1e4))
    errs = torch.stack(errs) if errs else torch.zeros(0, dtype=f32,
                                                      device=dev)
    return BAProblem(xi, points, prob.uv, prob.mask, prob.intr), errs
