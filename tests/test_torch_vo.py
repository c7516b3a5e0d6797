"""Parity of the port's SE(3) algebra and VO solvers (``ops/se3.py``,
``ops/se3_np.py``, ``models/vo.py``) with the JAX package on the CPU.

Tolerances (float32 on both sides, different operation orders):
* ``se3`` / ``se3_np``: 1e-5 against the JAX ``se3`` and its numpy twin;
* ``triangulate_stereo``: 1e-5 relative;
* ``pnp_gn``: twist 1e-4, mean squared residual 1e-4 relative; the port's
  Jacobian is the analytic form of the JAX ``jacfwd`` one;
* ``pnp_ransac`` fed the JAX package's own Gumbel draws: the same inlier
  set and count, twist within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.models import vo as jvo
from steroscopic_hardware_tpu.ops import se3 as jse3
from steroscopic_hardware_tpu.ops import se3_np as jse3_np
from steroscopic_hardware_tpu_torch.models import vo
from steroscopic_hardware_tpu_torch.ops import se3, se3_np

SE3_TOL = 1e-5
XI_TOL = 1e-4
INTR = (240.0, 240.0, 160.0, 120.0)


def _twists(rng, n, small=False):
    xi = rng.normal(0, 0.5, (n, 6)).astype(np.float32)
    if small:
        xi[:, 3:] *= 1e-10  # the small-angle branches
    return xi


def _close(a, b, tol=SE3_TOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=tol,
                               rtol=rtol)


@pytest.mark.parametrize("small", [False, True])
def test_se3_equals_jax(small):
    rng = np.random.default_rng(3)
    xi = _twists(rng, 16, small)
    R, t = se3.se3_exp(torch.from_numpy(xi))
    jR, jt = jse3.se3_exp(jnp.asarray(xi))
    _close(R, jR)
    _close(t, jt)
    _close(se3.se3_log(R, t), jse3.se3_log(jR, jt))
    _close(se3.so3_exp(torch.from_numpy(xi[:, 3:])),
           jse3.so3_exp(jnp.asarray(xi[:, 3:])))
    _close(se3.so3_log(R), jse3.so3_log(jR))
    _close(se3.hat(torch.from_numpy(xi[:, :3])), jse3.hat(xi[:, :3]))
    Rb, tb = se3.se3_exp(torch.from_numpy(xi[::-1].copy()))
    jRb, jtb = jse3.se3_exp(jnp.asarray(xi[::-1].copy()))
    for g, w in zip(se3.compose(R, t, Rb, tb), jse3.compose(jR, jt, jRb, jtb)):
        _close(g, w)
    for g, w in zip(se3.inverse(R, t), jse3.inverse(jR, jt)):
        _close(g, w)
    pts = rng.normal(0, 2, (16, 10, 3)).astype(np.float32)
    pts[..., 2] += 8
    cam = se3.transform(R, t, torch.from_numpy(pts))
    jcam = jse3.transform(jR, jt, jnp.asarray(pts))
    _close(cam, jcam, 1e-4)
    # relative: a point near z = 0 projects far out
    _close(se3.project(cam, *INTR), jse3.project(jcam, *INTR), 1e-3, 1e-5)
    # the round trip
    _close(se3.se3_log(*se3.se3_exp(torch.from_numpy(xi))), xi, 1e-4)


@pytest.mark.parametrize("small", [False, True])
def test_se3_np_equals_jax_twin(small):
    rng = np.random.default_rng(4)
    xi = _twists(rng, 12, small)
    for name in ("so3_exp", "hat"):
        _close(getattr(se3_np, name)(xi[:, 3:]),
               getattr(jse3_np, name)(xi[:, 3:]))
    R, t = se3_np.se3_exp(xi)
    jR, jt = jse3_np.se3_exp(xi)
    _close(R, jR)
    _close(t, jt)
    _close(se3_np.se3_log(R, t), jse3_np.se3_log(jR, jt))
    _close(se3_np.so3_log(R), jse3_np.so3_log(jR))
    _close(se3_np.accum(xi[0], xi[1]), jse3_np.accum(xi[0], xi[1]))
    _close(se3_np.relative(xi[0], xi[1]), jse3_np.relative(xi[0], xi[1]))
    _close(se3_np.positions(xi), jse3_np.positions(xi))
    _close(se3_np.quaternions(xi), jse3_np.quaternions(xi))
    # and the numpy copy agrees with the JAX module itself
    _close(se3_np.accum(xi[2], xi[3]),
           jse3.se3_log(*jse3.compose(*jse3.se3_exp(jnp.asarray(xi[2])),
                                      *jse3.se3_exp(jnp.asarray(xi[3])))))


def test_triangulate_equals_jax():
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 300, (64, 2)).astype(np.float32)
    disp = rng.uniform(-1, 40, 64).astype(np.float32)
    pts, ok = vo.triangulate_stereo(torch.from_numpy(xy),
                                    torch.from_numpy(disp), *INTR, 0.4)
    jpts, jok = jvo.triangulate_stereo(xy, disp, *INTR, 0.4)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=1e-5)
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert not ok.all() and ok.any()


def _pnp_problem(seed, K=96, noise=0.3, outliers=0.2):
    """World points, their noisy observations under a known pose (a share
    of them gross outliers), and validity."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, K), rng.uniform(-2, 2, K),
                    rng.uniform(4, 12, K)], -1).astype(np.float32)
    xi_true = np.array([0.05, -0.03, 0.12, 0.01, -0.02, 0.015], np.float32)
    R, t = jse3_np.se3_exp(xi_true)
    cam = pts @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)
    uv = (np.asarray(jse3_np.project(cam, *INTR), np.float32)
          + rng.normal(0, noise, (K, 2)).astype(np.float32))
    bad = rng.random(K) < outliers
    uv[bad] += rng.uniform(-40, 40, (int(bad.sum()), 2)).astype(np.float32)
    valid = rng.random(K) < 0.9
    return pts, uv, valid, xi_true


@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_gn_equals_jax(seed):
    pts, uv, valid, xi_true = _pnp_problem(seed, outliers=0.0)
    w = valid.astype(np.float32)
    jxi, jmse = jvo.pnp_gn(pts, uv, w, INTR, iters=10)
    xi, mse = vo.pnp_gn(torch.from_numpy(pts), torch.from_numpy(uv),
                        torch.from_numpy(w), INTR, iters=10)
    _close(xi, jxi, XI_TOL)
    np.testing.assert_allclose(float(mse), float(jmse), rtol=1e-4)
    _close(xi, xi_true, 0.02)
    # batched weights solve each problem as the single call does
    ws = np.stack([w, w * (np.arange(len(w)) % 2)]).astype(np.float32)
    xis, _ = vo.pnp_gn(torch.from_numpy(pts), torch.from_numpy(uv),
                       torch.from_numpy(ws), INTR, iters=10)
    _close(xis[0], xi, 1e-6)
    one, _ = vo.pnp_gn(torch.from_numpy(pts), torch.from_numpy(uv),
                       torch.from_numpy(ws[1]), INTR, iters=10)
    _close(xis[1], one, 1e-6)


def test_pnp_gn_jacobian_is_jacfwd():
    """The analytic Jacobian equals ``jax.jacfwd`` of the JAX package's
    left-perturbed residual at a general pose."""
    pts, uv, _, xi_true = _pnp_problem(2, K=20, outliers=0.0)
    xi = jnp.asarray(xi_true * 1.3)

    def res(delta):
        Rc, tc = jse3.compose(*jse3.se3_exp(delta), *jse3.se3_exp(xi))
        return jse3.project(pts @ Rc.T + tc, *INTR) - uv

    want = jax.jacfwd(res)(jnp.zeros(6, jnp.float32))
    cam = vo._camera_points(torch.from_numpy(np.array(xi)),
                            torch.from_numpy(pts))
    got = vo._jacobian(cam, INTR)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_with_jax_draws(seed):
    pts, uv, valid, xi_true = _pnp_problem(seed)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    jxi, jinl, jn = jvo.pnp_ransac(pts, uv, valid, INTR, key,
                                   n_hypotheses=32)
    K = len(pts)
    scores = jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(
        jax.random.split(key, 32))
    xi, inl, n = vo.pnp_ransac(torch.from_numpy(pts), torch.from_numpy(uv),
                               torch.from_numpy(valid), INTR,
                               torch.from_numpy(np.array(scores)))
    assert int(n) == int(jn)
    assert np.array_equal(inl.numpy(), np.asarray(jinl))
    _close(xi, jxi, XI_TOL)
    _close(xi, xi_true, 0.02)


def test_gumbel_scores_reproducible():
    g = torch.Generator().manual_seed(11)
    a = vo.gumbel_scores(32, 64, g, "cpu")
    g.manual_seed(11)
    b = vo.gumbel_scores(32, 64, g, "cpu")
    assert torch.equal(a, b) and a.shape == (32, 64)
    assert torch.isfinite(a).all()
    assert abs(float(a.mean()) - 0.5772) < 0.1  # Euler-Mascheroni
