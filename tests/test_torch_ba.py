"""Parity of the port's windowed BA (``models/ba.py``) with the JAX package
on the CPU.

The setups of ``tests/test_vo_ba.py`` (4 poses, 48 landmarks: noise-free,
noisy, masked, gauge) and a stereo window with the pose prior (the form
``StereoSLAM`` solves): the same numpy inputs through the JAX ``ba_solve``
and the port's, which must meet the JAX tests' own gates.

* The stereo window with the prior is well conditioned: poses within
  XI_TOL, landmarks within PTS_TOL (m), the per-iteration error curve
  within ERR_RTOL of JAX's. Measured when written: 8.9e-8, 1.4e-5, 2.0e-6.
* The monocular windows leave the scale free (only the first pose is
  fixed), so the reduced camera system is near-singular along it, and
  float32 sums taken in another order move the step along that direction:
  3.2e-3 in the twists after the first iteration, 1.7e-3 at the end, 6 cm
  in the landmarks, 0.0086 px in the error curve. They are held to
  MONO_XI_TOL (the JAX noise-free gate's own tolerance to the truth),
  MONO_PTS_TOL and MONO_ERR_ATOL.

The analytic Jacobians equal JAX's ``jacfwd`` ones within JAC_TOL
(relative to the largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.models import ba as jba
from steroscopic_hardware_tpu_torch.models import ba
from tests.test_vo_ba import INTR, _ba_problem, _project, _scene

XI_TOL = 1e-4
PTS_TOL = 1e-3    # m
ERR_RTOL = 1e-4   # of each iteration's mean reprojection error
MONO_XI_TOL = 5e-3
MONO_PTS_TOL = 0.1  # m
MONO_ERR_ATOL = 0.02  # px
JAC_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_problem(jprob):
    opt = {}
    if jprob.uv_r is not None:
        opt = dict(uv_r=_t(jprob.uv_r), mask_r=_t(jprob.mask_r),
                   baseline=jprob.baseline)
    return ba.BAProblem(_t(jprob.xi), _t(jprob.points), _t(jprob.uv),
                        _t(jprob.mask), jprob.intr, **opt)


def _setup(name, rng):
    """(JAX problem, solve kwargs, gate) of one tests/test_vo_ba.py case;
    the monocular ones run 15 iterations (the JAX tests run 8-15), so the
    JAX package compiles one program for the four."""
    if name == "noise_free":
        prob, xi_true, _ = _ba_problem(rng)
        return prob, dict(iters=15), lambda xi, errs, p: (
            errs[-1] < 1e-2 and np.allclose(xi, xi_true, atol=5e-3))
    if name == "noisy":
        prob, *_ = _ba_problem(rng, obs_noise=0.5)
        return prob, dict(iters=15), lambda xi, errs, p: (
            errs[-1] < errs[0] * 0.2 and errs[-1] < 1.0)
    if name == "masked":
        prob, xi_true, _ = _ba_problem(rng)
        mask = np.asarray(prob.mask).copy()
        uv = np.asarray(prob.uv).copy()
        mask[-1, ::2] = 0.0
        uv[-1, ::2] = 1e5
        prob = prob._replace(mask=jnp.asarray(mask), uv=jnp.asarray(uv))
        return prob, dict(iters=15), lambda xi, errs, p: (
            errs[-1] < 1e-2 and np.allclose(xi, xi_true, atol=1e-2))
    if name == "gauge":
        prob, *_ = _ba_problem(rng)
        return prob, dict(iters=15), lambda xi, errs, p: np.allclose(
            xi[0], np.asarray(p.xi[0]), atol=1e-7)
    # stereo rows and the pose prior, as StereoSLAM's window solve
    prob, *_ = _ba_problem(rng, obs_noise=0.3)
    baseline = 0.5
    cam = _project(np.asarray(prob.points), np.asarray(prob.xi[0]))[1]
    uv_r = np.asarray(prob.uv)[..., 0] - INTR[0] * baseline / cam[None, :, 2]
    prob = jba.BAProblem(prob.xi, prob.points, prob.uv, prob.mask,
                         prob.intr, uv_r=jnp.asarray(uv_r),
                         mask_r=prob.mask, baseline=baseline)
    return prob, dict(iters=6, pose_prior_weight=3e4), lambda xi, errs, p: (
        errs[-1] <= errs[0])


@pytest.mark.parametrize("name", ["noise_free", "noisy", "masked", "gauge",
                                  "stereo_prior"])
def test_ba_solve_equals_jax(name, rng):
    jprob, kw, gate = _setup(name, rng)
    jsol, jerrs = jba.ba_solve(jprob, **kw)
    sol, errs = ba.ba_solve(_port_problem(jprob), **kw)
    xi, errs = sol.xi.numpy(), errs.numpy()
    jxi, jerrs = np.asarray(jsol.xi), np.asarray(jerrs)
    assert errs.shape == jerrs.shape == (kw["iters"],)
    assert gate(xi, errs, jprob), (xi, errs)
    pts, jpts = sol.points.numpy(), np.asarray(jsol.points)
    if name == "stereo_prior":
        np.testing.assert_allclose(xi, jxi, atol=XI_TOL)
        np.testing.assert_allclose(pts, jpts, atol=PTS_TOL)
        np.testing.assert_allclose(errs, jerrs, rtol=ERR_RTOL)
    else:
        np.testing.assert_allclose(xi, jxi, atol=MONO_XI_TOL)
        np.testing.assert_allclose(pts, jpts, atol=MONO_PTS_TOL)
        np.testing.assert_allclose(errs, jerrs, atol=MONO_ERR_ATOL)
    # the gauge: the first pose comes back exactly
    assert np.array_equal(xi[0], np.asarray(jprob.xi[0]))


@pytest.mark.parametrize("baseline", [None, 0.5])
def test_per_obs_jacobians_equal_jax(baseline, rng):
    prob, *_ = _ba_problem(rng, M=3, N=16)
    xi = np.asarray(prob.xi) + rng.normal(0, 0.02, (3, 6)).astype(np.float32)
    pts = np.asarray(prob.points)
    jJp, jJl = jax.jit(jba._per_obs_jacobians, static_argnums=(2, 3))(
        jnp.asarray(xi), jnp.asarray(pts), INTR, baseline)
    Jp, Jl = ba._per_obs_jacobians(_t(xi), _t(pts), INTR, baseline=baseline)
    C = 2 if baseline is None else 3
    assert Jp.shape == (3, 16, C, 6) and Jl.shape == (3, 16, C, 3)
    for got, want in ((Jp, jJp), (Jl, jJl)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= JAC_TOL, err


def test_residuals_and_twist_from_equal_jax(rng):
    pts = _scene(rng, 20)
    xi = rng.normal(0, 0.1, (3, 6)).astype(np.float32)
    ref = rng.normal(0, 0.1, (3, 6)).astype(np.float32)
    uv = rng.uniform(0, 600, (3, 20, 2)).astype(np.float32)
    mask = np.ones((3, 20), np.float32)
    jp = jba.BAProblem(jnp.asarray(xi), jnp.asarray(pts), jnp.asarray(uv),
                       jnp.asarray(mask), INTR)
    np.testing.assert_allclose(
        ba.residuals(_port_problem(jp)).numpy(),
        np.asarray(jax.jit(jba.residuals)(jp)), atol=1e-3)
    np.testing.assert_allclose(
        ba._twist_from(_t(xi), _t(ref)).numpy(),
        np.asarray(jax.jit(jba._twist_from)(jnp.asarray(xi),
                                            jnp.asarray(ref))), atol=1e-6)
