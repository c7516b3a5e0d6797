"""Parity of the port's pose-graph optimizer (``pose_graph_optimize`` of
``models/slam.py``) with the JAX package on the CPU.

The 8-node square loop of ``tests/test_slam.py`` (odometry chain drifted
by 0.05 noise, one loop edge), 10 Gauss-Newton iterations: the same numpy
inputs through both optimizers, with the fixed-lag ``n_fixed`` of
``tests/test_slam.py::test_pose_graph_fixed_lag_horizon`` (1, 3, 5; the
JAX runs share one compiled program), and, in the port, with node 0 fixed
by ``fix_first`` (the same arithmetic as ``n_fixed`` 1) and padded to a
16-node, 16-edge bucket with weight-0 edges as
``StereoSLAM._optimize_pose_graph`` pads. The port meets the JAX tests'
gates (final / initial cost <= 1e-3, the truth within 1e-3; frozen nodes
bit for bit, the free suffix nearer the truth) and stays within XI_TOL
of the JAX twists and COST_RTOL of its per-iteration costs (at least
COST_ATOL). Measured when written: twists 3.6e-7, costs 7.5e-8 abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.models import slam as jslam
from steroscopic_hardware_tpu_torch.models import slam
from steroscopic_hardware_tpu_torch.ops import se3_np

XI_TOL = 1e-5
COST_RTOL = 1e-4
COST_ATOL = 1e-6
M = 8
ITERS = 10
N_FIXED = (1, 3, 5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop(rng):
    """(truth, drifted initial, edges, measurements) of the square loop."""
    step = np.array([0.5, 0, 0, 0, np.pi / 4, 0], np.float32)
    xi_true = np.zeros((M, 6), np.float32)
    for i in range(1, M):
        xi_true[i] = se3_np.accum(step, xi_true[i - 1])
    edges = np.array([(i, i + 1) for i in range(M - 1)] + [(M - 1, 0)],
                     np.int32)
    meas = np.stack([se3_np.relative(xi_true[i], xi_true[j])
                     for i, j in edges])
    noisy = xi_true + np.concatenate(
        [np.zeros((1, 6)), rng.normal(0, 0.05, (M - 1, 6))], 0).astype(
        np.float32)
    return xi_true, noisy, edges, meas


def _pad(nodes, edges, meas, Mb=16, Eb=16):
    E = len(edges)
    w = np.zeros(Eb, np.float32)
    w[:E] = 1.0
    return (np.pad(nodes, ((0, Mb - len(nodes)), (0, 0))),
            np.pad(edges, ((0, Eb - E), (0, 0))),
            np.pad(meas, ((0, Eb - E), (0, 0))), w)


@pytest.fixture(scope="module")
def cases():
    """Inputs and the JAX package's results of every horizon, computed
    once."""
    rng = np.random.default_rng(1234)
    xi_true, noisy, edges, meas = _loop(rng)
    w = np.ones(len(edges), np.float32)
    out = {"truth": xi_true, "args": (noisy, edges, meas, w)}
    for nf in N_FIXED:
        out[nf] = tuple(np.asarray(a) for a in jslam.pose_graph_optimize(
            jnp.asarray(noisy), jnp.asarray(edges), jnp.asarray(meas),
            jnp.asarray(w), iters=ITERS, n_fixed=jnp.int32(nf)))
    return out


def _run(args, kw):
    xi, costs = slam.pose_graph_optimize(
        *(torch.from_numpy(np.array(a)) for a in args), **kw)
    return xi.numpy(), costs.numpy()


def _check_jax(xi, costs, jxi, jcosts):
    np.testing.assert_allclose(xi, jxi, atol=XI_TOL)
    np.testing.assert_allclose(costs, jcosts, rtol=COST_RTOL, atol=COST_ATOL)


def test_pose_graph_closes_loop_as_jax(cases):
    args = cases["args"]
    xi, costs = _run(args, dict(iters=ITERS))  # fix_first
    assert costs.shape == (ITERS,)
    assert costs[-1] < costs[0] * 1e-3
    assert np.allclose(xi, cases["truth"], atol=1e-3)
    assert np.array_equal(xi[0], args[0][0])  # node 0 fixed
    _check_jax(xi, costs, *cases[1])


@pytest.mark.parametrize("nf", N_FIXED)
def test_pose_graph_fixed_lag_as_jax(nf, cases):
    args = cases["args"]
    xi, costs = _run(args, dict(iters=ITERS, n_fixed=nf))
    noisy, truth = args[0], cases["truth"]
    # frozen nodes pass through bit for bit, as in the JAX test
    np.testing.assert_array_equal(xi[:nf], noisy[:nf])
    assert costs[-1] < costs[0]
    assert (np.abs(xi[nf:] - truth[nf:]).mean()
            < np.abs(noisy[nf:] - truth[nf:]).mean())
    _check_jax(xi, costs, *cases[nf])
    # a 0-d tensor n_fixed is the same horizon
    xi_t, _ = _run(args, dict(iters=ITERS, n_fixed=torch.tensor(nf)))
    np.testing.assert_array_equal(xi_t, xi)


def test_pose_graph_padded_bucket_as_jax(cases):
    xi, costs = _run(_pad(*cases["args"][:3]), dict(iters=ITERS))
    # the padding is inert: padded nodes stay put, the real nodes come out
    # as from the unpadded graph
    np.testing.assert_array_equal(xi[M:], 0.0)
    _check_jax(xi[:M], costs, *cases[1])


def test_pose_graph_sums_do_not_depend_on_edge_order():
    """The scatters add in float64, so the order in which the edges'
    terms arrive (an atomic order on CUDA) cannot change a bit of the
    twists: chip_smoke.py's 64-node loop graph, edges reversed."""
    from steroscopic_hardware_tpu_torch.slam_probe import loop_graph

    nodes, edges, meas, w = loop_graph(np.random.default_rng(7))
    xi, costs = _run((nodes, edges, meas, w), dict(iters=ITERS))
    xi_r, costs_r = _run((nodes, edges[::-1], meas[::-1], w[::-1]),
                         dict(iters=ITERS))
    np.testing.assert_array_equal(xi_r, xi)
    # the costs' own sum over the edges is float32
    np.testing.assert_allclose(costs_r, costs, rtol=1e-6)
    assert costs[-1] < costs[0]
