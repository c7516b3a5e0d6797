"""Parity of the port's multi-process tier (``steroscopic_hardware_tpu_torch
/parallel``) with the JAX package's ``parallel/`` on the CPU.

The port's ranks are real processes: a gloo group of 2 ranks and one of 4,
each started once per module by ``dryrun.launch_cases`` on the CPU (one
torch thread per rank), runs every case of its world and writes the
gathered results, which the tests read. A rank imports only the port (its
function is ``dryrun.run_cases``). The JAX side runs here on the 8 virtual
CPU devices of ``tests/conftest.py``, on the same numpy inputs:

* row-band SAD with the halo exchange, (b7, d16) and (b16, d64) on the
  64x96 pair of ``tests/test_parallel.py``: bit for bit the JAX
  ``disparity_sharded`` and ``sad_golden.disparity_numpy``;
* scanline-sharded SGM, d16, subpixel on and off: bit for bit the JAX
  ``sgm_disparity_sharded`` (and the port's single-process fused chain);
* landmark-sharded BA on ``tests/test_ba_dist.py``'s problem and the
  edge-sharded pose graph on ``tests/test_parallel.py``'s 16-node
  multi-loop graph, with the JAX tests' tolerances against the JAX and
  the port's single-process solves. The sharded pose graph's twists are
  the port's single-process ones bit for bit (its float64 node sums are
  reduced before rounding); its costs, float32 sums over the edges in
  another order, within 1e-5;
* a (2, 2) batch x rows mesh (two frames, each over two ranks);
* the bytes each rank sent through the halo exchange and the all_to_all;
* ValueErrors raised in the ranks: H and W not divisible by the axis, and
  the halo taller than a band (where the JAX function returns a wrong map
  without an error: the port repairs it, so this checks the error);
* ``init_distributed`` / ``make_mesh`` / ``global_mesh`` on one process.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.models.ba import BAProblem as JBAProblem
from steroscopic_hardware_tpu.models.ba import ba_solve as jba_solve
from steroscopic_hardware_tpu.models.slam import (
    pose_graph_optimize as jpose_graph_optimize,
)
from steroscopic_hardware_tpu.ops import se3 as jse3
from steroscopic_hardware_tpu.ops.sad_golden import disparity_numpy
from steroscopic_hardware_tpu.parallel.ba_dist import (
    ba_solve_sharded as jba_solve_sharded,
)
from steroscopic_hardware_tpu.parallel.disparity_shard import (
    disparity_sharded as jdisparity_sharded,
)
from steroscopic_hardware_tpu.parallel.mesh import make_mesh as jmake_mesh
from steroscopic_hardware_tpu.parallel.sgm_shard import (
    sgm_disparity_sharded as jsgm_disparity_sharded,
)
from steroscopic_hardware_tpu_torch.models.ba import BAProblem, ba_solve
from steroscopic_hardware_tpu_torch.models.slam import pose_graph_optimize
from steroscopic_hardware_tpu_torch.ops.sgm import sgm_disparity
from steroscopic_hardware_tpu_torch.parallel import dryrun, multihost
from tests.test_ba_dist import INTR, _problem

WORLDS = (2, 4)
SAD_CONFIGS = ((7, 16), (16, 64))
SGM_MAXD = 16
ITERS = 10


def _pair(rng, shape, shift):
    left = rng.integers(0, 256, shape, dtype=np.uint8)
    right = np.clip(np.roll(left, -shift, axis=-1).astype(int)
                    + rng.integers(-2, 3, shape), 0, 255).astype(np.uint8)
    return left, right


def _pose_graph():
    """``tests/test_parallel.py``'s drifted 16-node multi-loop graph:
    (truth, initial nodes, edges, measurements, weights)."""
    rng = np.random.default_rng(1234)
    M = 16
    xi_true = np.zeros((M, 6), np.float32)
    step = np.array([0.4, 0, 0.1, 0, np.pi / 8, 0], np.float32)
    for i in range(1, M):
        xi_true[i] = np.asarray(jse3.se3_log(*jse3.compose(
            *jse3.se3_exp(jnp.asarray(step)),
            *jse3.se3_exp(jnp.asarray(xi_true[i - 1])))))

    def rel(i, j):
        Ri, ti = jse3.se3_exp(jnp.asarray(xi_true[i]))
        Rj, tj = jse3.se3_exp(jnp.asarray(xi_true[j]))
        return np.asarray(jse3.se3_log(*jse3.compose(
            Rj, tj, *jse3.inverse(Ri, ti))))

    edges = [(i, i + 1) for i in range(M - 1)]
    edges += [(M - 1, 0), (0, M // 2), (3, 11)]
    meas = np.stack([rel(i, j) for i, j in edges]).astype(np.float32)
    w = np.ones(len(edges), np.float32)
    xi_init = xi_true + np.concatenate(
        [np.zeros((1, 6)), rng.normal(0, 0.05, (M - 1, 6))], 0
    ).astype(np.float32)
    return xi_true, xi_init, np.array(edges, np.int32), meas, w


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1234)
    xi0, pts0, uv, mask, xi_true = _problem(np.random.default_rng(1234))
    return {
        "sad": _pair(rng, (64, 96), 3),
        "sgm": _pair(rng, (48, 96), 4),
        "sad_batch": tuple(np.stack(a) for a in zip(
            _pair(rng, (64, 96), 3), _pair(rng, (64, 96), 5))),
        "sgm_batch": tuple(np.stack(a) for a in zip(
            _pair(rng, (48, 96), 4), _pair(rng, (48, 96), 2))),
        "ba": (xi0, pts0, uv, mask, xi_true),
        "pg": _pose_graph(),
        "odd": _pair(rng, (33, 99), 3),
    }


def _cases(n, inp):
    sad_l, sad_r = inp["sad"]
    sgm_l, sgm_r = inp["sgm"]
    odd_l, odd_r = inp["odd"]
    xi0, pts0, uv, mask, _ = inp["ba"]
    _, nodes, edges, meas, w = inp["pg"]
    cases = [(f"sad_b{b}_d{d}", dict(kind="sad", left=sad_l, right=sad_r,
                                      block_size=b, max_disparity=d))
             for b, d in SAD_CONFIGS]
    cases += [(f"sgm_sub{int(sub)}", dict(kind="sgm", left=sgm_l,
                                          right=sgm_r, subpixel=sub,
                                          max_disparity=SGM_MAXD))
              for sub in (False, True)]
    cases += [
        ("ba", dict(kind="ba", xi=xi0, points=pts0, uv=uv, mask=mask,
                    intr=INTR, iters=ITERS)),
        ("pg", dict(kind="pg", nodes=nodes, edges=edges, meas=meas, w=w,
                    iters=ITERS)),
        ("sad_rows", dict(kind="sad", left=odd_l, right=odd_r,
                          block_size=7, max_disparity=16,
                          expect_error=True)),
        ("sgm_rows", dict(kind="sgm", left=odd_l[:, :96],
                          right=odd_r[:, :96], max_disparity=16,
                          expect_error=True)),
        ("sgm_cols", dict(kind="sgm", left=odd_l[:32], right=odd_r[:32],
                          max_disparity=16, expect_error=True)),
        # 8 rows a rank at n = 4 (the JAX defect's 64 rows over 8 devices),
        # a 15-row halo
        ("sad_halo", dict(kind="sad", left=sad_l[:8 * n, :64],
                          right=sad_r[:8 * n, :64], block_size=31,
                          max_disparity=16, expect_error=True)),
    ]
    if n == 4:
        bl, br = inp["sad_batch"]
        gl, gr = inp["sgm_batch"]
        cases += [
            ("sad_mesh22", dict(kind="sad", left=bl, right=br, mesh=(2, 2),
                                block_size=16, max_disparity=64)),
            ("sgm_mesh22", dict(kind="sgm", left=gl, right=gr, mesh=(2, 2),
                                max_disparity=SGM_MAXD)),
        ]
    return cases


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every case's gathered results, by world size: one launch per
    world."""
    return {n: dryrun.launch_cases(_cases(n, inputs), n, backend="gloo",
                                   device="cpu")
            for n in WORLDS}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("block,maxd", SAD_CONFIGS)
def test_sharded_sad_equals_jax_and_golden(ranks, inputs, n, block, maxd):
    left, right = inputs["sad"]
    got = ranks[n][f"sad_b{block}_d{maxd}"]["disp"]
    want = np.asarray(jdisparity_sharded(
        left, right, block_size=block, max_disparity=maxd,
        mesh=jmake_mesh(n_rows=n)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, disparity_numpy(left, right, block,
                                                       maxd))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("subpixel", [False, True])
def test_sharded_sgm_equals_jax(ranks, inputs, n, subpixel):
    left, right = inputs["sgm"]
    got = ranks[n][f"sgm_sub{int(subpixel)}"]["disp"]
    want = np.asarray(jsgm_disparity_sharded(
        left, right, max_disparity=SGM_MAXD, subpixel=subpixel,
        mesh=jmake_mesh(n_rows=n)))
    np.testing.assert_array_equal(got, want)
    single = sgm_disparity(torch.from_numpy(left), torch.from_numpy(right),
                           max_disparity=SGM_MAXD, subpixel=subpixel,
                           epilogue="fused").numpy()
    np.testing.assert_array_equal(got, single)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_ba_matches_jax_and_single(ranks, inputs, n):
    """``tests/test_ba_dist.py``'s gates, against the JAX single-device
    and sharded solves and the port's single-process one."""
    xi0, pts0, uv, mask, xi_true = inputs["ba"]
    got = ranks[n]["ba"]
    jsingle, jerrs = jba_solve(JBAProblem(
        jnp.asarray(xi0), jnp.asarray(pts0), jnp.asarray(uv),
        jnp.asarray(mask), INTR), iters=ITERS)
    jxi_d, _, jerrs_d = jba_solve_sharded(
        jnp.asarray(xi0), jnp.asarray(pts0), jnp.asarray(uv),
        jnp.asarray(mask), intr=INTR, mesh=jmake_mesh(n_rows=n),
        iters=ITERS)
    single, errs = ba_solve(BAProblem(
        *(torch.from_numpy(a) for a in (xi0, pts0, uv, mask)), INTR),
        iters=ITERS)
    refs = [(np.asarray(jsingle.xi), np.asarray(jsingle.points),
             np.asarray(jerrs)),
            (single.xi.numpy(), single.points.numpy(), errs.numpy())]
    for xi, pts, e in refs:
        assert np.allclose(got["errs"][0], e[0], rtol=1e-5)
        assert np.allclose(got["xi"], xi, atol=5e-3)
        assert np.allclose(got["points"], pts, atol=1e-1)
    assert np.allclose(got["errs"][0], np.asarray(jerrs_d)[0], rtol=1e-5)
    assert np.allclose(got["xi"], np.asarray(jxi_d), atol=5e-3)
    assert got["errs"][-1] < 1e-3
    assert np.allclose(got["xi"], xi_true, atol=5e-3)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_pose_graph_matches_jax_and_single(ranks, inputs, n):
    """``tests/test_parallel.py``'s gates against the JAX solve; the port's
    single-process twists bit for bit."""
    xi_true, nodes, edges, meas, w = inputs["pg"]
    got = ranks[n]["pg"]
    jxi, jcosts = jpose_graph_optimize(
        jnp.asarray(nodes), jnp.asarray(edges), jnp.asarray(meas),
        jnp.asarray(w), iters=ITERS)
    xi, costs = pose_graph_optimize(
        *(torch.from_numpy(a) for a in (nodes, edges, meas, w)),
        iters=ITERS)
    for c0 in (np.asarray(jcosts)[0], costs[0].item()):
        assert np.allclose(got["costs"][0], c0, rtol=1e-5)
    assert got["costs"][-1] < got["costs"][0] * 1e-3
    assert np.allclose(got["xi"], np.asarray(jxi), atol=1e-4)
    assert np.allclose(got["xi"], xi_true, atol=1e-3)
    np.testing.assert_array_equal(got["xi"], xi.numpy())
    np.testing.assert_allclose(got["costs"], costs.numpy(), rtol=1e-5,
                               atol=1e-12)


def test_batch_by_rows_mesh(ranks, inputs):
    """A (2, 2) mesh: frame b on batch rank b, rows over two ranks."""
    got = ranks[4]
    for b in range(2):
        left, right = (a[b] for a in inputs["sad_batch"])
        np.testing.assert_array_equal(got["sad_mesh22"]["disp"][b],
                                      disparity_numpy(left, right, 16, 64))
        left, right = (a[b] for a in inputs["sgm_batch"])
        want = sgm_disparity(torch.from_numpy(left),
                             torch.from_numpy(right),
                             max_disparity=SGM_MAXD, epilogue="fused")
        np.testing.assert_array_equal(got["sgm_mesh22"]["disp"][b],
                                      want.numpy())


@pytest.mark.parametrize("n", WORLDS)
def test_bytes_sent_by_each_rank(ranks, inputs, n):
    """The halo: h rows of both images to each neighbour (uint8); the
    all_to_all: the uint8 aggregate's blocks for the n - 1 other ranks."""
    H, W = inputs["sad"][0].shape
    h = 16 // 2
    sad = ranks[n]["sad_b16_d64"]["ranks"]
    for i, r in enumerate(sad):
        neighbours = (i > 0) + (i < n - 1)
        assert r["sent_bytes"] == {"halo": neighbours * h * 2 * W,
                                   "all_to_all": 0}
    H, W = inputs["sgm"][0].shape
    block = (SGM_MAXD + 1) * (W // n) * (H // n)
    for r in ranks[n]["sgm_sub1"]["ranks"]:
        assert r["sent_bytes"] == {"halo": 0, "all_to_all": (n - 1) * block}
        # the CPU ranks run the plain versions: no kernel launched
        assert not any(r["launches"].values())


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case,match", [
    ("sad_rows", "size 33 along dim 0 not divisible by mesh axis rows"),
    ("sgm_rows", "H=33 and W=96 must divide by mesh axis rows"),
    ("sgm_cols", "H=32 and W=99 must divide by mesh axis rows"),
    ("sad_halo", "halo of block 31 (15 rows) is taller than a band of 8 "
                 "rows"),
])
def test_value_errors_in_the_ranks(ranks, n, case, match):
    error = ranks[n][case].get("error", "")
    assert error.startswith("ValueError: ") and match in error, error


def test_one_process_group(monkeypatch):
    """The no-op-safe single-process path: a one-rank group, a (1, 1)
    mesh, global_mesh, a second init that changes nothing, and the sharded
    SAD and SGM on one rank equal to the single-process functions."""
    import torch.distributed as dist

    from steroscopic_hardware_tpu_torch.parallel import make_mesh
    from steroscopic_hardware_tpu_torch.parallel.disparity_shard import (
        disparity_sharded,
    )
    from steroscopic_hardware_tpu_torch.parallel.sgm_shard import (
        sgm_disparity_sharded,
    )
    from steroscopic_hardware_tpu_torch.ops.sad import disparity

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh(device_type="cpu")
    info = multihost.init_distributed(backend="gloo", device="cpu")
    try:
        assert info == {"process_id": 0, "num_processes": 1,
                        "local_devices": 1, "global_devices": 1,
                        "device": torch.device("cpu"), "backend": "gloo"}
        assert multihost.init_distributed(backend="gloo",
                                          device="cpu") == info
        mesh = make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("batch", "rows")
        assert tuple(mesh.shape) == (1, 1)
        assert tuple(multihost.global_mesh("cpu").shape) == (1, 1)
        with pytest.raises(ValueError, match="every rank must be on"):
            make_mesh(n_rows=2, device_type="cpu")
        rng = np.random.default_rng(5)
        left, right = (torch.from_numpy(a)
                       for a in _pair(rng, (24, 64), 3))
        torch.testing.assert_close(
            disparity_sharded(left, right, block_size=7, max_disparity=16,
                              mesh=mesh),
            disparity(left, right, block_size=7, max_disparity=16),
            rtol=0, atol=0)
        torch.testing.assert_close(
            sgm_disparity_sharded(left, right, max_disparity=16, mesh=mesh),
            sgm_disparity(left, right, max_disparity=16, epilogue="fused"),
            rtol=0, atol=0)
    finally:
        dist.destroy_process_group()
