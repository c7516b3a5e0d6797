"""The port's multi-process launcher and ``StereoSLAM(pg_mesh=)`` on the CPU.

* ``multihost.launch`` / ``init_distributed`` refuse what cannot run:
  "nccl" with more ranks than cards or on the CPU, "cuda" without a GPU,
  an unknown backend; and a rank that raises fails the launch.
* ``StereoSLAM(pg_mesh=)`` over two gloo ranks (``dryrun.run_cases``, kind
  "slam"): every rank runs the same engine on the same synthetic loop
  (``vo.synthetic_sequence``, 120x320, 14 frames, a keyframe a frame, BoW
  loop closure), and each closure's pose-graph solve is edge-sharded over
  the two ranks. Synchronously, both ranks keep the same keyframes, close
  the same loops as the single-process engine, and their camera centres
  stay within SLAM_TOL of its (the sharded solve's twists equal the
  single-process ones bit for bit, so they agree exactly). The
  asynchronous backend cannot keep the ranks in step (each rank's backend
  checks loops on the keyframes it has seen by then and sheds checks by
  its own backlog), so every rank refuses ``pg_mesh`` with it, before any
  collective.
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from steroscopic_hardware_tpu_torch.models.slam import StereoSLAM
from steroscopic_hardware_tpu_torch.parallel import dryrun, multihost
from steroscopic_hardware_tpu_torch.vo import run_slam, synthetic_sequence

SIZE = (120, 320)
FRAMES = 14
SEED = 3
KW = dict(window=4, kf_every=1, ba_iters=3, loop_closure=True, block_size=7,
          max_disparity=32, max_keypoints=256)
SLAM_TOL = 1e-3  # m, the ranks' camera centres against one process's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the no-fallback rule needs one "
                    "without")


def test_launch_refuses_what_cannot_run():
    with pytest.raises(ValueError, match="one card per rank"):
        multihost.launch(dryrun.run_cases, 2, backend="nccl", device="cuda",
                         args=([], "unused"))
    with pytest.raises(ValueError, match="ranks on the CPU need backend"):
        multihost.launch(dryrun.run_cases, 2, backend="nccl", device="cpu",
                         args=([], "unused"))
    with pytest.raises(ValueError, match="unknown backend"):
        multihost.init_distributed(backend="mpi", device="cpu")


def test_launch_cuda_raises_without_a_gpu():
    _no_cuda()
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.launch(dryrun.run_cases, 2, backend="gloo", device="cuda",
                         args=([], "unused"))
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.init_distributed(backend="gloo")  # cuda is the default


def test_a_failing_rank_fails_the_launch():
    rng = np.random.default_rng(0)
    left = rng.integers(0, 256, (16, 64), dtype=np.uint8)
    case = dict(kind="sad", left=left, right=left, block_size=31,
                max_disparity=16)  # a halo of 15 rows over 8-row bands
    with pytest.raises(mp.ProcessRaisedException, match="taller than a band"):
        dryrun.launch_cases([("halo", case)], 2, backend="gloo",
                            device="cpu")


@pytest.fixture(scope="module")
def slam_runs():
    case = dict(kind="slam", frames=FRAMES, size=SIZE, seed=SEED, kwargs=KW)
    cases = [("sync", case),
             ("async", dict(case, kwargs=dict(KW, async_backend=True),
                            expect_error=True))]
    ranks = dryrun.launch_cases(cases, 2, backend="gloo", device="cpu")
    cam, pairs, _ = synthetic_sequence(FRAMES, size=SIZE, seed=SEED)
    single = StereoSLAM(cam, device="cpu", seed=SEED, **KW)
    run_slam(single, pairs)
    return ranks, single


def test_pg_mesh_sync_ranks_equal_one_process(slam_runs):
    ranks, single = slam_runs
    per_rank = ranks["sync"]["per_rank"]
    keyframes = [ti for _, ti in single.kf_history]
    assert single.loops_closed > 0
    for r in per_rank:
        assert r["backend_errors"] == 0
        assert r["keyframes"] == keyframes
        assert r["loops_closed"] == single.loops_closed
        dev = np.abs(r["positions"] - single.vo.positions()).max()
        assert dev <= SLAM_TOL, dev


def test_pg_mesh_async_ranks_stay_in_step(slam_runs):
    """The ranks stay in step by refusing the asynchronous backend: each
    rank raises in the constructor, and the launch goes on to its end."""
    ranks, _ = slam_runs
    assert ranks["async"]["error"].startswith(
        "ValueError: pg_mesh needs the synchronous backend")
    assert [r["seconds"] for r in ranks["async"]["ranks"]] == [None, None]
