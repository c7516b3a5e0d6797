"""The port's ``StereoSLAM`` as a whole on the CPU, against the JAX package.

The out-and-back sequence of ``tests/test_checkpoint_slam.py``
(``test_loop_closure_fires_and_reduces_drift``: 11 frames, 0.12 m steps
out along x and back, 240x320, window 3, a keyframe a frame, BA 3
iterations, loop closure with 25 matches and a gap of 4), run once per
module through the JAX ``StereoSLAM`` and the port's
``StereoSLAM(device="cpu")``:

* both loop indexes (``bow``, ``exhaustive``): the port meets the JAX
  test's gates (a loop closes; the final camera within 0.12 m of the
  start) and its camera centres stay within TRAJ_TOL of the JAX engine's
  (the two draw their RANSAC scores from different generators and agree
  up to the refinement's convergence; measured when written: 1.8e-5 m);
* the asynchronous backend meets ``tests/test_slam.py``'s gates against
  the synchronous engine (no backend error, a BA run and a closure, ATE
  within max(2.5 x sync, 0.06));
* checkpoints cross the packages both ways: the JAX engine's checkpoint
  after SAVE_AT frames resumes in the port, which runs the rest within
  ``tests/test_checkpoint_slam.py``'s ATE < 0.15; the port's loads in the
  JAX ``StereoSLAM.load_checkpoint`` with the same frame index,
  trajectory, keyframes and pose-graph edges;
* the port's repair of the JAX ``_try_loop_closure`` (it reads the current
  keyframe's fields again after the match, where a concurrent cull may
  have nulled them): the fields are read once, and a closure lands though
  they are nulled mid-check;
* ``positions(tail=)``, the fixed-lag pose graph inside the engine, the
  backend warmup's count, culling and the JAX rule for ``pg_mesh``'s
  axes.
"""

import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from steroscopic_hardware_tpu.models import slam as jslam
from steroscopic_hardware_tpu_torch.models import slam
from steroscopic_hardware_tpu_torch.models.slam import (
    FrameState,
    StereoCamera,
    StereoSLAM,
)
from steroscopic_hardware_tpu_torch.ops import se3_np
from tests.test_slam import CAM as JCAM
from tests.test_slam import _make_world, _render

CAM = StereoCamera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, baseline=0.4)
KW = dict(window=3, kf_every=1, ba_iters=3, loop_closure=True,
          loop_min_matches=25, loop_gap=4, block_size=7, max_disparity=32,
          max_keypoints=128, fast_threshold=15)
INDEXES = ("bow", "exhaustive")
SAVE_AT = 6       # frames before the checkpoint
TRAJ_TOL = 1e-3   # m, camera centres of the port's and the JAX StereoSLAM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequence():
    rng = np.random.default_rng(42)
    pts, patches = _make_world(rng)
    xis = [np.zeros(6, np.float32)]
    for step in [0.12] * 5 + [-0.12] * 5:
        xi = xis[-1].copy()
        xi[0] += step
        xis.append(xi)
    frames = [(_render(pts, patches, xi), _render(pts, patches, xi,
                                                  right=True)) for xi in xis]
    return frames, se3_np.positions(np.stack(xis))


def _final_distance(engine):
    return float(np.linalg.norm(engine.vo.positions()[-1]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sequence through the JAX and the port's engines, once: per
    index the engines, with a checkpoint of each after SAVE_AT frames of
    the bow run."""
    frames, gt = _sequence()
    ckdir = tmp_path_factory.mktemp("slam_ckpt")
    out = {"frames": frames, "gt": gt}
    for index in INDEXES:
        for tag, make in (("jax", lambda: jslam.StereoSLAM(
                JCAM, loop_index=index, **KW)), ("port", lambda: StereoSLAM(
                CAM, loop_index=index, device="cpu", **KW))):
            engine = make()
            for k, (left, right) in enumerate(frames):
                if index == "bow" and k == SAVE_AT:
                    path = str(ckdir / f"{tag}.ckpt")
                    engine.save_checkpoint(path)
                    out[f"{tag}_ckpt"] = path
                    out[f"{tag}_at_save"] = dict(
                        frame_idx=engine.frame_idx,
                        trajectory=np.stack(engine.vo.trajectory),
                        last_xi_rel=np.array(engine.vo._last_xi_rel),
                        hist=len(engine.kf_history),
                        keyframes=len(engine.keyframes),
                        edges=[(i, j, np.array(m))
                               for i, j, m in engine.graph_edges])
                engine.process(left, right)
            out[tag, index] = engine
            out[tag, index, "positions"] = engine.vo.positions()
    return out


@pytest.mark.parametrize("index", INDEXES)
def test_loop_closure_equals_jax(index, runs):
    port, jax_engine = runs["port", index], runs["jax", index]
    # the gates of tests/test_checkpoint_slam.py
    assert port.loops_closed >= 1
    assert _final_distance(port) < 0.12
    assert port.ba_runs == jax_engine.ba_runs >= 1
    assert port.loops_closed == jax_engine.loops_closed
    assert [(i, j) for i, j, _ in port.graph_edges] == [
        (i, j) for i, j, _ in jax_engine.graph_edges]
    dev = np.abs(runs["port", index, "positions"]
                 - runs["jax", index, "positions"]).max()
    assert dev <= TRAJ_TOL, dev


def test_async_backend_matches_sync(runs):
    frames, gt = runs["frames"], runs["gt"]
    engine = StereoSLAM(CAM, async_backend=True, device="cpu", **KW)
    try:
        for left, right in frames:
            engine.process(left, right)
        engine.finish()
    finally:
        engine.close()
    assert engine.backend_errors == 0
    assert engine.loops_closed >= 1 and engine.ba_runs >= 1
    assert engine.backend_pending == 0
    ate_sync = slam.ate_rmse(runs["port", "bow", "positions"], gt)
    ate_async = slam.ate_rmse(engine.vo.positions(), gt)
    assert ate_async < max(2.5 * ate_sync, 0.06), (ate_sync, ate_async)


def test_jax_checkpoint_resumes_in_port(runs):
    frames, gt = runs["frames"], runs["gt"]
    saved = runs["jax_at_save"]
    kw = {k: v for k, v in KW.items() if k not in ("window", "kf_every")}
    engine = StereoSLAM.load_checkpoint(runs["jax_ckpt"], device="cpu", **kw)
    assert engine.frame_idx == saved["frame_idx"] == SAVE_AT
    np.testing.assert_array_equal(np.stack(engine.vo.trajectory),
                                  saved["trajectory"])
    assert len(engine.kf_history) == saved["hist"]
    assert len(engine.keyframes) == saved["keyframes"]
    assert engine._bow.n == saved["hist"]
    for left, right in frames[SAVE_AT:]:
        engine.process(left, right)
    assert len(engine.vo.trajectory) == len(frames)
    ate = slam.ate_rmse(engine.vo.positions(), gt)
    assert ate < 0.15, f"ATE {ate}"
    assert engine.loops_closed >= 1


def test_port_checkpoint_loads_in_jax(runs):
    saved = runs["port_at_save"]
    kw = {k: v for k, v in KW.items() if k not in ("window", "kf_every")}
    engine = jslam.StereoSLAM.load_checkpoint(runs["port_ckpt"], **kw)
    assert engine.frame_idx == saved["frame_idx"] == SAVE_AT
    np.testing.assert_array_equal(np.stack(engine.vo.trajectory),
                                  saved["trajectory"])
    assert len(engine.kf_history) == saved["hist"]
    assert len(engine.keyframes) == saved["keyframes"]
    assert [(i, j) for i, j, _ in engine.graph_edges] == [
        (i, j) for i, j, _ in saved["edges"]]
    for (_, _, m), (_, _, want) in zip(engine.graph_edges, saved["edges"]):
        np.testing.assert_array_equal(m, want)
    # and back into the port
    back = StereoSLAM.load_checkpoint(runs["port_ckpt"], device="cpu", **kw)
    assert back.frame_idx == SAVE_AT
    assert len(back.kf_history) == saved["hist"]


def test_port_checkpoint_resumes_as_the_uninterrupted_run(runs):
    """A resumed engine draws each frame's and each loop check's RANSAC
    scores as the uninterrupted one does, falls back on the same motion
    where a frame drops, and its window keyframes are its pose-graph nodes
    (one object each, as in the running engine), so the rest of the run
    lands the same poses, BA runs and closures."""
    frames = runs["frames"]
    kw = {k: v for k, v in KW.items() if k not in ("window", "kf_every")}
    engine = StereoSLAM.load_checkpoint(runs["port_ckpt"], loop_index="bow",
                                        device="cpu", **kw)
    np.testing.assert_array_equal(engine.vo._last_xi_rel,
                                  runs["port_at_save"]["last_xi_rel"])
    assert engine.vo._last_xi_rel.any()
    hist = {t: kf for kf, t in engine.kf_history}
    assert engine.keyframes and all(
        hist[t] is kf for kf, t in zip(engine.keyframes, engine.kf_traj_idx))
    for left, right in frames[SAVE_AT:]:
        engine.process(left, right)
    whole = runs["port", "bow"]
    assert (engine.ba_runs, engine.loops_closed) == (whole.ba_runs,
                                                     whole.loops_closed)
    assert [(i, j) for i, j, _ in engine.graph_edges] == [
        (i, j) for i, j, _ in whole.graph_edges]
    np.testing.assert_array_equal(engine.vo.positions(),
                                  runs["port", "bow", "positions"])


def test_loop_closure_reads_the_current_keyframe_once(runs, monkeypatch):
    """A concurrent cull may null the current keyframe's fields while its
    loop check runs (the JAX function then fails reading cur.xy_sub after
    the match). The port reads them once, at the top."""
    engine = runs["port", "exhaustive"]
    cur = engine.kf_history[-1][0]
    fields = {f: getattr(cur, f) for f in ("desc", "valid", "xy_sub")}
    real = slam.match_batch
    seen = []

    def culled_meanwhile(*args, **kwargs):
        for f in fields:
            setattr(cur, f, None)  # what _cull_history does
        seen.append(True)
        return real(*args, **kwargs)

    monkeypatch.setattr(slam, "match_batch", culled_meanwhile)
    before = engine.loops_closed
    try:
        engine._try_loop_closure()
    finally:
        for f, v in fields.items():
            setattr(cur, f, v)
    assert seen and engine.loops_closed == before + 1


def test_positions_tail():
    vo = slam.StereoVO(CAM, device="cpu")
    vo.trajectory = [np.array([0.1 * i, 0, 0, 0, 0.01 * i, 0], np.float32)
                     for i in range(6)]
    full = vo.positions()
    assert full.shape == (6, 3)
    np.testing.assert_array_equal(vo.positions(tail=3), full[-3:])
    np.testing.assert_array_equal(vo.positions(tail=100), full)


def _history(engine, n):
    """n keyframes on a line, with odometry edges and one loop edge
    (n - 1 -> 1), landed as the engine lands them."""
    for i in range(n):
        xi = np.array([0.1 * i, 0, 0, 0, 0.02 * i, 0], np.float32)
        kf = FrameState(xy=np.zeros((4, 2), np.int32),
                        xy_sub=np.zeros((4, 2), np.float32),
                        desc=np.zeros((4, 256), np.uint8),
                        valid=np.ones(4, bool),
                        pts_cam=np.ones((4, 3), np.float32),
                        pts_ok=np.ones(4, bool), xi_world=xi)
        engine.vo.trajectory.append(xi)
        engine.vo.prev = kf
        engine._push_history(kf)
    engine.graph_edges.append(
        (1, n - 1, se3_np.relative(np.zeros(6, np.float32),
                                   np.full(6, 0.01, np.float32))))


def test_pose_graph_horizon_freezes_old_keyframes():
    engine = StereoSLAM(CAM, device="cpu", pg_horizon=3,
                        max_keypoints=4)
    _history(engine, 8)
    before = [kf.xi_world.copy() for kf, _ in engine.kf_history]
    engine._optimize_pose_graph()
    after = [kf.xi_world for kf, _ in engine.kf_history]
    for i in range(5):  # max(1, 8 - 3) frozen, bit for bit
        np.testing.assert_array_equal(after[i], before[i])
    assert any(not np.array_equal(a, b)
               for a, b in zip(after[5:], before[5:]))


def test_cull_history_keeps_loop_anchors():
    engine = StereoSLAM(CAM, device="cpu", window=1, max_loop_keyframes=6,
                        max_keypoints=4, loop_closure=True)
    _history(engine, 30)
    for _ in range(30):
        engine._bow.add_zero()
    engine._cull_history()
    kept = [i for i, (kf, _) in enumerate(engine.kf_history)
            if kf.desc is not None]
    assert engine.culled_keyframes == 30 - len(kept) > 0
    assert 1 in kept  # a loop-edge endpoint is never culled
    assert kept[-18:] == list(range(12, 30))  # the newest 2 * window + 16


def test_warmup_backend_and_pg_mesh_axes():
    engine = StereoSLAM(CAM, device="cpu", loop_closure=True,
                        max_keypoints=32)
    n = engine.warmup_backend()
    # matches x2 kinds, PnP, BA windows (M = 2..4), pose graph, BoW x3
    assert n == 14
    engine = StereoSLAM(CAM, device="cpu", pg_horizon=4, max_keypoints=32)
    assert engine.warmup_backend() == 12  # + the n_fixed pose graph
    assert engine.warmup_backend(should_stop=lambda: True) == 0
    # the JAX rule for pg_mesh's axes: one dim, or one named "rows" (the
    # engine reads only the mesh's dim names until a loop closes)
    for names, axis in ((("x",), "x"), (("batch", "rows"), "rows")):
        mesh = SimpleNamespace(mesh_dim_names=names)
        engine = StereoSLAM(CAM, device="cpu", pg_mesh=mesh, max_keypoints=4)
        assert engine._pg_axis == axis
    message = "pg_mesh must have a single axis (or one named 'rows')"
    with pytest.raises(ValueError, match=re.escape(message)):
        StereoSLAM(CAM, device="cpu", max_keypoints=4,
                   pg_mesh=SimpleNamespace(mesh_dim_names=("a", "b")))
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
    with pytest.raises(ValueError, match=re.escape(message)):
        jslam.StereoSLAM(JCAM, pg_mesh=jmesh, max_keypoints=4)
