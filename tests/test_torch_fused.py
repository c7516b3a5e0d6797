"""The port's fused serve+track step (``runtime/fused.py``) on the CPU, as
``tests/test_fused.py`` holds the JAX one.

* The serve half of the fused buffer equals the unfused
  ``compute_serve_async`` bit for bit, for SAD (host-colorize, device
  colorize and light layouts) and SGM.
* Its tracking half reproduces the classic ``StereoSLAM.process`` chain:
  a batch of one tracks exactly as ``StereoVO.process`` (the same RANSAC
  draws, from the same (seed, frame) generator seeds), and batches of two
  chain frame b on frame b - 1 as the classic loop does.
* The in-step BoW vector equals ``BowIndex.vector`` of the tracked
  frame's features, and without loop closure there is none.
* ``DepthPipeline`` + ``SlamPipeline`` run fused end to end over the bus.
* The drop-oldest backstop of ``SlamPipeline.submit_track`` (a reference
  defect, repaired in the port): the TrackResult after a dropped one
  re-bootstraps the pose chain instead of composing across the gap.
"""

import time

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu_torch.models.blockmatch import (
    BlockMatcher,
    SGMMatcher,
)
from steroscopic_hardware_tpu_torch.models.slam import (
    StereoCamera,
    StereoSLAM,
)
from steroscopic_hardware_tpu_torch.runtime.fused import (
    FusedServeTrack,
    TrackResult,
    split_serve,
)
from steroscopic_hardware_tpu_torch.utils.params import Parameters
from steroscopic_hardware_tpu_torch.utils.synth import (
    SyntheticScene,
    straight_trajectory,
)

CAM = StereoCamera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, baseline=0.4)
H, W = 240, 320
VO_KW = dict(block_size=7, max_disparity=32, max_keypoints=128,
             fast_threshold=15, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    scene = SyntheticScene(CAM, size=(H, W), n_landmarks=60, seed=11)
    return [scene.render_pair(xi) for xi in straight_trajectory(6)]


def _mk(matcher_cls=BlockMatcher, **slam_kw):
    slam = StereoSLAM(CAM, async_backend=False, **slam_kw, **VO_KW)
    matcher = matcher_cls(device="cpu")
    matcher.set_params(Parameters(block_size=7, max_disparity=32))
    return FusedServeTrack(matcher, slam), matcher, slam


def test_fused_serve_equals_unfused(frames):
    fused, matcher, _ = _mk()
    pairs = frames[:3]
    B = len(pairs)
    for kw in (dict(fetch_all=True, colorize_dev=False), {},
               dict(preview_scale=2, fetch_all=False)):
        flat, track = fused.step(pairs, **kw)
        assert track.xi_rel.shape == (B, 6) and track.n_inl.shape == (B,)
        depths, rgb = split_serve(flat, B, H, W, **kw)
        ref = matcher.compute_serve_async(pairs, **kw).result()
        if not kw:  # (B + 3, H, W): depths then the RGB planes
            np.testing.assert_array_equal(depths, ref[:B])
            np.testing.assert_array_equal(rgb, ref[B:].transpose(1, 2, 0))
        elif kw.get("colorize_dev", True):  # light: one raveled buffer
            np.testing.assert_array_equal(
                np.concatenate([depths.ravel(), rgb.ravel()]), ref)
        else:
            assert rgb is None
            np.testing.assert_array_equal(depths, ref)


def test_fused_serve_sgm_equals_unfused(frames):
    fused, matcher, _ = _mk(SGMMatcher)
    assert fused.engine == "sgm"
    pairs = frames[:2]
    flat, track = fused.step(pairs, fetch_all=True, colorize_dev=False)
    depths, _ = split_serve(flat, 2, H, W, fetch_all=True,
                            colorize_dev=False)
    ref = matcher.compute_serve_async(pairs, fetch_all=True,
                                      colorize_dev=False).result()
    np.testing.assert_array_equal(depths, ref)
    assert track.xi_rel.shape == (2, 6)


@pytest.mark.parametrize("batch", [1, 2])
def test_fused_tracking_equals_classic(batch, frames):
    """batch 1: keyframes and BA as usual; batch 2 (keyframing off, as the
    JAX test): frame b chains on frame b - 1 on the device."""
    kf = {} if batch == 1 else dict(kf_every=1000)
    fused, _, engine = _mk(**kf)
    classic = StereoSLAM(CAM, async_backend=False, **kf, **VO_KW)
    for i in range(0, len(frames), batch):
        _, track = fused.step(frames[i:i + batch], fetch_all=True,
                              colorize_dev=False)
        assert track.bootstrap == (i == 0)
        engine.process_tracked(track)
    for left, right in frames:
        classic.process(left, right)
    assert engine.frame_idx == classic.frame_idx == len(frames)
    assert engine.vo.n_inliers[1:] == classic.vo.n_inliers[1:]
    assert engine.ba_runs == classic.ba_runs
    # the same draws and the same arithmetic on the CPU: equal poses
    np.testing.assert_array_equal(engine.vo.positions(),
                                  classic.vo.positions())
    if batch == 1:
        assert engine.ba_runs >= 1


def test_fused_bow_vector_equals_index(frames):
    fused, _, engine = _mk(loop_closure=True)
    _, track = fused.step([frames[0]], fetch_all=True, colorize_dev=False)
    assert track.bow_vec is not None and track.bow_vec.shape == (256,)
    feats = track.host_features()
    np.testing.assert_allclose(track.bow_vec,
                               engine._bow.vector(feats[2], feats[3]),
                               atol=1e-6)
    fused, _, _ = _mk()  # loop closure off: no vector
    _, track = fused.step([frames[0]], fetch_all=True, colorize_dev=False)
    assert track.bow_vec is None and track.bootstrap


def test_fused_pipeline_end_to_end():
    from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
    from steroscopic_hardware_tpu_torch.runtime.pipeline import (
        DepthPipeline,
        SlamPipeline,
    )
    from steroscopic_hardware_tpu_torch.runtime.sources import (
        SyntheticSource,
    )

    bus = FrameBus()
    slam_pipe = SlamPipeline(bus, CAM, slam_kwargs=dict(
        loop_closure=True, **VO_KW))
    matcher = BlockMatcher(device="cpu")
    matcher.set_params(Parameters(block_size=7, max_disparity=32))
    depth_pipe = DepthPipeline(bus, matcher, slam_pipeline=slam_pipe,
                               max_batch=2)
    assert depth_pipe._fused is not None and slam_pipe.fused
    shape = (H // 2, W // 2)
    left = SyntheticSource(bus, "left", shape=shape, fps=30.0).start()
    right = SyntheticSource(bus, "right", shape=shape, fps=30.0,
                            shift=8).start()
    depth_pipe.start()
    slam_pipe.start()
    try:
        deadline = time.time() + 60.0
        while time.time() < deadline:
            if slam_pipe.frames >= 4 and depth_pipe.frames >= 4:
                break
            time.sleep(0.1)
        snap = slam_pipe.snapshot()
        assert snap["frames"] >= 4, snap
        assert snap["fused"] and snap["fused_dropped"] == 0
        assert depth_pipe.errors == 0 and slam_pipe.errors == 0
        assert len(snap["positions"]) >= 4
        assert snap["positions_total"] >= len(snap["positions"])
        assert bus.latest("out") is not None
        assert bus.latest("depth") is not None
    finally:
        left.close()
        right.close()
        depth_pipe.close()
        slam_pipe.close()
    assert not slam_pipe._thread.is_alive()


def _track(xi, bootstrap=False, feats=None):
    return TrackResult(feat_dev=feats, xi_rel=np.asarray([xi], np.float32),
                       n_inl=np.asarray([50]), bow_vec=None,
                       bootstrap=bootstrap)


def test_dropped_track_rebootstraps_the_chain(frames, monkeypatch):
    """With the backlog full, submit_track drops the oldest TrackResult;
    the one after it must not compose its first relative twist (which
    links to the dropped frame) onto the chain."""
    from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
    from steroscopic_hardware_tpu_torch.runtime.pipeline import SlamPipeline

    fused, _, _ = _mk()
    _, first = fused.step([frames[0]], fetch_all=True, colorize_dev=False)
    _, second = fused.step([frames[1]], fetch_all=True, colorize_dev=False)
    feats = first.feat_dev
    pipe = SlamPipeline(FrameBus(), CAM, slam_kwargs=dict(
        async_backend=False, kf_every=1000, **VO_KW))
    pipe.enable_fused()
    monkeypatch.setattr(SlamPipeline, "FUSED_BACKLOG", 2)
    step = np.array([0.1, 0, 0, 0, 0, 0], np.float32)
    gap = np.array([5.0, 0, 0, 0, 0, 0], np.float32)  # the lost motion
    pipe.submit_track(_track(step, bootstrap=True, feats=feats))
    pipe.submit_track(_track(step))
    pipe.submit_track(_track(gap))  # drops the first; marks the second
    assert pipe.fused_dropped == 1
    assert [t.bootstrap for t in pipe._fused_q] == [True, False]
    pipe.submit_track(_track(step))  # drops the marked one; marks `gap`
    assert pipe.fused_dropped == 2
    queued = list(pipe._fused_q)
    assert queued[0].xi_rel[0, 0] == 5.0 and queued[0].bootstrap
    # the queue's first result re-bootstraps: its twist across the gap is
    # not applied, the next one composes on it
    queued[0].feat_dev = second.feat_dev
    while pipe._fused_q:
        pipe.slam.process_tracked(pipe._next_track(0.0))
    x = pipe.slam.vo.positions()[:, 0]
    assert len(x) == 2 and abs(x[0]) < 1e-6
    assert abs(abs(x[1]) - 0.1) < 1e-5  # one step, not 5 m + a step
