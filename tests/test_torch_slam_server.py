"""The port's live SLAM serving on the CPU: ``build_app(["--slam", "--device",
"cpu", ...])`` over a 120x160 rendered pair booted from PNGs, fused (the
default) and with ``--no-slam-fused``.

``GET /slam`` carries the JAX ``SlamPipeline`` snapshot's keys (listed
from ``runtime/pipeline.py`` of the JAX package) plus ``enabled``;
``GET /slam/trajectory`` serves the whole trajectory in TUM form (index,
position, quaternion; 8 fields a line) and as JSON twists; the live page
carries the trajectory canvas; ``--slam-checkpoint-dir`` resumes; and the
SLAM flags take the JAX defaults.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu_torch.__main__ import build_app, parse_args
from steroscopic_hardware_tpu_torch.io.png import write_png
from steroscopic_hardware_tpu_torch.models.slam import StereoCamera
from steroscopic_hardware_tpu_torch.utils.synth import SyntheticScene

H, W = 120, 160
CAM = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, baseline=0.4)
# the keys of the JAX SlamPipeline._after_step snapshot
JAX_SNAPSHOT_KEYS = {
    "frames", "errors", "keyframes", "ba_runs", "loops_closed",
    "backend_pending", "backend_coalesced", "loop_checks_skipped",
    "culled_keyframes", "warm", "fused", "fused_dropped", "stage_s",
    "inliers", "positions", "positions_total"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    scene = SyntheticScene(StereoCamera(**CAM), size=(H, W), n_landmarks=40,
                           seed=3)
    left, right = scene.render_pair(np.zeros(6, np.float32))
    d = tmp_path_factory.mktemp("pair")
    write_png(str(d / "l.png"), left)
    write_png(str(d / "r.png"), right)
    return str(d / "l.png"), str(d / "r.png")


def _argv(pngs, *flags):
    return ["--left", pngs[0], "--right", pngs[1], "--fps", "20",
            "--no-open", "--port", "0", "--device", "cpu",
            *(f"--{k}={v}" for k, v in CAM.items()), "--slam",
            "--loop-closure", *flags]


def _serve_slam(pngs, *flags, frames=3, timeout=90.0):
    app = build_app(_argv(pngs, *flags)).start()
    try:
        base = app.url
        t0 = time.time()
        while True:
            snap = json.loads(_get(base + "/slam"))
            if snap["frames"] >= frames and snap["keyframes"] >= 1:
                break
            assert time.time() - t0 < timeout, snap
            time.sleep(0.1)
        tum = _get(base + "/slam/trajectory").decode()
        js = json.loads(_get(base + "/slam/trajectory?format=json"))
        page = _get(base + "/live").decode()
    finally:
        app.shutdown()
    return app, snap, tum, js, page


@pytest.mark.parametrize("fused", [True, False])
def test_slam_routes(fused, pngs):
    flags = () if fused else ("--no-slam-fused",)
    app, snap, tum, js, page = _serve_slam(pngs, *flags)
    assert set(snap) == JAX_SNAPSHOT_KEYS | {"enabled"}
    assert snap["enabled"] and snap["fused"] == fused
    assert snap["errors"] == 0 and snap["fused_dropped"] == 0
    assert set(snap["stage_s"]) == {"vo", "ba", "loop", "graph"}
    assert len(snap["positions"]) == snap["positions_total"] >= 3
    lines = tum.strip().splitlines()
    assert len(lines) >= snap["positions_total"]
    rows = np.array([[float(v) for v in line.split()] for line in lines])
    assert rows.shape[1] == 8
    np.testing.assert_array_equal(rows[:, 0], np.arange(len(rows)))
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0,
                               atol=1e-5)
    xi = np.array(js["xi"])
    assert xi.shape[1] == 6 and len(xi) >= len(rows)
    assert np.isfinite(xi).all()
    # a static pair: the camera stays where it started
    assert np.abs(rows[:, 1:4]).max() < 0.05
    assert 'id="slamcv"' in page and "drawSlam" in page
    slam = app.slam_pipeline
    assert slam.fused == fused
    assert not slam._thread.is_alive()


def test_slam_checkpoint_dir_resumes(pngs, tmp_path):
    from steroscopic_hardware_tpu_torch.runtime import pipeline

    ckdir = str(tmp_path / "ck")
    argv = _argv(pngs, "--slam-checkpoint-dir", ckdir)
    app = build_app(argv)
    slam = app.slam_pipeline
    slam.checkpoint_every = 2
    app.start()
    try:
        t0 = time.time()
        while not (tmp_path / "ck").exists() or not list(
                (tmp_path / "ck").iterdir()):
            assert time.time() - t0 < 90, slam.snapshot()
            time.sleep(0.1)
    finally:
        app.shutdown()
    resumed_app = build_app(argv)
    try:
        resumed = resumed_app.slam_pipeline
        assert isinstance(resumed, pipeline.SlamPipeline)
        # the pipeline resumes at the engine's frame index (fused, a
        # checkpoint is named by TrackResults, which carry batches of
        # frames)
        assert resumed.frames == resumed.slam.frame_idx >= 2
        assert len(resumed.slam.vo.trajectory) == resumed.frames
        assert resumed.slam.kf_history
    finally:
        # never started: this closes its sources, socket and SLAM backend
        resumed_app.shutdown()


def test_slam_flags_take_the_jax_defaults():
    args = parse_args(["--slam"])
    assert (args.slam, args.slam_frontend, args.slam_fused) == (
        True, "sad", True)
    assert (args.fx, args.fy, args.cx, args.cy, args.baseline) == (
        500.0, 500.0, None, None, 0.1)
    assert (args.slam_checkpoint_dir, args.loop_closure,
            args.pg_horizon) == (None, False, None)
    args = parse_args(["--slam", "--slam-frontend", "sgm_half",
                       "--pg-horizon", "8", "--no-slam-fused"])
    assert (args.slam_frontend, args.pg_horizon, args.slam_fused) == (
        "sgm_half", 8, False)


def test_slam_probe_on_the_cpu(capsys):
    """The SLAM probe's parts on a tiny CPU run: the pose graph against
    itself (equal, repeatable, the bfloat16 control off), the sync run's
    BA windows solved again, the backend variants (a stub takes the sync
    run's time per call), and the live windows with both backends."""
    from steroscopic_hardware_tpu_torch import slam_probe

    assert slam_probe.main([
        "--device", "cpu", "--pg-seeds", "1", "--frames", "3", "--size",
        "120", "400", "--variants", "sync,async-sleep", "--live-size", "48",
        "160", "--live-seconds", "0.3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    rows = [json.loads(line) for line in lines[1:] if line.startswith("{")]
    pg = [r for r in rows if r["part"] == "pg"]
    assert [r["n_fixed"] for r in pg] == [None, 16]
    for r in pg:
        assert r["card_vs_cpu"] == 0.0 and r["card_repeat_equal"]
        assert r["bf16_control_vs_cpu"] > 1e-3
    ba = [r for r in rows if r["part"] == "ba"]
    assert ba and all(r["card_vs_cpu"] == 0.0 for r in ba)
    backend = [r for r in rows if r["part"] == "backend"]
    assert [r["variant"] for r in backend] == ["sync", "async-sleep"]
    assert backend[0]["ba_runs"] >= 1 and backend[0]["stub_ms"] is None
    assert backend[1]["stub_ms"][0] == pytest.approx(
        backend[0]["ba_ms_per_window"])
    live = [r for r in rows if r["part"] == "live"]
    assert [r["backend"] for r in live] == ["async", "sync"]
    assert all(r["errors"] == 0 and r["served_fps"] > 0 for r in live)
