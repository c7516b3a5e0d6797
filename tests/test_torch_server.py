"""The port's HTTP server end to end on the CPU (``--device cpu``, the plain
torch versions): a 48x160 synthetic pair booted from PNGs through
``__main__.build_app``, the routes and status codes of the JAX server, and
``/stream/out`` held exactly to the JAX ``BlockMatcher(backend="xla")`` and,
with ``--backend sgm``, to the JAX ``SGMMatcher``."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from steroscopic_hardware_tpu.io.png import read_png, write_png
from steroscopic_hardware_tpu.models.blockmatch import (
    BlockMatcher as JaxBlockMatcher,
)
from steroscopic_hardware_tpu.utils.params import Parameters
from steroscopic_hardware_tpu_torch.__main__ import build_app

H, W = 48, 160


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read(), dict(r.headers)


def _post(url, data: bytes, ctype="application/x-www-form-urlencoded"):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=5.0) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _frames(base) -> int:
    return json.loads(_get(base + "/metrics")[1])["pipeline"]["frames"]


def _wait_frames(base, n, timeout=30.0):
    t0 = time.time()
    while _frames(base) < n:
        assert time.time() - t0 < timeout, "pipeline produced no frames"
        time.sleep(0.05)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    rng = np.random.default_rng(1234)
    left = rng.integers(0, 256, (H, W), dtype=np.uint8)
    right = np.clip(np.roll(left, -6, axis=1).astype(int)
                    + rng.integers(-2, 3, (H, W)), 0, 255).astype(np.uint8)
    d = tmp_path_factory.mktemp("pair")
    write_png(str(d / "l.png"), left)
    write_png(str(d / "r.png"), right)
    app = build_app(["--left", str(d / "l.png"), "--right", str(d / "r.png"),
                     "--device", "cpu", "--port", "0", "--no-open",
                     "--fps", "15"]).start()
    try:
        _wait_frames(app.url, 1)
        yield app.url, left, right
    finally:
        app.shutdown()


def test_checkhealth_and_live(served):
    base, _, _ = served
    status, body, _ = _get(base + "/checkhealth")
    assert status == 200 and body == b"OK"
    status, body, _ = _get(base + "/live")
    assert status == 200 and b"stereo depth" in body


def test_metrics_and_params(served):
    base, _, _ = served
    status, body, headers = _get(base + "/metrics")
    m = json.loads(body)
    assert status == 200 and headers["Content-Type"] == "application/json"
    assert m["pipeline"]["frames"] >= 1 and m["pipeline"]["errors"] == 0
    assert m["pipeline"]["device_s"] is None  # no device time on the CPU
    assert set(m["sources"]) == {"left", "right"}
    assert json.loads(_get(base + "/params")[1]) == {
        "blockSize": 16, "maxDisparity": 64}


def test_stream_out_matches_jax(served):
    base, left, right = served
    status, body, headers = _get(base + "/stream/out")
    assert status == 200 and headers["Content-Type"] == "image/png"
    want = JaxBlockMatcher(Parameters(16, 64), backend="xla").compute(
        left, right)
    assert np.array_equal(read_png(body), want)
    depth = read_png(_get(base + "/stream/depth")[1])
    assert depth.shape == (H, W, 3)


def test_update_params_retunes_the_stream(served):
    base, left, right = served
    status, body = _post(base + "/update-params",
                         b"blockSize=7&maxDisparity=128")
    assert status == 200
    assert json.loads(body) == {"blockSize": 7, "maxDisparity": 128}
    assert json.loads(_get(base + "/params")[1])["blockSize"] == 7
    # frames of batches started after the update (a batch holds <= 8)
    _wait_frames(base, _frames(base) + 17)
    want = JaxBlockMatcher(Parameters(7, 128), backend="xla").compute(
        left, right)
    assert np.array_equal(read_png(_get(base + "/stream/out")[1]), want)
    for bad in (b"blockSize=8&maxDisparity=64",     # even block
                b"blockSize=7&maxDisparity=100",    # not a multiple of 16
                b"blockSize=x&maxDisparity=64"):
        status, body = _post(base + "/update-params", bad)
        assert status == 400 and "error" in json.loads(body)
    assert json.loads(_get(base + "/params")[1])["blockSize"] == 7


def test_slam_not_enabled_and_unknown_routes(served):
    base, _, _ = served
    for path in ("/slam", "/slam/trajectory", "/stream/nope", "/nope"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + path)
        assert e.value.code == 404
        if path.startswith("/slam"):
            assert json.loads(e.value.read()) == {"enabled": False}


def test_upload_swaps_the_camera(served):
    base, left, _ = served
    png = write_png(None, left[:, ::-1].copy())
    boundary = "XbOuNdArY"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"type\"\r\n\r\nright\r\n--{boundary}\r\n"
            f"Content-Disposition: form-data; name=\"image\"; "
            f"filename=\"r.png\"\r\nContent-Type: image/png\r\n\r\n"
            ).encode() + png + f"\r\n--{boundary}--\r\n".encode()
    status, resp = _post(base + "/upload", body,
                         f"multipart/form-data; boundary={boundary}")
    assert status == 200
    assert json.loads(resp) == {"uploaded": "right", "shape": [H, W]}
    status, _ = _post(base + "/upload", b"type=left",
                      "application/x-www-form-urlencoded")
    assert status == 400  # missing image field


def test_serve_probe_on_the_cpu(capsys):
    """The serving probe drives build_app per mode and reports a window of
    /metrics; on the CPU there is no device time to report."""
    from steroscopic_hardware_tpu_torch import serve_probe

    assert serve_probe.main([
        "--device", "cpu", "--height", "24", "--width", "64", "--fps", "30",
        "--seconds", "0.3", "--modes", "default,lr-check"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    rows = [json.loads(line) for line in lines[1:]]
    assert [r["mode"] for r in rows] == ["default", "lr-check"]
    for r in rows:
        assert r["errors"] == 0 and r["fps"] > 0 and r["frames"] > 0
        assert r["lat_serve_p50"] is not None and "device_busy" not in r


def test_serve_probe_ingest_slam_and_rig_modes(capsys):
    """The modes of tools/serve_bench.py: TCP emitters attached through
    /{left,right}/configure (the native parser, the wire bytes per frame),
    a second rig (both rigs' fps in one window) and live SLAM."""
    from steroscopic_hardware_tpu_torch import serve_probe

    assert serve_probe.main([
        "--device", "cpu", "--height", "24", "--width", "64", "--fps", "30",
        "--seconds", "0.5", "--modes", "tcp-raw,tcp-lzma,dual-rig,slam"]) == 0
    rows = {r["mode"]: r for r in map(
        json.loads, capsys.readouterr().out.splitlines()[1:])}
    assert set(rows) == {"tcp-raw", "tcp-lzma", "dual-rig", "slam"}
    for r in rows.values():
        assert r["errors"] == 0
        assert all(v > 0 for v in r["source_rates"].values())
    assert set(rows["dual-rig"]["source_rates"]) == {
        "left", "right", "rig2.left", "rig2.right"}
    for mode in ("tcp-raw", "tcp-lzma"):
        assert rows[mode]["parsers"] == ["NativeFrameParser"]
        assert rows[mode]["wire_bytes_per_frame"] > 24 * 64
        assert rows[mode]["frames"] > 0
    assert rows["dual-rig"]["rig2_frames"] > 0
    assert rows["dual-rig"]["both_rigs_fps"] == pytest.approx(
        rows["dual-rig"]["fps"] + rows["dual-rig"]["rig2_fps"])
    assert rows["slam"]["slam_errors"] == 0
    assert rows["slam"]["slam_keyframes"] >= 1


@pytest.mark.parametrize("flags", [["--backend", "xla"]])
def test_unported_flags_exit_with_an_error(flags, capsys):
    """--backend xla has no counterpart here (--device cpu runs the plain
    torch versions); every other flag of the JAX server is ported."""
    with pytest.raises(SystemExit) as e:
        build_app(["--device", "cpu", "--no-open", "--port", "0", *flags])
    assert e.value.code == 2
    assert flags[0] in capsys.readouterr().err


def _rig_file(tmp_path):
    from steroscopic_hardware_tpu_torch.io.calib import save_calibration

    path = str(tmp_path / "rig.json")
    K = np.array([[200.0, 0, 85.0], [0, 200.0, 22.0], [0, 0, 1]])
    save_calibration(path, K1=K, K2=K, R=np.eye(3), T=[-0.15, 0.0, 0.01],
                     size=(40, 144), dist1=[-0.1, 0.01, 0.0, 0.0, 0.0])
    return path


@pytest.mark.parametrize("flags", [
    ["--calib", "rig.json", "--slam"],
    ["--calib", "rig.json", "--slam-frontend", "sgm"],
    ["--calib", "rig.json", "--no-slam-fused"],
    ["--calib", "rig.json"], ["--calib", "rig.json", "--loop-closure"],
    ["--calib", "rig.json", "--pg-horizon", "8"],
    ["--calib", "rig.json", "--fx", "500"],
])
def test_calib_flags_build_an_app_with_a_rectifier(flags, tmp_path):
    """--calib (rectification) with each SLAM flag builds the server: one
    rectifier on --device, handed to the depth pipeline (and to the SLAM
    pipeline), and with --slam the camera from the rectified rig (K_new
    and the baseline, not --fx)."""
    path = _rig_file(tmp_path)
    flags = [path if f == "rig.json" else f for f in flags]
    app = build_app(["--device", "cpu", "--no-open", "--port", "0", *flags])
    try:
        rect = app.rectifier
        assert rect is not None and rect.device.type == "cpu"
        assert rect.size == (40, 144) and rect.baseline == pytest.approx(
            np.hypot(0.15, 0.01))
        assert app.server.ctx.pipeline.rectifier is rect
        if "--slam" in flags:
            slam = app.slam_pipeline
            assert slam.rectifier is rect
            cam = slam.slam.cam
            assert (cam.fx, cam.fy, cam.cx, cam.cy, cam.baseline) == (
                200.0, 200.0, 72.0, 20.0, rect.baseline)
        else:
            assert app.slam_pipeline is None
    finally:
        app.shutdown()


def test_prewarm_warms_the_calibrated_size(tmp_path, monkeypatch):
    """--prewarm with --calib warms the rectified size the matcher sees,
    not the raw frames' shape (the JAX server warms the raw shape)."""
    from steroscopic_hardware_tpu_torch.models.blockmatch import BlockMatcher

    rng = np.random.default_rng(5)
    write_png(str(tmp_path / "l.png"),
              rng.integers(0, 256, (H, W), dtype=np.uint8))
    warmed = []
    monkeypatch.setattr(BlockMatcher, "warmup",
                        lambda self, shape, *a, **k: warmed.append(shape))
    app = build_app(["--device", "cpu", "--no-open", "--port", "0",
                     "--left", str(tmp_path / "l.png"), "--right",
                     str(tmp_path / "l.png"), "--calib",
                     _rig_file(tmp_path), "--prewarm"]).start()
    try:
        t0 = time.time()
        while not warmed:
            assert time.time() - t0 < 10
            time.sleep(0.01)
    finally:
        app.shutdown()
    assert warmed == [(40, 144)]


@pytest.mark.parametrize("colorize,host_colorize,k,lr", [
    (True, True, 1, False), (True, True, 2, False), (True, False, 1, False),
    (True, False, 2, True), (False, True, 1, True),
])
def test_pipeline_step_publishes_depth_and_preview(rng, colorize,
                                                   host_colorize, k, lr):
    """One synchronous pipeline step in each colorize mode: ``out`` holds
    the JAX matcher's map, ``depth`` the Turbo preview (host LUT exact,
    device colorize within 1 level of ``colorize_disparity_jax``)."""
    from steroscopic_hardware_tpu.ops import colorize as jax_colorize
    from steroscopic_hardware_tpu.runtime.bus import FrameBus
    from steroscopic_hardware_tpu_torch.models.blockmatch import BlockMatcher
    from steroscopic_hardware_tpu_torch.runtime.pipeline import (
        DepthPipeline,
        _mean_pool2d,
    )

    left = rng.integers(0, 256, (24, 50), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    bus = FrameBus()
    bus.publish("left", left, source="test")
    bus.publish("right", right, source="test")
    pipe = DepthPipeline(bus, BlockMatcher(Parameters(5, 16), device="cpu"),
                         lr_check=lr, colorize=colorize,
                         host_colorize=host_colorize, preview_scale=k)
    pipe.step()
    ref = JaxBlockMatcher(Parameters(5, 16), backend="xla")
    want = (ref.compute_checked(left, right)[0] if lr
            else ref.compute(left, right))
    assert np.array_equal(bus.latest("out").data, want)
    assert pipe.frames == pipe.batches == 1
    if not colorize:
        assert bus.latest("depth") is None
        return
    rgb = bus.latest("depth").data
    if host_colorize:
        assert np.array_equal(rgb, jax_colorize.colorize_disparity_lut(
            _mean_pool2d(want, k)))
    else:
        ref_rgb = np.asarray(jax_colorize.colorize_disparity_jax(
            jax_colorize.downscale_u8_jax(want, k)))
        assert rgb.shape == ref_rgb.shape
        assert np.abs(rgb.astype(int) - ref_rgb.astype(int)).max() <= 1


# -- --backend sgm ------------------------------------------------------------

@pytest.fixture(scope="module")
def served_sgm(tmp_path_factory):
    rng = np.random.default_rng(4321)
    left = rng.integers(0, 256, (H, W), dtype=np.uint8)
    right = np.clip(np.roll(left, -6, axis=1).astype(int)
                    + rng.integers(-2, 3, (H, W)), 0, 255).astype(np.uint8)
    d = tmp_path_factory.mktemp("sgm_pair")
    write_png(str(d / "l.png"), left)
    write_png(str(d / "r.png"), right)
    app = build_app(["--left", str(d / "l.png"), "--right", str(d / "r.png"),
                     "--backend", "sgm", "--device", "cpu", "--port", "0",
                     "--no-open", "--fps", "15", "--prewarm"]).start()
    try:
        _wait_frames(app.url, 1)
        yield app, left, right
    finally:
        app.shutdown()


def test_sgm_stream_out_matches_jax_and_retunes(served_sgm):
    """/stream/out of the SGM server equals the JAX SGMMatcher, before and
    after /update-params sets maxDisparity 32."""
    from steroscopic_hardware_tpu.models.blockmatch import (
        SGMMatcher as JaxSGMMatcher,
    )
    from steroscopic_hardware_tpu_torch.models.blockmatch import SGMMatcher

    app, left, right = served_sgm
    base = app.url
    assert isinstance(app.matcher, SGMMatcher)
    want = JaxSGMMatcher(Parameters(16, 64)).compute(left, right)
    assert np.array_equal(read_png(_get(base + "/stream/out")[1]), want)
    status, body = _post(base + "/update-params",
                         b"blockSize=7&maxDisparity=32")
    assert status == 200
    assert json.loads(body) == {"blockSize": 7, "maxDisparity": 32}
    _wait_frames(base, _frames(base) + 17)
    want = JaxSGMMatcher(Parameters(7, 32)).compute(left, right)
    assert np.array_equal(read_png(_get(base + "/stream/out")[1]), want)
    m = json.loads(_get(base + "/metrics")[1])["pipeline"]
    assert m["errors"] == 0 and m["max_disparity"] == 32


def test_sgm_pipeline_step_lr_matches_jax(rng):
    """One pipeline step of the SGM engine with the LR check: the served
    map is the JAX SGMMatcher's, masked to 255 where the check fails."""
    from steroscopic_hardware_tpu.models.blockmatch import (
        SGMMatcher as JaxSGMMatcher,
    )
    from steroscopic_hardware_tpu_torch.models.blockmatch import SGMMatcher
    from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
    from steroscopic_hardware_tpu_torch.runtime.pipeline import DepthPipeline

    left = rng.integers(0, 256, (24, 50), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    bus = FrameBus()
    bus.publish("left", left, source="test")
    bus.publish("right", right, source="test")
    pipe = DepthPipeline(bus, SGMMatcher(Parameters(5, 16), device="cpu"),
                         lr_check=True)
    pipe.step()
    want = JaxSGMMatcher(Parameters(5, 16)).compute_checked(left, right)[0]
    assert np.array_equal(bus.latest("out").data, want)
    assert (want == 255).any() and pipe.frames == 1


def test_sgm_backend_cuda_raises_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the no-fallback rule needs one "
                    "without")
    with pytest.raises(RuntimeError, match="cuda"):
        build_app(["--backend", "sgm", "--device", "cuda", "--port", "0",
                   "--no-open"])
