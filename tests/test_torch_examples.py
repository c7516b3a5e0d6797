"""The port's user-facing scripts on the CPU: the examples
(``python -m steroscopic_hardware_tpu_torch.examples.<name>``, the
counterparts of ``examples/``), ``utils/timing.py`` and the ``soak`` tool
(``serve_probe``'s modes are held in ``tests/test_torch_server.py``).

Where a JAX counterpart computes the same thing it runs on the same seeded
input: the map ``run_once`` writes is the JAX golden model's, ``lzma_cli``
writes the JAX codec's bytes, ``RollingTimer`` gives the JAX timer's
statistics. ``run_kitti_vo`` runs on a tiny synthetic sequence written to
``tmp_path`` in the KITTI layout and reports the ATE of the port's
``StereoVO`` over the same frames. Every script that computes runs on
``cuda`` unless ``--device cpu`` is given, and raises without a card.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.io import lzma_codec as jax_lzma
from steroscopic_hardware_tpu.models.blockmatch import (
    BlockMatcher as JaxBlockMatcher,
)
from steroscopic_hardware_tpu.ops.sad_golden import disparity_numpy
from steroscopic_hardware_tpu.utils.params import Parameters as JaxParameters
from steroscopic_hardware_tpu.utils.timing import (
    RollingTimer as JaxRollingTimer,
)
from steroscopic_hardware_tpu_torch import serve_probe, soak
from steroscopic_hardware_tpu_torch.examples import (
    list_ports,
    lzma_cli,
    run_kitti_vo,
    run_once,
    run_stream,
)
from steroscopic_hardware_tpu_torch.io.png import read_png, write_png
from steroscopic_hardware_tpu_torch.runtime.sources import list_serial_ports
from steroscopic_hardware_tpu_torch.utils.timing import (
    RollingTimer,
    profiler_trace,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # six test workers share the machine's cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_once_synthetic_writes_the_golden_map(tmp_path, capsys):
    out = str(tmp_path / "d.png")
    assert run_once.main([out, "--synthetic", "--size", "32", "96",
                          "--seed", "3", "--block", "7", "--disp", "32",
                          "--device", "cpu"]) == 0
    # the synthetic pair is serve_probe's seeded textured pair
    left, right = serve_probe.textured_pair(3, 32, 96)
    assert np.array_equal(read_png(out), disparity_numpy(left, right, 7, 32))
    assert "computed 96x32 disparity" in capsys.readouterr().out


def test_run_once_reads_a_png_pair(tmp_path, rng):
    left = rng.integers(0, 256, (24, 80), dtype=np.uint8)
    right = np.roll(left, -5, axis=1)
    lp, rp, out = (str(tmp_path / n) for n in ("l.png", "r.png", "o.png"))
    write_png(lp, left)
    write_png(rp, right)
    assert run_once.main([lp, rp, out, "--device", "cpu"]) == 0
    want = JaxBlockMatcher(JaxParameters(16, 64), backend="xla").compute(
        left, right)
    assert np.array_equal(read_png(out), want)
    for bad in ([], [lp], [lp, rp, out, out], [lp, rp, "--synthetic"]):
        with pytest.raises(SystemExit):
            run_once.main(bad + ["--device", "cpu"])


def test_run_stream_prints_frames_and_throughput(capsys, tmp_path):
    assert run_stream.main(["--synthetic", "--size", "24", "64", "-n", "5",
                            "--block", "5", "--disp", "16", "--device",
                            "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:5]] == [
        f"frame {i}" for i in range(5)]
    assert re.match(r"mean [\d.]+ ms  p50 [\d.]+ ms  [\d.]+ fps  "
                    r"[\d.]+ Mpix/s on cpu$", lines[5]), lines[5]
    lp = str(tmp_path / "l.png")
    write_png(lp, np.zeros((16, 32), np.uint8))
    assert run_stream.main(["--left", lp, "--right", lp, "-n", "1",
                            "--device", "cpu"]) == 0
    with pytest.raises(SystemExit):
        run_stream.main(["--left", lp, "--device", "cpu"])


def test_lzma_cli_roundtrip_with_the_jax_codec_bytes(tmp_path, capsys):
    data = b"stereo frames " * 300
    f = tmp_path / "x.bin"
    f.write_bytes(data)
    assert lzma_cli.main(["-c", "-k", "-l", "7", str(f)]) == 0
    blob = (tmp_path / "x.bin.lzma").read_bytes()
    assert blob == jax_lzma.compress_known_size(data, 7)
    f.unlink()
    assert lzma_cli.main(["-d", str(tmp_path / "x.bin.lzma")]) == 0
    assert f.read_bytes() == data
    assert not (tmp_path / "x.bin.lzma").exists()  # without -k
    assert "x.bin.lzma -> " in capsys.readouterr().out


def test_list_ports_prints_each_serial_port(capsys):
    rc = list_ports.main([])
    out = capsys.readouterr().out.splitlines()
    ports = list_serial_ports()
    assert (rc, out) == ((0, ports) if ports
                         else (1, ["no serial ports found"]))


def _kitti_sequence(root, n=5, size=(120, 320)):
    """A synthetic stereo sequence written in the KITTI odometry layout."""
    from steroscopic_hardware_tpu_torch.vo import synthetic_sequence

    cam, pairs, gt = synthetic_sequence(n, trajectory="straight", size=size,
                                        seed=3)
    seq = root / "sequences" / "04"
    for d in ("image_0", "image_1"):
        (seq / d).mkdir(parents=True)
    (root / "poses").mkdir()
    fx, fy, cx, cy, b = cam.fx, cam.fy, cam.cx, cam.cy, cam.baseline
    with open(seq / "calib.txt", "w") as f:
        f.write(f"P0: {fx!r} 0 {cx!r} 0 0 {fy!r} {cy!r} 0 0 0 1 0\n")
        f.write(f"P1: {fx!r} 0 {cx!r} {-fx * b!r} 0 {fy!r} {cy!r} 0 0 0 1 "
                "0\n")
    for i, (left, right) in enumerate(pairs):
        write_png(str(seq / "image_0" / f"{i:06d}.png"), left)
        write_png(str(seq / "image_1" / f"{i:06d}.png"), right)
    np.savetxt(str(root / "poses" / "04.txt"), np.array(
        [[1, 0, 0, p[0], 0, 1, 0, p[1], 0, 0, 1, p[2]] for p in gt]))
    return cam, pairs, gt


@pytest.mark.parametrize("slam", [False, True])
def test_run_kitti_vo_on_a_synthetic_kitti_sequence(tmp_path, capsys, slam):
    from steroscopic_hardware_tpu_torch.models.slam import StereoVO
    from steroscopic_hardware_tpu_torch.vo import run

    cam, pairs, gt = _kitti_sequence(tmp_path)
    args = [str(tmp_path), "04", "--frames", "4", "--max-disparity", "32",
            "--block", "7", "--device", "cpu"]
    assert run_kitti_vo.main(args + (["--slam"] if slam else [])) == 0
    out = capsys.readouterr().out
    assert "sequence 04: 5 frames" in out
    ate = float(re.search(r"ATE RMSE vs ground truth: ([\d.]+) m over 4 "
                          r"frames", out).group(1))
    if not slam:
        want = run(StereoVO(cam, block_size=7, max_disparity=32,
                            max_keypoints=512, fast_threshold=20,
                            device="cpu"), pairs[:4], gt)["ate"]
        assert ate == round(want, 3)
    assert ate < 0.1


def test_rolling_timer_equals_jax(rng):
    samples = rng.uniform(0.001, 0.05, 37)
    port, ref = RollingTimer(window=30), JaxRollingTimer(window=30)
    assert port.stats() == ref.stats() == {}
    for s in samples:
        port.add(float(s))
        ref.add(float(s))
    assert port.stats(pixels=640 * 480) == ref.stats(pixels=640 * 480)
    assert port.stats()["n"] == 30
    with port.measure():
        pass
    assert port.stats()["n"] == 30 and port.stats()["ms_max"] >= 0


def test_profiler_trace_writes_a_trace(tmp_path):
    with profiler_trace(str(tmp_path)):
        torch.ones(64).add_(1).sum()
    traces = [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("main,argv", [
    (run_once.main, ["--synthetic"]),
    (run_stream.main, ["--synthetic"]),
    (soak.main, ["--minutes", "0"]),
])
def test_entry_points_default_to_cuda_and_raise_without_it(main, argv):
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the no-fallback rule needs one "
                    "without")
    with pytest.raises((RuntimeError, SystemExit), match="cuda"):
        main(argv)


def test_soak_samples_the_slam_server_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "soak.json"
    assert soak.main(["--device", "cpu", "--size", "48", "160", "--minutes",
                      "0.15", "--interval", "3", "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    summary, series = doc["summary"], doc["series"]
    assert summary["samples"] == len(series) >= 2
    assert summary["sample_errors"] == 0 == summary["server_tracebacks"]
    # on a loaded CPU one tracked frame may outlast a sample interval (on
    # the card chip_smoke.py phase 10k gates growth at every sample)
    for a, b in zip(series, series[1:]):
        assert b["depth_frames"] >= a["depth_frames"]
        assert b["slam_poses"] >= a["slam_poses"]
    assert series[-1]["slam_poses"] > series[0]["slam_poses"]
    for s in series:
        # the JAX soak's fields, and the server's RSS
        assert {"t", "depth_fps_window", "slam_pose_fps_window",
                "keyframes", "loops_closed", "backend_pending", "stage_s",
                "ms_per_closure", "rss_mb"} <= set(s)
        assert s["rss_mb"] > 0 and s["gpu_mem_mb"] is None
        assert s["slam_errors"] == 0 == s["pipeline_errors"]
    assert summary["last"] == series[-1]
    assert os.path.exists(summary["log"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == summary

