"""Parity of the port's facade and host copies with the JAX package on the
CPU: ``despair`` (on the model of ``tests/test_despair_compat.py``, with
synthetic pairs), the ``sweep`` runner on a reduced envelope, the
``sad_golden`` copy, the PGM codec and the KITTI loader (round trips on
temporary files), and the ``utils.synth`` copy. Integer outputs exact.
"""

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu import despair as jdespair
from steroscopic_hardware_tpu.io import pgm as jpgm
from steroscopic_hardware_tpu.io.kitti import KittiOdometry as JKitti
from steroscopic_hardware_tpu.models.blockmatch import sweep as jsweep
from steroscopic_hardware_tpu.ops import sad_golden as jgolden
from steroscopic_hardware_tpu.utils import synth as jsynth
from steroscopic_hardware_tpu_torch import despair
from steroscopic_hardware_tpu_torch.io import kitti, pgm
from steroscopic_hardware_tpu_torch.io.png import write_png
from steroscopic_hardware_tpu_torch.models.blockmatch import sweep
from steroscopic_hardware_tpu_torch.models.slam import StereoCamera
from steroscopic_hardware_tpu_torch.ops import sad_golden
from steroscopic_hardware_tpu_torch.utils import synth
from steroscopic_hardware_tpu_torch.utils.params import Parameters


def _pair(seed, h, w, shift=3):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (h, w), dtype=np.uint8)
    return left, np.roll(left, -shift, axis=1)


@pytest.mark.parametrize("h,w,block,maxd", [(24, 40, 7, 16), (30, 64, 3, 32),
                                            (21, 37, 9, 48)])
def test_run_sad_bit_exact(h, w, block, maxd):
    left, right = _pair(h, h, w)
    out = despair.run_sad(left, right, block, maxd, device="cpu")
    assert out.dtype == np.uint8
    assert np.array_equal(out, jgolden.disparity_numpy(left, right, block,
                                                       maxd))
    assert np.array_equal(out, jdespair.run_sad(left, right, block, maxd))


def test_default_params_flow():
    despair.set_default_params(Parameters(5, 32))
    try:
        assert despair.default_params() == Parameters(5, 32)
        left, right = _pair(1, 16, 32)
        out = despair.run_sad(left, right, device="cpu")  # the defaults
        assert np.array_equal(out, jgolden.disparity_numpy(left, right, 5,
                                                           32))
    finally:
        despair.set_default_params(Parameters())
    assert despair.default_params() == Parameters()


def test_run_sad_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the no-fallback rule needs one "
                    "without")
    left, right = _pair(2, 16, 32)
    with pytest.raises(RuntimeError, match="cuda"):
        despair.run_sad(left, right, 3, 16)


def test_sum_absolute_differences():
    rng = np.random.default_rng(3)
    left = rng.integers(0, 256, (12, 14), dtype=np.uint8)
    right = rng.integers(0, 256, (12, 14), dtype=np.uint8)
    for lx, ly, rx, ry, b in [(5, 5, 3, 5, 7), (0, 0, 0, 0, 15),
                              (13, 11, 2, 11, 16)]:
        got = despair.sum_absolute_differences(left, right, lx, ly, rx, ry, b)
        assert got == jgolden.sad_window_golden_scalar(left, right, lx, ly,
                                                       rx, ry, b)
        assert got == jdespair.sum_absolute_differences(left, right, lx, ly,
                                                        rx, ry, b)


def test_sad_golden_copy_equals_original():
    left, right = _pair(4, 14, 20)
    for b, d in ((3, 4), (5, 8)):
        assert np.array_equal(sad_golden.disparity_numpy(left, right, b, d),
                              jgolden.disparity_numpy(left, right, b, d))
        assert np.array_equal(
            sad_golden.disparity_golden_scalar(left[:6, :9], right[:6, :9],
                                               b, d),
            jgolden.disparity_golden_scalar(left[:6, :9], right[:6, :9],
                                            b, d))


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(5).integers(0, 256, (10, 12), dtype=np.uint8)
    p = str(tmp_path / "g.png")
    despair.save_png(p, img)
    assert np.array_equal(despair.load_png(p), img)
    assert np.array_equal(jdespair.load_png(p), img)


def test_sweep_runner_reduced_envelope():
    left, right = _pair(6, 16, 40, 2)
    got = list(sweep(left, right, block_sizes=(3, 7, 9),
                     max_disparities=(16, 32), device="cpu"))
    want = list(jsweep(left, right, block_sizes=(3, 7, 9),
                       max_disparities=(16, 32), backend="xla"))
    assert len(got) == len(want) == 6
    for (p, out), (jp, jout) in zip(got, want):
        assert (p.block_size, p.max_disparity) == (jp.block_size,
                                                   jp.max_disparity)
        assert np.array_equal(out, np.asarray(jout))
        assert np.array_equal(out, jgolden.disparity_numpy(
            left, right, p.block_size, p.max_disparity))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_pgm_roundtrip(tmp_path, dtype):
    rng = np.random.default_rng(7)
    img = rng.integers(0, np.iinfo(dtype).max, (9, 13)).astype(dtype)
    p = str(tmp_path / "a.pgm")
    pgm.write_pgm(p, img)
    got = pgm.read_pgm(p)
    assert got.dtype == dtype and np.array_equal(got, img)
    assert np.array_equal(jpgm.read_pgm(p), img)
    q = str(tmp_path / "b.pgm")
    jpgm.write_pgm(q, img)
    with open(p, "rb") as a, open(q, "rb") as b:
        assert a.read() == b.read()


def test_pgm_ascii_with_comment(tmp_path):
    p = tmp_path / "c.pgm"
    p.write_bytes(b"P2\n# a comment\n3 2\n255\n1 2 3\n4 5 250\n")
    assert np.array_equal(pgm.read_pgm(str(p)),
                          np.array([[1, 2, 3], [4, 5, 250]], np.uint8))
    with pytest.raises(ValueError):
        pgm.write_pgm(str(p), np.zeros((2, 2, 3), np.uint8))


def _make_kitti(tmp_path, n_frames=3):
    rng = np.random.default_rng(8)
    seq = tmp_path / "sequences" / "04"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    (tmp_path / "poses").mkdir()
    fx, fy, cx, cy, b = 718.856, 718.856, 607.1928, 185.2157, 0.5372
    with open(seq / "calib.txt", "w") as f:
        f.write(f"P0: {fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0\n")
        f.write(f"P1: {fx} 0 {cx} {-fx * b} 0 {fy} {cy} 0 0 0 1 0\n")
        f.write("Tr: 1 0 0 0 0 1 0 0 0 0 1 0\nnot a matrix line\n")
    poses = []
    for i in range(n_frames):
        img = rng.integers(0, 256, (32, 96), dtype=np.uint8)
        write_png(str(seq / "image_0" / f"{i:06d}.png"), img)
        write_png(str(seq / "image_1" / f"{i:06d}.png"),
                  np.roll(img, -4, axis=1))
        poses.append([1, 0, 0, 0.1 * i, 0, 1, 0, 0, 0, 0, 1, 0.5 * i])
    np.savetxt(str(tmp_path / "poses" / "04.txt"), np.array(poses))
    return str(tmp_path), (fx, fy, cx, cy, b)


def test_kitti_sequence_roundtrip(tmp_path):
    root, (fx, fy, cx, cy, b) = _make_kitti(tmp_path)
    seq = kitti.KittiOdometry(root, "04")
    jseq = JKitti(root, "04")
    assert len(seq) == len(jseq) == 3
    cam = seq.stereo_camera()
    assert isinstance(cam, StereoCamera)
    assert np.allclose([cam.fx, cam.fy, cam.cx, cam.cy, cam.baseline],
                       [fx, fy, cx, cy, b])
    assert (seq.fx, seq.fy, seq.cx, seq.cy, seq.baseline) == (
        jseq.fx, jseq.fy, jseq.cx, jseq.cy, jseq.baseline)
    for i in range(3):
        for a, w in zip(seq.pair(i), jseq.pair(i)):
            assert a.shape == (32, 96) and np.array_equal(a, w)
    assert np.array_equal(seq.gt_positions(), jseq.gt_positions())
    assert np.allclose(seq.gt_positions()[:, 0], [0.0, 0.1, 0.2])
    calib = kitti.read_calib(f"{root}/sequences/04/calib.txt")
    assert set(calib) == {"P0", "P1", "Tr"}
    # a sequence without poses has no ground truth
    (tmp_path / "poses" / "04.txt").unlink()
    assert kitti.KittiOdometry(root, "04").gt_positions() is None


def test_synth_copy_renders_the_jax_frames():
    """The numpy copy of ``utils.synth`` renders the JAX module's frames
    (pose math in float32 on both sides; pixels may differ by one level
    where a value lands at a rounding boundary) and the same ground
    truth."""
    cam = StereoCamera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, baseline=0.4)
    for name in ("straight_trajectory", "loop_trajectory",
                 "helix_trajectory"):
        xis = getattr(synth, name)(5)
        jxis = getattr(jsynth, name)(5)
        np.testing.assert_allclose(np.stack(xis), np.stack(jxis), atol=1e-6)
        np.testing.assert_allclose(synth.gt_positions(xis),
                                   jsynth.gt_positions(jxis), atol=1e-5)
    scene = synth.SyntheticScene(cam, n_landmarks=40, seed=3, n_occluders=2)
    jscene = jsynth.SyntheticScene(cam, n_landmarks=40, seed=3, n_occluders=2)
    for xi in synth.loop_trajectory(4):
        for a, w in zip(scene.render_pair(xi), jscene.render_pair(xi)):
            diff = np.abs(a.astype(int) - w.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
