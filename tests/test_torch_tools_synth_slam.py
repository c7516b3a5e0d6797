"""Parity of the port's SLAM stress tool (``tools/run_synth_slam.py``) with
the JAX package's tool on the CPU; the original is loaded from its path.

* ``render_sequence`` for each of the five suite conditions (4 frames):
  the same camera, ground truth within GT_TOL and frames within one grey
  level on at most RENDER_SHARE of a frame's pixels. The two differ only
  in the pose math of ``utils/synth.py``: the port's runs in numpy, the
  original's in XLA, whose float32 sin, cos and arccos differ from
  numpy's in the last bit, which moves a splatted patch's rounding on a
  pixel or two of some frames (the clean loop's frames are equal byte for
  byte).
* ``run_engines`` with the ``vo`` engine on the photometric loop (6
  frames) and both front ends, on the original's frames, the port fed the
  JAX StereoVO's RANSAC draws: the same tracking drops, ATE within
  ATE_TOL. (The loop's 6 frames circle it once, so most frames drop; a
  dropped frame's inlier count is that of a pose fitted to outliers and is
  not compared.)
* ``run_suite`` runs every condition x front end x engine and prints the
  original's table.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.models import slam as jslam
from steroscopic_hardware_tpu_torch.models import slam
from steroscopic_hardware_tpu_torch.tools import run_synth_slam as tool

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "jax_run_synth_slam", ROOT / "tools" / "run_synth_slam.py")
jtool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jtool)

GT_TOL = 1e-6         # m, ground-truth camera centres
RENDER_SHARE = 1e-4   # of a frame's pixels, each at most one grey level off
ATE_TOL = 1.5e-4      # m: 1e-4, and the original rounds to 4 decimals


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(frames, *flags):
    a = tool.parse_args(["--frames", str(frames), "--device", "cpu",
                         "--json", *flags])
    a.device = torch.device("cpu")
    return a


@pytest.mark.parametrize("label", [c for c, _ in tool.CONDITIONS])
def test_render_sequence_matches_the_original(label):
    a = tool.condition_args(_args(4), dict(tool.CONDITIONS)[label], "sad")
    cam, frames, gt = tool.render_sequence(a)
    jcam, jframes, jgt = jtool.render_sequence(a)
    assert (cam.fx, cam.fy, cam.cx, cam.cy, cam.baseline) == (
        jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.baseline)
    np.testing.assert_allclose(gt, np.asarray(jgt), rtol=0, atol=GT_TOL)
    assert len(frames) == len(jframes) == 4
    for pair, jpair in zip(frames, jframes):
        for img, jimg in zip(pair, jpair):
            assert img.dtype == np.uint8 and img.shape == (240, 320)
            diff = np.abs(img.astype(int) - jimg.astype(int))
            assert diff.max() <= 1
            assert (diff > 0).mean() <= RENDER_SHARE
    if label == "clean loop":
        assert all(np.array_equal(x, y) for p, q in zip(frames, jframes)
                   for x, y in zip(p, q))


def _jax_draws(self, ctr):
    """The JAX StereoVO's RANSAC draws for frame ``ctr``."""
    sub = jax.random.fold_in(jax.random.PRNGKey(self.seed), ctr)
    scores = jax.vmap(lambda k: jax.random.gumbel(
        k, (self.max_keypoints,)))(jax.random.split(sub, slam.N_HYPOTHESES))
    return torch.from_numpy(np.array(scores))


@pytest.mark.parametrize("frontend", ["sad", "sgm"])
def test_vo_drops_equal_the_jax_tool(monkeypatch, frontend):
    cond = dict(tool.CONDITIONS)["photometric loop"]
    a = tool.condition_args(_args(6), cond, frontend)
    jcam, jframes, jgt = jtool.render_sequence(a)
    want, = jtool.run_engines(a, jcam, jframes, jgt, {"vo": jslam.StereoVO(
        jcam, block_size=7, max_disparity=32, max_keypoints=128,
        fast_threshold=15, frontend=frontend)})
    monkeypatch.setattr(slam.StereoVO, "_ransac_scores", _jax_draws)
    cam, _, gt = tool.render_sequence(a)
    got, = tool.run_engines(a, cam, jframes, gt, ["vo"])
    assert (got["engine"], got["frontend"]) == ("vo", frontend)
    assert got["tracking_drops"] == want["tracking_drops"] > 0
    assert abs(got["ate_rmse_m"] - want["ate_rmse_m"]) <= ATE_TOL
    assert set(want) - set(got) <= {"graph_compiles"}


def test_suite_prints_its_table(capsys):
    rows = tool.run_suite(_args(2))
    assert len(rows) == len(tool.CONDITIONS) * 2 * len(tool.ENGINE_NAMES)
    assert {(r["condition"], r["frontend"], r["engine"]) for r in rows} == {
        (c, fe, e) for c, _ in tool.CONDITIONS for fe in ("sad", "sgm")
        for e in tool.ENGINE_NAMES}
    assert all(np.isfinite(r["ate_rmse_m"]) for r in rows)
    slam_rows = [r for r in rows if r["engine"] != "vo"]
    assert all(set(r["stage_s"]) == {"vo", "ba", "loop", "graph"}
               for r in slam_rows)
    out = capsys.readouterr().out
    table = out[out.index("| condition |"):].strip().splitlines()
    assert table[0] == ("| condition | frontend | engine | ATE (m) | drops "
                        "| loops |")
    assert len(table) == 2 + len(rows)
    assert table[2].startswith("| clean loop | sad | vo | ")
