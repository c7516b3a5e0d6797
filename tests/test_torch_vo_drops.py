"""Tracking drops of the port's ``StereoVO`` against the JAX package's on
the same synthetic loop, the port fed the JAX package's own RANSAC draws,
and where the drops come from.

A frame is dropped (the constant-velocity fallback) when its RANSAC PnP
ends with fewer than ``min_pnp_inliers`` (12) inliers. Per tracked frame
the table below holds, beside both inlier counts, the ratio-tested matches
against the previous frame, how many of them are inliers of the
ground-truth relative motion (reprojection error under 3 px) and how many
of the 32 minimal sets that the frame's draws pick hold only such inliers.

The tests, on a reduced KITTI-shaped loop: both packages drop the same
frames, their inlier counts agree on every tracked frame, and a frame is
dropped only where none of its 32 minimal sets is all inliers.

Run as a script, it does the same at KITTI odometry's frame geometry with
``chip_smoke.py`` phase 6v's sequence and settings (about 1 s a frame for
each package on the CPU) and prints the table and a JSON summary:

    env PYTHONPATH=. python tests/test_torch_vo_drops.py [--frames 40]
"""

import argparse
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from steroscopic_hardware_tpu.models import slam as jslam  # noqa: E402
from steroscopic_hardware_tpu_torch.models import slam  # noqa: E402
from steroscopic_hardware_tpu_torch.models.vo import (  # noqa: E402
    _reproj_residual,
)
from steroscopic_hardware_tpu_torch.ops import se3_np  # noqa: E402
from steroscopic_hardware_tpu_torch.ops.matching import match  # noqa: E402
from steroscopic_hardware_tpu_torch.utils.synth import (  # noqa: E402
    loop_trajectory,
)
from steroscopic_hardware_tpu_torch.vo import synthetic_sequence  # noqa: E402

INLIER_PX = 3.0  # pnp_ransac's inlier radius
SMOKE = dict(seed=20261016, size=(376, 1241), block_size=9,
             max_disparity=128, max_keypoints=512, fast_threshold=20)


class JaxDrawsVO(slam.StereoVO):
    """The port's StereoVO on the JAX StereoVO's RANSAC draws:
    ``fold_in(PRNGKey(seed), ctr)`` split into 32 Gumbel vectors."""

    def _ransac_scores(self, ctr):
        sub = jax.random.fold_in(jax.random.PRNGKey(self.seed), ctr)
        K = self.max_keypoints
        scores = jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(
            jax.random.split(sub, slam.N_HYPOTHESES))
        return torch.from_numpy(np.array(scores))


def _frame_row(prev, cur, scores, xi_prev, xi_cur, intr):
    """(matches, ground-truth inliers among them, all-inlier minimal sets)
    of one tracking step, from the two frames' host features."""
    t = torch.from_numpy
    idx, good = match(t(prev.desc), t(cur.desc), t(prev.valid),
                      t(cur.valid), ratio=0.9, max_distance=80.0)
    good = good & t(prev.pts_ok)
    uv = t(cur.xy_sub)[idx]
    xi_gt = t(se3_np.relative(xi_prev, xi_cur))
    err = _reproj_residual(xi_gt, t(prev.pts_cam), uv, intr).norm(dim=-1)
    true = (err < INLIER_PX) & good
    # pnp_ransac's minimal sets: the 4 valid matches of highest score
    ranked = torch.where(good, scores, float("-inf"))
    sets = torch.topk(ranked, 4, dim=-1).indices
    clean = int(true[sets].all(-1).sum())
    return int(good.sum()), int(true.sum()), clean


def drop_table(frames, *, seed, size, **vo_kw):
    """Both StereoVOs over a seeded ``frames``-frame loop; returns (rows,
    summary). A row: (frame, JAX inliers, port inliers, matches,
    ground-truth inliers, all-inlier sets of 32)."""
    cam, pairs, gt = synthetic_sequence(frames, trajectory="loop", size=size,
                                        seed=seed)
    xis = loop_trajectory(frames)
    jcam = jslam.StereoCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                              baseline=cam.baseline)
    jvo = jslam.StereoVO(jcam, seed=seed, **vo_kw)
    vo = JaxDrawsVO(cam, seed=seed, device="cpu", **vo_kw)
    rows = []
    for i, (left, right) in enumerate(pairs):
        prev = vo.prev
        jvo.process(left, right)
        vo.process(left, right)
        if i:
            rows.append((i, jvo.n_inliers[-1], vo.n_inliers[-1],
                         *_frame_row(prev, vo.prev, vo._ransac_scores(i),
                                     xis[i - 1], xis[i], cam.intr)))
    share = [r[4] / max(r[3], 1) for r in rows]
    summary = {
        "frames": frames, "size": list(size),
        "drops_jax": jvo.tracking_drops, "drops_port": vo.tracking_drops,
        "dropped_jax": [r[0] for r in rows if r[1] < vo.min_pnp_inliers],
        "dropped_port": [r[0] for r in rows if r[2] < vo.min_pnp_inliers],
        "no_clean_set": [r[0] for r in rows if r[5] == 0],
        "inlier_share_min": min(share),
        "inlier_share_median": float(np.median(share)),
        # the chance that none of 32 minimal sets is all inliers, summed
        # over the frames (draws with replacement; an estimate)
        "expected_no_clean_set": float(sum(
            (1 - s**4) ** slam.N_HYPOTHESES for s in share)),
        "ate_jax": jslam.ate_rmse(jvo.positions(), gt),
        "ate_port": slam.ate_rmse(vo.positions(), gt),
    }
    return rows, summary


@pytest.fixture(scope="module")
def reduced():
    """The smoke's loop over 16 frames at half KITTI's width and height
    (the intrinsics scaled with it), maxDisparity 64, 256 keypoints: on
    these draws it drops two frames."""
    return drop_table(16, seed=SMOKE["seed"], size=(188, 620), block_size=9,
                      max_disparity=64, max_keypoints=256, fast_threshold=20)


def test_port_drops_the_frames_jax_drops(reduced):
    rows, s = reduced
    assert s["dropped_jax"], "the reduced loop drops no frame"
    assert s["dropped_port"] == s["dropped_jax"], s
    assert s["drops_port"] == s["drops_jax"] == len(s["dropped_jax"])
    for frame, n_jax, n_port, *_ in rows:
        if frame not in s["dropped_jax"]:
            assert n_port == n_jax, (frame, n_port, n_jax)


def test_drops_only_where_no_minimal_set_is_clean(reduced):
    rows, s = reduced
    assert set(s["dropped_port"]) <= set(s["no_clean_set"]), s
    for frame, _, n_port, matches, n_true, clean in rows:
        assert n_true <= matches
        if clean:
            # a clean minimal set converges onto the true motion's inliers
            assert n_port >= n_true - 2, (frame, n_port, n_true)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    rows, summary = drop_table(args.frames, **SMOKE)
    print("frame  jax  port  matches  gt_inliers  clean_sets/32")
    for r in rows:
        print("%5d %4d %5d %8d %11d %14d" % r)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
