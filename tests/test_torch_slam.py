"""Parity of the port's tracking step and of ``StereoVO`` as a whole with
the JAX package on the CPU (``models/slam.py``).

* ``_frame_frontend`` / ``_track_step`` for the "sad" and "sgm" front
  ends on one rendered pair (and its predecessor), the RANSAC fed the JAX
  package's own Gumbel draws: keypoints, validity, triangulation validity
  and the inlier count exact; subpixel positions 1e-6 px; descriptor bits
  ORB_BIT_SHARE; points 1e-5 relative; the relative twist XI_TOL.
* The slice on the setup of ``tests/test_slam.py`` (240x320, 6
  straight-trajectory frames, block 7, maxDisparity 32, 128 keypoints,
  FAST 15): ``StereoVO(device="cpu")`` meets that test's gates (minimum
  inliers >= 15, ATE < 0.12) and its camera centres stay within
  TRAJ_TOL of the JAX ``StereoVO``'s on the same frames. The two draw
  their RANSAC scores from different generators, so they agree only up
  to the refinement's convergence.
"""

import jax
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.models import slam as jslam
from steroscopic_hardware_tpu.utils.synth import (
    SyntheticScene,
    gt_positions,
    straight_trajectory,
)
from steroscopic_hardware_tpu_torch.models import slam
from steroscopic_hardware_tpu_torch.models.slam import StereoCamera, StereoVO

ORB_BIT_SHARE = 0.999
XI_TOL = 1e-4
TRAJ_TOL = 1e-4  # m, camera centres of the port's and the JAX StereoVO

CAM = StereoCamera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, baseline=0.4)
JCAM = jslam.StereoCamera(fx=240.0, fy=240.0, cx=160.0, cy=120.0,
                          baseline=0.4)
H, W = 240, 320
STATIC = dict(block_size=7, max_disparity=32, fast_threshold=15,
              max_keypoints=128, intr=CAM.intr, baseline=CAM.baseline)


def _frames(n):
    """tests/test_slam.py's scene: 60 landmarks, seeded from its ``rng``
    fixture's first draw."""
    seed = int(np.random.default_rng(1234).integers(0, 2**31))
    scene = SyntheticScene(JCAM, size=(H, W), n_landmarks=60, seed=seed)
    xis = straight_trajectory(n)
    return [scene.render_pair(xi) for xi in xis], gt_positions(xis)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_features(got, want):
    xy, xy_sub, desc, valid, pts, ok = (g.numpy() for g in got)
    wxy, wsub, wdesc, wvalid, wpts, wok = (np.asarray(w) for w in want)
    assert np.array_equal(xy, wxy)
    assert np.array_equal(valid, wvalid)
    assert np.abs(xy_sub - wsub).max() <= 1e-6
    share = float((desc == wdesc).mean())
    assert share >= ORB_BIT_SHARE, share
    assert np.array_equal(ok, wok)
    assert ok.sum() >= 20
    np.testing.assert_allclose(pts[ok], wpts[ok], rtol=1e-5)


@pytest.mark.parametrize("frontend", ["sad", "sgm"])
def test_track_step_equals_jax(frontend):
    (p0, p1), _ = _frames(2)
    kw = dict(STATIC, frontend=frontend)
    prev = slam._frame_frontend(_t(p0[0]), _t(p0[1]), **kw)
    jprev = jslam._frame_frontend(p0[0], p0[1], use_pallas=False, **kw)
    _check_features(prev, jprev)

    key = jax.random.PRNGKey(0)
    ctr = 3
    sub = jax.random.fold_in(key, ctr)
    K = STATIC["max_keypoints"]
    scores = jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(
        jax.random.split(sub, slam.N_HYPOTHESES))
    want = jslam._track_step(p1[0], p1[1], *jprev[2:], key, ctr,
                             use_pallas=False, **kw)
    # the same previous features on both sides
    got = slam._track_step(_t(p1[0]), _t(p1[1]),
                           *(_t(a) for a in jprev[2:]), _t(scores), **kw)
    _check_features(got[:6], want[:6])
    assert int(got[7]) == int(want[7]) >= 15
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[6]),
                               atol=XI_TOL)


def test_sgm_half_frontend_equals_jax():
    (p0,), _ = _frames(1)
    kw = dict(STATIC, frontend="sgm_half")
    got = slam._frame_frontend(_t(p0[0]), _t(p0[1]), **kw)
    want = jslam._frame_frontend(p0[0], p0[1], use_pallas=False, **kw)
    _check_features(got, want)


def test_stereo_vo_slice_matches_jax_and_gates():
    frames, gt = _frames(6)
    vo = StereoVO(CAM, block_size=7, max_disparity=32, max_keypoints=128,
                  fast_threshold=15, device="cpu")
    jvo = jslam.StereoVO(JCAM, block_size=7, max_disparity=32,
                         max_keypoints=128, fast_threshold=15)
    for left, right in frames:
        vo.process(left, right)
        jvo.process(left, right)
    # the gates of tests/test_slam.py::test_stereo_vo_recovers_trajectory
    assert min(vo.n_inliers[1:]) >= 15
    ate = slam.ate_rmse(vo.positions(), gt)
    assert ate < 0.12, f"ATE {ate}"
    assert vo.tracking_drops == 0
    dev = np.abs(vo.positions() - jvo.positions()).max()
    assert dev <= TRAJ_TOL, dev
    assert abs(ate - jslam.ate_rmse(jvo.positions(), gt)) <= TRAJ_TOL


def test_stereo_vo_reproducible_and_resumes_from_host_state():
    frames, _ = _frames(3)
    runs = []
    for _ in range(2):
        vo = StereoVO(CAM, block_size=7, max_disparity=32, max_keypoints=128,
                      fast_threshold=15, device="cpu", seed=5)
        for left, right in frames:
            vo.process(left, right)
        runs.append(np.stack(vo.trajectory))
    assert np.array_equal(runs[0], runs[1])
    # dropping the device-resident features rebuilds them from the host
    # FrameState with the same result
    vo = StereoVO(CAM, block_size=7, max_disparity=32, max_keypoints=128,
                  fast_threshold=15, device="cpu", seed=5)
    for i, (left, right) in enumerate(frames):
        vo._prev_dev = None if i == 2 else vo._prev_dev
        vo.process(left, right)
    assert np.array_equal(np.stack(vo.trajectory), runs[0])


def test_stereo_vo_rejects_unknown_frontend():
    with pytest.raises(ValueError, match="frontend"):
        StereoVO(CAM, frontend="census", device="cpu")


def test_ate_rmse_equals_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(0, 1, (20, 3))
    b = a + rng.normal(0, 0.05, (20, 3))
    assert abs(slam.ate_rmse(a, b) - jslam.ate_rmse(a, b)) < 1e-12
