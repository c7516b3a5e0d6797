"""Stereo visual odometry, the tracking half of ``models/slam.py``:
``StereoCamera``, ``FrameState``, ``_frame_frontend``, ``_track_step``,
``StereoVO`` and ``ate_rmse``.

Per frame: a disparity sweep with subpixel refinement and the
right-referenced map (``frontend`` "sad": B2 with costs, ``_kernels.sad_lr``
on a CUDA device; "sgm" / "sgm_half": the census + SGM chain, B3 and B4)
-> FAST / ORB on the left image -> LR-gated stereo triangulation ->
matching against the previous frame's features -> RANSAC PnP -> pose
accumulation on the host. The stages run under ``torch.profiler``
labels (``vo.disparity``, ``vo.features``, ``vo.triangulate``,
``vo.match``, ``vo.pnp``), so a profile splits a frame's device time by
stage.

A ``StereoVO`` owns an explicit ``torch.device``: "cuda" needs a usable GPU
and raises without one; only an explicit "cpu" runs the plain versions.
Each frame crosses to the device in one upload; the previous frame's
(desc, valid, pts, ok) stay on the device between frames and only the
frame's results come back. The RANSAC draws come from a
``torch.Generator`` on the device, seeded from ``seed`` and the frame
counter, so a run is reproducible.

The keyframe BA, loop closure and pose graph of ``StereoSLAM``, and the
fused serve+track ingestion, are not ported yet.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch
from torch.profiler import record_function

from steroscopic_hardware_tpu_torch.models.blockmatch import resolve_device
from steroscopic_hardware_tpu_torch.models.vo import (
    gumbel_scores,
    pnp_ransac,
    triangulate_stereo,
)
from steroscopic_hardware_tpu_torch.ops import se3_np
from steroscopic_hardware_tpu_torch.ops.colorize import downscale_u8
from steroscopic_hardware_tpu_torch.ops.features import detect_and_describe
from steroscopic_hardware_tpu_torch.ops.matching import match
from steroscopic_hardware_tpu_torch.ops.sad import disparity_subpixel
from steroscopic_hardware_tpu_torch.ops.sgm import sgm_disparity_lr

FRONTENDS = ("sad", "sgm", "sgm_half")
N_HYPOTHESES = 32  # RANSAC hypotheses a frame, as the JAX _track_step


@dataclasses.dataclass
class StereoCamera:
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float

    @property
    def intr(self):
        return (self.fx, self.fy, self.cx, self.cy)


@dataclasses.dataclass
class FrameState:
    xy: np.ndarray       # (K, 2) int32 (indexing maps / descriptors)
    xy_sub: np.ndarray   # (K, 2) float32 subpixel positions (observations)
    desc: np.ndarray     # (K, 256)
    valid: np.ndarray    # (K,)
    pts_cam: np.ndarray  # (K, 3) camera-frame 3D from stereo
    pts_ok: np.ndarray   # (K,) triangulation validity
    xi_world: np.ndarray  # (6,) world->camera twist of this frame


def _disparities(left, right, *, block_size, max_disparity, frontend):
    """(dL float32 subpixel, dR right-referenced) of a (H, W) pair."""
    if frontend == "sad":
        return disparity_subpixel(left, right, block_size=block_size,
                                  max_disparity=max_disparity)
    if frontend == "sgm":
        dL, dR = sgm_disparity_lr(left, right, max_disparity=max_disparity,
                                  subpixel=True)
        return dL, dR.to(torch.float32)
    # sgm_half: SGM at half resolution (half the disparity range covers
    # the same depths), disparities upsampled 2x for keypoint sampling
    dLh, dRh = sgm_disparity_lr(
        downscale_u8(left, 2), downscale_u8(right, 2),
        max_disparity=max(16, max_disparity // 2), subpixel=True)
    H, W = left.shape

    def up2(d):
        return (d.to(torch.float32) * 2.0).repeat_interleave(
            2, 0).repeat_interleave(2, 1)[:H, :W]

    return up2(dLh), up2(dRh)


def _at(img, ys, xs):
    """img[ys, xs] with the indices clamped into the map, as a JAX gather
    clamps them (the half-resolution maps lose an odd last row/column)."""
    return img[ys.clamp(0, img.shape[0] - 1), xs.clamp(0, img.shape[1] - 1)]


def _frame_frontend(left, right, *, block_size, max_disparity,
                    fast_threshold, max_keypoints, intr, baseline,
                    frontend="sad"):
    """The per-frame front end of a uint8 (H, W) pair on its device:
    subpixel LR disparity -> FAST / ORB -> LR-consistency-gated stereo
    triangulation. The right-referenced map gates triangulation so
    occluded or mismatched keypoints never become landmarks.
    Returns (xy, xy_sub, desc, valid, pts, ok)."""
    if frontend not in FRONTENDS:
        raise ValueError(f"unknown frontend {frontend!r}")
    with record_function("vo.disparity"):
        dL, dR = _disparities(left, right, block_size=block_size,
                              max_disparity=max_disparity, frontend=frontend)
    with record_function("vo.features"):
        feats = detect_and_describe(left, threshold=fast_threshold,
                                    max_keypoints=max_keypoints)
    with record_function("vo.triangulate"):
        xy = feats["xy"].long()
        d_at = _at(dL, xy[:, 1], xy[:, 0])                 # float32 subpixel
        W = left.shape[-1]
        xr = (xy[:, 0] - torch.round(d_at).to(torch.int64)).clamp(0, W - 1)
        # pyramid disparities are 2x-quantized before subpixel, so the LR
        # gate gets a proportionally wider tolerance
        lr_tol = 2.0 if frontend == "sgm_half" else 1.0
        lr_ok = (d_at - _at(dR, xy[:, 1], xr)).abs() <= lr_tol
        fx, fy, cx, cy = intr
        pts, ok = triangulate_stereo(feats["xy_sub"], d_at, fx, fy, cx, cy,
                                     baseline)
        ok = ok & lr_ok & feats["valid"]
    return feats["xy"], feats["xy_sub"], feats["desc"], feats["valid"], pts, ok


def _track_step(left, right, prev_desc, prev_valid, prev_pts, prev_ok,
                scores, *, block_size, max_disparity, fast_threshold,
                max_keypoints, intr, baseline, frontend):
    """The whole tracking step of one frame on its device: front end,
    matching against the previous frame's features, RANSAC PnP with the
    (hypotheses, K) Gumbel ``scores``. Returns (xy, xy_sub, desc, valid,
    pts, ok, xi_rel, n_inliers)."""
    xy, xy_sub, desc, valid, pts, ok = _frame_frontend(
        left, right, block_size=block_size, max_disparity=max_disparity,
        fast_threshold=fast_threshold, max_keypoints=max_keypoints,
        intr=intr, baseline=baseline, frontend=frontend)
    with record_function("vo.match"):
        idx, good = match(prev_desc, desc, prev_valid, valid, ratio=0.9,
                          max_distance=80.0)
        good = good & prev_ok
        uv = xy_sub[idx]
    with record_function("vo.pnp"):
        xi_rel, _, n_inl = pnp_ransac(prev_pts, uv, good, intr, scores)
    return xy, xy_sub, desc, valid, pts, ok, xi_rel, n_inl


def _to_host(tensors) -> list[np.ndarray]:
    """numpy copies of device tensors: on a GPU one pinned asynchronous
    copy each and one wait for them all."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return [t.numpy() for t in tensors]
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
        t, non_blocking=True) for t in tensors]
    torch.cuda.current_stream(dev).synchronize()
    return [o.numpy() for o in outs]


class StereoVO:
    """Frame-to-frame stereo visual odometry.

    Per frame: subpixel disparity -> FAST + ORB on the left image ->
    keypoint triangulation -> descriptor matching against the previous
    frame -> RANSAC PnP of previous-frame 3D points in the current image
    -> pose accumulation in numpy (``ops.se3_np``).

    Args:
      camera: the rectified pair's :class:`StereoCamera`.
      device: "cuda" (the hand-written kernels; raises without a usable
        GPU) or "cpu" (the plain torch versions).
    """

    def __init__(self, camera: StereoCamera, *, block_size=7,
                 max_disparity=64, max_keypoints=256, fast_threshold=20,
                 min_pnp_inliers=12, seed=0, frontend="sad",
                 device="cuda"):
        if frontend not in FRONTENDS:
            raise ValueError(f"unknown frontend {frontend!r}")
        self.device = resolve_device(device)
        self.cam = camera
        self.frontend = frontend
        self.block_size = block_size
        self.max_disparity = max_disparity
        self.max_keypoints = max_keypoints
        self.fast_threshold = fast_threshold
        # tracking-failure gate: a PnP estimate supported by fewer inliers
        # than this is rejected and the previous relative motion is reused
        # (constant-velocity model), so one degenerate frame cannot
        # teleport the trajectory
        self.min_pnp_inliers = min_pnp_inliers
        # guards the pose state (trajectory entries, prev.xi_world) against
        # a backend thread that corrects poses
        self.pose_lock = threading.Lock()
        self.prev: FrameState | None = None
        self.trajectory: list[np.ndarray] = []  # world->camera twists
        self.n_inliers: list[int] = []
        self.tracking_drops = 0
        self._last_xi_rel = np.zeros(6, np.float32)
        self.seed = int(seed)
        self._gen = torch.Generator(device=self.device)
        self._ctr = 0
        # the previous frame's (desc, valid, pts, ok), resident on device
        self._prev_dev = None

    def _static_kwargs(self):
        return dict(block_size=self.block_size,
                    max_disparity=self.max_disparity,
                    fast_threshold=self.fast_threshold,
                    max_keypoints=self.max_keypoints, intr=self.cam.intr,
                    baseline=self.cam.baseline, frontend=self.frontend)

    def _upload(self, left, right):
        """The pair as two (H, W) uint8 views of ONE device copy."""
        pair = torch.from_numpy(np.stack([np.asarray(left, np.uint8),
                                          np.asarray(right, np.uint8)]))
        pair = pair.to(self.device)
        return pair[0], pair[1]

    def _ransac_scores(self, ctr: int) -> torch.Tensor:
        """The (hypotheses, K) Gumbel scores of frame ``ctr``, drawn on the
        device from a generator seeded by (seed, ctr)."""
        self._gen.manual_seed((self.seed << 32) + ctr)
        return gumbel_scores(N_HYPOTHESES, self.max_keypoints, self._gen,
                             self.device)

    def _frame_state(self, left, right, xi_world) -> FrameState:
        L, R = self._upload(left, right)
        outs = _frame_frontend(L, R, **self._static_kwargs())
        self._prev_dev = outs[2:]
        xy, xy_sub, desc, valid, pts, ok = _to_host(outs)
        return FrameState(xy=xy, xy_sub=xy_sub, desc=desc, valid=valid,
                          pts_cam=pts, pts_ok=ok,
                          xi_world=np.asarray(xi_world))

    def process(self, left, right):
        """Ingest one stereo pair; returns the world->camera twist (6,)."""
        if self.prev is None:
            state = self._frame_state(left, right, np.zeros(6, np.float32))
            with self.pose_lock:
                self.prev = state
                self.trajectory.append(state.xi_world)
            self.n_inliers.append(0)
            return state.xi_world

        self._ctr += 1
        if self._prev_dev is None:  # rebuilt from the host FrameState
            self._prev_dev = tuple(
                torch.from_numpy(np.asarray(a)).to(self.device)
                for a in (self.prev.desc, self.prev.valid,
                          self.prev.pts_cam, self.prev.pts_ok))
        L, R = self._upload(left, right)
        outs = _track_step(L, R, *self._prev_dev,
                           self._ransac_scores(self._ctr),
                           **self._static_kwargs())
        self._prev_dev = outs[2:6]
        (xy, xy_sub, desc, valid, pts, ok, xi_rel,
         n_inl) = _to_host(outs)
        cur = FrameState(xy=xy, xy_sub=xy_sub, desc=desc, valid=valid,
                         pts_cam=pts, pts_ok=ok,
                         xi_world=np.zeros(6, np.float32))
        n_inl = int(n_inl)
        self.n_inliers.append(n_inl)
        if n_inl < self.min_pnp_inliers:
            xi_rel = self._last_xi_rel  # constant-velocity fallback
            self.tracking_drops += 1
        else:
            self._last_xi_rel = xi_rel

        # T_cur_world = T_cur_prev * T_prev_world, atomic with the append
        with self.pose_lock:
            xi_world = se3_np.accum(xi_rel, self.prev.xi_world)
            cur.xi_world = xi_world
            self.prev = cur
            self.trajectory.append(xi_world)
        return xi_world

    def positions(self) -> np.ndarray:
        """Camera centers in world coordinates (T^-1 translation), in
        numpy."""
        with self.pose_lock:
            xis = np.stack(self.trajectory)
        return se3_np.positions(xis)


def ate_rmse(positions_est: np.ndarray, positions_gt: np.ndarray) -> float:
    """Absolute trajectory error after rigid (Umeyama, no scale)
    alignment, the standard SLAM accuracy metric."""
    est = np.asarray(positions_est, np.float64)
    gt = np.asarray(positions_gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, _, Vt = np.linalg.svd(E.T @ G)
    S = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ S @ Vt).T
    t = mu_g - R @ mu_e
    aligned = est @ R.T + t
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))
