"""Stereo SLAM on torch tensors (counterpart of ``models/slam.py``):
``StereoCamera``, ``FrameState``, ``_frame_frontend``, ``_track_step``,
``StereoVO``, ``StereoSLAM``, ``pose_graph_optimize`` and ``ate_rmse``.

Tracking, per frame: a disparity sweep with subpixel refinement and the
right-referenced map (``frontend`` "sad": B2 with costs, ``_kernels.sad_lr``
on a CUDA device; "sgm" / "sgm_half": the census + SGM chain, B3 and B4)
-> FAST / ORB on the left image -> LR-gated stereo triangulation ->
matching against the previous frame's features -> RANSAC PnP -> pose
accumulation on the host. The stages run under ``torch.profiler``
labels (``vo.disparity``, ``vo.features``, ``vo.triangulate``,
``vo.match``, ``vo.pnp``), so a profile splits a frame's device time by
stage; the backend's work runs under ``slam.ba``, ``slam.loop`` and
``slam.graph``.

A ``StereoVO`` owns an explicit ``torch.device``: "cuda" needs a usable GPU
and raises without one; only an explicit "cpu" runs the plain versions.
Each frame crosses to the device in one upload; the previous frame's
(desc, valid, pts, ok) stay on the device between frames and only the
frame's results come back. The RANSAC draws come from a CPU
``torch.Generator`` seeded from ``seed`` and the frame counter and are
copied to the device (``gumbel_scores``), so a run is reproducible and
the card draws the CPU's minimal sets. Frames tracked by the fused serve+track
step (``runtime/fused.py``) land through ``ingest_external_frame``,
``seed_external`` and ``apply_track_result``.

``StereoSLAM`` adds the backend: a keyframe every ``kf_every`` frames,
sliding-window BA (``models/ba.py``) over the newest ``window`` keyframes,
loop closure (BoW retrieval, ``ops/bow.py``, or an exhaustive search; then
batched matching and RANSAC PnP) and pose-graph optimization with the
corrections carried to every frame, feature culling, checkpoints in the
JAX package's format, and an asynchronous backend thread. The backend
solves on the VO's device; on a GPU the backend thread and the boot warmup
launch on CUDA streams of their own while the frame thread keeps the
default stream. Keyframe features stay numpy on the host, as in the JAX
``FrameState``, so the backend uploads its own inputs. Loop-closure RANSAC
draws from the engine's own CPU generator, reseeded by (seed + 0x5EED, the
keyframe's index) for each check and used only by the thread that runs
loop closure (the frame thread in synchronous mode, the backend's in
asynchronous mode): a resumed or asynchronous engine draws for a keyframe
what an uninterrupted synchronous one draws. With the frame counter's
draws, a resumed run repeats the uninterrupted one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import traceback

import numpy as np
import torch
from torch.profiler import record_function

from steroscopic_hardware_tpu_torch.models.ba import (
    BAProblem,
    ba_solve,
    reproject,
)
from steroscopic_hardware_tpu_torch.models.vo import (
    gumbel_scores,
    pnp_ransac,
    triangulate_stereo,
)
from steroscopic_hardware_tpu_torch.ops import se3, se3_np
from steroscopic_hardware_tpu_torch.ops.colorize import downscale_u8
from steroscopic_hardware_tpu_torch.ops.features import detect_and_describe
from steroscopic_hardware_tpu_torch.ops.matching import (
    match,
    match_batch,
    match_one_to_many,
)
from steroscopic_hardware_tpu_torch.ops.sad import disparity_subpixel
from steroscopic_hardware_tpu_torch.ops.sgm import sgm_disparity_lr
from steroscopic_hardware_tpu_torch.utils.collectives import all_reduce
from steroscopic_hardware_tpu_torch.utils.device import resolve_device

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
    # optional pre-quantized BoW place vector (the fused serve+track tail);
    # loop-closure retrieval then skips the quantize product
    bow: np.ndarray | None = None


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
        self._gen = torch.Generator()  # CPU: the same draws on every device
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
        return frame_scores(self._gen, self.seed, ctr, self.max_keypoints,
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

    def positions(self, tail: int | None = None) -> np.ndarray:
        """Camera centers in world coordinates (T^-1 translation), in
        numpy. ``tail`` limits them to the newest N poses (the live
        ``/slam`` snapshot: O(tail) a poll, not O(run length))."""
        with self.pose_lock:
            traj = (self.trajectory if tail is None
                    else self.trajectory[-tail:])
            xis = np.stack(traj)
        return se3_np.positions(xis)

    # -- fused serve+track ingestion (runtime/fused.py) ---------------------
    def _external_prev_pose(self) -> np.ndarray:
        """The pose a re-bootstrapped chain continues from: the last known
        one (a resumed checkpoint, a dropped link), identity at start.
        Caller holds ``pose_lock``."""
        return (np.asarray(self.prev.xi_world) if self.prev is not None
                else np.zeros(6, np.float32))

    def ingest_external_frame(self, track) -> np.ndarray:
        """Bootstrap from one externally tracked frame: the fused step ran
        its front end on the device; its features come to the host and the
        trajectory continues from the last known pose."""
        xy, xy_sub, desc, valid, pts, ok = track.host_features()
        with self.pose_lock:
            state = FrameState(xy=xy, xy_sub=xy_sub, desc=desc, valid=valid,
                               pts_cam=pts, pts_ok=ok,
                               xi_world=self._external_prev_pose(),
                               bow=track.bow_vec)
            self.prev = state
            self.trajectory.append(state.xi_world)
        self.n_inliers.append(0)
        return state.xi_world

    def seed_external(self):
        """Seed the trajectory at the chain root of a fused bootstrap batch
        (no features: the batch's newest frame carries them, and this root
        can never become a keyframe)."""
        with self.pose_lock:
            xi0 = self._external_prev_pose()
            self.prev = FrameState(xy=None, xy_sub=None, desc=None,
                                   valid=None, pts_cam=None, pts_ok=None,
                                   xi_world=xi0)
            self.trajectory.append(xi0)
        self.n_inliers.append(0)

    def apply_track_result(self, track, *, fetch_features: bool,
                           skip_first: bool = False):
        """Land a batch of tracking steps of the fused serve+track step:
        per frame the inlier gate, the constant-velocity fallback and the
        host pose accumulation (the second half of :meth:`process`). Only
        the newest frame has features; ``fetch_features`` brings them to
        the host (keyframe-bound batches). ``skip_first`` drops the chain
        root of a bootstrap batch, whose relative twist is meaningless."""
        xi_rels = np.atleast_2d(np.asarray(track.xi_rel, np.float32))
        n_inls = np.atleast_1d(np.asarray(track.n_inl))
        B = xi_rels.shape[0]
        xi_world = None
        for b in range(1 if skip_first else 0, B):
            if b == B - 1 and fetch_features:
                xy, xy_sub, desc, valid, pts, ok = track.host_features()
                cur = FrameState(xy=xy, xy_sub=xy_sub, desc=desc,
                                 valid=valid, pts_cam=pts, pts_ok=ok,
                                 xi_world=np.zeros(6, np.float32),
                                 bow=track.bow_vec)
            else:
                cur = FrameState(xy=None, xy_sub=None, desc=None, valid=None,
                                 pts_cam=None, pts_ok=None,
                                 xi_world=np.zeros(6, np.float32))
            xi_rel = xi_rels[b]
            n_inl = int(n_inls[b])
            self.n_inliers.append(n_inl)
            if n_inl < self.min_pnp_inliers:
                xi_rel = self._last_xi_rel  # constant-velocity fallback
                self.tracking_drops += 1
            else:
                self._last_xi_rel = xi_rel
            with self.pose_lock:
                xi_world = se3_np.accum(xi_rel, self.prev.xi_world)
                cur.xi_world = xi_world
                self.prev = cur
                self.trajectory.append(xi_world)
        return xi_world


def frame_scores(gen: torch.Generator, seed: int, ctr: int, K: int,
                 device) -> torch.Tensor:
    """The (hypotheses, K) RANSAC Gumbel scores of frame ``ctr`` on
    ``device``, drawn from the CPU generator ``gen`` reseeded by (seed,
    ctr): the same draws for the same frame in ``StereoVO.process`` and in
    the fused step, on any device."""
    gen.manual_seed((seed << 32) + ctr)
    return gumbel_scores(N_HYPOTHESES, K, gen, device)


def _relative_twist(xi_i: np.ndarray, xi_j: np.ndarray) -> np.ndarray:
    """log(T_j * T_i^-1): the measured relative motion i -> j, in numpy."""
    return se3_np.relative(xi_i, xi_j)


def _apply_pose_corrections(xis, seg, old_kf, new_kf):
    """Batched right-factor pose correction in numpy: for frame f in
    segment s, T_f_new = T_f_old * (T_kf_old[s]^-1 * T_kf_new[s])."""
    Roi, toi = se3_np.inverse(*se3_np.se3_exp(old_kf))
    Rn, tn = se3_np.se3_exp(new_kf)
    Rd, td = se3_np.compose(Roi, toi, Rn, tn)
    Rf, tf = se3_np.se3_exp(xis)
    return se3_np.se3_log(*se3_np.compose(Rf, tf, Rd[seg], td[seg]))


def _tensor(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype=dtype)


def _load_linalg(device) -> None:
    """Make the process's first CUDA ``torch.linalg`` call here, on one
    thread. torch loads its CUDA linear-algebra library on that first call,
    and two threads making it at once (the frame thread's PnP and the
    backend's or the boot warmup's BA solve) can fail one of them with
    "lazy wrapper should be called at most once"."""
    if device.type == "cuda":
        torch.linalg.solve_ex(torch.ones((1, 1), device=device),
                              torch.ones((1, 1), device=device))


class StereoSLAM:
    """Keyframed stereo SLAM: VO front end + sliding-window BA backend +
    loop closure + pose graph + checkpoint / resume.

    Every ``kf_every`` frames the current frame becomes a keyframe; when
    the window holds >= 2 keyframes, landmarks anchored at the oldest
    keyframe are matched into every window keyframe and the window is
    refined with the Schur-complement BA (``models/ba.py``), and the
    corrections reach every frame of the trajectory.

    Args: as the JAX ``StereoSLAM``, plus ``device`` ("cuda", which raises
    without a usable GPU, or "cpu"), which the VO and the backend share.

    ``pg_mesh``: a ``DeviceMesh`` with one dim, or one named "rows" (the
    JAX rule; else ValueError). Every rank of it runs the same engine on
    the same frames, SPMD, and each loop closure's pose-graph solve is
    edge-sharded over the axis (``parallel/pg_dist.py``): the group's
    first rank's graph goes to every rank, which solves on its 1/n of the
    padded edges and applies the common result. The ranks must close the
    same loops on the same graph, which only the synchronous backend
    gives: with ``async_backend`` the keyframes a rank's backend has seen
    when it checks a loop, and the loop checks it sheds past
    ``loop_backlog_cap``, depend on its timing, so ``pg_mesh`` with
    ``async_backend`` raises ValueError; ranks whose graphs differ in size
    raise.
    """

    def __init__(self, camera: StereoCamera, *, window: int = 4,
                 kf_every: int = 2, ba_iters: int = 6,
                 ba_pose_prior: float = 3e4,
                 loop_closure: bool = False, loop_min_matches: int = 30,
                 loop_gap: int = 4, loop_index: str = "bow",
                 loop_top_k: int = 3, loop_min_score: float = 0.05,
                 pg_mesh=None, async_backend: bool = False,
                 loop_backlog_cap: int = 8,
                 max_loop_keyframes: int = 1500,
                 pg_horizon: int | None = None, device="cuda",
                 **vo_kwargs):
        self.pg_mesh = pg_mesh
        self._pg_axis = None
        if pg_mesh is not None:
            names = tuple(pg_mesh.mesh_dim_names or ())
            if len(names) == 1:
                self._pg_axis = names[0]
            elif "rows" in names:
                self._pg_axis = "rows"
            else:
                raise ValueError(
                    "pg_mesh must have a single axis (or one named "
                    f"'rows'); got axes {names}")
            if async_backend:
                raise ValueError(
                    "pg_mesh needs the synchronous backend: the ranks of an "
                    "asynchronous one check and close loops at times of "
                    "their own, so their pose-graph collectives would not "
                    "meet")
        if loop_index not in ("bow", "exhaustive"):
            raise ValueError(f"unknown loop_index {loop_index!r}")
        self.vo = StereoVO(camera, device=device, **vo_kwargs)
        self.device = self.vo.device
        self.cam = camera
        self.window = window
        self.kf_every = kf_every
        self.ba_iters = ba_iters
        self.ba_pose_prior = float(ba_pose_prior)
        self.loop_closure = loop_closure
        self.loop_min_matches = loop_min_matches
        self.loop_gap = loop_gap
        # "bow": retrieval over the whole history in one product, then
        # verification of the top-k only; "exhaustive": every old keyframe
        self.loop_index = loop_index
        self.loop_top_k = loop_top_k
        self.loop_min_score = loop_min_score
        self._bow = None
        if loop_closure and loop_index == "bow":
            from steroscopic_hardware_tpu_torch.ops.bow import BowIndex

            self._bow = BowIndex(device=self.device)
        self.keyframes: list[FrameState] = []
        # trajectory index of each window keyframe, aligned with keyframes
        self.kf_traj_idx: list[int] = []
        # every keyframe (FrameState, trajectory index): loop-closure
        # candidates and pose-graph nodes
        self.kf_history: list[tuple[FrameState, int]] = []
        self.graph_edges: list[tuple[int, int, np.ndarray]] = []
        self.loops_closed = 0
        # backlog shedding: past this many queued keyframes the backend
        # checks only the newest ones for loops and counts the rest
        self.loop_backlog_cap = int(loop_backlog_cap)
        self.loop_checks_skipped = 0
        # memory bound: past this many feature-holding keyframes, old
        # keyframes that anchor no loop edge lose their features
        self.max_loop_keyframes = int(max_loop_keyframes)
        self.culled_keyframes = 0
        # fixed-lag pose graph: optimize only the newest pg_horizon
        # keyframe poses (None: the whole graph)
        self.pg_horizon = pg_horizon
        self.frame_idx = 0
        self.ba_runs = 0
        self.last_ba_errs: np.ndarray | None = None
        # the newest pose-graph solve's per-iteration costs
        self.last_pg_costs: np.ndarray | None = None
        # per-stage wall time (s)
        self.stage_s = {"vo": 0.0, "ba": 0.0, "loop": 0.0, "graph": 0.0}
        # -- asynchronous backend (tracking / mapping split) ---------------
        self.async_backend = bool(async_backend)
        self._lock = threading.RLock()
        self.vo.pose_lock = self._lock
        self._backend_queue: queue.Queue[int] = queue.Queue()
        self._backend_stop = threading.Event()
        self._backend_thread: threading.Thread | None = None
        self.backend_coalesced = 0   # BA windows skipped by coalescing
        self.backend_errors = 0
        # loop-closure RANSAC, reseeded per check (the frame thread owns
        # the VO's generator)
        self._loop_gen = torch.Generator()
        _load_linalg(self.device)
        if self.async_backend:
            self._backend_thread = threading.Thread(
                target=self._backend_run, daemon=True, name="slam-backend")
            self._backend_thread.start()

    def _side_stream(self):
        """A CUDA stream of its own for a backend or warmup thread (no-op
        on the CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(torch.cuda.Stream(self.device))

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return _tensor(a, self.device, dtype)

    def process(self, left, right) -> np.ndarray:
        t0 = time.perf_counter()
        self.vo.process(left, right)
        self.stage_s["vo"] += time.perf_counter() - t0
        return self._after_track()

    def process_tracked(self, track) -> np.ndarray:
        """:meth:`process` for a batch of frames tracked by the fused
        serve+track step (``runtime/fused.py``): lands every frame's pose,
        runs the keyframe policy (a keyframe lands on the batch's newest
        frame, the one with features, whenever one is due inside the
        batch) and hands the backend its work."""
        t0 = time.perf_counter()
        B = np.atleast_2d(np.asarray(track.xi_rel)).shape[0]
        bootstrap = track.bootstrap or self.vo.prev is None
        kf_due = any((self.frame_idx + i) % self.kf_every == 0
                     for i in range(B))
        if bootstrap and B == 1:
            self.vo.ingest_external_frame(track)
        elif bootstrap:
            self.vo.seed_external()
            self.vo.apply_track_result(track, fetch_features=kf_due,
                                       skip_first=True)
        else:
            self.vo.apply_track_result(track, fetch_features=kf_due)
        self.stage_s["vo"] += time.perf_counter() - t0
        self.frame_idx += B
        if kf_due:
            self._ingest_keyframe()
        with self._lock:
            return self.vo.trajectory[-1]

    def _after_track(self) -> np.ndarray:
        if self.frame_idx % self.kf_every == 0:
            self._ingest_keyframe()
        self.frame_idx += 1
        with self._lock:
            return self.vo.trajectory[-1]

    def _ingest_keyframe(self):
        if self.async_backend:
            self._ingest_keyframe_async()
        else:
            self._ingest_keyframe_sync()

    def _push_keyframe(self, kf: FrameState) -> int:
        """Window, sequential pose-graph edge and history entry of a new
        keyframe (caller holds ``_lock`` in async mode)."""
        self.keyframes.append(kf)
        self.kf_traj_idx.append(len(self.vo.trajectory) - 1)
        if len(self.keyframes) > self.window:
            self.keyframes.pop(0)
            self.kf_traj_idx.pop(0)
        return len(self.keyframes)

    def _push_history(self, kf: FrameState) -> int:
        if self.kf_history:
            prev_kf, _ = self.kf_history[-1]
            rel = _relative_twist(prev_kf.xi_world, kf.xi_world)
            self.graph_edges.append(
                (len(self.kf_history) - 1, len(self.kf_history), rel))
        self.kf_history.append((kf, len(self.vo.trajectory) - 1))
        return len(self.kf_history) - 1

    def _ingest_keyframe_sync(self):
        """Synchronous keyframe path: BA before the sequential edge (the
        edge measures the refined relative motion), loop closure inline."""
        kf = self.vo.prev
        if self._push_keyframe(kf) >= 2:
            t0 = time.perf_counter()
            self._refine_window()
            self.stage_s["ba"] += time.perf_counter() - t0
        self._push_history(kf)
        if self._bow is not None:
            self._bow_add(kf)
        if self.loop_closure:
            t0 = time.perf_counter()
            self._try_loop_closure()
            self.stage_s["loop"] += time.perf_counter() - t0
        self._cull_history()

    def _bow_add(self, kf: FrameState):
        """Index a keyframe for place recognition (no quantize product when
        the fused step already computed its vector)."""
        if kf.bow is not None:
            self._bow.add_vector(kf.bow)
        else:
            self._bow.add(kf.desc, kf.valid)

    def _ingest_keyframe_async(self):
        """Asynchronous keyframe path: bookkeeping only, in one locked
        block (a backend snapshot never sees an edge whose end node is not
        in kf_history yet), then the backend gets the heavy work. The
        sequential edge uses the pre-BA VO poses."""
        kf = self.vo.prev
        with self._lock:
            self._push_keyframe(kf)
            hist_idx = self._push_history(kf)
        if self._bow is not None:
            self._bow_add(kf)
        self._cull_history()
        self._backend_queue.put(hist_idx)

    def _cull_history(self):
        """Bound keyframe-history memory: past ``max_loop_keyframes``
        feature-holding keyframes, every second old keyframe (outside the
        newest 2 * window + 16, never a loop-edge endpoint) loses its
        features and its BoW row; graph nodes, edges and the trajectory
        stay exact."""
        with self._lock:
            n_feat = sum(1 for kf, _ in self.kf_history
                         if kf.desc is not None)
            if n_feat <= self.max_loop_keyframes:
                return
            anchored = set()
            for i, j, _ in self.graph_edges:
                if abs(j - i) > 1:  # loop edges pin their endpoints
                    anchored.add(i)
                    anchored.add(j)
            recent = max(0, len(self.kf_history) - (2 * self.window + 16))
            victims = [
                i for i, (kf, _) in enumerate(self.kf_history[:recent])
                if kf.desc is not None and i not in anchored
            ][::2]
        for i in victims:
            if n_feat <= self.max_loop_keyframes:
                break
            kf = self.kf_history[i][0]
            kf.desc = None
            kf.valid = None
            kf.xy = None
            kf.xy_sub = None
            kf.pts_cam = None
            kf.pts_ok = None
            if self._bow is not None:
                self._bow.disable(i)
            self.culled_keyframes += 1
            n_feat -= 1

    # -- backend worker -----------------------------------------------------
    def _backend_run(self):
        with self._side_stream():
            while not self._backend_stop.is_set():
                try:
                    job = self._backend_queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                # coalesce the BA backlog: one refinement of the current
                # window subsumes the stale ones; loop detection still runs
                # once per queued keyframe
                jobs = [job]
                while True:
                    try:
                        jobs.append(self._backend_queue.get_nowait())
                    except queue.Empty:
                        break
                self.backend_coalesced += len(jobs) - 1
                try:
                    if len(self.keyframes) >= 2:
                        t0 = time.perf_counter()
                        self._refine_window()
                        self.stage_s["ba"] += time.perf_counter() - t0
                    if self.loop_closure:
                        t0 = time.perf_counter()
                        run = jobs
                        if len(jobs) > self.loop_backlog_cap:
                            # a saturated backend checks the newest
                            # keyframes and counts the skipped ones
                            run = jobs[-self.loop_backlog_cap:]
                            self.loop_checks_skipped += len(jobs) - len(run)
                        for j in run:
                            self._try_loop_closure(hist_idx=j)
                        self.stage_s["loop"] += time.perf_counter() - t0
                except Exception:  # keep the backend alive; count, report
                    self.backend_errors += 1
                    traceback.print_exc()
                finally:
                    for _ in jobs:
                        self._backend_queue.task_done()

    @property
    def backend_pending(self) -> int:
        return self._backend_queue.qsize()

    def finish(self):
        """Block until the backend has drained every queued keyframe (no-op
        in synchronous mode). Call before reading final metrics."""
        if self._backend_thread is not None:
            self._backend_queue.join()

    def close(self):
        """Stop the backend worker (async mode)."""
        if self._backend_thread is not None:
            self._backend_stop.set()
            self._backend_thread.join(timeout=30)
            self._backend_thread = None

    def warmup_backend(self, should_stop=None) -> int:
        """Run every backend solver shape once at boot, on a CUDA stream of
        its own: the batched matches (loop verification, 1..top_k
        candidates in power-of-two buckets; the window build, 1..window-1
        keyframes), RANSAC PnP, BA at M = 2..window, the smallest
        pose-graph bucket (and its ``n_fixed`` form with ``pg_horizon``),
        and the BoW products. Nothing compiles here, but the first
        ``torch.linalg`` call creates the cuBLAS / cuSOLVER handles and the
        first large tensors grow the caching allocator; a live session's
        first loop closure should not pay for them. ``should_stop`` is
        polled between solver runs. Returns the number of runs."""

        def stopped():
            return should_stop is not None and should_stop()

        K = self.vo.max_keypoints
        dev = self.device
        desc = torch.zeros((K, 256), dtype=torch.uint8, device=dev)
        valid = torch.zeros((K,), dtype=torch.bool, device=dev)
        n = 0
        with self._side_stream():
            for B in sorted({1 << i for i in range(
                    max(1, (self.loop_top_k - 1).bit_length() + 1))}):
                if stopped():
                    return n
                match_batch(desc.expand(B, K, 256), desc,
                            valid.expand(B, K), valid, ratio=0.85,
                            max_distance=60.0)[1].cpu()
                n += 1
            for B in range(1, self.window):
                if stopped():
                    return n
                match_one_to_many(desc, desc.expand(B, K, 256), valid,
                                  valid.expand(B, K), ratio=0.9,
                                  max_distance=80.0)[1].cpu()
                n += 1
            if stopped():
                return n
            gen = torch.Generator()
            pnp_ransac(torch.zeros((K, 3), device=dev),
                       torch.zeros((K, 2), device=dev), valid, self.cam.intr,
                       gumbel_scores(N_HYPOTHESES, K, gen.manual_seed(0),
                                     dev))[0].cpu()
            n += 1
            for M in range(2, self.window + 1):
                if stopped():
                    return n
                zeros = torch.zeros((M, K), device=dev)
                prob = BAProblem(
                    torch.zeros((M, 6), device=dev),
                    torch.ones((K, 3), device=dev),
                    torch.zeros((M, K, 2), device=dev), zeros,
                    self.cam.intr, uv_r=zeros, mask_r=zeros,
                    baseline=self.cam.baseline)
                ba_solve(prob, iters=self.ba_iters,
                         pose_prior_weight=self.ba_pose_prior)[1].cpu()
                n += 1
            edges = torch.zeros((16, 2), dtype=torch.int64, device=dev)
            edges[0, 1] = 1
            w = torch.zeros(16, device=dev)
            w[0] = 1.0
            zeros = torch.zeros((16, 6), device=dev)
            for n_fixed in ((None,) if self.pg_horizon is None
                            else (None, 1)):
                if stopped():
                    return n
                pose_graph_optimize(zeros, edges, zeros, w, iters=10,
                                    n_fixed=n_fixed)[1].cpu()
                n += 1
        if self._bow is not None:
            n += self._bow.warmup(K)
        return n

    def _try_loop_closure(self, hist_idx: int | None = None):
        """Find a revisited place among old keyframes (BoW-retrieved top-k,
        or all with ``loop_index="exhaustive"``); on a strong descriptor
        match, estimate the relative pose by RANSAC PnP, add a pose-graph
        edge and re-optimize every keyframe pose.

        ``hist_idx``: the keyframe to close against (default: the newest);
        the async backend passes each queued keyframe's index. Matching and
        PnP read snapshots of the keyframes' feature fields (a concurrent
        ``_cull_history`` may null them), so no lock is held through the
        heavy part."""
        with self._lock:
            hist = list(self.kf_history)
        if hist_idx is None:
            hist_idx = len(hist) - 1
        cur, _ = hist[hist_idx]
        cur_idx = hist_idx
        # snapshot the current keyframe's fields once, as the candidates'
        # below (the JAX function reads cur.valid / cur.xy_sub again later)
        c_desc, c_valid, c_xy_sub, c_bow = (cur.desc, cur.valid, cur.xy_sub,
                                            cur.bow)
        if c_desc is None or c_valid is None or c_xy_sub is None:
            return  # features culled while queued (deep backlog)
        with record_function("slam.loop"):
            if self._bow is not None:
                kw = dict(top_k=self.loop_top_k,
                          min_score=self.loop_min_score,
                          before=cur_idx - self.loop_gap)
                if c_bow is not None:
                    found = self._bow.query_vector(c_bow, **kw)
                else:
                    found = self._bow.query(c_desc, c_valid, **kw)
                candidates = [j for j, _score in found]
            else:
                candidates = range(0, cur_idx - self.loop_gap)
            cands = []
            for j in candidates:
                old, _ = hist[j]
                od, ov, opts, opok = (old.desc, old.valid, old.pts_cam,
                                      old.pts_ok)
                if od is None or ov is None or opts is None or opok is None:
                    continue  # features culled (see _cull_history)
                cands.append((j, od, ov, opts, opok))
            if not cands:
                return
            # power-of-two candidate bucket: padded rows are all invalid
            # (never good), as in the JAX function
            Bp = 1 << (len(cands) - 1).bit_length()
            pad = Bp - len(cands)
            descs = np.stack([c[1] for c in cands]
                             + [np.zeros_like(cands[0][1])] * pad)
            valids = np.stack([c[2] for c in cands]
                              + [np.zeros_like(cands[0][2])] * pad)
            idx_b, good_b = match_batch(
                self._dev(descs), self._dev(c_desc), self._dev(valids),
                self._dev(c_valid), ratio=0.85, max_distance=60.0)
            idx_b, good_b = _to_host([idx_b, good_b])
            best = None
            for k, (j, od, ov, opts, opok) in enumerate(cands):
                good = good_b[k] & opok
                n = int(good.sum())
                if n >= self.loop_min_matches and (best is None
                                                   or n > best[0]):
                    best = (n, j, idx_b[k], good, opts)
            if best is None:
                return
            n, j, idx, good, old_pts = best
            uv = c_xy_sub[idx].astype(np.float32)
            gen = self._loop_gen.manual_seed(
                ((self.vo.seed + 0x5EED) << 32) + cur_idx)
            scores = gumbel_scores(N_HYPOTHESES, len(idx), gen, self.device)
            xi_rel, _, n_inl = pnp_ransac(
                self._dev(old_pts, torch.float32), self._dev(uv),
                self._dev(good), self.cam.intr, scores)
            xi_rel, n_inl = _to_host([xi_rel, n_inl])
        if int(n_inl) < self.loop_min_matches:
            return
        # measured T_cur_old from PnP of old's 3D points in cur's image
        with self._lock:
            self.graph_edges.append((j, cur_idx, np.array(xi_rel)))
            self.loops_closed += 1
        t0 = time.perf_counter()
        self._optimize_pose_graph()
        self.stage_s["graph"] += time.perf_counter() - t0

    def _propagate_pose_updates(self, traj_indices, old_xis, new_xis):
        """Write refined keyframe poses into the trajectory and carry each
        keyframe's correction to the frames that follow it (up to the next
        keyframe) by the right factor D = T_kf_old^-1 * T_kf_new:
        T_F_new = T_F_old * D, for all of them in one numpy evaluation."""
        traj = self.vo.trajectory
        bounds = list(traj_indices[1:]) + [len(traj)]
        frame_idx: list[int] = []
        frame_seg: list[int] = []
        segs_old: list[np.ndarray] = []
        segs_new: list[np.ndarray] = []
        for ti, next_ti, old, new in zip(traj_indices, bounds,
                                         old_xis, new_xis):
            traj[ti] = np.asarray(new)
            if next_ti - ti <= 1 or np.allclose(old, new):
                continue
            k = len(segs_old)
            segs_old.append(np.asarray(old, np.float32))
            segs_new.append(np.asarray(new, np.float32))
            for t in range(ti + 1, next_ti):
                frame_idx.append(t)
                frame_seg.append(k)
        if not frame_idx:
            return
        xis = np.stack([traj[t] for t in frame_idx]).astype(np.float32)
        out = _apply_pose_corrections(
            xis, np.asarray(frame_seg, np.int32),
            np.stack(segs_old), np.stack(segs_new))
        for t, x in zip(frame_idx, out):
            traj[t] = np.asarray(x, np.float32)

    def _apply_pose_result(self, kfs, traj_idx, old_xis, new_xis):
        """Land refined keyframe poses (BA window or pose graph): write the
        FrameStates, propagate through the trajectory, then re-sync every
        keyframe and the VO anchor created after the optimization's
        snapshot. Caller holds _lock."""
        for kf, xi in zip(kfs, new_xis):
            kf.xi_world = np.asarray(xi)
        self._propagate_pose_updates(traj_idx, old_xis, list(new_xis))
        traj = self.vo.trajectory
        last_ti = traj_idx[-1]
        for kf2, ti2 in self.kf_history:
            if ti2 > last_ti:
                kf2.xi_world = np.asarray(traj[ti2])
        self.vo.prev.xi_world = np.asarray(traj[-1])

    def _optimize_pose_graph(self):
        with self._lock:
            hist = list(self.kf_history)
            g_edges = list(self.graph_edges)
            nodes = np.stack([kf.xi_world for kf, _ in hist]).astype(
                np.float32)
        old = list(nodes)
        edges = np.array([(i, j) for i, j, _ in g_edges], np.int64)
        meas = np.stack([m for _, _, m in g_edges]).astype(np.float32)
        M, E = len(nodes), len(edges)
        # power-of-two buckets, as in the JAX engine: padded edges have
        # weight 0, padded nodes no edges
        Mb = max(16, 1 << (M - 1).bit_length())
        Eb = max(16, 1 << (E - 1).bit_length())
        nodes = np.pad(nodes, ((0, Mb - M), (0, 0)))
        edges = np.pad(edges, ((0, Eb - E), (0, 0)))
        meas = np.pad(meas, ((0, Eb - E), (0, 0)))
        w = np.zeros(Eb, np.float32)
        w[:E] = 1.0
        with record_function("slam.graph"):
            if self.pg_mesh is not None:
                xi_opt, costs = self._sharded_pose_graph(nodes, edges, meas,
                                                         w)
            else:
                n_fixed = None
                if self.pg_horizon is not None:
                    n_fixed = max(1, M - self.pg_horizon)
                xi_opt, costs = pose_graph_optimize(
                    self._dev(nodes), self._dev(edges), self._dev(meas),
                    self._dev(w), iters=10, n_fixed=n_fixed)
            xi_opt, costs = _to_host([xi_opt, costs])
        self.last_pg_costs = np.array(costs)
        xi_opt = xi_opt[:M]
        with self._lock:
            self._apply_pose_result([kf for kf, _ in hist],
                                    [ti for _, ti in hist], old,
                                    list(xi_opt))

    def _sharded_pose_graph(self, nodes, edges, meas, w):
        """The bucketed graph's solve, edge-sharded over ``pg_mesh`` (as the
        JAX engine, without ``pg_horizon``): every rank takes the group's
        first rank's graph and its own block of the padded edges."""
        from steroscopic_hardware_tpu_torch.parallel.multihost import (
            all_gather,
            broadcast,
            shard,
        )
        from steroscopic_hardware_tpu_torch.parallel.pg_dist import (
            pad_edges,
            pose_graph_optimize_sharded,
        )

        mesh, axis = self.pg_mesh, self._pg_axis
        group = mesh.get_group(axis)
        edges, meas, w = pad_edges(edges, meas, w, group.size())
        sizes = all_gather(self._dev(np.array([[len(nodes), len(edges)]])),
                           mesh, axis)
        if not bool((sizes == sizes[0]).all()):
            raise RuntimeError(
                "the ranks of pg_mesh disagree on the pose graph's (nodes, "
                f"edges): {sizes.tolist()}")
        nodes, edges, meas, w = (broadcast(self._dev(a), group)
                                 for a in (nodes, edges, meas, w))
        return pose_graph_optimize_sharded(
            nodes, shard(edges, mesh, axis), shard(meas, mesh, axis),
            shard(w, mesh, axis), mesh=mesh, iters=10, axis_name=axis)

    def _refine_window(self):
        # snapshot the window (the frame thread pops / appends it
        # concurrently in async mode); poses are captured in xi0
        with self._lock:
            kfs = list(self.keyframes)
            traj_idx = list(self.kf_traj_idx)
            xi0 = np.stack([kf.xi_world for kf in kfs]).astype(np.float32)
        with record_function("slam.ba"):
            xi_new = self._solve_window(kfs, xi0)
        # write every refined window pose back, carry each correction to
        # the frames in between, re-sync what came after the snapshot
        with self._lock:
            self._apply_pose_result(kfs, traj_idx, list(xi0), list(xi_new))

    def _solve_window(self, kfs, xi0) -> np.ndarray:
        """The window's BA problem and its solve: returns the refined
        (M, 6) poses."""
        M = len(kfs)
        anchor = kfs[0]
        N = anchor.xy.shape[0]
        # landmarks: the anchor's triangulated keypoints in the world frame
        Rai, tai = se3_np.inverse(*se3_np.se3_exp(xi0[0]))
        pts_w = np.asarray(anchor.pts_cam @ Rai.T + tai)
        # left observations + stereo right-camera u rows: u_R = u_L - d,
        # d = fx * b / z from each frame's own triangulated depth
        fxb = self.cam.fx * self.cam.baseline
        uv = np.zeros((M, N, 2), np.float32)
        mask = np.zeros((M, N), np.float32)
        uv_r = np.zeros((M, N), np.float32)
        mask_r = np.zeros((M, N), np.float32)
        uv[0] = anchor.xy_sub.astype(np.float32)
        mask[0] = anchor.pts_ok.astype(np.float32)
        uv_r[0] = uv[0, :, 0] - fxb / np.maximum(anchor.pts_cam[:, 2], 1e-6)
        mask_r[0] = mask[0]
        # the anchor matched into every other window keyframe at once
        idx_all, good_all = match_one_to_many(
            self._dev(anchor.desc),
            self._dev(np.stack([kf.desc for kf in kfs[1:]])),
            self._dev(anchor.valid),
            self._dev(np.stack([kf.valid for kf in kfs[1:]])),
            ratio=0.9, max_distance=80.0)
        idx_all, good_all = _to_host([idx_all, good_all])
        for i, kf in enumerate(kfs[1:], start=1):
            idx, good = idx_all[i - 1], good_all[i - 1]
            good = good & anchor.pts_ok
            uv[i] = kf.xy_sub[idx].astype(np.float32)
            mask[i] = good.astype(np.float32)
            uv_r[i] = uv[i, :, 0] - fxb / np.maximum(kf.pts_cam[idx, 2],
                                                     1e-6)
            mask_r[i] = mask[i] * kf.pts_ok[idx].astype(np.float32)
        f32 = torch.float32
        xi0_d, pts_d, uv_d = (self._dev(xi0, f32), self._dev(pts_w, f32),
                              self._dev(uv))
        # outlier gate: the VO poses are decent, so an observation whose
        # initial reprojection error exceeds 25 px is a mismatch
        r0 = reproject(xi0_d, pts_d, self.cam.intr) - uv_d
        gate = (torch.sqrt((r0**2).sum(-1)) < 25.0).to(f32)
        prob = BAProblem(xi0_d, pts_d, uv_d, self._dev(mask) * gate,
                         self.cam.intr, uv_r=self._dev(uv_r),
                         mask_r=self._dev(mask_r) * gate,
                         baseline=self.cam.baseline)
        solved, errs = ba_solve(prob, iters=self.ba_iters,
                                pose_prior_weight=self.ba_pose_prior)
        xi_new, errs = _to_host([solved.xi, errs])
        self.ba_runs += 1
        self.last_ba_errs = np.array(errs)
        return np.array(xi_new)

    # -- persistence --------------------------------------------------------
    _FIELDS = ("xy", "xy_sub", "desc", "valid", "pts_cam", "pts_ok",
               "xi_world", "bow")

    def save_checkpoint(self, path: str):
        """Write the whole state in the JAX package's checkpoint format
        (``utils/checkpoint.py``); returns the manifest."""
        from steroscopic_hardware_tpu_torch.utils import checkpoint as ckpt

        with self._lock:
            arrays = {
                "trajectory": np.stack(self.vo.trajectory),
                "n_inliers": np.asarray(self.vo.n_inliers, np.int32),
                # the constant-velocity fallback of a dropped frame (the
                # JAX engine neither saves nor reads it)
                "vo_last_xi_rel": np.asarray(self.vo._last_xi_rel,
                                             np.float32),
            }
            for i, kf in enumerate(self.keyframes):
                for field in self._FIELDS:
                    val = getattr(kf, field)
                    if val is not None:
                        arrays[f"kf{i}_{field}"] = val
            # feature-culled keyframes save only their pose
            for i, (kf, _) in enumerate(self.kf_history):
                for field in self._FIELDS:
                    val = getattr(kf, field)
                    if val is not None:
                        arrays[f"hist{i}_{field}"] = val
            arrays["hist_traj_idx"] = np.asarray(
                [ti for _, ti in self.kf_history], np.int32)
            arrays["kf_traj_idx"] = np.asarray(self.kf_traj_idx, np.int32)
            if self.graph_edges:
                arrays["graph_edges_ij"] = np.asarray(
                    [(i, j) for i, j, _ in self.graph_edges], np.int32)
                arrays["graph_edges_meas"] = np.stack(
                    [m for _, _, m in self.graph_edges]).astype(np.float32)
            meta = {
                "frame_idx": self.frame_idx,
                "n_keyframes": len(self.keyframes),
                "n_kf_history": len(self.kf_history),
                "loops_closed": self.loops_closed,
                "ba_runs": self.ba_runs,
                "camera": dataclasses.asdict(self.cam),
                "window": self.window,
                "kf_every": self.kf_every,
            }
            return ckpt.save(path, arrays, meta)

    @classmethod
    def load_checkpoint(cls, path: str, **kwargs):
        """A StereoSLAM resumed from a checkpoint of either package;
        ``kwargs`` are the constructor's (``device`` among them)."""
        from steroscopic_hardware_tpu_torch.utils import checkpoint as ckpt

        arrays, manifest = ckpt.load(path)
        meta = manifest["meta"]
        cam = StereoCamera(**meta["camera"])
        slam = cls(cam, window=meta["window"], kf_every=meta["kf_every"],
                   **kwargs)
        slam.frame_idx = meta["frame_idx"]
        slam.ba_runs = meta["ba_runs"]
        slam.loops_closed = meta.get("loops_closed", 0)
        slam.vo.trajectory = list(arrays["trajectory"])
        slam.vo.n_inliers = [int(v) for v in arrays["n_inliers"]]
        if "graph_edges_ij" in arrays and len(arrays["graph_edges_ij"]):
            slam.graph_edges = [
                (int(i), int(j), m)
                for (i, j), m in zip(arrays["graph_edges_ij"],
                                     arrays["graph_edges_meas"])]

        def state(prefix):
            return FrameState(**{f: arrays.get(f"{prefix}_{f}")
                                 for f in cls._FIELDS})

        for i in range(meta.get("n_kf_history", 0)):
            kf = state(f"hist{i}")
            slam.kf_history.append((kf, int(arrays["hist_traj_idx"][i])))
            # the retrieval table is rebuilt, not checkpointed; culled
            # keyframes keep an inert zero row so rows stay aligned
            if slam._bow is not None:
                if kf.bow is not None:
                    slam._bow.add_vector(kf.bow)
                elif kf.desc is None:
                    slam._bow.add_zero()
                else:
                    slam._bow.add(kf.desc, kf.valid)
        slam.kf_traj_idx = [int(v) for v in arrays.get(
            "kf_traj_idx", np.zeros(0, np.int32))]
        # a window keyframe is its history entry, one object, as in the
        # running engine: BA's poses reach the pose graph's nodes and a
        # closure's reach the window (the JAX engine loads two copies)
        by_traj = {t: kf for kf, t in slam.kf_history}
        for i in range(meta["n_keyframes"]):
            kf = None
            if i < len(slam.kf_traj_idx):
                kf = by_traj.get(slam.kf_traj_idx[i])
            slam.keyframes.append(kf if kf is not None else state(f"kf{i}"))
        if slam.keyframes:
            slam.vo.prev = slam.keyframes[-1]
        # frame f draws RANSAC scores (seed, f) and a dropped frame falls
        # back on the last tracked motion, as in the uninterrupted run (the
        # JAX engine restarts its counter at 0 and its fallback at rest)
        slam.vo._ctr = max(0, slam.frame_idx - 1)
        if "vo_last_xi_rel" in arrays:
            slam.vo._last_xi_rel = np.asarray(arrays["vo_last_xi_rel"],
                                              np.float32)
        return slam


# -- pose graph ---------------------------------------------------------------

_CG_CHECK = 8  # CG iterations between the host's convergence checks


def _edge_residual(xi_i, xi_j, xi_m):
    """log(exp(xi_m)^-1 * T_j * T_i^-1): the edge's error twist."""
    Ri, ti = se3.se3_exp(xi_i)
    Rj, tj = se3.se3_exp(xi_j)
    Rm, tm = se3.se3_exp(xi_m)
    Rrel, trel = se3.compose(Rj, tj, *se3.inverse(Ri, ti))
    return se3.se3_log(*se3.compose(*se3.inverse(Rm, tm), Rrel, trel))


def _retract(d, x):
    return se3.se3_log(*se3.compose(*se3.se3_exp(d), *se3.se3_exp(x)))


def _series(th, closed, coeffs):
    """``closed(th)`` where th >= 1e-2, else the Taylor series ``coeffs`` in
    th^2 (float64; the closed forms cancel catastrophically near 0)."""
    t2 = th * th
    near = coeffs[0] + t2 * (coeffs[1] + t2 * coeffs[2])
    safe = torch.where(th < 1e-2, torch.ones_like(th), th)
    return torch.where(th < 1e-2, near, closed(safe))


def _jl_inv(xi):
    """(..., 6, 6) inverse left Jacobian of SE(3) at twists ``xi``
    [rho, phi], float64: [[Ji, -Ji Q Ji], [0, Ji]] with the SO(3) inverse
    left Jacobian Ji and Barfoot's Q(rho, phi)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th = torch.linalg.norm(phi, dim=-1)[..., None, None]
    P, Rh = se3.hat(phi), se3.hat(rho)
    PP = P @ P
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    a = _series(th, lambda t: (t - torch.sin(t)) / t**3,
                (1 / 6, -1 / 120, 1 / 5040))
    b = _series(th, lambda t: (t * t + 2 * torch.cos(t) - 2) / (2 * t**4),
                (1 / 24, -1 / 720, 1 / 40320))
    c = _series(th, lambda t: (2 * t - 3 * torch.sin(t) + t * torch.cos(t))
                / (2 * t**5), (1 / 120, -1 / 2520, 1 / 120960))
    d = _series(th, lambda t: (1 - 0.5 * t / torch.tan(0.5 * t)) / (t * t),
                (1 / 12, 1 / 720, 1 / 30240))
    PR, PRP = P @ Rh, P @ Rh @ P
    Q = (0.5 * Rh + a * (PR + Rh @ P + PRP)
         + b * (PP @ Rh + Rh @ PP - 3 * PRP)
         + c * (PRP @ P + P @ PRP))
    Ji = eye - 0.5 * P + d * PP
    top = torch.cat([Ji, -Ji @ Q @ Ji], -1)
    bottom = torch.cat([torch.zeros_like(Ji), Ji], -1)
    return torch.cat([top, bottom], -2)


def _adjoint(R, t):
    """(..., 6, 6) adjoint of T = (R, t) acting on twists [rho, phi]."""
    top = torch.cat([R, se3.hat(t) @ R], -1)
    bottom = torch.cat([torch.zeros_like(R), R], -1)
    return torch.cat([top, bottom], -2)


def _edge_r_J(xi_i, xi_j, xi_m):
    """Every edge's residual (E, 6) and its Jacobians (E, 6, 6) with respect
    to the left perturbations of its two nodes.

    The JAX function takes them with ``jax.jacfwd`` of the residual; here
    they are the same derivatives written out. With T_i' = exp(d_i) T_i,
    the error E = T_m^-1 exp(d_j) T_j T_i^-1 exp(-d_i) =
    exp(Ad(T_m^-1) d_j) E0 = exp(-Ad(E0) d_i) E0, so
    dr / d d_j = Jl^-1(r0) Ad(T_m^-1) and dr / d d_i = -Jl^-1(r0) Ad(E0).
    The Jacobians are formed in float64 and rounded to float32."""
    xi_i, xi_j = _retract(torch.zeros_like(xi_i), xi_i), _retract(
        torch.zeros_like(xi_j), xi_j)
    r = _edge_residual(xi_i, xi_j, xi_m)
    f64 = torch.float64
    Ri, ti = se3.se3_exp(xi_i.to(f64))
    Rj, tj = se3.se3_exp(xi_j.to(f64))
    Rmi, tmi = se3.inverse(*se3.se3_exp(xi_m.to(f64)))
    E0 = se3.compose(Rmi, tmi, *se3.compose(Rj, tj, *se3.inverse(Ri, ti)))
    Jl_inv = _jl_inv(r.to(f64))
    Jj = Jl_inv @ _adjoint(Rmi, tmi)
    Ji = -Jl_inv @ _adjoint(*E0)
    return r, Ji.to(xi_i.dtype), Jj.to(xi_i.dtype)


def pose_graph_optimize(xi_nodes, edges_ij, xi_meas, weights, *,
                        iters: int = 15, damping: float = 1e-4,
                        fix_first: bool = True, cg_iters: int = 100,
                        cg_tol: float = 1e-8, group=None, n_fixed=None):
    """Gauss-Newton pose-graph optimization, block-sparse.

    Args:
      xi_nodes: (M, 6) world->camera twists.
      edges_ij: (E, 2) integer node index pairs (i, j).
      xi_meas: (E, 6) measured relative twists T_j_i (i -> j).
      weights: (E,) edge weights; weight-0 edges are inert, so callers pad
        edges (and edge-free nodes) to bucketed shapes.
      n_fixed: optional int (or 0-d tensor): freeze the first n_fixed nodes
        (fixed-lag horizon; overrides ``fix_first``, keep it >= 1 to pin
        the gauge). Frozen nodes come back bit for bit.
    Returns the optimized (M, 6) twists and the per-iteration weighted
    costs (iters,), each at its iteration's starting state.

    Residual per edge: log(exp(xi_meas)^-1 * T_j * T_i^-1), its
    Jacobians analytic (``_edge_r_J``). Each edge touches two nodes, so H
    is applied matrix-free (two gathers and two
    ``index_add_`` scatters per edge) and solved by block-Jacobi
    preconditioned conjugate gradients. The scatters add in float64: on
    CUDA ``index_add_`` adds with atomics in no fixed order, and a node's
    few float32 terms sum exactly in float64 while their magnitudes lie
    within 2^29 of one another, so the sums are the same from run to run
    and on the CPU.

    The JAX CG is a ``while_loop`` that stops after ``cg_iters`` or once
    the residual falls below ``cg_tol`` x |b|^2. Here every iteration's
    update is masked by that test, so a converged state stops changing
    (the same arithmetic as stopping), and the host reads the test only
    every ``_CG_CHECK`` iterations to leave the loop early: one device
    wait per eight iterations instead of one per iteration, and no
    launches past convergence beyond the last eight.

    ``group`` (a ``torch.distributed`` process group, the counterpart of
    the JAX ``axis_name``): the edge arrays are this rank's block of the
    edges, and every edge sum (the gradient, the preconditioner, each CG
    product and the cost) is all-reduced over the group. The scatters'
    float64 sums are reduced before they are rounded to float32, so the
    twists are the single-process solve's bit for bit; the cost, a float32
    sum over the edges, is summed in another order. Every rank reads the
    CG's exit test from the same reduced values, so the ranks stay in
    step.
    """
    dev, f32 = xi_nodes.device, torch.float32
    M = xi_nodes.shape[0]
    ei, ej = edges_ij[:, 0].long(), edges_ij[:, 1].long()
    eye6 = torch.eye(6, dtype=f32, device=dev)
    if n_fixed is not None:
        m = (torch.arange(M, device=dev) >= torch.as_tensor(
            n_fixed, device=dev)).to(f32)[:, None].expand(M, 6)
    elif fix_first:
        m = torch.ones((M, 6), dtype=f32, device=dev)
        m[0] = 0.0
    else:
        m = torch.ones((M, 6), dtype=f32, device=dev)
    mm = m[:, :, None] * m[:, None, :]
    frozen = m.amax(1, keepdim=True) == 0
    w = weights[:, None]

    def scatter(a, b):
        """(M, ...) float64 sum of a at the edges' first nodes and b at
        their second."""
        out = torch.zeros((M,) + a.shape[1:], dtype=torch.float64,
                          device=dev)
        return out.index_add_(0, ei, a.double()).index_add_(0, ej,
                                                            b.double())

    def esum(*xs):
        """float32 of float64 edge sums, summed over the group first."""
        if group is not None:
            xs = all_reduce(xs, group)
        return [x.to(f32) for x in xs]

    xi_all = xi_nodes
    costs = []
    for _ in range(iters):
        r, Ji, Jj = _edge_r_J(xi_all[ei], xi_all[ej], xi_meas)
        rw = r * w
        cost = (r**2 * w).sum()
        g = scatter(torch.einsum("eab,ea->eb", Ji, rw),
                    torch.einsum("eab,ea->eb", Jj, rw))
        # block-Jacobi preconditioner: per-node 6 x 6 diagonal blocks;
        # fixed / padded dofs act as identity rows
        diag = scatter(torch.einsum("eab,eac->ebc", Ji, Ji * w[..., None]),
                       torch.einsum("eab,eac->ebc", Jj, Jj * w[..., None]))
        g, diag = esum(g, diag)
        if group is not None:
            (cost,) = all_reduce([cost], group)
        g = g * m
        diag = diag + damping * eye6
        diag = diag * mm + (eye6 - eye6 * mm)
        diag_inv = torch.linalg.inv(diag)

        def matvec(v):
            vm = v * m
            s = (torch.einsum("eab,eb->ea", Ji, vm[ei])
                 + torch.einsum("eab,eb->ea", Jj, vm[ej])) * w
            (out,) = esum(scatter(torch.einsum("eab,ea->eb", Ji, s),
                                  torch.einsum("eab,ea->eb", Jj, s)))
            out = out + damping * vm
            return out * m + (v - vm)

        def precond(v):
            return torch.einsum("mab,mb->ma", diag_inv, v)

        # preconditioned CG on H d = -g
        b = -g
        d = torch.zeros((M, 6), dtype=f32, device=dev)
        rr = b
        z = precond(rr)
        p = z
        rz = (rr * z).sum()
        thresh = cg_tol * (b * b).sum()
        for k in range(cg_iters):
            active = (rr * rr).sum() > thresh
            if k % _CG_CHECK == 0 and not bool(active):
                break
            Hp = matvec(p)
            alpha = rz / (p * Hp).sum().clamp_min(1e-30)
            d_n = d + alpha * p
            rr_n = rr - alpha * Hp
            z_n = precond(rr_n)
            rz_n = (rr_n * z_n).sum()
            beta = rz_n / rz.clamp_min(1e-30)
            p_n = z_n + beta * p
            d = torch.where(active, d_n, d)
            rr = torch.where(active, rr_n, rr)
            z = torch.where(active, z_n, z)
            p = torch.where(active, p_n, p)
            rz = torch.where(active, rz_n, rz)
        xi_new = _retract(d * m, xi_all)
        # fully frozen nodes pass through bit for bit (retract(0, x) is a
        # log(exp(x)) round trip)
        xi_new = torch.where(frozen, xi_all, xi_new)
        costs.append(cost)
        xi_all = xi_new
    return xi_all, torch.stack(costs)


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
