"""Depth and SLAM pipelines (counterpart of ``runtime/pipeline.py``):
``DepthPipeline`` and ``SlamPipeline``.

``DepthPipeline`` blocks on the in-memory bus for fresh stereo pairs,
micro-batches up to ``max_batch`` of them, runs the matcher's serve step
(``BlockMatcher`` or ``SGMMatcher``: one upload and one fetch per batch;
with a ``StereoRectifier`` the raw pairs are rectified on the device after
the upload, so the published maps have the calibration's size),
publishes the depth maps to the ``out`` slot and the colorized newest
frame to the ``depth`` slot, and keeps rolling fps / latency metrics. With
a ``SlamPipeline`` and ``fuse_slam`` the serve step is the fused
serve+track step (``runtime/fused.py``): every frame of the batch is also
tracked, and the results go to the SLAM pipeline's thread.

``SlamPipeline`` runs a ``StereoSLAM`` over the bus (the newest pair,
rectified first with a calibrated rig, or the fused step's
``TrackResult``s in order), resumes from and writes
checkpoints, warms the backend at boot on its own thread, and keeps the
snapshot that ``GET /slam`` serves.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import zlib

import numpy as np

from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
from steroscopic_hardware_tpu_torch.runtime.logger import get_logger
from steroscopic_hardware_tpu_torch.models.blockmatch import BlockMatcher
from steroscopic_hardware_tpu_torch.ops.colorize import (
    colorize_disparity_lut,
)


def _mean_pool2d(img: np.ndarray, k: int) -> np.ndarray:
    """k x k host-side mean pool (uint8 in/out), matching the on-device
    preview downscale so the host-LUT light mode previews the same
    content."""
    if k <= 1:
        return img
    H, W = img.shape[:2]
    h, w = H - H % k, W - W % k
    pooled = (
        img[:h, :w].reshape(h // k, k, w // k, k)
        .astype(np.float32).mean(axis=(1, 3))
    )
    return np.round(pooled).astype(np.uint8)


class DepthPipeline:
    def __init__(self, bus: FrameBus, matcher: BlockMatcher,
                 left_slot="left", right_slot="right", out_slot="out",
                 lr_check: bool = False, colorize: bool = True,
                 rectifier=None, depth_slot="depth", max_batch: int = 8,
                 preview_scale: int = 1, host_colorize: bool = True,
                 max_queue: int | None = None, dedup_uploads: bool = False,
                 slam_pipeline=None, fuse_slam: bool = True):
        self.bus = bus
        self.matcher = matcher
        # calibrated rig: the uploaded batch is rectified on the device
        # (one upload and one copy back per batch, as unrectified)
        if rectifier is not None:
            rectifier.check_device(matcher.device)
        self.rectifier = rectifier
        self.max_batch = max_batch
        # fused serve+track: with a SLAM pipeline on the same frames, one
        # upload and one copy back per batch cover the depth serve and the
        # tracking of every frame (runtime/fused.py)
        self.slam_pipeline = slam_pipeline
        self._fused = None
        if slam_pipeline is not None and fuse_slam:
            from steroscopic_hardware_tpu_torch.runtime.fused import (
                FusedServeTrack,
            )

            self._fused = FusedServeTrack(matcher, slam_pipeline.slam,
                                          rectifier)
            slam_pipeline.enable_fused()
        # preview_scale > 1: "light" fetches — only the newest depth comes
        # back full-res and the RGB preview is k x k mean-pooled before
        # colorization; out/depth then carry one frame per batch
        self.preview_scale = max(1, int(preview_scale))
        # host_colorize: fetch uint8 disparity only and apply the Turbo
        # palette host-side via the 256-entry LUT (1 byte/pixel on the
        # copy back instead of 1+3); False colorizes on the device
        self.host_colorize = host_colorize
        self.left_slot = left_slot
        self.right_slot = right_slot
        self.out_slot = out_slot
        self.depth_slot = depth_slot
        self.lr_check = lr_check
        self.colorize = colorize
        self.log = get_logger("pipeline")
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        self._times = collections.deque(maxlen=100)   # per-frame latency
        self._pub_times = collections.deque(maxlen=100)  # publish stamps
        self._times_lock = threading.Lock()
        # queue-depth cap (drop-OLDEST): backlog becomes counted drops,
        # not latency. Default: one batch deep.
        self.max_queue = max(1, int(max_queue)) if max_queue else max_batch
        # capture->publish latency decomposition (seconds):
        #   queue  — capture to dispatch start (backlog wait)
        #   serve  — upload + kernel + copy back
        #   host   — host colorize + bus publish
        self._lat_parts = {
            "queue": collections.deque(maxlen=100),
            "serve": collections.deque(maxlen=100),
            "host": collections.deque(maxlen=100),
        }
        self.frames = 0
        self.batches = 0
        # seconds of device time in serve steps (CUDA events around each
        # step, BlockMatcher ServeFuture.device_ms); the device's busy
        # share over a window is its growth over the window's wall time.
        # None on the CPU.
        self.device_s = 0.0 if matcher.device.type == "cuda" else None
        self.errors = 0
        self.dropped = 0        # coalesced in light mode / batch-trimmed
        self.queue_dropped = 0  # overwritten in the capped inbox
        # opt-in: skip byte-identical consecutive pairs before upload
        self.dedup_uploads = dedup_uploads
        self.dup_skipped = 0
        self._last_pair_crc: int | None = None
        self._busy_since: float | None = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: float = 5.0):
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def _frames_in(self):
        lf = self.bus.latest(self.left_slot)
        rf = self.bus.latest(self.right_slot)
        if lf is None or rf is None:
            return None
        left, right = lf.data, rf.data
        if left.shape != right.shape:
            # mismatched feeds: crop to the common size
            h = min(left.shape[0], right.shape[0])
            w = min(left.shape[1], right.shape[1])
            left, right = left[:h, :w], right[:h, :w]
        return left, right

    def _out_shape(self, frames):
        """(H, W) of the served maps: the calibration's size, or the raw
        frames'."""
        if self.rectifier is not None:
            return self.rectifier.size
        return frames[-1][0].shape

    def _serve(self, frames, **kw) -> np.ndarray:
        """Run the matcher's serve step, wait for its result and add its
        device span to ``device_s``."""
        fut = self.matcher.compute_serve_async(
            frames, lr=self.lr_check, rectifier=self.rectifier, **kw)
        out = fut.result()
        ms = fut.device_ms()
        if ms is not None:
            self.device_s += ms / 1000
        return out

    def _serve_fused(self, frames, t_capture):
        """The fused serve+track step: the serve layouts of the unfused
        modes, and the batch's TrackResult handed to the SLAM pipeline."""
        from steroscopic_hardware_tpu_torch.runtime.fused import split_serve

        k = self.preview_scale
        if not self.colorize:
            sargs = dict(fetch_all=True, colorize_dev=False)
        elif self.host_colorize:
            sargs = dict(fetch_all=(k == 1), colorize_dev=False)
        elif k > 1:
            sargs = dict(preview_scale=k, fetch_all=False)
        else:
            sargs = {}
        flat, track = self._fused.step(frames, lr=self.lr_check, **sargs)
        if self._fused.device_ms is not None:
            self.device_s += self._fused.device_ms / 1000
        track.t_capture = t_capture
        self.slam_pipeline.submit_track(track)
        H, W = self._out_shape(frames)
        return split_serve(flat, len(frames), H, W, **sargs)

    def _step_batch(self, pairs) -> np.ndarray:
        """Compute and publish one micro-batch: B frame pairs ride one
        upload, one kernel launch (plus the LR check and, with device
        colorization, the Turbo colormap) and one copy back."""
        t0s = [t for t, _ in pairs]
        t_start = time.time()
        k = self.preview_scale
        frames = [p for _, p in pairs]
        H, W = self._out_shape(frames)
        rgb = None
        if self._fused is not None:
            depths, rgb = self._serve_fused(frames, t0s[-1])
            t_serve_end = time.time()
            if self.colorize and self.host_colorize:
                rgb = colorize_disparity_lut(_mean_pool2d(depths[-1], k))
        elif not self.colorize or self.host_colorize:
            # depth-only fetch; with preview_scale > 1 only the newest
            # frame comes back (light mode)
            depths = self._serve(
                frames, fetch_all=(k == 1 or not self.colorize),
                colorize_dev=False,
            )
            t_serve_end = time.time()
            if self.colorize:
                rgb = colorize_disparity_lut(_mean_pool2d(depths[-1], k))
        elif k > 1:
            # light fetch: 1D [newest depth | downscaled RGB preview]
            flat = self._serve(frames, preview_scale=k, fetch_all=False)
            want = H * W + (H // k) * (W // k) * 3
            if flat.size != want:
                raise ValueError(
                    f"light serve fetch returned {flat.size} elements, "
                    f"expected {want} for shape {H}x{W} preview_scale={k}"
                )
            t_serve_end = time.time()
            depths = flat[: H * W].reshape(1, H, W)
            rgb = flat[H * W:].reshape(H // k, W // k, 3)
        else:
            packed = self._serve(frames)
            t_serve_end = time.time()
            B = len(pairs)
            depths = packed[:B]
            rgb = packed[B:].transpose(1, 2, 0)
        for b in range(depths.shape[0]):
            self.bus.publish(self.out_slot, depths[b],
                             source="DepthPipeline")
        if rgb is not None:
            self.bus.publish(
                self.depth_slot, np.ascontiguousarray(rgb),
                source="DepthPipeline",
            )
        # in light mode only depths.shape[0] frames were published; fps
        # reflects published throughput, coalesced frames count as dropped
        published = depths.shape[0]
        now = time.time()
        with self._times_lock:
            for t0 in t0s[-published:]:
                self._times.append(now - t0)
                self._pub_times.append(now)
                self._lat_parts["queue"].append(t_start - t0)
                self._lat_parts["serve"].append(t_serve_end - t_start)
                self._lat_parts["host"].append(now - t_serve_end)
        self.frames += published
        self.batches += 1
        self.dropped += len(t0s) - published
        return depths[-1]

    def step(self) -> np.ndarray | None:
        """One synchronous pipeline iteration (for tests and batch use)."""
        self._busy_since = time.time()
        try:
            pair = self._frames_in()
            if pair is None:
                return None
            return self._step_batch([(time.time(), pair)])
        finally:
            self._busy_since = None

    def _collect(self, buf, lock, fresh):
        """Collector thread: snapshot every new bus pair into ``buf`` so
        the compute thread can batch the frames that arrived while the
        previous batch was in flight."""
        last_seq = 0
        while not self._closed.is_set():
            f = self.bus.wait_next(self.left_slot, last_seq, timeout=0.5)
            if f is None:
                continue
            last_seq = f.seq
            pair = self._frames_in()
            if pair is None:
                continue
            if self.dedup_uploads:
                crc = (zlib.crc32(pair[0].tobytes())
                       ^ (zlib.crc32(pair[1].tobytes()) << 1))
                if crc == self._last_pair_crc:
                    self.dup_skipped += 1
                    continue
                self._last_pair_crc = crc
            with lock:
                if len(buf) == buf.maxlen:
                    # drop-OLDEST at the queue cap
                    self.queue_dropped += 1
                buf.append((time.time(), pair))
            fresh.set()

    def _run(self):
        buf = collections.deque(maxlen=min(self.max_queue,
                                           self.max_batch))
        lock = threading.Lock()
        fresh = threading.Event()
        collector = threading.Thread(
            target=self._collect, args=(buf, lock, fresh), daemon=True
        )
        collector.start()
        while not self._closed.is_set():
            if not fresh.wait(timeout=0.5):
                continue
            with lock:
                pairs = list(buf)
                buf.clear()
                fresh.clear()
            if not pairs:
                continue
            # power-of-two batch of the NEWEST pairs (B in {1, 2, 4, 8});
            # older frames drop — latest-frame semantics
            B = 1
            while B * 2 <= len(pairs) and B * 2 <= self.max_batch:
                B *= 2
            self.dropped += len(pairs) - B
            pairs = pairs[-B:]
            try:
                self._busy_since = time.time()
                self._step_batch(pairs)
                self._busy_since = None
            except Exception as e:  # keep the loop alive
                self._busy_since = None
                self.errors += 1
                self.log.warning("pipeline error: %s", e)
                time.sleep(0.01)
        collector.join(1.0)

    def _state(self) -> str:
        """Human-readable pipeline state: surfaces a stuck first launch
        (e.g. the kernel build) instead of a silent frames=0."""
        busy = self._busy_since
        if busy is not None:
            elapsed = time.time() - busy
            if self.frames == 0:
                return (f"building first kernel ({elapsed:.0f}s)"
                        if elapsed > 2 else "computing")
            if elapsed > 10:
                return f"stalled in compute ({elapsed:.0f}s)"
            return "computing"
        return "running" if self.frames else "waiting for frames"

    def metrics(self) -> dict:
        with self._times_lock:
            times = list(self._times)
            pubs = list(self._pub_times)
            lat = {k: list(v) for k, v in self._lat_parts.items()}
        if not times:
            return {"frames": self.frames, "batches": self.batches,
                    "device_s": self.device_s,
                    "errors": self.errors, "dropped": self.dropped,
                    "queue_dropped": self.queue_dropped,
                    "state": self._state()}
        p = self.matcher.get_params()
        arr = np.array(times)
        # throughput from publish intervals; latency percentiles from
        # capture->publish times
        if len(pubs) >= 2:
            fps = (len(pubs) - 1) / max(pubs[-1] - pubs[0], 1e-6)
        else:
            fps = 1.0 / float(arr.mean())
        out = {
            "frames": self.frames,
            "batches": self.batches,
            "device_s": self.device_s,
            "errors": self.errors,
            "dropped": self.dropped,
            "queue_dropped": self.queue_dropped,
            "dup_skipped": self.dup_skipped,
            "state": self._state(),
            "fps": round(float(fps), 2),
            "ms_mean": round(float(arr.mean()) * 1000, 2),
            "ms_p50": round(float(np.median(arr)) * 1000, 2),
            "ms_p95": round(float(np.percentile(arr, 95)) * 1000, 2),
            "block_size": p.block_size,
            "max_disparity": p.max_disparity,
        }
        # capture->publish latency decomposed: queue wait vs serve (upload
        # + kernel + copy back) vs host colorize+publish, p50/p95 ms
        for name, vals in lat.items():
            if vals:
                a = np.array(vals) * 1000
                out[f"lat_{name}_p50"] = round(float(np.median(a)), 2)
                out[f"lat_{name}_p95"] = round(
                    float(np.percentile(a, 95)), 2)
        return out


class SlamPipeline:
    """Live stereo SLAM over the frame bus: a ``StereoSLAM`` fed the newest
    left / right pair (or, fused, every frame the depth pipeline tracked),
    and the running trajectory served at ``GET /slam``.

    Args:
      bus: the frame bus.
      camera: the rig's ``StereoCamera``.
      slam_kwargs: ``StereoSLAM`` arguments (``device`` among them); the
        asynchronous backend is the default here, so BA and pose-graph
        solves never stall the frame loop.
      checkpoint_dir: resume from the newest checkpoint there and write one
        every ``checkpoint_every`` frames (keeping the newest three).
      rectifier: a ``StereoRectifier``; unfused, each pair is rectified
        before ``StereoSLAM.process`` (a round trip to the rectifier's
        device; fused, the depth pipeline's step rectifies).
    """

    # fused TrackResults queued beyond this many drop the oldest (a dead or
    # stalled consumer); the next one then re-bootstraps the pose chain
    FUSED_BACKLOG = 1000

    def __init__(self, bus: FrameBus, camera, *, left_slot="left",
                 right_slot="right", slam_kwargs=None,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 50, rectifier=None):
        from steroscopic_hardware_tpu_torch.models.slam import StereoSLAM

        slam_kwargs = dict(slam_kwargs or {})
        slam_kwargs.setdefault("async_backend", True)
        self.bus = bus
        self.left_slot = left_slot
        self.right_slot = right_slot
        self.rectifier = rectifier
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.log = get_logger("slam")
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        self._warm_thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._snapshot = None
        self.frames = 0
        self.errors = 0
        self._warm_done = False
        # fused mode: the depth pipeline tracks inside its serve step and
        # submits TrackResults; the run loop consumes them in order
        self.fused = False
        self._fused_q: collections.deque | None = None
        self._fused_cv = threading.Condition()
        self.fused_dropped = 0

        # elastic recovery: resume from the newest checkpoint if present
        self.slam = None
        if checkpoint_dir is not None:
            from steroscopic_hardware_tpu_torch.utils import checkpoint as ckpt

            path = ckpt.latest(checkpoint_dir)
            if path is not None:
                try:
                    self.slam = StereoSLAM.load_checkpoint(path, **slam_kwargs)
                    self.frames = self.slam.frame_idx
                    self.log.info("resumed SLAM from %s (frame %d)", path,
                                  self.frames)
                except Exception as e:  # a bad file must not stop serving
                    self.log.warning("checkpoint resume failed: %s", e)
        if self.slam is None:
            self.slam = StereoSLAM(camera, **slam_kwargs)

    def start(self):
        if self._thread is None:
            # warm the backend's solvers in a boot thread so the first live
            # loop closure does not pay for the first BLAS / solver calls
            def _warm():
                try:
                    t0 = time.time()
                    n = self.slam.warmup_backend(
                        should_stop=self._closed.is_set)
                    self.log.info("backend warmup: %d solver runs in %.1fs",
                                  n, time.time() - t0)
                    self._warm_done = True
                except Exception as e:  # serving goes on without it
                    self.log.warning("backend warmup failed: %s", e)

            self._warm_thread = threading.Thread(
                target=_warm, daemon=True, name="slam-warmup")
            self._warm_thread.start()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="slam")
            self._thread.start()
        return self

    def close(self, timeout: float = 5.0):
        self._closed.set()
        with self._fused_cv:
            self._fused_cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        if self._warm_thread is not None:
            self._warm_thread.join(120.0)
        self.slam.close()

    def enable_fused(self):
        """Switch to fused ingestion (called, before start(), by the
        DepthPipeline that owns the fused serve+track step)."""
        self._fused_q = collections.deque()
        self.fused = True
        return self

    def submit_track(self, track) -> None:
        """Hand one TrackResult from the depth compute thread to this
        pipeline's thread. Past ``FUSED_BACKLOG`` queued results the oldest
        is dropped (counted in ``fused_dropped``); it was a link of the
        relative-pose chain, so the result after it is marked as a
        re-bootstrap and the chain does not compose across the gap."""
        if self._fused_q is None:
            return
        with self._fused_cv:
            q = self._fused_q
            if len(q) >= self.FUSED_BACKLOG:
                q.popleft()
                self.fused_dropped += 1
                (q[0] if q else track).bootstrap = True
            q.append(track)
            self._fused_cv.notify()

    def _next_track(self, timeout: float):
        with self._fused_cv:
            if not self._fused_q:
                self._fused_cv.wait(timeout)
            return self._fused_q.popleft() if self._fused_q else None

    def step(self):
        """Track the newest bus pair (unfused mode; tests and batch use)."""
        lf = self.bus.latest(self.left_slot)
        rf = self.bus.latest(self.right_slot)
        if lf is None or rf is None:
            return None
        left, right = lf.data, rf.data
        if left.shape != right.shape:
            # mismatched feeds: crop to the common size like DepthPipeline
            h = min(left.shape[0], right.shape[0])
            w = min(left.shape[1], right.shape[1])
            left, right = left[:h, :w], right[:h, :w]
        if self.rectifier is not None:
            left, right = self.rectifier(left, right)
        xi = self.slam.process(left, right)
        self.frames += 1
        self._after_step()
        return xi

    def _after_step(self):
        # refresh the cached snapshot so /slam never waits on the compute
        slam = self.slam
        snap = {
            "frames": self.frames,
            "errors": self.errors,
            "keyframes": len(slam.kf_history),
            "ba_runs": slam.ba_runs,
            "loops_closed": slam.loops_closed,
            "backend_pending": slam.backend_pending,
            "backend_coalesced": slam.backend_coalesced,
            "loop_checks_skipped": slam.loop_checks_skipped,
            "culled_keyframes": slam.culled_keyframes,
            "warm": self._warm_done,
            "fused": self.fused,
            "fused_dropped": self.fused_dropped,
            # cumulative per-stage seconds (vo / ba / loop / graph)
            "stage_s": {k: round(v, 3) for k, v in slam.stage_s.items()},
            "inliers": list(slam.vo.n_inliers[-20:]),
            # the newest 4096 poses only: the trajectory grows at stream
            # rate; positions_total keeps the count
            "positions": slam.vo.positions(tail=4096).tolist(),
            "positions_total": len(slam.vo.trajectory),
        }
        with self._lock:
            self._snapshot = snap
        if (self.checkpoint_dir is not None
                and self.frames % self.checkpoint_every == 0):
            self._save_checkpoint()

    def _save_checkpoint(self):
        from steroscopic_hardware_tpu_torch.utils import checkpoint as ckpt

        try:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            path = os.path.join(self.checkpoint_dir,
                                f"slam-{self.frames:08d}.ckpt")
            self.slam.save_checkpoint(path)
            ckpt.prune(self.checkpoint_dir, keep=3)
            self.log.info("checkpoint saved %s", path)
        except Exception as e:  # a full disk must not stop tracking
            self.log.warning("checkpoint save failed: %s", e)

    def _run(self):
        if self.fused:
            self._run_fused()
            return
        last_seq = 0
        while not self._closed.is_set():
            f = self.bus.wait_next(self.left_slot, last_seq, timeout=0.5)
            if f is None:
                continue
            last_seq = f.seq
            try:
                self.step()
            except Exception as e:  # keep the loop alive
                self.errors += 1
                self.log.warning("slam error: %s", e)
                time.sleep(0.01)

    def _run_fused(self):
        """Consume the fused step's TrackResults in order: each carries
        one link of the relative-pose chain."""
        while not self._closed.is_set():
            track = self._next_track(0.5)
            if track is None:
                continue
            try:
                self.slam.process_tracked(track)
                self.frames += 1
                self._after_step()
            except Exception as e:  # keep the loop alive
                self.errors += 1
                self.log.warning("slam fused error: %s", e)

    def snapshot(self) -> dict:
        with self._lock:
            snap = self._snapshot
        if snap is None:
            return {"frames": 0, "errors": self.errors, "keyframes": 0,
                    "ba_runs": 0, "loops_closed": 0, "inliers": [],
                    "positions": []}
        return snap
