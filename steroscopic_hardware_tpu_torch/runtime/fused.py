"""Fused serve+track (counterpart of ``runtime/fused.py``): one upload and
one copy back per micro-batch cover the depth serve AND the live SLAM
tracking step.

A micro-batch of B stereo pairs crosses to the device in ONE pinned copy
(``models/blockmatch.enqueue_serve``). On the device the serve step runs as
in the unfused pipeline (``serve_step`` / ``sgm_serve_step`` and
``pack_serve``), then ``models/slam._track_step`` runs on every frame of
the batch, chained on the device: frame b tracks against frame b-1's
features, frame 0 against the previous batch's newest. With BoW loop
closure the newest frame's place vector is computed there too. The packed
serve buffer and the track tail go back in ONE copy:

    [ serve buffer (raveled) | xi_rel B x 6 f32 | n_inl B x i32 | bow V x f32 ]

(the tail's bytes as ``fused.py:44-51`` of the JAX package lays them out;
the BoW part only with loop closure). The newest frame's features stay on
the device: they are the next batch's previous features, and a keyframe
ingest on the SLAM thread copies them to the host (``TrackResult``).

The JAX module keeps an executable cache with background recompiles,
because XLA compiles a program per parameter set; nothing compiles here,
so a retune applies to the next batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from steroscopic_hardware_tpu_torch.models.blockmatch import (
    SGMMatcher,
    enqueue_serve,
)
from steroscopic_hardware_tpu_torch.models.slam import (
    _to_host,
    _track_step,
    frame_scores,
)
from steroscopic_hardware_tpu_torch.ops.bow import _bow_vector

# track tail, bytes per tracked frame: the relative twist (6 x f32) and
# the inlier count (i32); the BoW vector (V x f32) once per batch
_XI_BYTES = 24
_NINL_BYTES = 4


def split_serve(flat, B, H, W, *, preview_scale=1, fetch_all=True,
                colorize_dev=True):
    """Decode the serve part of a fused buffer (track tail stripped) into
    ``(depths (kept, H, W), rgb or None)``, the layouts of the unfused
    ``compute_serve_async``."""
    kept = B if fetch_all else 1
    k = preview_scale
    if not colorize_dev:
        return flat[: kept * H * W].reshape(kept, H, W), None
    if fetch_all and k == 1:
        buf = flat[: (B + 3) * H * W].reshape(B + 3, H, W)
        return buf[:B], buf[B:].transpose(1, 2, 0)
    nd = kept * H * W
    rgb = flat[nd: nd + (H // k) * (W // k) * 3].reshape(H // k, W // k, 3)
    return flat[:nd].reshape(kept, H, W), rgb


@dataclasses.dataclass
class TrackResult:
    """One batch's tracking results, handed from the depth compute thread
    to the SLAM pipeline thread. Only the newest frame's features exist
    (on the device); every frame's relative twist does."""

    feat_dev: tuple          # newest frame's (xy, xy_sub, desc, valid,
    #                          pts, ok) on the device
    xi_rel: np.ndarray       # (B, 6) relative twists, frame b-1 -> b
    n_inl: np.ndarray        # (B,) PnP inlier support per frame
    bow_vec: np.ndarray | None  # (V,) newest frame's place vector
    bootstrap: bool          # chain root: xi_rel[0] is meaningless
    t_capture: float = 0.0   # bus capture timestamp of the newest frame
    # CUDA event recorded on the compute thread's stream after the step:
    # the reading thread's stream waits on it before it copies feat_dev
    ready: torch.cuda.Event | None = None

    def host_features(self) -> list[np.ndarray]:
        """The newest frame's features on the host."""
        if self.ready is not None:
            torch.cuda.current_stream(self.feat_dev[0].device).wait_event(
                self.ready)
        return _to_host(list(self.feat_dev))


class FusedServeTrack:
    """The fused serve+track step and the device-resident tracking chain.

    Driven by ``DepthPipeline._step_batch`` on the compute thread: one
    ``step`` per micro-batch does one upload, the serve step and the
    tracking of every frame of the batch, and one copy back.

    Args:
      matcher: the serving engine (``BlockMatcher`` or ``SGMMatcher``).
      slam: the ``StereoSLAM`` whose VO settings track the frames; it must
        live on the matcher's device.
    """

    def __init__(self, matcher, slam):
        if slam.device != matcher.device:
            raise ValueError(f"the SLAM engine is on {slam.device}, the "
                             f"matcher on {matcher.device}")
        self.matcher = matcher
        self.slam = slam
        self.engine = "sgm" if isinstance(matcher, SGMMatcher) else "sad"
        self.device = matcher.device
        vo = slam.vo
        self._static = dict(
            block_size=vo.block_size, max_disparity=vo.max_disparity,
            fast_threshold=vo.fast_threshold, max_keypoints=vo.max_keypoints,
            intr=slam.cam.intr, baseline=slam.cam.baseline,
            frontend=vo.frontend)
        # the VO's per-frame RANSAC draws (seed, frame counter): a batch of
        # one draws what StereoVO.process draws for the same frame. The
        # VO's own generator never runs in fused mode; this one is the
        # compute thread's.
        self.seed = vo.seed
        self._gen = torch.Generator(device=self.device)
        bow = getattr(slam, "_bow", None)
        self._words = bow.words if bow is not None else None
        self.bow_bytes = 4 * bow.n_words if bow is not None else 0
        self._prev_dev = None
        # the next frame's draw counter: 0, or a resumed engine's frame index
        self._ctr = slam.frame_idx
        self.device_ms: float | None = None  # the last step's device span

    def _zeros(self):
        K = self.slam.vo.max_keypoints
        dev = self.device
        return (torch.zeros((K, 256), dtype=torch.uint8, device=dev),
                torch.zeros((K,), dtype=torch.bool, device=dev),
                torch.zeros((K, 3), dtype=torch.float32, device=dev),
                torch.zeros((K,), dtype=torch.bool, device=dev))

    def step(self, pairs, *, lr=False, preview_scale=1, fetch_all=True,
             colorize_dev=True):
        """One fused step for a micro-batch of (left, right) pairs.

        Returns ``(serve_flat, TrackResult)``; ``serve_flat`` decodes with
        :func:`split_serve`.
        """
        serve = self.matcher.serve_fn(self.matcher.get_params(), lr,
                                      preview_scale, fetch_all, colorize_dev)
        bootstrap = self._prev_dev is None
        prev = self._zeros() if bootstrap else self._prev_dev
        ctr, K = self._ctr, self.slam.vo.max_keypoints
        feats = {}

        def serve_track(stacked):
            packed = serve(stacked)
            chain = prev
            xi_rels, n_inls = [], []
            for b in range(stacked.shape[0]):
                outs = _track_step(
                    stacked[b, 0], stacked[b, 1], *chain,
                    frame_scores(self._gen, self.seed, ctr + b, K,
                                 self.device), **self._static)
                chain = outs[2:6]
                xi_rels.append(outs[6])
                n_inls.append(outs[7])
            tail = [torch.stack(xi_rels).to(torch.float32),
                    torch.stack(n_inls).to(torch.int32)]
            if self._words is not None:
                tail.append(_bow_vector(outs[2], outs[3], self._words))
            feats["dev"] = outs[:6]
            return torch.cat([packed.reshape(-1)] + [
                t.contiguous().view(torch.uint8).reshape(-1) for t in tail])

        fut = enqueue_serve(self.device, self.matcher._launch_lock, pairs,
                            serve_track)
        flat = fut.result()
        self.device_ms = fut.device_ms()
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        B = len(pairs)
        self._ctr += B
        feat_dev = feats["dev"]
        self._prev_dev = feat_dev[2:6]

        tb = B * (_XI_BYTES + _NINL_BYTES) + self.bow_bytes
        serve_flat, tail = flat[:-tb], flat[-tb:]
        xi_rel = tail[: B * _XI_BYTES].copy().view(np.float32).reshape(B, 6)
        n_inl = tail[B * _XI_BYTES: B * (_XI_BYTES + _NINL_BYTES)].copy(
            ).view(np.int32)
        bow_vec = None
        if self.bow_bytes:
            bow_vec = tail[B * (_XI_BYTES + _NINL_BYTES):].copy().view(
                np.float32)
        return serve_flat, TrackResult(
            feat_dev=feat_dev, xi_rel=xi_rel, n_inl=n_inl, bow_vec=bow_vec,
            bootstrap=bootstrap, ready=ready)
