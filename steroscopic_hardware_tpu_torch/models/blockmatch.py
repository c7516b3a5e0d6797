"""The stereo engines (counterpart of ``models/blockmatch.py``):
``BlockMatcher`` (SAD block matching) and ``SGMMatcher`` (census + SGM).

Each owns a live-retunable parameter store (``utils.params.ParamStore``)
and an explicit ``torch.device``. On a CUDA device every disparity comes
from the hand-written kernels of ``csrc/``; the plain torch versions run
only on an explicit CPU device. Block size, maximum disparity and the SGM
penalties are runtime arguments of the kernels, so a retune needs no
rebuild.

A serve step takes a (B, 2, H, W) uint8 micro-batch that crossed to the
device in ONE pinned copy and packs its result into ONE buffer that comes
back in one copy, in the three layouts of ``_pack_serve``:
``serve_step`` (the ``_disparity_serve`` counterpart) runs ONE SAD launch
over all B frames; ``sgm_serve_step`` (``_sgm_serve``) runs the SGM chain
per frame.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import torch

from steroscopic_hardware_tpu_torch import _kernels
from steroscopic_hardware_tpu_torch.ops.colorize import (
    colorize_disparity,
    downscale_u8,
)
from steroscopic_hardware_tpu_torch.ops.lr_check import check_from_raw
from steroscopic_hardware_tpu_torch.ops.sad import (
    disparity_batch,
    disparity_lr,
)
from steroscopic_hardware_tpu_torch.ops.sgm import (
    sgm_disparity,
    sgm_lr_checked,
)
from steroscopic_hardware_tpu_torch.utils.params import (
    VALID_BLOCK_SIZES,
    VALID_MAX_DISPARITIES,
    Parameters,
    ParamStore,
)


def resolve_device(device) -> torch.device:
    """The explicit device rule: "cuda" needs a usable GPU and raises
    without one (no silent CPU fallback); "cpu" runs the plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device 'cpu' to run the plain torch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def serve_step(stacked, *, block_size, max_disparity, lr=False,
               threshold=1, preview_scale=1, fetch_all=True,
               colorize_dev=True) -> torch.Tensor:
    """One serving step over a (B, 2, H, W) uint8 micro-batch on its device:
    one SAD launch for all B frames (plus the LR check when ``lr``), packed
    into one uint8 buffer:

    * ``colorize_dev=False``: the depths, (B, H, W), or only the newest,
      (1, H, W), when not ``fetch_all`` (the host colorizes via the LUT);
    * ``fetch_all`` and ``preview_scale == 1``: (B+3, H, W), the depths
      then the newest frame's RGB planes;
    * otherwise ("light"): 1D, the raveled depth(s) (only the newest when
      not ``fetch_all``) then the raveled (H//k, W//k, 3) RGB preview of
      the k x k mean-pooled newest depth.
    """
    lefts, rights = stacked[:, 0], stacked[:, 1]
    if lr:
        dL, dR = disparity_lr(lefts, rights, block_size=block_size,
                              max_disparity=max_disparity)
        depths, _valid = check_from_raw(dL, dR, stacked.shape[-1],
                                        max_disparity, threshold=threshold)
    else:
        depths = disparity_batch(lefts, rights, block_size=block_size,
                                 max_disparity=max_disparity)
    return pack_serve(depths, preview_scale, fetch_all, colorize_dev)


def pack_serve(depths, preview_scale, fetch_all, colorize_dev=True):
    """Pack a (B, H, W) uint8 depth batch (+ the newest frame's RGB) into
    ONE buffer, in the layouts ``serve_step`` lists."""
    kept = depths if fetch_all else depths[-1:]
    if not colorize_dev:
        return kept
    if fetch_all and preview_scale == 1:
        rgb_planes = colorize_disparity(depths[-1]).permute(2, 0, 1)
        return torch.cat([depths, rgb_planes], dim=0)
    rgb = colorize_disparity(downscale_u8(depths[-1], preview_scale))
    return torch.cat([kept.reshape(-1), rgb.reshape(-1)])


def _sgm_u8(disp, max_disparity) -> torch.Tensor:
    """The serving quantisation ``clip(d * 255 / maxD + 0.5, 0, 255)``."""
    return (disp * (255.0 / max_disparity) + 0.5).clamp(0, 255).to(torch.uint8)


def sgm_one(left, right, *, max_disparity, p1, p2, subpixel, lr,
            threshold) -> torch.Tensor:
    """One frame of the SGM serving step (the ``_sgm_one`` counterpart):
    uint8 disparity ``clip(d * 255 / maxD + 0.5, 0, 255)``, LR-masked to
    255 when ``lr``."""
    if lr:
        disp, valid = sgm_lr_checked(left, right, max_disparity=max_disparity,
                                     P1=p1, P2=p2, threshold=threshold)
    else:
        disp = sgm_disparity(left, right, max_disparity=max_disparity,
                             P1=p1, P2=p2, subpixel=subpixel)
    u8 = _sgm_u8(disp, max_disparity)
    if lr:
        u8 = torch.where(valid, u8, 255)
    return u8


def sgm_serve_step(stacked, *, max_disparity, p1, p2, subpixel, lr=False,
                   threshold=1.0, preview_scale=1, fetch_all=True,
                   colorize_dev=True) -> torch.Tensor:
    """The SGM counterpart of :func:`serve_step` (``_sgm_serve``): the SGM
    chain per frame of a (B, 2, H, W) micro-batch, packed the same way."""
    depths = torch.stack([
        sgm_one(stacked[b, 0], stacked[b, 1], max_disparity=max_disparity,
                p1=p1, p2=p2, subpixel=subpixel, lr=lr, threshold=threshold)
        for b in range(stacked.shape[0])])
    return pack_serve(depths, preview_scale, fetch_all, colorize_dev)


class ServeFuture:
    """The packed result of one serve step, copying back to the host.
    ``result()`` waits for the copy and returns the numpy array;
    ``device_ms()`` then gives the device span of the step."""

    def __init__(self, host: torch.Tensor, start: torch.cuda.Event | None = None,
                 done: torch.cuda.Event | None = None):
        self._host = host
        self._start = start
        self._done = done

    def result(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()

    def device_ms(self) -> float | None:
        """CUDA-event time from before the upload to after the copy back,
        in ms (None on the CPU). The host enqueues the step's operations
        back to back, so this is the device's busy time for the step plus
        at most the enqueue gaps between them. Call after ``result()``."""
        if self._start is None:
            return None
        return self._start.elapsed_time(self._done)


def enqueue_serve(device: torch.device, lock: threading.Lock, pairs,
                  step) -> ServeFuture:
    """Enqueue one serve step without waiting: stage the (left, right)
    uint8 arrays of one shape into ONE pinned (B, 2, H, W) host buffer,
    copy it to ``device``, run ``step`` (stacked device batch -> packed
    uint8 tensor) under ``lock``, and start ONE copy of the packed result
    back into pinned memory."""
    H, W = np.asarray(pairs[0][0]).shape
    cuda = device.type == "cuda"
    host = torch.empty((len(pairs), 2, H, W), dtype=torch.uint8,
                       pin_memory=cuda)
    staged = host.numpy()
    for b, (left, right) in enumerate(pairs):
        staged[b, 0] = left
        staged[b, 1] = right
    with lock:
        if cuda:
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        packed = step(host.to(device, non_blocking=True))
        if not cuda:
            return ServeFuture(packed)
        out = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        out.copy_(packed, non_blocking=True)
        done = torch.cuda.Event(enable_timing=True)
        done.record(stream)
    return ServeFuture(out, start, done)


class _Engine:
    """What both engines share: the parameter store, the explicit device
    and the lock that serializes their launches (the pipeline thread and a
    warmup or request thread)."""

    def __post_init__(self):
        self.store = ParamStore(self.params)
        self.device = resolve_device(self.device)
        self._launch_lock = threading.Lock()

    # -- live retuning (POST /update-params equivalent) ---------------------
    def set_params(self, params: Parameters) -> None:
        self.store.set(params)

    def get_params(self) -> Parameters:
        return self.store.get()

    def _pair(self, left, right):
        return (torch.as_tensor(np.asarray(left)).to(self.device),
                torch.as_tensor(np.asarray(right)).to(self.device))


@dataclasses.dataclass
class BlockMatcher(_Engine):
    """Stereo SAD block matcher with live-retunable parameters.

    Args:
      params: initial :class:`Parameters` (reference defaults: block 16,
        maxDisparity 64).
      device: "cuda" (the hand-written kernels; raises without a usable
        GPU) or "cpu" (the plain torch versions).
      lr_threshold: disparity tolerance of :meth:`compute_checked` and of
        the LR serve step (1 when unset).
    """

    params: Parameters = dataclasses.field(default_factory=Parameters)
    device: str | torch.device = "cuda"
    lr_threshold: int | None = None

    def _threshold(self) -> int:
        return 1 if self.lr_threshold is None else self.lr_threshold

    def compute(self, left, right) -> np.ndarray:
        """Full-frame uint8 disparity with the current parameters."""
        p = self.store.get()
        L, R = self._pair(left, right)
        with self._launch_lock:
            out = disparity_batch(L[None], R[None], block_size=p.block_size,
                                  max_disparity=p.max_disparity)
        return out[0].cpu().numpy()

    def compute_checked(self, left, right):
        """Disparity plus left-right consistency mask, both directions
        from one launch."""
        p = self.store.get()
        L, R = self._pair(left, right)
        with self._launch_lock:
            dL, dR = disparity_lr(L, R, block_size=p.block_size,
                                  max_disparity=p.max_disparity)
        disp, valid = check_from_raw(dL, dR, L.shape[-1], p.max_disparity,
                                     threshold=self._threshold())
        return disp.cpu().numpy(), valid.cpu().numpy()

    def compute_serve_async(self, pairs, lr: bool = False,
                            preview_scale: int = 1,
                            fetch_all: bool = True,
                            colorize_dev: bool = True) -> ServeFuture:
        """Enqueue the serve step for a micro-batch of frame pairs without
        waiting: ONE pinned (B, 2, H, W) host-to-device copy, one kernel
        launch over the B frames, ONE copy of the packed result back into
        pinned memory (layout per :func:`serve_step`).

        ``pairs``: list of (left, right) uint8 arrays of one shape.
        """
        return self._serve_async(self.store.get(), pairs, lr, preview_scale,
                                 fetch_all, colorize_dev)

    def serve_fn(self, p, lr, preview_scale, fetch_all, colorize_dev):
        """The serve step with parameters ``p`` as a function of the
        stacked device batch (also the serve half of the fused serve+track
        step, ``runtime/fused.py``)."""
        return functools.partial(
            serve_step, block_size=p.block_size,
            max_disparity=p.max_disparity, lr=lr,
            threshold=self._threshold(), preview_scale=preview_scale,
            fetch_all=fetch_all, colorize_dev=colorize_dev)

    def _serve_async(self, p, pairs, lr, preview_scale, fetch_all,
                     colorize_dev) -> ServeFuture:
        return enqueue_serve(self.device, self._launch_lock, pairs,
                             self.serve_fn(p, lr, preview_scale, fetch_all,
                                           colorize_dev))

    # -- warmup -------------------------------------------------------------
    def warmup(self, shape, params_list=None, lr: bool = False) -> int:
        """Warm the serve step for ``shape`` (the JAX ``warmup``'s
        signature and count). Without ``params_list`` it stands for the
        whole HTTP-API envelope (15 block sizes x 16 disparities). Each
        entry must be a :class:`Parameters` inside the kernels' envelope
        (block 1..63, maxDisparity 1..511; the reference's default block
        16 is even, so the HTTP rule would refuse it). Block size and
        disparity are runtime arguments of the kernels, so one launch
        with the first entry (and one more for the LR kernel with ``lr``)
        builds the kernel library for all of them. The launches take the
        entry as an argument and leave the current parameters as they
        are, so a pipeline serving meanwhile never sees them change.
        Returns the number of parameter sets warmed."""
        if params_list is None:
            params_list = [Parameters(b, d) for b in VALID_BLOCK_SIZES
                           for d in VALID_MAX_DISPARITIES]
        for p in params_list:
            if not isinstance(p, Parameters):
                raise TypeError(f"params_list entries must be Parameters, "
                                f"got {type(p).__name__}")
            if not (1 <= p.block_size <= _kernels.MAX_BLOCK_SIZE and
                    1 <= p.max_disparity <= _kernels.MAX_DISPARITY):
                raise ValueError(f"{p} outside the kernels' envelope")
        if not params_list:
            return 0
        zeros = np.zeros(shape, np.uint8)
        for with_lr in (False, True) if lr else (False,):
            self._serve_async(params_list[0], [(zeros, zeros)], with_lr, 1,
                              True, False).result()
        return len(params_list)


@dataclasses.dataclass
class SGMMatcher(_Engine):
    """Semi-global matching engine, a drop-in for :class:`BlockMatcher` in
    the pipeline: census costs, 4-path aggregation, subpixel parabola.
    Only ``max_disparity`` of the parameters applies. Like the JAX
    ``SGMMatcher`` it has no ``warmup``: the first frame builds the kernel
    library.

    Args:
      params: initial :class:`Parameters`.
      p1, p2: the smoothness penalties.
      subpixel: parabola refinement of :meth:`compute` and the serve step
        (the LR-checked maps always use it).
      device: "cuda" (the hand-written kernels; raises without a usable
        GPU) or "cpu" (the plain torch versions).
    """

    params: Parameters = dataclasses.field(default_factory=Parameters)
    p1: float = 1.0
    p2: float = 8.0
    subpixel: bool = True
    device: str | torch.device = "cuda"

    def compute_raw(self, left, right) -> np.ndarray:
        """Float32 (subpixel when enabled) disparity in pixels."""
        p = self.store.get()
        L, R = self._pair(left, right)
        with self._launch_lock:
            disp = sgm_disparity(L, R, max_disparity=p.max_disparity,
                                 P1=self.p1, P2=self.p2,
                                 subpixel=self.subpixel)
        return disp.cpu().numpy()

    def compute(self, left, right) -> np.ndarray:
        """uint8 disparity ``clip(d * 255 / maxD + 0.5, 0, 255)``."""
        p = self.store.get()
        L, R = self._pair(left, right)
        with self._launch_lock:
            out = sgm_one(L, R, max_disparity=p.max_disparity, p1=self.p1,
                          p2=self.p2, subpixel=self.subpixel, lr=False,
                          threshold=1.0)
        return out.cpu().numpy()

    def compute_checked(self, left, right):
        """uint8 disparity masked to 255 where the left-right check fails
        (the right map is the diagonal argmin of the same volume), and the
        valid mask."""
        p = self.store.get()
        L, R = self._pair(left, right)
        with self._launch_lock:
            disp, valid = sgm_lr_checked(L, R, max_disparity=p.max_disparity,
                                         P1=self.p1, P2=self.p2)
            out = torch.where(valid, _sgm_u8(disp, p.max_disparity), 255)
        return out.cpu().numpy(), valid.cpu().numpy()

    def compute_serve_async(self, pairs, lr: bool = False,
                            preview_scale: int = 1,
                            fetch_all: bool = True,
                            colorize_dev: bool = True) -> ServeFuture:
        """The serve step of :meth:`BlockMatcher.compute_serve_async` with
        the SGM chain per frame (:func:`sgm_serve_step`)."""
        return enqueue_serve(self.device, self._launch_lock, pairs,
                             self.serve_fn(self.store.get(), lr,
                                           preview_scale, fetch_all,
                                           colorize_dev))

    def serve_fn(self, p, lr, preview_scale, fetch_all, colorize_dev):
        """The SGM serve step with parameters ``p`` as a function of the
        stacked device batch (see :meth:`BlockMatcher.serve_fn`)."""
        return functools.partial(
            sgm_serve_step, max_disparity=p.max_disparity, p1=self.p1,
            p2=self.p2, subpixel=self.subpixel, lr=lr,
            preview_scale=preview_scale, fetch_all=fetch_all,
            colorize_dev=colorize_dev)


def sweep(left, right, block_sizes=VALID_BLOCK_SIZES,
          max_disparities=VALID_MAX_DISPARITIES, device="cuda"):
    """Parameter-sweep runner (BASELINE config #2, the JAX ``sweep``):
    yields ``(Parameters, disparity_map)`` over the block size x maximum
    disparity grid, through one :class:`BlockMatcher` on ``device``."""
    m = BlockMatcher(device=device)
    for b in block_sizes:
        for d in max_disparities:
            m.set_params(Parameters(b, d))
            yield m.get_params(), m.compute(left, right)
