"""Timing utilities (counterpart of ``utils/timing.py``): rolling timers
with percentiles and throughput units (fps, Mpix/s), and one-line capture
of a ``torch.profiler`` trace.

``RollingTimer`` is the JAX module's, name for name; ``profiler_trace``
records with ``torch.profiler`` where the JAX module used
``jax.profiler``: the host's activity and, on a machine with a CUDA card,
the card's kernels and copies, written to ``logdir`` as a Chrome trace
(``chrome://tracing``, Perfetto or TensorBoard's profiler plugin).
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np


class RollingTimer:
    """Rolling window of durations with percentile/throughput stats."""

    def __init__(self, window: int = 200):
        self._samples = collections.deque(maxlen=window)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples.append(time.perf_counter() - t0)

    def add(self, seconds: float):
        self._samples.append(seconds)

    def stats(self, pixels: int | None = None) -> dict:
        if not self._samples:
            return {}
        a = np.array(self._samples)
        out = {
            "n": len(a),
            "ms_mean": round(float(a.mean()) * 1e3, 3),
            "ms_p50": round(float(np.median(a)) * 1e3, 3),
            "ms_p95": round(float(np.percentile(a, 95)) * 1e3, 3),
            "ms_max": round(float(a.max()) * 1e3, 3),
            "fps": round(1.0 / float(a.mean()), 2),
        }
        if pixels:
            out["mpix_per_s"] = round(pixels / 1e6 / float(a.mean()), 2)
        return out


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Capture a torch.profiler trace into ``logdir`` (one
    ``*.pt.trace.json`` per capture)."""
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
