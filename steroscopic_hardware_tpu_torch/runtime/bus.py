"""In-memory frame bus.

Replaces the reference's home-directory PNG file bus (``pkg/homedir``,
``pkg/camera/static.go:143``, ``output.go:134-162``): named slots each hold
the latest frame with a monotonically increasing sequence number;
consumers can poll the latest frame or block for the next one. Single
latest-value semantics match the reference (each iteration re-reads the
newest left/right file; intermediate frames are dropped by design).

The port's own copy of ``steroscopic_hardware_tpu/runtime/bus.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Frame:
    data: np.ndarray        # uint8 grayscale (H, W)
    seq: int
    timestamp: float
    source: str = ""


class FrameBus:
    """Thread-safe latest-frame slots keyed by stream name
    ("left" / "right" / "out" by convention, cmd/routes.go:59-70)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._slots: dict[str, Frame] = {}
        self._seqs: dict[str, int] = {}

    def publish(self, name: str, data: np.ndarray, source: str = "") -> Frame:
        with self._cond:
            seq = self._seqs.get(name, 0) + 1
            self._seqs[name] = seq
            frame = Frame(data=data, seq=seq, timestamp=time.time(),
                          source=source)
            self._slots[name] = frame
            self._cond.notify_all()
            return frame

    def latest(self, name: str) -> Frame | None:
        with self._lock:
            return self._slots.get(name)

    def wait_next(self, name: str, after_seq: int,
                  timeout: float | None = None) -> Frame | None:
        """Block until slot ``name`` holds a frame with seq > after_seq."""
        deadline = None if timeout is None else time.time() + timeout
        with self._cond:
            while True:
                f = self._slots.get(name)
                if f is not None and f.seq > after_seq:
                    return f
                remaining = (
                    None if deadline is None else deadline - time.time()
                )
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)

    def seq(self, name: str) -> int:
        with self._lock:
            return self._seqs.get(name, 0)

    def names(self) -> list[str]:
        with self._lock:
            return list(self._slots)
