"""Camera manager: named source registry with hot-swap.

Parity with ``pkg/camera/manager.go:11-117``: a global-style registry keyed
by camera type (left/right/out); ``set_source`` pauses and closes any
existing source of that type before installing and starting the new one
(the pause-swap-resume dance, ``manager.go:45-84``); ``close_all`` tears
everything down for graceful shutdown (``manager.go:105-117``,
``cmd/root.go:76-84``).

The port's own copy of ``steroscopic_hardware_tpu/runtime/manager.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading

from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
from steroscopic_hardware_tpu_torch.runtime.logger import get_logger
from steroscopic_hardware_tpu_torch.runtime.sources import BaseSource


class CameraManager:
    def __init__(self, bus: FrameBus | None = None):
        self.bus = bus or FrameBus()
        self._lock = threading.RLock()
        self._sources: dict[str, BaseSource] = {}
        self.log = get_logger("manager")

    def set_source(self, name: str, source: BaseSource) -> BaseSource:
        with self._lock:
            old = self._sources.get(name)
            if old is not None:
                old.pause()
                old.close()
                self.log.info("replaced source %s", name)
            self._sources[name] = source
            source.start()
            return source

    def get_source(self, name: str) -> BaseSource | None:
        with self._lock:
            return self._sources.get(name)

    def pause_all(self):
        with self._lock:
            for s in self._sources.values():
                s.pause()

    def resume_all(self):
        with self._lock:
            for s in self._sources.values():
                s.resume()

    def close_all(self):
        with self._lock:
            for name, s in list(self._sources.items()):
                s.close()
                self.log.info("closed source %s", name)
            self._sources.clear()

    def status(self, stale_after: float = 2.0) -> dict:
        """Per-source status with failure detection: a source whose last
        bus frame is older than ``stale_after`` seconds is flagged
        ``stale`` (the watchdog the reference approximates with its 1 s
        UI health poll, SURVEY.md section 5)."""
        import time

        now = time.time()
        with self._lock:
            out = {}
            for name, s in self._sources.items():
                f = self.bus.latest(name)
                age = None if f is None else round(now - f.timestamp, 2)
                out[name] = {
                    "type": type(s).__name__,
                    "closed": s.closed,
                    "frames": s.frames_published,
                    "bus_seq": self.bus.seq(name),
                    "last_frame_age_s": age,
                    "stale": age is None or age > stale_after,
                }
            return out
