"""Structured logging with an in-memory ring buffer.

Parity with ``pkg/logger/logger.go:26-73``: every record goes to stderr
*and* to a bounded in-memory buffer that can be dumped (the reference
serves it at ``GET /exit`` and saves it on shutdown, ``cmd/root.go:80``,
``cmd/routes.go:38-44``). Subsystem loggers use dotted names the way the
reference uses ``WithGroup`` (e.g. ``serial-camera-left``).

The port's own copy of ``steroscopic_hardware_tpu/runtime/logger.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time

_BUFFER_MAX = 10_000


class _RingBufferHandler(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = collections.deque(maxlen=_BUFFER_MAX)
        self._lock2 = threading.Lock()

    def emit(self, record):
        entry = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.args and isinstance(record.args, dict):
            entry.update(record.args)
        with self._lock2:
            self.records.append(entry)

    def dump(self) -> bytes:
        with self._lock2:
            lines = [json.dumps(r) for r in self.records]
        return ("\n".join(lines) + "\n").encode()


_handler: _RingBufferHandler | None = None
_setup_lock = threading.Lock()


def setup() -> _RingBufferHandler:
    """Install the fan-out handlers on the package root logger (idempotent)."""
    global _handler
    with _setup_lock:
        if _handler is None:
            _handler = _RingBufferHandler()
            root = logging.getLogger("shtpu")
            root.setLevel(logging.INFO)
            stream = logging.StreamHandler()
            stream.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s %(message)s"
            ))
            root.addHandler(stream)
            root.addHandler(_handler)
        return _handler


def get_logger(subsystem: str) -> logging.Logger:
    setup()
    return logging.getLogger(f"shtpu.{subsystem}")


def dump_buffer() -> bytes:
    """The GET /exit payload (routes.go:38-44 equivalent)."""
    return setup().dump()


def log_timing(logger: logging.Logger, msg: str, start: float, **fields):
    """Elapsed-time structured log, the reference's only perf metric style
    (pkg/camera/output.go:200-204)."""
    fields["elapsed_ms"] = round((time.time() - start) * 1000, 2)
    logger.info("%s %s", msg, json.dumps(fields))
