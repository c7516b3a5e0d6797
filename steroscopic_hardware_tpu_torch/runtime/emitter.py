"""Camera-device emitter: the protocol-level fake of a capture board.

Plays the role of the Zedboard firmware loop (``camera_app.c:130-233``:
wait for 0xFFD8, ack 0x01, stream frames, stop on 0xFFD9) over TCP. Used
by tests as the fake backend (the reference's own strategy: protocol
assertions without real hardware, ``image_receive/image_receive.c:142-225``)
and usable as a real bridge process feeding live imagery into the engine.

The port's own copy of ``steroscopic_hardware_tpu/runtime/emitter.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import select
import socket
import threading

import numpy as np

from steroscopic_hardware_tpu_torch.runtime import wire
from steroscopic_hardware_tpu_torch.runtime.logger import get_logger

# Live-emitter registry: the TCP analog of the reference's serial-port
# enumeration (cmd/handlers/ports.go:14-61). Emitters register on start
# and deregister on close so GET /ports can advertise real, currently
# listening ingest endpoints instead of a stub.
_registry: dict[int, "CameraEmitter"] = {}
_registry_lock = threading.Lock()


def list_emitters() -> list[dict]:
    """Snapshot of live emitters: [{host, port, codec, fps}]."""
    with _registry_lock:
        ems = list(_registry.values())
    return [
        {"host": e.host, "port": e.port, "codec": e.codec, "fps": e.fps}
        for e in ems
    ]


class SerialEmitter:
    """Firmware loop over a raw file descriptor (serial device or pty
    master): wait for 0xFFD8, ack 0x01, stream frames, stop on 0xFFD9 —
    the fd-level twin of :class:`CameraEmitter`, playing the Zedboard
    UART firmware (``camera_app.c:130-233``) against
    ``runtime.sources.SerialSource``. Tests attach it to the master end
    of ``os.openpty()`` for a hardware-free full-protocol drive."""

    POLL_S = 0.1  # select timeout: how soon the loop sees close()

    def __init__(self, frame_fn, fd: int, codec: int = wire.CODEC_RAW,
                 fps: float = 30.0, max_frames: int | None = None):
        self.frame_fn = frame_fn
        self.fd = fd
        self.codec = codec
        self.fps = fps
        self.max_frames = max_frames
        self.frames_sent = 0
        self.log = get_logger("SerialEmitter")
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def close(self):
        """Stop the loop, wait for its thread, then close the descriptor:
        the thread waits in ``select`` with a short timeout and never
        blocks in a read or a write, so it ends within one poll and no
        thread touches the descriptor number after it is closed (the JAX
        package's copy closes it under a writer that may be blocked on a
        full line, and the number may by then belong to another file)."""
        self._closed.set()
        if self._thread.ident is not None:
            self._thread.join(5.0)
        try:
            os.close(self.fd)
        except OSError:
            pass

    def _wait(self, write: bool) -> bool:
        """Poll the descriptor until it is readable (writable); False once
        closed."""
        while not self._closed.is_set():
            ready = select.select([] if write else [self.fd],
                                  [self.fd] if write else [], [], self.POLL_S)
            if ready[0] or ready[1]:
                return True
        return False

    def _read(self, n: int) -> bytes:
        try:
            return os.read(self.fd, n)
        except BlockingIOError:
            return b""

    def _write_all(self, blob: bytes) -> bool:
        off = 0
        while off < len(blob):
            if not self._wait(write=True):
                return False
            try:
                off += os.write(self.fd, blob[off:])
            except BlockingIOError:
                pass
        return True

    def _serve(self):
        import time

        try:
            os.set_blocking(self.fd, False)
            # scan for the start request: slide a 2-byte window over the
            # line until it reads START_SEQ, so leading noise bytes are
            # skipped as the firmware skips them (the JAX package's copy
            # gives up after the first two bytes)
            start = b""
            while start != wire.START_SEQ:
                if not self._wait(write=False):
                    return
                chunk = self._read(1)
                if not chunk:
                    return
                start = (start + chunk)[-2:]
            if not self._write_all(wire.ACK):
                return
            n = 0
            period = 1.0 / self.fps
            ctrl = b""
            while not self._closed.is_set():
                if self.max_frames is not None and n >= self.max_frames:
                    break
                ctrl = (ctrl + self._read(16))[-4:]
                if wire.END_SEQ in ctrl:
                    break
                frame = np.asarray(self.frame_fn(n), dtype=np.uint8)
                if not self._write_all(wire.encode_frame(frame,
                                                         codec=self.codec)):
                    break
                self.frames_sent = n = n + 1
                time.sleep(period)
        except OSError:
            pass


class CameraEmitter:
    """TCP server that streams frames from ``frame_fn(index) -> ndarray``
    to every client that sends the start sequence."""

    def __init__(self, frame_fn, host="127.0.0.1", port=0,
                 codec: int = wire.CODEC_RAW, fps: float = 30.0,
                 max_frames: int | None = None):
        self.frame_fn = frame_fn
        self.host = host
        self.codec = codec
        self.fps = fps
        self.max_frames = max_frames
        self.log = get_logger("CameraEmitter")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)

    def start(self):
        self._thread.start()
        with _registry_lock:
            _registry[id(self)] = self
        return self

    def close(self):
        self._closed.set()
        with _registry_lock:
            _registry.pop(id(self), None)
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self):
        while not self._closed.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                break
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn: socket.socket):
        import time

        with conn:
            try:
                start = b""
                while len(start) < 2:  # tolerate split TCP delivery
                    chunk = conn.recv(2 - len(start))
                    if not chunk:
                        return
                    start += chunk
                if start != wire.START_SEQ:
                    return
                conn.sendall(wire.ACK)
                conn.setblocking(False)
                n = 0
                period = 1.0 / self.fps
                ctrl = b""  # rolling control-byte buffer (split-safe)
                while not self._closed.is_set():
                    if self.max_frames is not None and n >= self.max_frames:
                        break
                    # non-blocking check for the stop sequence
                    try:
                        data = conn.recv(2)
                        if data == b"":
                            break
                        ctrl = (ctrl + data)[-4:]
                        if wire.END_SEQ in ctrl:
                            break
                    except BlockingIOError:
                        pass
                    frame = np.asarray(self.frame_fn(n), dtype=np.uint8)
                    conn.setblocking(True)
                    conn.sendall(wire.encode_frame(frame, codec=self.codec))
                    conn.setblocking(False)
                    n += 1
                    time.sleep(period)
            except (OSError, BrokenPipeError):
                pass
