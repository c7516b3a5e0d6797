"""Frame sources — the ``Camera`` interface equivalent.

The reference defines a ``Camera`` interface with Stream/Pause/Resume/Close
and three implementations (``pkg/camera/types.go:32-45``): a file-backed
static camera on a 10 Hz ticker (``static.go:45``), a UART serial camera
speaking the start/ack/stop raw-gray protocol (``serial.go``), and the
output camera that runs the compute loop (``output.go``, reimplemented in
``runtime/pipeline.py``). Here:

* ``StaticSource``    — re-reads an image file at a fixed rate (upload and
                        test-image boot path, ``cmd/root.go:160-189``).
* ``SyntheticSource`` — procedurally generated stereo-shifted noise frames
                        (the golden-vector pattern of ``hardware/test.py``
                        as a live source; useful for soak tests).
* ``TcpSource``       — connects to a camera endpoint over TCP and speaks
                        the reference's wire protocol semantics (start
                        0xFFD8 / ack 0x01 / payload / stop 0xFFD9, framed
                        headers — ``serial.go:17-27``, ``camera_app.c:130-233``)
                        with reconnect + exponential backoff
                        (``serial.go:181-229``).
* ``SerialSource``    — the same protocol over a REAL serial device
                        (raw termios 8N1, ``serial.go:46-91``); see the
                        class docstring.

Each source runs a daemon thread publishing grayscale frames to a
``FrameBus`` slot, with pause/resume/close lifecycle.

The port's own copy of ``steroscopic_hardware_tpu/runtime/sources.py``,
so that the port imports nothing of the JAX package. ``StaticSource._load``
decodes through the port's ``ops.gray``.
"""

from __future__ import annotations

import os
import socket
import threading
import time

import numpy as np

from steroscopic_hardware_tpu_torch.runtime import wire
from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
from steroscopic_hardware_tpu_torch.runtime.logger import get_logger


class BaseSource:
    """Lifecycle shared by all sources (pkg/camera/base.go equivalent)."""

    def __init__(self, bus: FrameBus, slot: str):
        self.bus = bus
        self.slot = slot
        self._paused = threading.Event()
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        self.log = get_logger(f"{type(self).__name__}.{slot}")
        self.frames_published = 0

    # -- Camera interface ---------------------------------------------------
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def pause(self):
        self._paused.set()

    def resume(self):
        self._paused.clear()

    def close(self, timeout: float = 2.0):
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    # -- implementation helpers --------------------------------------------
    def _publish(self, frame: np.ndarray):
        if not self._paused.is_set():
            self.bus.publish(self.slot, frame, source=type(self).__name__)
            self.frames_published += 1

    def _run(self):  # pragma: no cover - overridden
        raise NotImplementedError


class StaticSource(BaseSource):
    """Publishes a fixed image at ``fps`` (default 10 Hz like
    static.go:45). The file is re-read every ``reload_every`` frames so an
    upload can swap the backing file without restarting."""

    def __init__(self, bus, slot, path_or_array, fps: float = 10.0,
                 reload_every: int = 10):
        super().__init__(bus, slot)
        self.fps = fps
        self.reload_every = reload_every
        if isinstance(path_or_array, np.ndarray):
            self.path = None
            self._frame = path_or_array
        else:
            self.path = path_or_array
            self._frame = self._load()

    def _load(self) -> np.ndarray:
        from steroscopic_hardware_tpu_torch.ops.gray import load_gray

        return load_gray(self.path)

    def _run(self):
        n = 0
        period = 1.0 / self.fps
        while not self._closed.is_set():
            t0 = time.time()
            if self.path is not None and n % self.reload_every == 0 and n > 0:
                try:
                    self._frame = self._load()
                except Exception:
                    # keep serving the last good frame (static.go:54-56
                    # retry-style resilience)
                    pass
            self._publish(self._frame)
            n += 1
            time.sleep(max(0.0, period - (time.time() - t0)))


class SyntheticSource(BaseSource):
    """Procedural stereo test pattern: drifting textured noise; the right
    channel (shift > 0) is the same texture shifted horizontally so the
    disparity engine sees a known ground truth."""

    def __init__(self, bus, slot, shape=(480, 640), fps: float = 30.0,
                 shift: int = 0, seed: int = 0):
        super().__init__(bus, slot)
        self.shape = shape
        self.fps = fps
        self.shift = shift
        rng = np.random.default_rng(seed)
        self._texture = rng.integers(0, 256, shape, dtype=np.uint8)

    def _run(self):
        n = 0
        period = 1.0 / self.fps
        while not self._closed.is_set():
            t0 = time.time()
            frame = np.roll(self._texture, n - self.shift, axis=1)
            self._publish(frame)
            n += 1
            time.sleep(max(0.0, period - (time.time() - t0)))


def list_serial_ports() -> list[str]:
    """Enumerate REAL serial devices — the stdlib equivalent of the
    reference's go.bug.st/serial/enumerator walk
    (``cmd/handlers/ports.go:14-61``): stable ``/dev/serial/by-id``
    names first, then USB serial adapters, then platform UARTs that
    actually have a UART bound (``/sys/class/tty/<dev>/type != 0`` —
    an unbound ttyS node is a stub, not a port)."""
    import glob

    out: list[str] = []
    out += sorted(glob.glob("/dev/serial/by-id/*"))
    out += sorted(glob.glob("/dev/ttyUSB*"))
    out += sorted(glob.glob("/dev/ttyACM*"))
    for p in sorted(glob.glob("/dev/ttyS*")):
        try:
            name = p.rsplit("/", 1)[-1]
            with open(f"/sys/class/tty/{name}/type") as f:
                if f.read().strip() != "0":
                    out.append(p)
        except OSError:
            out.append(p)
    return out


class SerialSource(BaseSource):
    """Streams frames from a REAL serial device.

    The transport the reference's live cameras actually use
    (``pkg/camera/serial.go:46-91``: go.bug.st/serial, 8 data bits, no
    parity, one stop bit). pyserial is not in the image, so the port is
    configured directly with stdlib ``termios``: raw mode (which is 8N1
    — raw clears parity and sets CS8), the requested baud when the
    kernel supports it, and VMIN=0/VTIME=1 so reads poll at 100 ms and
    ``close()`` stays responsive.

    Protocol and lifecycle match :class:`TcpSource` exactly — send
    0xFFD8, expect the 0x01 ack, feed the byte stream through the
    shared wire parser, send 0xFFD9 on close — with the same 10 ms to
    1 s reconnect backoff (``serial.go:181-229``) and 4-minute frame
    timeout (``serial.go:242``). Works on any termios-capable character
    device including a pty (``os.openpty``), which is how the test
    suite drives the full protocol hardware-free
    (``tests/test_serial.py``).
    """

    def __init__(self, bus, slot, device: str, baud: int = 921600,
                 frame_timeout: float = 240.0):
        super().__init__(bus, slot)
        self.device = device
        self.baud = baud
        self.frame_timeout = frame_timeout
        self.reconnects = 0
        # the current connection's parser: a NativeFrameParser, or the
        # Python FrameParser where the native library did not build
        self.parser = None

    @staticmethod
    def _configure_tty(fd: int, baud: int) -> None:
        import termios
        import tty

        tty.setraw(fd)  # raw 8N1: clears ICANON/ECHO/PARENB, sets CS8
        attrs = termios.tcgetattr(fd)
        speed = getattr(termios, f"B{baud}", None)
        if speed is not None:
            attrs[4] = speed  # ispeed
            attrs[5] = speed  # ospeed
        attrs[6][termios.VMIN] = 0
        attrs[6][termios.VTIME] = 1  # 100 ms read poll
        termios.tcsetattr(fd, termios.TCSANOW, attrs)

    def _read_exact(self, fd: int, n: int, timeout: float) -> bytes:
        deadline = time.time() + timeout
        buf = b""
        while (len(buf) < n and time.time() < deadline
               and not self._closed.is_set()):
            buf += os.read(fd, n - len(buf))
        return buf

    def _run(self):
        import termios

        backoff = 0.01
        while not self._closed.is_set():
            fd = None
            try:
                fd = os.open(self.device, os.O_RDWR | os.O_NOCTTY)
                try:
                    self._configure_tty(fd, self.baud)
                except termios.error as e:
                    raise ConnectionError(f"not a serial device: {e}")
                self.log.info("opened %s @ %d baud", self.device,
                              self.baud)
                os.write(fd, wire.START_SEQ)
                ack = self._read_exact(fd, 1, timeout=5.0)
                if ack != wire.ACK:
                    raise ConnectionError(f"bad ack {ack!r}")
                backoff = 0.01
                parser = self.parser = wire.make_parser()
                last_frame = time.time()
                while not self._closed.is_set():
                    data = os.read(fd, 65536)
                    if data:
                        frames = parser.feed(data)
                        for frame in frames:
                            self._publish(frame)
                        if frames:
                            last_frame = time.time()
                    elif time.time() - last_frame > self.frame_timeout:
                        raise ConnectionError("frame timeout")
                try:
                    os.write(fd, wire.END_SEQ)
                except OSError:
                    pass
            except (OSError, ConnectionError) as e:
                if self._closed.is_set():
                    break
                self.log.warning("serial error: %s; retry in %.0fms",
                                 e, backoff * 1000)
                self.reconnects += 1
                time.sleep(backoff)
                backoff = min(backoff * 2, 1.0)
            finally:
                if fd is not None:
                    try:
                        os.close(fd)
                    except OSError:
                        pass


class TcpSource(BaseSource):
    """Streams frames from a TCP camera endpoint with the reference wire
    protocol; reconnects with exponential backoff 10ms -> 1s
    (serial.go:181-229)."""

    def __init__(self, bus, slot, host: str, port: int,
                 frame_timeout: float = 240.0):
        super().__init__(bus, slot)
        self.host = host
        self.port = port
        self.frame_timeout = frame_timeout  # serial.go:242 (4 min)
        self.reconnects = 0
        # the current connection's parser: a NativeFrameParser, or the
        # Python FrameParser where the native library did not build
        self.parser = None

    def _run(self):
        backoff = 0.01
        while not self._closed.is_set():
            try:
                with socket.create_connection(
                    (self.host, self.port), timeout=5.0
                ) as sock:
                    sock.settimeout(self.frame_timeout)
                    self.log.info("connected %s:%d", self.host, self.port)
                    # start request + ack (serial.go:140-168)
                    sock.sendall(wire.START_SEQ)
                    ack = sock.recv(1)
                    if ack != wire.ACK:
                        raise ConnectionError(f"bad ack {ack!r}")
                    backoff = 0.01
                    parser = self.parser = wire.make_parser()
                    while not self._closed.is_set():
                        data = sock.recv(65536)
                        if not data:
                            raise ConnectionError("EOF")
                        for frame in parser.feed(data):
                            self._publish(frame)
                    sock.sendall(wire.END_SEQ)
            except (OSError, ConnectionError) as e:
                if self._closed.is_set():
                    break
                self.log.warning("stream error: %s; retry in %.0fms",
                                 e, backoff * 1000)
                self.reconnects += 1
                time.sleep(backoff)
                backoff = min(backoff * 2, 1.0)
