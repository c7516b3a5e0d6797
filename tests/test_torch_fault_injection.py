"""Fault injection on the port's ingest path, as
``tests/test_fault_injection.py`` holds the JAX one: garbage, truncation
and disconnects between valid frames, and a parser fed random bytes. Both
packages' parsers (the Python one and the native one) read the same
fuzzed stream into the same frames.
"""

import socket
import threading
import time

import numpy as np
import pytest

from steroscopic_hardware_tpu.runtime import wire as jax_wire
from steroscopic_hardware_tpu_torch._native import get_lib
from steroscopic_hardware_tpu_torch.runtime import wire
from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
from steroscopic_hardware_tpu_torch.runtime.sources import TcpSource

from torch_wait import wait


class ChaosEmitter:
    """Protocol emitter that injects faults between valid frames."""

    def __init__(self, frames, faults):
        self.frames = frames
        self.faults = faults  # list of callables(bytes)->bytes per frame
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.accepted = 0
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._closed.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.accepted += 1
            with conn:
                try:
                    if conn.recv(2) != wire.START_SEQ:
                        continue
                    conn.sendall(wire.ACK)
                    for frame, fault in zip(self.frames, self.faults):
                        conn.sendall(fault(wire.encode_frame(frame)))
                        time.sleep(0.01)
                except OSError:
                    pass
            # the connection closes: the client must reconnect

    def close(self):
        self._closed.set()
        self.sock.close()
        self._thread.join(5.0)


def test_recovers_from_garbage_between_frames(rng):
    frames = [rng.integers(0, 256, (8, 16), dtype=np.uint8)
              for _ in range(4)]
    faults = [
        lambda b: b,
        lambda b: b"\x00\xff\xd8garbage" + b,     # fake start marker + junk
        lambda b: b[: len(b) // 2],               # truncated frame
        lambda b: b,                              # the parser resyncs
    ]
    em = ChaosEmitter(frames, faults)
    bus = FrameBus()
    src = TcpSource(bus, "left", "127.0.0.1", em.port).start()
    try:
        # valid frames 0, 1 and 3 land despite the noise
        assert wait(lambda: bus.seq("left") >= 3)
        assert any(np.array_equal(bus.latest("left").data, f)
                   for f in frames)
    finally:
        src.close()
        em.close()


def test_reconnect_after_disconnect(rng):
    frames = [rng.integers(0, 256, (8, 16), dtype=np.uint8)] * 2
    em = ChaosEmitter(frames, [lambda b: b, lambda b: b])
    bus = FrameBus()
    src = TcpSource(bus, "left", "127.0.0.1", em.port).start()
    try:
        assert wait(lambda: bus.seq("left") >= 2)
        # the emitter drops the connection after its frames; the source
        # reconnects and pulls the stream again
        assert wait(lambda: em.accepted >= 2)
        assert wait(lambda: bus.seq("left") >= 4)
        assert src.reconnects >= 1
    finally:
        src.close()
        em.close()


def test_parser_never_crashes_on_fuzz(rng):
    parser = wire.FrameParser()
    for _ in range(50):
        blob = rng.integers(0, 256, rng.integers(1, 400),
                            dtype=np.uint8).tobytes()
        parser.feed(blob)  # must not raise
    # and still parses a valid frame afterwards
    f = rng.integers(0, 256, (4, 8), dtype=np.uint8)
    got = parser.feed(wire.encode_frame(f))
    # fuzz may have left a partial header consuming the start marker;
    # a second frame must definitely parse
    got += parser.feed(wire.encode_frame(f))
    assert any(np.array_equal(g, f) for g in got)


def _fuzzed_stream(rng):
    """Valid frames in each codec with random bytes, fake markers and a
    truncated frame between them."""
    parts = []
    for i in range(12):
        frame = rng.integers(0, 256, (int(rng.integers(1, 20)),
                                      int(rng.integers(1, 30))),
                             dtype=np.uint8)
        parts.append(wire.encode_frame(frame, codec=i % 3))
        junk = rng.integers(0, 256, int(rng.integers(0, 60)),
                            dtype=np.uint8).tobytes()
        parts.append([junk, b"\xff\xd8" + junk, junk + b"\xff",
                      wire.encode_frame(frame)[:int(rng.integers(2, 20))]][
            i % 4])
    return b"".join(parts)


@pytest.mark.parametrize("kind", ["python", "native"])
def test_parsers_agree_with_jax_on_a_fuzzed_stream(rng, kind):
    """The port's parser and the JAX package's, each fed the same fuzzed
    stream in the same random chunks, return the same frames and count
    the same dropped bytes."""
    stream = _fuzzed_stream(rng)
    if kind == "native":
        lib = get_lib()
        assert lib is not None, "the native library did not build"
        from steroscopic_hardware_tpu._native import get_lib as jax_get_lib

        port, ref = wire.NativeFrameParser(lib), jax_wire.NativeFrameParser(
            jax_get_lib())
    else:
        port, ref = wire.FrameParser(), jax_wire.FrameParser()
    got_port, got_ref = [], []
    i = 0
    while i < len(stream):
        n = int(rng.integers(1, 97))
        got_port += port.feed(stream[i:i + n])
        got_ref += ref.feed(stream[i:i + n])
        i += n
    # a fake marker may swallow a frame; most come through
    assert len(got_port) == len(got_ref) >= 6
    for a, b in zip(got_port, got_ref):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert port.bytes_dropped == ref.bytes_dropped > 0
