"""The port's serial transport on the CPU, as ``tests/test_serial.py`` holds
the JAX one: ``SerialSource`` speaks the 0xFFD8 / ack / 0xFFD9 protocol over
a real termios device, a pty (``os.openpty``), against a ``SerialEmitter``
on its master side, in each codec, through garbage between frames, with
backoff on a dead device, through ``POST /left/configure device=...``
and ``/ports``; and a JAX ``SerialEmitter`` feeds a port ``SerialSource``
and the other way round, the frames byte-equal.

Every pty case runs in a fresh interpreter: a thread another test left in
this process may still read from a closed descriptor whose number a new
pty reuses, and would take the bytes meant for the source. Each case
waits on its condition under a deadline and closes every source, emitter,
pty and server it opens.
"""

import os
import subprocess
import sys
import time

import pytest

from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
from steroscopic_hardware_tpu_torch.runtime.sources import (
    SerialSource,
    list_serial_ports,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import json, os, sys, threading, time, urllib.request
import numpy as np
from steroscopic_hardware_tpu_torch.runtime import wire
from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
from steroscopic_hardware_tpu_torch.runtime.emitter import SerialEmitter
from steroscopic_hardware_tpu_torch.runtime.sources import SerialSource

sys.path.insert(0, "tests")
from torch_wait import wait


def frames(n, shape=(48, 64), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]


def pty_pair():
    master, slave = os.openpty()
    return master, os.ttyname(slave), slave


case = sys.argv[1]
if case == "stream":
    fs = frames(8)
    master, path, slave = pty_pair()
    em = SerialEmitter(lambda i: fs[i % 8], master, fps=200.0,
                       max_frames=8).start()
    bus = FrameBus()
    src = SerialSource(bus, "left", path, baud=115200,
                       frame_timeout=5.0).start()
    try:
        assert wait(lambda: src.frames_published >= 8)
        got = bus.latest("left").data
        # the last published frame is the last one emitted, bit for bit
        assert em.frames_sent == 8 and np.array_equal(got, fs[7])
        assert type(src.parser).__name__ == "NativeFrameParser"
    finally:
        src.close()
        em.close()
        os.close(slave)
elif case.startswith("codec"):
    codec = int(case[5:])
    fs = frames(3, seed=codec)
    master, path, slave = pty_pair()
    em = SerialEmitter(lambda i: fs[i % 3], master, codec=codec, fps=200.0,
                       max_frames=3).start()
    bus = FrameBus()
    src = SerialSource(bus, "left", path, frame_timeout=5.0).start()
    try:
        assert wait(lambda: src.frames_published >= 3)
        assert np.array_equal(bus.latest("left").data, fs[2])
    finally:
        src.close()
        em.close()
        os.close(slave)
elif case == "garbage":
    # a hand-rolled firmware loop with garbage between the frames and a
    # truncated frame at the end, which is dropped
    fs = frames(4)
    master, path, slave = pty_pair()
    bus = FrameBus()
    src = SerialSource(bus, "left", path, frame_timeout=5.0)

    def emit():
        buf = b""
        while buf[-2:] != wire.START_SEQ:
            buf += os.read(master, 1)
        os.write(master, wire.ACK)
        for f in fs:
            os.write(master, wire.encode_frame(f))
            os.write(master, b"\x00\xffjunk\xd8garbage" * 3)
        os.write(master, wire.encode_frame(fs[0])[:40])

    t = threading.Thread(target=emit, daemon=True)
    src.start()
    t.start()
    try:
        assert wait(lambda: src.frames_published >= 4)
        assert np.array_equal(bus.latest("left").data, fs[-1])
        t.join(10.0)
        assert not t.is_alive()
    finally:
        src.close()
        os.close(master)
        os.close(slave)
elif case == "configure":
    # POST /left/configure device= attaches a SerialSource, /ports lists
    # it, and the served frame is the emitted one
    from steroscopic_hardware_tpu_torch.__main__ import build_app
    from steroscopic_hardware_tpu_torch.serve_probe import configure

    fs = frames(4, shape=(24, 64))
    master, path, slave = pty_pair()
    em = SerialEmitter(lambda i: fs[i % 4], master, fps=100.0).start()
    app = build_app(["--device", "cpu", "--port", "0", "--no-open"]).start()
    try:
        resp = configure(app.url, "left", {"device": path, "baud": 115200})
        assert resp["device"] == path and resp["baud"] == 115200, resp
        bus = app.manager.bus
        assert wait(lambda: bus.latest("left") is not None)
        assert any(np.array_equal(bus.latest("left").data, f) for f in fs)
        with urllib.request.urlopen(app.url + "/ports") as r:
            ports = json.load(r)["ports"]
        configured = [p for p in ports if p.get("kind") == "configured"
                      and p.get("device") == path]
        assert configured and configured[0]["baud"] == 115200, ports
    finally:
        app.shutdown()
        em.close()
        os.close(slave)
elif case in ("jax-to-port", "port-to-jax"):
    from steroscopic_hardware_tpu.runtime import emitter as jax_emitter
    from steroscopic_hardware_tpu.runtime import sources as jax_sources
    from steroscopic_hardware_tpu.runtime.bus import FrameBus as JaxBus

    fs = frames(3, seed=7)
    master, path, slave = pty_pair()
    if case == "jax-to-port":
        em_cls, src_cls, bus = (jax_emitter.SerialEmitter, SerialSource,
                                FrameBus())
    else:
        em_cls, src_cls, bus = (SerialEmitter, jax_sources.SerialSource,
                                JaxBus())
    got = []
    publish = bus.publish

    def record(name, data, source=""):
        got.append(np.array(data))
        return publish(name, data, source=source)

    bus.publish = record
    em = em_cls(lambda i: fs[i % 3], master, codec=wire.CODEC_RANGE,
                fps=200.0, max_frames=3).start()
    src = src_cls(bus, "left", path, frame_timeout=5.0).start()
    try:
        assert wait(lambda: len(got) >= 3)
        for g, f in zip(got, fs):
            assert np.array_equal(g, f)
    finally:
        src.close()
        em.close()
        if case == "jax-to-port":
            em._thread.join(5.0)
        os.close(slave)
print("ok", case)
"""


def _run(case: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, case], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"ok {case}" in proc.stdout, proc.stdout


def test_serial_source_streams_frames_over_pty():
    _run("stream")


@pytest.mark.parametrize("codec", [0, 1, 2])
def test_serial_source_all_codecs_roundtrip(codec):
    _run(f"codec{codec}")


def test_serial_source_resyncs_through_garbage():
    """Garbage bytes between frames do not end the stream: the parser
    drops them and resyncs on the next start marker."""
    _run("garbage")


def test_server_configure_serial_end_to_end():
    _run("configure")


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_serial_interoperates_with_jax(direction):
    _run(direction)


def test_serial_source_reconnect_backoff_on_dead_device():
    """Opening a path that is not a serial device fails fast and retries
    with backoff (no busy spin, the thread lives on)."""
    bus = FrameBus()
    src = SerialSource(bus, "left", "/nonexistent/ttyXYZ", frame_timeout=1.0)
    src.start()
    try:
        t0 = time.time()
        while src.reconnects < 2:
            assert time.time() - t0 < 5.0, "no retry"
            time.sleep(0.01)
        assert src.frames_published == 0 and src._thread.is_alive()
    finally:
        src.close()
    assert not src._thread.is_alive()


def test_list_serial_ports_runs_and_filters():
    ports = list_serial_ports()
    assert isinstance(ports, list)
    for p in ports:
        assert p.startswith("/dev/")
