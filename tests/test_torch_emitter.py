"""The port's ``SerialEmitter`` scans the line for the start request: noise
bytes before 0xFFD8 are skipped, and the emitter acks and streams (the
JAX package's copy returns after the first two bytes when they are not
the start sequence; its file stays as it is).

Each case runs in a fresh interpreter: a thread another test left behind
in this process may still read from a closed descriptor whose number a
new pty reuses, and would take the bytes meant for the emitter.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os, select, sys, tty
import numpy as np
from steroscopic_hardware_tpu_torch.runtime import wire
from steroscopic_hardware_tpu_torch.runtime.emitter import SerialEmitter


def read(fd, n, timeout=5.0):
    out = b""
    while len(out) < n:
        ready, _, _ = select.select([fd], [], [], timeout)
        if not ready:
            break
        out += os.read(fd, n - len(out))
    return out


noise = bytes.fromhex(sys.argv[1])
master, slave = os.openpty()
tty.setraw(slave)
if sys.argv[2] == "stream":
    frame = np.arange(12, dtype=np.uint8).reshape(3, 4)
    em = SerialEmitter(lambda i: frame, master, fps=200.0,
                       max_frames=1).start()
    os.write(slave, noise + wire.START_SEQ)
    print("ack", read(slave, 1) == wire.ACK)
    # and a frame follows the ack
    print("frame", len(read(slave, 4)) == 4)
    em.close()
else:  # closed before any start request: the scan ends, nothing is sent
    em = SerialEmitter(lambda i: None, master, fps=200.0).start()
    os.write(slave, noise)
    em.close()
    os.close(slave)
    em._thread.join(timeout=5.0)
    print("stopped", not em._thread.is_alive() and em.frames_sent == 0)
"""


def _run(noise: bytes, mode: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, noise.hex(), mode],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


@pytest.mark.parametrize("noise", [b"", b"\x00", b"\x00\x42",
                                   b"\xff\xff\x13\xff", b"\xd8\xff\x00"])
def test_serial_emitter_skips_noise_before_start(noise):
    out = _run(noise, "stream")
    assert "ack True" in out and "frame True" in out, out


def test_serial_emitter_stops_when_closed_before_start():
    assert "stopped True" in _run(b"\x00\x01\x02", "close")
