"""``wait``: poll a condition under a deadline, for the port's transport,
serial, fault-injection, concurrency and server-hardening tests (they
never sleep for a fixed window and then assert)."""

import time


def wait(cond, timeout=20.0, dt=0.01):
    """True once ``cond()`` holds, False if ``timeout`` seconds pass
    first."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(dt)
    return False
