"""ctypes binding to the C++ native runtime (``native/shtpu_native.cpp``).

Builds the shared library on first use if it is missing (g++ is part of the
toolchain). Every entry point has a pure-Python fallback in its calling
module, so the framework still works if no compiler is available.

The port's own copy of ``steroscopic_hardware_tpu/_native.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

# the source checkout's top-level native/, the C++ shared by both packages;
# an installed port without it takes the pure-Python fallbacks
_NATIVE_DIRS = [
    os.path.join(os.path.dirname(os.path.dirname(__file__)), "native"),
]
_LIB_NAME = "libshtpu_native.so"

_lock = threading.Lock()
_lib = None
_tried = False


def _cache_dir() -> str:
    """Per-version, per-machine cache directory for read-only installs:
    a package upgrade must not keep loading a stale binary, and a
    ``-march=native`` artifact in a shared/NFS home must not SIGILL on a
    host with a different CPU (ADVICE r4)."""
    import platform

    from steroscopic_hardware_tpu_torch.version import __version__

    return os.path.join(
        os.path.expanduser("~"), ".cache", "steroscopic_hardware_tpu_torch",
        f"{__version__}-{platform.machine()}-{platform.node()}",
    )


def _build(native_dir: str) -> str | None:
    """Build the shared library from ``native_dir``'s source; returns the
    built path. Read-only installs (site-packages owned by root, zipped
    wheels unpacked read-only) build into ``~/.cache`` instead."""
    src = os.path.join(native_dir, "shtpu_native.cpp")
    if not os.path.exists(src):
        return None
    out = os.path.join(native_dir, _LIB_NAME)
    try:
        if os.access(native_dir, os.W_OK):
            subprocess.run(
                ["make", "-C", native_dir], check=True,
                capture_output=True, timeout=120,
            )
            return out if os.path.exists(out) else None
        cache = _cache_dir()
        os.makedirs(cache, exist_ok=True)
        out = os.path.join(cache, _LIB_NAME)
        if not os.path.exists(out):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17",
                 "-shared", "-o", out, src],
                check=True, capture_output=True, timeout=120,
            )
        return out if os.path.exists(out) else None
    except Exception:
        return None


def _locate() -> str | None:
    for d in _NATIVE_DIRS:
        lib = os.path.join(d, _LIB_NAME)
        if os.path.exists(lib):
            return lib
    cached = os.path.join(_cache_dir(), _LIB_NAME)
    if os.path.exists(cached):
        return cached
    for d in _NATIVE_DIRS:
        built = _build(d)
        if built is not None:
            return built
    return None


def get_lib():
    """Return the loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _locate()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None

        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.shtpu_png_unfilter.restype = ctypes.c_int
        lib.shtpu_png_unfilter.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, u8p,
        ]
        lib.shtpu_png_filter_sub.restype = None
        lib.shtpu_png_filter_sub.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, u8p,
        ]
        lib.shtpu_rc_encode.restype = ctypes.c_int64
        lib.shtpu_rc_encode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib.shtpu_rc_decode.restype = ctypes.c_int64
        lib.shtpu_rc_decode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]

        lib.shtpu_parser_new.restype = ctypes.c_void_p
        lib.shtpu_parser_free.argtypes = [ctypes.c_void_p]
        lib.shtpu_parser_feed.restype = ctypes.c_int64
        lib.shtpu_parser_feed.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64]
        for name, res in [
            ("shtpu_parser_frame_ready", ctypes.c_int),
            ("shtpu_parser_width", ctypes.c_uint32),
            ("shtpu_parser_height", ctypes.c_uint32),
            ("shtpu_parser_payload_len", ctypes.c_uint32),
            ("shtpu_parser_codec", ctypes.c_uint8),
            ("shtpu_parser_frames", ctypes.c_int64),
            ("shtpu_parser_dropped", ctypes.c_int64),
        ]:
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = [ctypes.c_void_p]
        lib.shtpu_parser_take.restype = ctypes.c_int
        lib.shtpu_parser_take.argtypes = [ctypes.c_void_p, u8p]
        lib.shtpu_frame_encode.restype = ctypes.c_int64
        lib.shtpu_frame_encode.argtypes = [
            u8p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint8, u8p,
        ]

        _lib = lib
        return _lib
